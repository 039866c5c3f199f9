"""The port's coarse_depth family (unet, lite, hybrid, dual_reg), its bins
and losses, and the legacy blocks, against the JAX package, on the CPU.

  * `coarse_state_dict_from_jax` equals `export_for_config` key for key and
    value for value for each model_type (the `bin_centers` buffer written as
    the reference default), and the port's model loads it with strict=True;
    at base 64, n_bins 128 the parameter counts are 17,270,656 (unet),
    14,042,560 (lite), 25,181,825 (hybrid) and 25,173,570 (dual_reg), the
    JAX models' (from their variables' shapes);
  * each forward in eval and train mode (every output: logits, coarse,
    offset, final) and the running statistics a train forward folds match
    flax in f64 at 1e-10 (base 4, n_bins 8, 32²); the bilinear resize of
    the logits matches `jax.image.resize` at sizes the families never give
    it; the hybrid's and dual_reg's fusion input is detached;
  * every loss matches at 1e-12; the bin edges exactly, and the bins of
    every host path bit for bit;
  * `loss_fn`'s loss and gradients match `jax.grad` of the JAX task at
    1e-10 and 1e-8 for each type (lite with the focal loss); three AdamW + clip
    steps of the engines agree at 2e-6 (unet and hybrid);
    the JAX package computes the classification terms in float32 whatever
    the compute dtype (`astype(jnp.float32)`), and so does the port
    (`losses/coarse.py::CE_DTYPE`): those comparisons lift that one cast to
    float64 on both sides (`f64_ce`), so that they hold the formulas in
    float64, and `test_loss_dtype_follows_jax` holds the float32 terms
    themselves, at float32's precision;
  * `Engine.evaluate` with a ragged tail matches JAX's at 1e-6;
    `checkpoint_aux` equals JAX's; a checkpoint trained on linear bins is
    evaluated and served on them under the default sid config, from a port
    checkpoint and from a reference wrapper (whose bins `--init_from_torch`
    adopts too);
  * the codec, the device cache and prefetch carry 'bins' and
    'original_depth' unchanged; the train CLI's new general flags give the
    JAX CLI's config;
  * the legacy EncodeBlock, FCBlock and DecodeBlock match flax at 1e-10 in
    train and eval mode.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from audiodepth_tpu.configs import load_config as jax_load_config
from audiodepth_tpu.data import bins as jbins
from audiodepth_tpu.losses import coarse as jloss
from audiodepth_tpu.models import make_task as jax_make_task
from audiodepth_tpu.models import coarse_depth as jcoarse
from audiodepth_tpu.tools.import_torch import export_for_config
from audiodepth_tpu.train.engine import Engine as JaxEngine

from audiodepth_tpu_torch.cli import evaluate as evaluate_cli
from audiodepth_tpu_torch.cli import serve as serve_cli
from audiodepth_tpu_torch.cli import train as train_cli
from audiodepth_tpu_torch.configs import load_config
from audiodepth_tpu_torch.data import bins
from audiodepth_tpu_torch.data.batvision import make_dataset
from audiodepth_tpu_torch.data.codec import decode_batch, encode_batch
from audiodepth_tpu_torch.data.device_cache import DeviceDatasetCache
from audiodepth_tpu_torch.data.prefetch import device_prefetch
from audiodepth_tpu_torch.losses import coarse as loss
from audiodepth_tpu_torch.metrics import METRIC_NAMES
from audiodepth_tpu_torch.models import coarse_depth, init_weights, legacy, make_task
from audiodepth_tpu_torch.tools.import_jax import _Exporter, coarse_state_dict_from_jax
from audiodepth_tpu_torch.train.engine import Engine

from tests.torch_parity import (assert_close_rel, f64, jax_state, n_params,  # noqa: F401
                                nchw, nhwc, one_torch_thread, randomize, shapes, to_np,
                                torch_batch)

TYPES = ("unet", "lite", "hybrid", "dual_reg")
FULL_PARAMS = {"unet": 17_270_656, "lite": 14_042_560, "hybrid": 25_181_825,
               "dual_reg": 25_173_570}
SMALL = {"model.base_channels": 4, "model.n_bins": 8, "dataset.images_size": 32,
         "mode.compute_dtype": "float64"}


class _JnpF64:
    """jax.numpy with float32 read as float64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture
def f64_ce(f64, monkeypatch):
    """float64 mode with the losses' float32 classification terms in
    float64 too, in the JAX package's losses (every jnp.float32 of
    losses/coarse.py) and in the port's (CE_DTYPE)."""
    monkeypatch.setattr(jloss, "jnp", _JnpF64())
    monkeypatch.setattr(loss, "CE_DTYPE", torch.float64)


def _overrides(model_type, extra=()):
    return dict(SMALL, **{"model.model_type": model_type}, **dict(extra))


def _sd(variables, model_type):
    return coarse_state_dict_from_jax(to_np(variables["params"]),
                                      to_np(variables["batch_stats"]), model_type, 8)


def _args(jtask, x):
    return (x,) if jtask.model_type == "dual_reg" else (x, jtask.bin_centers)


@functools.lru_cache(maxsize=None)
def _jtask(model_type, extra=()):
    cfg = jax_load_config("synthetic", "train", model_name="coarse_depth",
                          overrides=_overrides(model_type, extra))
    return cfg, jax_make_task(cfg)


@functools.lru_cache(maxsize=None)
def _variables(model_type):
    jtask = _jtask(model_type)[1]
    return randomize(shapes(jtask.model.init, *_args(jtask, jnp.zeros((1, 32, 32, 2))),
                            train=False), 5)


def _port(model_type, extra=()):
    cfg = load_config("synthetic", "train", model_name="coarse_depth",
                      overrides=_overrides(model_type, extra))
    task = make_task(cfg, device="cpu")
    task.model.double().load_state_dict(_sd(_variables(model_type), model_type), strict=True)
    return cfg, task


@functools.lru_cache(maxsize=None)
def _batches():
    """Three train batches of 2 with bins, float64 (the bins int32)."""
    cfg = load_config("synthetic", "train", model_name="coarse_depth", overrides=SMALL)
    edges = bins.compute_bin_edges(8, 0.1, 30.0, "sid")[0]
    out = []
    for b in make_dataset(cfg, "train", num_samples=6).batches(2, shuffle=False):
        b = {k: v.astype(np.float64) for k, v in b.items()}
        out.append(bins.add_bins_to_batch(b, edges, 30.0, False))
    return out


# ---------------------------------------------------------------------------
# weights and forwards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model_type", TYPES)
def test_state_dict_equals_jax_export_and_param_count(model_type):
    cfg, jtask = _jtask(model_type)
    variables = randomize(shapes(jtask.model.init, *_args(jtask, jnp.zeros((1, 32, 32, 2))),
                                 train=False), 3, np.float32)
    want = export_for_config(cfg, variables)
    got = _sd(variables, model_type)
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    port = make_task(load_config("synthetic", "train", model_name="coarse_depth",
                                 overrides=_overrides(model_type)), device="cpu")
    result = port.model.load_state_dict(got, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    if model_type != "dual_reg":  # the task's centers, not the file's
        np.testing.assert_array_equal(port.model.bin_centers.numpy(), port.bin_centers)
    cfg = load_config("batvisionv2", "test", model_name="coarse_depth",
                      overrides={"model.model_type": model_type})
    assert cfg.model.n_bins == 128 and cfg.model.base_channels == 64
    with torch.device("meta"):  # shapes only
        full = coarse_depth.build_coarse(model_type, 2, 128, 64, 256, torch.bfloat16)
    assert sum(p.numel() for p in full.parameters()) == FULL_PARAMS[model_type]
    if model_type == "unet":  # the JAX model's count at one width, from its shapes
        jfull = jax_make_task(jax_load_config("batvisionv2", "test", model_name="coarse_depth"))
        want_n = n_params(shapes(jfull.model.init, *_args(jfull, jnp.zeros((1, 32, 32, 2))),
                                 train=False)["params"])
        assert want_n == FULL_PARAMS["unet"]


# the loss configuration of each type's reference: lite runs the focal loss
LOSS_EXTRA = {"lite": (("model.extra.use_focal", True),)}


def _forward_input():
    return np.random.default_rng(1).uniform(size=(2, 32, 32, 2))


@functools.lru_cache(maxsize=None)
def _jax_reference(model_type):
    """JAX's eval and train forwards of `_forward_input()`, and `loss_fn`'s
    value, aux and gradients on the first batch, from one compile (under
    `f64_ce`), as numpy."""
    jtask = _jtask(model_type, LOSS_EXTRA.get(model_type, ()))[1]

    def fn(v, x, batch):
        evaluated = jtask.model.apply(v, *_args(jtask, x), train=False)
        trained, upd = jtask.model.apply(v, *_args(jtask, x), train=True,
                                         mutable=["batch_stats"])

        def value(params):
            loss_value, (_, aux) = jtask.loss_fn(params, v["batch_stats"], batch,
                                                 jax.random.PRNGKey(1), 0.0)
            return loss_value, aux

        (loss_value, aux), grads = jax.value_and_grad(value, has_aux=True)(v["params"])
        return evaluated, trained, upd, loss_value, aux, grads

    out = jax.jit(fn)(_variables(model_type), jnp.asarray(_forward_input()),
                      {k: jnp.asarray(v) for k, v in _batches()[0].items()})
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("model_type", TYPES)
def test_forward_matches_flax_f64(model_type, train, f64_ce):
    variables = _variables(model_type)
    evaluated, trained, upd = _jax_reference(model_type)[:3]
    _, task = _port(model_type)
    task.model.train(train)
    with torch.no_grad():
        got = task.model(nchw(_forward_input()))
    want = trained if train else evaluated
    assert len(got) == len(want) == {"unet": 2, "lite": 2, "hybrid": 4, "dual_reg": 3}[model_type]
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and nhwc(g).shape == w.shape
        assert np.abs(nhwc(g) - w).max() <= 1e-10 * np.abs(w).max()
    if train:
        want_sd = _sd({"params": variables["params"], "batch_stats": upd["batch_stats"]},
                      model_type)
        stats = [k for k in want_sd if k.endswith(("running_mean", "running_var"))]
        assert_close_rel(task.model.state_dict(), want_sd, 1e-10, "running statistic",
                         keys=stats)


@pytest.mark.parametrize("size", [24, 48])
def test_resize_to_matches_jax_image_resize(size, f64):
    """`_resize_bilinear_to` at a size other than the input's (the families
    give it their own size at 256²): antialiased when it shrinks."""
    x = np.random.default_rng(3).normal(size=(2, 32, 32, 5))
    want = np.asarray(jcoarse._resize_bilinear_to(jnp.asarray(x), size))
    got = nhwc(coarse_depth._resize_bilinear_to(nchw(x), size))
    assert got.shape == want.shape == (2, size, size, 5)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    t = nchw(x)
    assert coarse_depth._resize_bilinear_to(t, 32) is t


@pytest.mark.parametrize("model_type", ["hybrid", "dual_reg"])
def test_fusion_input_is_detached(model_type):
    """The offset branch's loss reaches no coarse-branch parameter."""
    cfg = load_config("synthetic", "train", model_name="coarse_depth",
                      overrides={**_overrides(model_type), "mode.compute_dtype": "float32"})
    task = make_task(cfg, device="cpu")
    init_weights(task.model, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(2).uniform(size=(2, 2, 32, 32)).astype(np.float32))
    out = task.model.train()(x)
    out[-2].abs().mean().backward()  # the offset
    grads = {n: p.grad for n, p in task.model.named_parameters()}
    assert all(grads[n] is None for n in grads if n.startswith("coarse_"))
    assert all(g is not None for n, g in grads.items() if n.startswith("offset_"))


# ---------------------------------------------------------------------------
# losses and bins
# ---------------------------------------------------------------------------

def _loss_inputs():
    rng = np.random.default_rng(4)
    logits = rng.normal(0.0, 2.0, size=(2, 8, 8, 6))
    target = rng.integers(0, 6, size=(2, 8, 8)).astype(np.int32)
    gt = rng.uniform(0.0, 30.0, size=(2, 8, 8, 1))
    gt[:, :2] = 0.0
    coarse, offset = rng.uniform(0, 30, gt.shape), rng.normal(0, 1, gt.shape)
    return logits, target, gt, coarse, offset, coarse + offset


_LOSSES = {
    "ordinal": lambda m, a: m.ordinal_regression_loss(a[0], a[1]),
    "soft_ce": lambda m, a: m.soft_cross_entropy_loss(a[0], a[1], 1.5),
    "hard_ce": lambda m, a: m.hard_cross_entropy_loss(a[0], a[1]),
    "hard_ce_smoothed": lambda m, a: m.hard_cross_entropy_loss(a[0], a[1], 0.1),
    "focal": lambda m, a: m.focal_loss(a[0], a[1], 2.0),
    "coarse_depth_soft": lambda m, a: m.coarse_depth_loss(a[0], a[3], a[1], a[2], a[2] > 0),
    "coarse_depth_focal": lambda m, a: m.coarse_depth_loss(a[0], a[3], a[1], a[2], a[2] > 0,
                                                           mode="focal"),
    "coarse_depth_hard": lambda m, a: m.coarse_depth_loss(a[0], a[3], a[1], a[2], None,
                                                          mode="hard", ce_weight=0.7),
    "coarse_offset": lambda m, a: m.coarse_offset_loss(a[0], a[3], a[4], a[5], a[2], a[1],
                                                       0.9, 0.5, 0.01, label_smoothing=0.1),
    "coarse_offset_l2": lambda m, a: m.coarse_offset_loss(a[0], a[3], a[4], a[5], a[2], a[1],
                                                          regression="l2"),
    "dual_regression": lambda m, a: m.dual_regression_loss(a[3], a[4], a[5], a[2], 0.8, 1.1),
}


@pytest.mark.parametrize("name", list(_LOSSES))
def test_losses_match_jax_f64(name, f64_ce):
    inputs = _loss_inputs()
    got = _LOSSES[name](loss, [torch.from_numpy(a) for a in inputs])
    want = _LOSSES[name](jloss, [jnp.asarray(a) for a in inputs])
    if isinstance(want, tuple):
        assert set(got[1]) == set(want[1])
        pairs = [(got[1][k], want[1][k]) for k in want[1]] + [(got[0], want[0])]
    else:
        pairs = [(got, want)]
    for g, w in pairs:
        np.testing.assert_allclose(float(g), float(w), rtol=1e-12)


@pytest.mark.parametrize("name", ["ordinal", "soft_ce", "hard_ce_smoothed", "focal",
                                  "coarse_offset"])
def test_loss_dtype_follows_jax(name, f64):
    """Without the lift: float64 inputs, the classification term in float32
    on both sides (to float32's precision)."""
    inputs = _loss_inputs()
    got = _LOSSES[name](loss, [torch.from_numpy(a) for a in inputs])
    want = _LOSSES[name](jloss, [jnp.asarray(a) for a in inputs])
    ce, jce = (got[1]["ce"], want[1]["ce"]) if isinstance(want, tuple) else (got, want)
    assert ce.dtype == torch.float32
    np.testing.assert_allclose(float(ce), float(jce), rtol=1e-6)


@pytest.mark.parametrize("mode,alpha", [("linear", 0.6), ("log", 0.6), ("sid", 0.6),
                                        ("sid", 0.45)])
def test_bin_edges_match_jax_exactly(mode, alpha):
    for n, lo, hi in ((8, 0.1, 30.0), (128, 0.1, 30.0), (64, 0.2, 12.0)):
        got = bins.compute_bin_edges(n, lo, hi, mode, alpha)
        want = jbins.compute_bin_edges(n, lo, hi, mode, alpha)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("depth_norm", [False, True])
def test_bins_bit_equal_on_every_host_path(depth_norm):
    """The streamed path (add_bins_to_batch on float32 and on the loader's
    uint16 depth) and the device cache's (`_BinnedView`, from each sample's
    float32 depth) give the JAX package's bins; pixels exactly on an edge
    included; the torch bucketize agrees with numpy's."""
    max_depth = 12.0 if depth_norm else 30.0
    edges = bins.compute_bin_edges(128, 0.1, max_depth, "sid")[0]
    rng = np.random.default_rng(5)
    meters = rng.uniform(-1.0, max_depth + 2.0, size=(3, 16, 16)).astype(np.float32)
    meters.flat[:20] = edges[:20]
    depth = (meters / max_depth if depth_norm else meters)[..., None]
    compact = np.round(np.clip(depth, 0, 1 if depth_norm else max_depth)
                       * (65535.0 / (1 if depth_norm else max_depth))).astype(np.uint16)
    for d in (depth, compact):
        got = bins.add_bins_to_batch({"depth": d}, edges, max_depth, depth_norm)["bins"]
        want = jbins.add_bins_to_batch({"depth": d}, edges, max_depth, depth_norm)["bins"]
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(bins.depth_to_bins_np(meters, edges),
                                  jbins.depth_to_bins_np(meters, edges))
    np.testing.assert_array_equal(
        bins.depth_to_bins(torch.from_numpy(meters), torch.from_numpy(edges)).numpy(),
        np.asarray(jbins.depth_to_bins(jnp.asarray(meters), jnp.asarray(edges))))

    class One:
        def __len__(self):
            return 1

        def sample(self, i):
            return {"depth": depth[i]}

    cfg = load_config("batvisionv1" if depth_norm else "batvisionv2", "train")
    view = train_cli._BinnedView(One(), edges, cfg)
    want = jbins.depth_to_bins_np(depth[0, ..., 0] * (max_depth if depth_norm else 1.0), edges)
    np.testing.assert_array_equal(view.sample(0)["bins"], want)


# ---------------------------------------------------------------------------
# gradients and trajectories
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model_type", TYPES)
def test_loss_fn_gradients_match_jax_f64(model_type, f64_ce):
    """Each type's loss: unet soft CE, lite focal, hybrid hard CE with the
    task's label smoothing, dual_reg the two regressions."""
    variables = _variables(model_type)
    want_loss, want_aux, jgrads = _jax_reference(model_type)[3:]
    _, task = _port(model_type, LOSS_EXTRA.get(model_type, ()))
    assert task.ce_mode == ("focal" if model_type == "lite" else "soft_ce")
    value, aux = task.loss_fn(torch_batch(_batches()[0]), 0.0)
    value.backward()
    assert set(aux) == set(want_aux)
    np.testing.assert_allclose(value.item(), float(want_loss), rtol=1e-10)
    for k in want_aux:
        np.testing.assert_allclose(aux[k].item(), float(want_aux[k]), rtol=1e-10, err_msg=k)
    got = {n: p.grad for n, p in task.model.named_parameters()}
    want = _sd({"params": jgrads, "batch_stats": variables["batch_stats"]}, model_type)
    assert all(g is not None and float(g.abs().max()) > 0 for g in got.values())
    assert_close_rel(got, want, 1e-8, "gradient", keys=list(got))


@pytest.mark.parametrize("model_type", ["unet", "hybrid"])
def test_trajectory_matches_jax_f64(model_type, f64_ce):
    """Three AdamW + clip steps of both engines from the same variables,
    free-running: the losses, grad norms, parameters and BatchNorm
    statistics agree at 2e-6 after every step."""
    jcfg, jtask = _jtask(model_type)
    variables = _variables(model_type)
    cfg, task = _port(model_type)
    assert cfg.mode.optimizer == "AdamW" and cfg.mode.grad_clip_norm == 1.0
    jeng = JaxEngine(jcfg, jtask)
    jstate = jax_state(jeng, variables)
    eng = Engine(cfg, task)
    state = eng.init_state()
    keys = [n for n, _ in state.model.named_parameters()]
    start = {k: v.clone() for k, v in state.model.state_dict().items()}
    for batch in _batches():
        jstate, jm = jeng.train_step(jstate, batch)
        state, m = eng.train_step(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=2e-6)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=2e-6)
        want = _sd({"params": jstate.params, "batch_stats": jstate.batch_stats}, model_type)
        got = state.model.state_dict()
        assert_close_rel(got, want, 2e-6, "parameter", keys=keys)
    for stat in ("running_mean", "running_var"):
        assert_close_rel(got, want, 2e-6, stat, keys=[k for k in want if k.endswith(stat)])
    assert all(not torch.equal(got[k], start[k]) for k in keys)


# ---------------------------------------------------------------------------
# evaluation, checkpoints and the bins they carry
# ---------------------------------------------------------------------------

def test_evaluate_ragged_matches_jax(f64):
    """float32 metrics of the hybrid's final depth (no criterion: the coarse
    task defines none, as in the JAX package)."""
    jcfg, jtask = _jtask("hybrid")
    variables = _variables("hybrid")
    full, second = _batches()[:2]
    tail = {k: np.concatenate([v[:1], v[:1]]) for k, v in second.items()}
    tail["_valid"] = np.array([1, 0], np.int32)
    jeng = JaxEngine(jcfg, jtask)
    want = jeng.evaluate(jax_state(jeng, variables), [full, tail])
    cfg, task = _port("hybrid")
    got = Engine(cfg, task).evaluate(None, [full, tail])
    assert set(got) == set(want) == set(METRIC_NAMES) | {"loss"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("dataset", ["batvisionv2", "batvisionv1"])
def test_checkpoint_aux_equals_jax(dataset):
    """The bins a checkpoint carries (normalized centers on BV1's
    depth_norm); restore_aux adopts them and refuses another bin count."""
    ov = {"model.n_bins": 16, "model.bin_strategy": "log", "model.extra.sid_alpha": 0.5}
    want = jax_make_task(jax_load_config(dataset, "train", model_name="coarse_depth",
                                         overrides=ov)).checkpoint_aux()
    task = make_task(load_config(dataset, "train", model_name="coarse_depth",
                                 overrides=dict(ov, **{"model.base_channels": 4})), device="cpu")
    got = task.checkpoint_aux()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert task.pred_is_normalized == (dataset == "batvisionv1")
    linear = bins.compute_bin_edges(16, 0.1, task.max_depth, "linear")
    task.restore_aux({"bin_edges": linear[0], "bin_centers": linear[1]})
    np.testing.assert_array_equal(task.model.bin_centers.numpy(), linear[1])
    with pytest.raises(ValueError, match="--n_bins"):
        task.restore_aux({"bin_centers": np.zeros(8, np.float32)})


_CLI_SMALL = ["--device", "cpu", "--dataset", "synthetic", "--model", "coarse_depth",
              "--base_channels", "4", "--n_bins", "8", "--override", "dataset.images_size=32",
              "--batch_size", "2"]


def _linear_task(model_type="unet"):
    cfg = load_config("synthetic", "train", model_name="coarse_depth", overrides={
        "model.model_type": model_type, "model.base_channels": 4, "model.n_bins": 8,
        "dataset.images_size": 32, "model.bin_strategy": "linear"})
    return make_task(cfg, device="cpu")


def test_linear_checkpoint_evaluates_and_serves_on_its_bins(tmp_path):
    """A checkpoint trained with --bin_strategy linear, evaluated and served
    under the default sid config, soft-bins over its linear centers: the
    evaluate CLI's means equal a linear task's, not a sid one's."""
    ck = tmp_path / "ck"
    eng, _ = train_cli.main(_CLI_SMALL + [
        "--bin_strategy", "linear", "--num_samples", "4", "--epochs", "1",
        "--validation_iter", "1", "--ckpt_dir", str(ck)])
    assert eng.task.bin_mode == "linear"
    exp_dir = ck / next(p.name for p in ck.iterdir())
    sd = torch.load(exp_dir / "checkpoint_1.pth", weights_only=True)["state_dict"]
    ev = ["--device", "cpu", "--dataset", "synthetic", "--model", "coarse_depth",
          "--base_channels", "4", "--n_bins", "8", "--override", "dataset.images_size=32",
          "--checkpoint_path", str(exp_dir), "--use_best", "--eval_on", "val",
          "--stat_dir", str(tmp_path / "eval"), "--batch_size", "16"]
    means = evaluate_cli.main(ev)
    results = {}
    for mode in ("linear", "sid"):
        task = _linear_task() if mode == "linear" else make_task(
            load_config("synthetic", "test", model_name="coarse_depth", overrides={
                "model.base_channels": 4, "model.n_bins": 8, "dataset.images_size": 32}),
            device="cpu")
        task.model.load_state_dict(sd, strict=True)
        cfg = task.cfg
        results[mode] = Engine(cfg, task).evaluate(None, make_dataset(cfg, "val").batches(
            16, shuffle=False, drop_last=False))
    for k in means:
        np.testing.assert_allclose(means[k], results["linear"][k], rtol=1e-6, err_msg=k)
    assert abs(means["rmse"] - results["sid"]["rmse"]) > 1e-3 * means["rmse"]
    args = serve_cli.build_parser().parse_args([
        "--device", "cpu", "--model", "coarse_depth", "--base_channels", "4", "--n_bins", "8",
        "--checkpoint_path", str(exp_dir), "--use_best"])
    _, served, _ = serve_cli.load_serving_state(args)
    want = _linear_task().bin_centers
    np.testing.assert_array_equal(served.bin_centers, want)
    np.testing.assert_array_equal(served.model.bin_centers.numpy(), want)


def test_torch_wrapper_bins_reach_serve_evaluate_and_warm_start(tmp_path):
    """A reference wrapper {state_dict, bin_centers, bin_edges, epoch}: serve,
    evaluate (--torch_checkpoint) and train (--init_from_torch) adopt its
    bins, and the hybrid's served depth is the linear task's."""
    lin = _linear_task("hybrid")
    init_weights(lin.model, torch.Generator().manual_seed(3))
    path = tmp_path / "ref.pth"
    torch.save({"state_dict": lin.model.state_dict(), "epoch": 2,
                "bin_centers": torch.from_numpy(lin.bin_centers),
                "bin_edges": torch.from_numpy(lin.bin_edges)}, path)
    shape = ["--model", "coarse_depth", "--model_type", "hybrid", "--base_channels", "4",
             "--n_bins", "8"]
    args = serve_cli.build_parser().parse_args(
        ["--device", "cpu", "--torch_checkpoint", str(path)] + shape)
    _, served, _ = serve_cli.load_serving_state(args)
    np.testing.assert_array_equal(served.bin_centers, lin.bin_centers)
    np.testing.assert_array_equal(served.bin_edges, lin.bin_edges)
    wave = torch.from_numpy(np.random.default_rng(6).normal(0, 0.05, (1, 2, 7782))
                            .astype(np.float32))
    # serve runs at the preset's 256²: compare with the linear weights there
    lin256 = make_task(load_config("synthetic", "test", model_name="coarse_depth", overrides={
        "model.model_type": "hybrid", "model.base_channels": 4, "model.n_bins": 8,
        "model.bin_strategy": "linear"}), device="cpu")
    lin256.model.load_state_dict(lin.model.state_dict(), strict=True)
    torch.testing.assert_close(served.predict_meters({"waveform": wave}),
                               lin256.predict_meters({"waveform": wave}), rtol=0, atol=0)
    means = evaluate_cli.main(["--device", "cpu", "--dataset", "synthetic", *shape,
                               "--override", "dataset.images_size=32", "--torch_checkpoint",
                               str(path), "--eval_on", "val", "--batch_size", "32",
                               "--stat_dir", str(tmp_path / "eval")])
    want = Engine(lin.cfg, lin).evaluate(None, make_dataset(lin.cfg, "val").batches(
        32, shuffle=False, drop_last=False))
    for k in means:
        np.testing.assert_allclose(means[k], want[k], rtol=1e-6, err_msg=k)
    eng, state = train_cli.main(_CLI_SMALL + ["--model_type", "hybrid", "--init_from_torch",
                                              str(path), "--num_samples", "2", "--epochs", "3",
                                              "--validation", "false"])
    assert [r["epoch"] for r in eng.history] == [3] and state.step == 1
    np.testing.assert_array_equal(eng.task.bin_centers, lin.bin_centers)


def test_codec_cache_and_prefetch_carry_bins_and_original_depth():
    rng = np.random.default_rng(8)
    batch = {"waveform": rng.normal(0, 0.1, (2, 2, 100)).astype(np.float32),
             "depth": rng.uniform(0, 30, (2, 8, 8, 1)).astype(np.float32),
             "original_depth": rng.uniform(0, 30, (2, 8, 8, 1)).astype(np.float32),
             "bins": rng.integers(0, 128, (2, 8, 8)).astype(np.int32)}
    enc = encode_batch(batch, 30.0)
    assert enc["bins"] is batch["bins"] and enc["original_depth"].dtype == np.uint16
    dec = decode_batch({k: torch.from_numpy(v) for k, v in enc.items()}, 30.0)
    np.testing.assert_array_equal(dec["bins"].numpy(), batch["bins"])
    np.testing.assert_allclose(dec["original_depth"].numpy(), batch["original_depth"],
                               atol=30.0 / 65535)

    class Split:
        def __len__(self):
            return 2

        def sample(self, i):
            return {k: v[i] for k, v in batch.items()}

    cache = DeviceDatasetCache(Split(), 30.0, "cpu")
    got = cache.batch([1, 0])
    assert got["bins"].dtype == torch.int32
    np.testing.assert_array_equal(got["bins"].numpy(), batch["bins"][[1, 0]])
    np.testing.assert_array_equal(got["original_depth"].numpy(), enc["original_depth"][[1, 0]])
    (streamed,) = device_prefetch([batch], "cpu", encode_units=30.0)
    np.testing.assert_array_equal(streamed["bins"].numpy(), batch["bins"])
    np.testing.assert_array_equal(streamed["original_depth"].numpy(), enc["original_depth"])


@pytest.mark.parametrize("flags", [
    ["--use_silog", "false", "--audio_format", "spectrogram", "--max_depth", "12.5"],
    ["--use_silog", "true", "--model", "coarse_depth", "--model_type", "lite",
     "--bin_strategy", "log", "--sid_alpha", "0.5", "--ce_weight", "2", "--use_focal",
     "--regression_weight", "0.25", "--offset_reg_weight", "0.2", "--coarse_weight", "0.3",
     "--final_weight", "0.4", "--soft_ce_sigma", "1.5", "--n_bins", "64"],
    ["--model", "coarse_depth", "--model_type", "dual_reg", "--max_depth", "20",
     "--override", "model.extra.depth_min=0.2"],
])
def test_cli_config_matches_jax_cli(flags):
    from audiodepth_tpu.cli import train as jax_train_cli

    want = jax_train_cli.config_from_args(jax_train_cli.build_parser().parse_args(flags))
    got = train_cli.config_from_args(train_cli.build_parser().parse_args(flags))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ---------------------------------------------------------------------------
# the legacy blocks
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _legacy(name):
    from audiodepth_tpu.models import legacy as jlegacy

    x = np.random.default_rng(9).normal(size=(4, 8) if name == "FCBlock" else (2, 8, 8, 3))
    flax_block = getattr(jlegacy, name)(6, train=True, dtype=jnp.float64)
    jax.config.update("jax_enable_x64", True)
    try:
        variables = randomize(shapes(flax_block.init, jnp.zeros(x.shape)), 7)
        out = {}
        for train in (False, True):
            block = getattr(jlegacy, name)(6, train=train, dtype=jnp.float64)
            y, upd = block.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
            out[train] = (np.asarray(y), to_np(upd["batch_stats"]))
    finally:
        jax.config.update("jax_enable_x64", False)
    return x, variables, out


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", ["EncodeBlock", "FCBlock", "DecodeBlock"])
def test_legacy_blocks_match_flax_f64(name, train):
    x, variables, out = _legacy(name)
    want, stats = out[train]

    def state_dict(batch_stats):
        b = _Exporter(variables["params"], batch_stats)
        {"EncodeBlock": b.conv, "FCBlock": b.dense,
         "DecodeBlock": b.convT}[name]({"EncodeBlock": "Conv_0", "FCBlock": "Dense_0",
                                        "DecodeBlock": "ConvTranspose_0"}[name], "0")
        b.bn("BatchNorm_0/BatchNorm_0", "1")
        return b.finish()

    block = getattr(legacy, name)(x.shape[-1], 6, dtype=torch.float64).double()
    block.load_state_dict(state_dict(variables["batch_stats"]), strict=True)
    block.train(train)
    xt = torch.from_numpy(x) if name == "FCBlock" else nchw(x)
    with torch.no_grad():
        y = block(xt)
    got = y.numpy() if name == "FCBlock" else nhwc(y)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
    want_sd = state_dict(stats)
    keys = ["1.running_mean", "1.running_var"]
    assert_close_rel(block.state_dict(), want_sd, 1e-10, "running statistic", keys=keys)
