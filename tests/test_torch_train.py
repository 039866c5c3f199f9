"""The port's training slice against the JAX package, on the CPU.

Each case names its tolerance and why:
  * the codec round trip and the synthetic corpus are bit-equal to JAX's
    (numpy on both sides; the decode is one cast and one multiply);
  * the criteria with and without a mask, the RGB teacher's loss and the
    adaptive curriculum's weights match JAX in f64 at 1e-12 (the same
    formulas, another summation order); the edge-aware loss at 1e-12 for
    its recon term and 1e-6 for the edge and smooth terms, which JAX and the
    port both compute on float32 Sobel maps, summed in another order;
  * `compute_errors_np` equals JAX's exactly (the same numpy code), and
    `compute_errors_batch` matches JAX's at 1e-6 (float32 on both sides,
    reductions in another order);
  * the four schedules match optax within 1e-6 relative plus 1e-6·lr
    absolute (optax evaluates in float32: near a cosine cycle's end its
    value carries an absolute error of about 2^-24·lr), and clipping at norms just under and just over 1 matches
    `optax.clip_by_global_norm` in f64 at 1e-12;
  * BatchNorm folds its running statistics in bf16, f32 and f64 compute
    (the fold was lost in f64 before), and equals JAX's BatchNorm in f64 at
    1e-12; remat changes neither the running statistics nor the gradients;
  * the f64 loss and gradients of `BinauralAttentionTask.loss_fn` match
    `jax.grad` of the JAX task at 1e-10 and 1e-8 for `standard` and
    `adaptive` at epoch 0, and at 1e-6 for `edge_aware`, whose edge and
    smooth terms run on float32 Sobel maps on both sides (each gradient
    relative to max(its own max, 1e-3 of the largest), as
    tests/test_trajectory_parity.py:76-98 measures);
  * a 3-step `Engine.train_step` trajectory in f64 (γ = 0.7, remat on,
    clipping on every step) matches the JAX engine. With SGD, whose update
    is linear in the gradient, losses and parameters agree at 1e-8
    (parameters measured as above). With AdamW, the default, at 1e-6
    (losses) and 1e-5 (parameters): Adam divides
    each gradient element by its running RMS, so elements that are zero up
    to f64 rounding (weights of convs that feed a BatchNorm over a few
    pixels) turn rounding differences of the two frameworks into update
    differences; the update rule itself is held to optax at 1e-12 below.
    BatchNorm statistics at 1e-6 in both, measured as the parameters;
  * `Engine.evaluate` over a ragged tail padded with a `_valid` mask matches
    the JAX engine at 1e-6 (the metrics are float32 on both sides);
  * `unet_baseline` (5 downs, ngf 8, 32², f64, the JAX tests' small UNet):
    `loss_fn`'s loss and gradients match `jax.grad` of the JAX task at
    1e-10 and 1e-8, with and without depth_norm; 3-step trajectories with
    clipping on every step match the JAX engine at the binaural family's
    tolerances (SGD 1e-8, AdamW 1e-6 losses and 1e-5 parameters, BN
    statistics 1e-6), with depth_norm on (UNET_TRAJECTORY says why);
    `Engine.evaluate` over a ragged tail, its `criterion_loss` included
    (the training criterion on gt > 0 over the valid rows), at 1e-6;
  * `cli.train.main` trains two steps and validates on the CPU, and the
    flags of parts that are not ported exit naming their ROADMAP.md item
    (the real corpora, the holdout, the device cache and wandb are ported:
    tests/test_torch_corpus.py drives them; the other families and camera
    images have their own tests/test_torch_{base_residual,cvae,rgb_adabins,
    images}.py).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from audiodepth_tpu.configs import load_config as jax_load_config
from audiodepth_tpu.data import codec as jcodec
from audiodepth_tpu.data.batvision import make_dataset as jax_make_dataset
from audiodepth_tpu.losses import basic as jbasic
from audiodepth_tpu.losses import binaural as jbinaural
from audiodepth_tpu.metrics import errors as jerrors
from audiodepth_tpu.models import make_task as jax_make_task
from audiodepth_tpu.models.layers import BatchNorm as JaxBatchNorm
from audiodepth_tpu.models.unet import UNetGenerator as FlaxUNet
from audiodepth_tpu.train.engine import Engine as JaxEngine
from audiodepth_tpu.train.engine import TrainState as JaxTrainState
from audiodepth_tpu.train.optim import make_schedule as jax_make_schedule

from audiodepth_tpu_torch.cli import train as train_cli
from audiodepth_tpu_torch.configs import load_config
from audiodepth_tpu_torch.data import codec
from audiodepth_tpu_torch.data.batvision import make_dataset
from audiodepth_tpu_torch.losses import basic
from audiodepth_tpu_torch.losses import binaural
from audiodepth_tpu_torch.metrics import errors
from audiodepth_tpu_torch.models import init_weights, make_task
from audiodepth_tpu_torch.models.binaural_attention import BinauralAttentionNet
from audiodepth_tpu_torch.models.layers import BatchNorm
from audiodepth_tpu_torch.models.unet import UNetGenerator
from audiodepth_tpu_torch.tools.import_jax import (binaural_state_dict_from_jax,
                                                   unet_state_dict_from_jax)
from audiodepth_tpu_torch.train import optim
from audiodepth_tpu_torch.train.engine import Engine

# the slice's small configuration: base 8, 32², levels 2-5
SMALL = {"model.base_channels": 8, "dataset.images_size": 32}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models and tensors here are small: one intra-op thread runs them
    faster than many, and leaves the cores to the other test workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


@pytest.fixture
def f64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_codec_round_trip_matches_jax():
    rng = np.random.default_rng(0)
    wave = (rng.normal(size=(3, 2, 500)) * 0.3).astype(np.float32)
    wave[1] *= 8.0  # a sample above 1: the per-sample waveform_scale
    depth = rng.uniform(0, 31, size=(3, 8, 8, 1)).astype(np.float32)
    depth[0, 0, 0, 0], depth[0, 0, 1, 0], depth[2, 3, 3, 0] = np.nan, np.inf, 0.0
    image = rng.uniform(-0.1, 1.1, size=(3, 8, 8, 3)).astype(np.float32)
    batch = {"waveform": wave, "depth": depth, "image": image, "other": np.arange(3)}
    for units in (30.0, 1.0):
        want = jcodec.encode_batch(batch, units)
        got = codec.encode_batch(batch, units)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
        assert codec.batch_is_compact(got) and not codec.batch_is_compact(batch)
        # "other" passes through untouched (JAX would narrow it to int32)
        want_dec = jcodec.decode_batch({k: jnp.asarray(v) for k, v in want.items()
                                        if k != "other"}, units)
        got_dec = codec.decode_batch({k: torch.from_numpy(v) for k, v in got.items()
                                      if k != "other"}, units)
        assert set(got_dec) == set(want_dec) and "waveform_scale" not in got_dec
        for k in want_dec:
            w = np.asarray(want_dec[k])
            assert str(got_dec[k].dtype) == f"torch.{w.dtype}", k
            assert np.array_equal(got_dec[k].numpy(), w), k  # bit-equal


@pytest.mark.parametrize("name,units", [("synthetic", 30.0), ("batvisionv2", 30.0)])
def test_depth_units_match_jax(name, units):
    for norm in (False, True):
        cfg = load_config(name, overrides={"dataset.depth_norm": norm})
        jcfg = jax_load_config(name, overrides={"dataset.depth_norm": norm})
        assert codec.depth_storage_normalized(cfg) == jcodec.depth_storage_normalized(jcfg)
        assert codec.depth_storage_units(cfg) == jcodec.depth_storage_units(jcfg)
    # BV2 keeps meters even with depth_norm: the quirk the tasks reproduce
    bv2 = load_config("batvisionv2", overrides={"dataset.depth_norm": True})
    assert codec.depth_storage_units(bv2) == 30.0


def test_synthetic_samples_match_jax():
    overrides = {"dataset.images_size": 32}
    cfg, jcfg = load_config("synthetic", overrides=overrides), jax_load_config(
        "synthetic", overrides=overrides)
    for split in ("train", "val"):
        ds, jds = make_dataset(cfg, split, num_samples=6), jax_make_dataset(
            jcfg, split, num_samples=6)
        assert (len(ds), ds.seed, ds.length) == (len(jds), jds.seed, jds.length)
        for got, want in zip(ds.batches(4, seed=3, drop_last=False),
                             jds.batches(4, seed=3, drop_last=False)):
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    img = make_dataset(cfg, "test", with_image=True).sample(5)
    assert np.array_equal(img["image"], jax_make_dataset(jcfg, "test", with_image=True)
                          .sample(5)["image"])


def test_make_dataset_defaults_and_refusals():
    cfg = load_config("synthetic")
    assert [(len(make_dataset(cfg, s)), make_dataset(cfg, s).seed)
            for s in ("train", "val", "test")] == [(256, 0), (64, 1), (64, 2)]
    # the real corpora's loaders read the config's dataset_dir, absent
    # here, and fall back to nothing
    for name in ("batvisionv1", "batvisionv2"):
        with pytest.raises(FileNotFoundError):
            make_dataset(load_config(name, overrides={"dataset.dataset_dir": "/nonexistent"}),
                         "train")


# ---------------------------------------------------------------------------
# losses and metrics
# ---------------------------------------------------------------------------

def _pred_gt(seed=0, shape=(2, 12, 10, 1)):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0.5, 20.0, size=shape)
    gt = rng.uniform(0.5, 20.0, size=shape)
    gt[rng.uniform(size=shape) < 0.2] = 0.0  # invalid pixels
    return pred, gt


@pytest.mark.parametrize("criterion", ["L1", "L2", "SIlog", "Combined"])
@pytest.mark.parametrize("masked", [False, True])
def test_criteria_match_jax_f64(criterion, masked, f64):
    pred, gt = _pred_gt()
    kw = dict(l1_weight=0.3, silog_weight=0.6, silog_lambda=0.8)
    want = jbasic.make_criterion(criterion, **kw)(
        jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(gt != 0) if masked else None)
    got = basic.make_criterion(criterion, **kw)(
        _t(pred), _t(gt), _t(gt != 0) if masked else None)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)


def test_edge_aware_loss_matches_jax_f64(f64):
    pred, gt = _pred_gt(1)
    want_total, want = jbinaural.binaural_attention_loss(jnp.asarray(pred), jnp.asarray(gt),
                                                         1.0, 0.2, 0.1)
    got_total, got = binaural.binaural_attention_loss(_t(pred), _t(gt), 1.0, 0.2, 0.1)
    np.testing.assert_allclose(float(got["recon"]), float(want["recon"]), rtol=1e-12)
    for k in ("edge", "smooth"):
        assert float(want[k]) > 0.0
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)
    np.testing.assert_allclose(float(got_total), float(want_total), rtol=1e-6)


@pytest.mark.parametrize("epoch", [0, 19, 20, 40, 60, 61, 80, 100])
def test_adaptive_weights_match_jax(epoch, f64):
    want = jbinaural.adaptive_binaural_weights(jnp.asarray(float(epoch)))
    got = binaural.adaptive_binaural_weights(float(epoch))
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray([float(w) for w in want]), rtol=1e-12, atol=1e-15)


def test_rgb_depth_loss_matches_jax_f64(f64):
    pred, gt = _pred_gt(2)
    want_total, want = jbinaural.rgb_depth_loss(jnp.asarray(pred), jnp.asarray(gt))
    got_total, got = binaural.rgb_depth_loss(_t(pred), _t(gt))
    for k in ("l1", "smooth"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-12)
    np.testing.assert_allclose(float(got_total), float(want_total), rtol=1e-12)


def _metric_cases():
    rng = np.random.default_rng(5)
    gt = rng.uniform(0.5, 30.0, size=(4, 16, 16))
    gt[0, :4] = 0.0
    gt[3] = 0.0  # no valid pixel: the zero fallback
    pred = rng.uniform(0.01, 30.0, size=gt.shape)
    pred[1, :2] = -1.0  # clipped up to EVAL_PRED_MIN
    return gt.astype(np.float32), pred.astype(np.float32)


def test_compute_errors_batch_matches_jax():
    gt, pred = _metric_cases()
    pred = np.clip(pred, errors.EVAL_PRED_MIN, 30.0)
    assert errors.EVAL_PRED_MIN == jerrors.EVAL_PRED_MIN
    assert errors.METRIC_NAMES == jerrors.METRIC_NAMES
    want = jerrors.compute_errors_batch(jnp.asarray(gt), jnp.asarray(pred))
    got = errors.compute_errors_batch(_t(gt), _t(pred))
    for k in errors.METRIC_NAMES:
        assert got[k].shape == (4,) and got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)
    assert all(float(got[k][3]) == 0.0 for k in errors.METRIC_NAMES)
    # on the common branch the batch version equals the numpy one
    for i in range(3):
        np.testing.assert_allclose([float(got[k][i]) for k in errors.METRIC_NAMES],
                                   errors.compute_errors_np(gt[i], pred[i]), rtol=1e-5)


@pytest.mark.parametrize("case", ["common", "all_invalid", "non_positive", "tiny"])
def test_compute_errors_np_matches_jax(case):
    gt, pred = _metric_cases()
    gt, pred = gt[0].astype(np.float64), pred[0].astype(np.float64)
    if case == "all_invalid":
        gt[:] = 0.0
    elif case == "non_positive":
        pred[:] = -2.0
    elif case == "tiny":
        gt, pred = gt / 100.0, pred / 100.0
    assert errors.compute_errors_np(gt, pred) == jerrors.compute_errors_np(gt, pred)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["constant", "cosine", "step", "warm_restarts"])
def test_schedules_match_optax(kind):
    overrides = {"mode.lr_schedule": kind, "mode.epochs": 130, "mode.learning_rate": 0.002}
    mode, jmode = load_config(overrides=overrides).mode, jax_load_config(
        overrides=overrides).mode
    spe = 3
    sched, jsched = optim.make_schedule(mode, spe), jax_make_schedule(jmode, spe)
    for step in (0, 1, 59, 60, 61, 149, 150, 151, 179, 180, 181, 299, 300, 389, 390, 500):
        np.testing.assert_allclose(sched(step), float(jsched(step)), rtol=1e-6,
                                   atol=1e-6 * mode.learning_rate, err_msg=step)


@pytest.mark.parametrize("target", [0.999, 1.001, 3.0])
def test_clip_matches_optax_f64(target, f64):
    rng = np.random.default_rng(int(target * 1000))
    grads = [rng.normal(size=s) for s in ((3, 4), (5,), (2, 2, 2))]
    norm0 = np.sqrt(sum((g * g).sum() for g in grads))
    grads = [g * (target / norm0) for g in grads]
    want, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in grads], None)
    got = [_t(g) for g in grads]
    norm = optim.global_norm(got)
    np.testing.assert_allclose(float(norm), target, rtol=1e-12)
    optim.clip_by_global_norm_(got, norm, 1.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=0)
    if target < 1.0:  # under the norm: untouched
        assert all(np.array_equal(g.numpy(), h) for g, h in zip(got, grads))


def test_optimizers_follow_the_config():
    params = [torch.nn.Parameter(torch.zeros(2))]
    for name, cls in (("Adam", torch.optim.Adam), ("AdamW", torch.optim.AdamW),
                      ("SGD", torch.optim.SGD)):
        mode = load_config(overrides={"mode.optimizer": name, "mode.weight_decay": 0.05}).mode
        opt = optim.make_optimizer(params, mode)
        assert type(opt) is cls
    assert opt.param_groups[0]["momentum"] == 0.9
    assert optim.make_optimizer(params, load_config(overrides={
        "mode.weight_decay": 0.05}).mode).param_groups[0]["weight_decay"] == 0.05


# ---------------------------------------------------------------------------
# BatchNorm and remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float64])
def test_batchnorm_running_stats_move_in_every_dtype(dtype):
    x = torch.from_numpy(np.random.default_rng(0).normal(1.5, 2.0, size=(3, 4, 5, 6)))
    bn = BatchNorm(4, dtype=dtype).train()
    y = bn(x.to(dtype))
    assert y.dtype == dtype and bn.running_mean.dtype == torch.float32
    xs = x.to(dtype).to(torch.float64)
    want_mean = 0.1 * xs.mean((0, 2, 3))
    want_var = 0.9 + 0.1 * xs.var((0, 2, 3), unbiased=True)
    tol = 1e-6 if dtype != torch.bfloat16 else 1e-5
    np.testing.assert_allclose(bn.running_mean.double().numpy(), want_mean.numpy(), rtol=tol)
    np.testing.assert_allclose(bn.running_var.double().numpy(), want_var.numpy(), rtol=tol)
    # eval mode leaves them alone
    before = bn.running_mean.clone()
    bn.eval()(x.to(dtype))
    assert torch.equal(bn.running_mean, before)


def test_batchnorm_matches_jax_f64(f64):
    rng = np.random.default_rng(1)
    x = rng.normal(0.5, 1.5, size=(2, 5, 6, 3))  # NHWC
    module = JaxBatchNorm(use_running_average=False, dtype=jnp.float64)
    variables = jax.tree_util.tree_map(np.asarray, module.init(jax.random.PRNGKey(0),
                                                               jnp.asarray(x)))
    inner_p, inner_s = variables["params"]["BatchNorm_0"], variables["batch_stats"]["BatchNorm_0"]
    values = {k: rng.uniform(0.5, 1.5, size=3) for k in ("scale", "bias", "mean", "var")}
    params = {"BatchNorm_0": {"scale": values["scale"], "bias": values["bias"]}}
    stats = {"BatchNorm_0": {"mean": values["mean"], "var": values["var"]}}
    assert set(inner_p) == {"scale", "bias"} and set(inner_s) == {"mean", "var"}
    want, upd = module.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                             mutable=["batch_stats"])
    bn = BatchNorm(3, dtype=torch.float64).double().train()
    with torch.no_grad():
        bn.weight.copy_(_t(values["scale"]))
        bn.bias.copy_(_t(values["bias"]))
        bn.running_mean.copy_(_t(values["mean"]))
        bn.running_var.copy_(_t(values["var"]))
    got = bn(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-12)
    new = upd["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(new["mean"]), rtol=1e-12)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(new["var"]), rtol=1e-12)


def _binaural_step(remat, dtype=torch.float64):
    model = BinauralAttentionNet(base_channels=4, output_size=32, remat=remat, dtype=dtype)
    if dtype == torch.float64:
        model = model.double()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    x = torch.randn(2, 2, 32, 32, generator=gen, dtype=torch.float64)
    model.train()
    model(x).square().mean().backward()
    return model


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_remat_keeps_stats_and_gradients(dtype):
    on, off = _binaural_step(True, dtype), _binaural_step(False, dtype)
    assert on.left_encoder.remat and not off.left_encoder.remat
    for (name, a), b in zip(on.state_dict().items(), off.state_dict().values()):
        assert torch.equal(a, b), name  # one fold, not two
    for (name, a), b in zip(on.named_parameters(), off.parameters()):
        assert torch.equal(a.grad, b.grad), name
    moved = on.left_encoder.inc.double_conv[1].running_mean
    assert float(moved.abs().max()) > 0.0


# ---------------------------------------------------------------------------
# the task's gradients and the engine's trajectory against JAX, in f64
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_init_f64():
    """The JAX task's init at the small configuration, once per process, as
    f64 numpy arrays with every γ at 0.7 (call under x64)."""
    jcfg = jax_load_config("synthetic", "train", model_name="binaural_attention",
                           overrides=dict(SMALL, **{"mode.compute_dtype": "float64"}))
    cfg = load_config("synthetic", "train", model_name="binaural_attention", overrides=SMALL)
    batch = next(make_dataset(cfg, "train", num_samples=2).batches(2, shuffle=False))
    variables = jax.jit(jax_make_task(jcfg).init)(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()})
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
    for lv in (2, 3, 4, 5):
        variables["params"][f"attn_{lv}"]["gamma"] = np.full((1,), 0.7)
    return variables


def _f64_pair(extra=None, batch_size=2):
    """(JAX config and task, the f64 variables of its init, port config and
    task on the CPU holding them, numpy train batches): base 8, 32², levels
    2-5, γ = 0.7, remat on in the port. The JAX side runs without remat,
    which compiles faster and computes the same values."""
    overrides = dict(SMALL, **{"mode.compute_dtype": "float64"}, **(extra or {}))
    jcfg = jax_load_config("synthetic", "train", model_name="binaural_attention",
                           overrides=dict(overrides, **{"model.extra.remat": False}))
    cfg = load_config("synthetic", "train", model_name="binaural_attention",
                      overrides=overrides)
    batches = list(make_dataset(cfg, "train", num_samples=3 * batch_size)
                   .batches(batch_size, shuffle=False))
    variables = _jax_init_f64()
    task = make_task(cfg, device="cpu")
    task.model.double()
    task.model.load_state_dict(binaural_state_dict_from_jax(
        variables["params"], variables["batch_stats"]), strict=True)
    return jcfg, jax_make_task(jcfg), variables, cfg, task, batches


def _jax_state(jeng, variables):
    """The JAX engine's TrainState at `variables`, without its init."""
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                            variables["batch_stats"]),
                         opt_state=jeng.tx.init(params))


def _assert_close_rel(got, want, tol, what, keys=None):
    """Key by key, relative to each tensor's own max floored at 1e-3 of the
    largest max (tests/test_trajectory_parity.py:76-98)."""
    keys = keys or list(want)
    gmax = max(float(np.abs(np.asarray(got[k])).max()) for k in keys)
    worst, worst_key = 0.0, None
    for k in keys:
        a, b = np.asarray(want[k], np.float64), np.asarray(got[k], np.float64)
        rel = float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-3 * gmax, 1e-12)
        if rel > worst:
            worst, worst_key = rel, k
    assert worst < tol, f"worst {what} mismatch {worst:.2e} at {worst_key}"
    return worst


@pytest.mark.parametrize("loss_type,loss_tol,tol", [
    ("standard", 1e-10, 1e-8), ("adaptive", 1e-10, 1e-8), ("edge_aware", 1e-6, 1e-6)])
def test_loss_fn_gradients_match_jax_f64(loss_type, loss_tol, tol, f64):
    jcfg, jtask, variables, cfg, task, batches = _f64_pair({"model.extra.loss_type": loss_type})
    batch = batches[0]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(params):
        loss, (_, aux) = jtask.loss_fn(params, variables["batch_stats"], jbatch,
                                       jax.random.PRNGKey(1), jnp.float64(0.0))
        return loss, aux

    (want_loss, want_aux), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])
    loss, aux = task.loss_fn({k: torch.from_numpy(v) for k, v in batch.items()}, 0.0)
    loss.backward()
    assert set(aux) == set(want_aux)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=loss_tol)
    want = binaural_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads),
                                        variables["batch_stats"])
    got = {n: p.grad for n, p in task.model.named_parameters()}
    assert all(float(g.abs().max()) > 0 for n, g in got.items() if ".query." in n)
    _assert_close_rel(got, want, tol, f"{loss_type} gradient", keys=list(got))


@pytest.mark.parametrize("optimizer,loss_tol,param_tol", [("SGD", 1e-8, 1e-8),
                                                          ("AdamW", 1e-6, 1e-5)])
def test_train_step_trajectory_matches_jax_f64(optimizer, loss_tol, param_tol, f64):
    jcfg, jtask, variables, cfg, task, batches = _f64_pair({"mode.optimizer": optimizer})
    assert cfg.mode.grad_clip_norm == 1.0 and task.model.left_encoder.remat
    jeng = JaxEngine(jcfg, jtask)
    jstate = _jax_state(jeng, variables)
    eng = Engine(cfg, task)
    state = eng.init_state()
    for batch in batches:
        jstate, jmetrics = jeng.train_step(jstate, batch, epoch=0.0)
        state, metrics = eng.train_step(state, batch, epoch=0.0)
        np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]),
                                   rtol=loss_tol)
        assert float(metrics["grad_norm"]) > 1.0  # every step clips
        np.testing.assert_allclose(float(metrics["grad_norm"]), float(jmetrics["grad_norm"]),
                                   rtol=1e-6)  # JAX reports its norm in float32
    assert state.step == 3
    want = binaural_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params),
                                        jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
    got = state.model.state_dict()
    params_keys = [n for n, _ in state.model.named_parameters()]
    _assert_close_rel(got, want, param_tol, "parameter", keys=params_keys)
    for stat in ("running_mean", "running_var"):
        _assert_close_rel(got, want, 1e-6, stat, keys=[k for k in want if k.endswith(stat)])
    start = binaural_state_dict_from_jax(variables["params"], variables["batch_stats"])
    assert all(not np.array_equal(got[k].numpy(), start[k].numpy()) for k in params_keys
               if ".gamma" in k or ".weight" in k)


@pytest.mark.parametrize("name", ["Adam", "AdamW"])
def test_adam_update_matches_optax_f64(name, f64):
    """The update rule alone: 4 steps of the port's optimizer (per-step
    cosine lr, clipping) against optax's chain on the same gradients."""
    from audiodepth_tpu.train.optim import make_optimizer as jax_make_optimizer

    overrides = {"mode.optimizer": name, "mode.lr_schedule": "cosine", "mode.epochs": 4,
                 "mode.weight_decay": 0.05}
    mode, jmode = load_config(overrides=overrides).mode, jax_load_config(
        overrides=overrides).mode
    rng = np.random.default_rng(7)
    p0 = [rng.normal(size=s) for s in ((4, 3), (5,))]
    tx = jax_make_optimizer(jmode, steps_per_epoch=1)
    jparams = [jnp.asarray(p) for p in p0]
    jopt = tx.init(jparams)
    params = [torch.nn.Parameter(_t(p)) for p in p0]
    opt, sched = optim.make_optimizer(params, mode), optim.make_schedule(mode, 1)
    for step in range(4):
        grads = [rng.normal(size=p.shape) * (0.3 if step % 2 else 3.0) for p in p0]
        updates, jopt = tx.update([jnp.asarray(g) for g in grads], jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(params, grads):
            p.grad = _t(g)
        gs = [p.grad for p in params]
        optim.clip_by_global_norm_(gs, optim.global_norm(gs), mode.grad_clip_norm)
        for group in opt.param_groups:
            group["lr"] = sched(step)
        opt.step()
    for p, w in zip(params, jparams):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=1e-12, atol=1e-15)


def test_evaluate_ragged_valid_matches_jax(f64):
    jcfg, jtask, variables, cfg, task, batches = _f64_pair()
    full = batches[0]
    tail = {k: np.concatenate([v[:1], v[:1]]) for k, v in batches[1].items()}  # pad row = row 0
    tail["_valid"] = np.array([1, 0], np.int32)
    jeng = JaxEngine(jcfg, jtask)
    want = jeng.evaluate(_jax_state(jeng, variables), [full, tail])
    eng = Engine(cfg, task)
    got = eng.evaluate(eng.init_state(), [full, tail])
    assert set(got) == set(want) == set(errors.METRIC_NAMES) | {"loss"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    # the pad row is excluded: three samples, not four
    one = eng.evaluate(eng.init_state(), [{k: v[:1] for k, v in batches[1].items()}])
    two = eng.evaluate(eng.init_state(), [full])
    np.testing.assert_allclose(got["mae"], (2 * two["mae"] + one["mae"]) / 3, rtol=1e-9)


def test_train_step_refuses_padded_batches():
    cfg = load_config("synthetic", "train", model_name="binaural_attention", overrides=SMALL)
    eng = Engine(cfg, make_task(cfg, device="cpu"))
    batch = next(make_dataset(cfg, "train", num_samples=2).batches(2))
    with pytest.raises(ValueError, match="_valid"):
        eng.train_step(eng.init_state(), dict(batch, _valid=np.ones(2, np.int32)))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

_CPU_ARGS = ["--device", "cpu", "--dataset", "synthetic", "--model", "binaural_attention",
             "--base_channels", "8", "--override", "dataset.images_size=32"]


def test_cli_trains_two_steps_and_validates(capsys):
    eng, state = train_cli.main(_CPU_ARGS + [
        "--num_samples", "4", "--batch_size", "2", "--epochs", "1", "--validation_iter", "1",
        "--learning_rate", "0.001", "--loss_type", "edge_aware", "--seed", "3"])
    assert state.step == 2 and eng.cfg.mode.seed == 3
    assert eng.cfg.model.extra["loss_type"] == "edge_aware"
    (record,) = eng.history
    assert record["steps"] == 2 and record["samples"] == 4 and record["lr"] == 0.001
    assert {"loss", "recon", "edge", "smooth", "grad_norm", "pairs_per_sec"} <= set(record)
    assert set(record["val"]) == set(errors.METRIC_NAMES) | {"loss"}
    assert np.isfinite(record["loss"]) and np.isfinite(record["val"]["rmse"])
    assert '"epoch": 1' in capsys.readouterr().out


def test_cli_config_from_flags():
    args = train_cli.build_parser().parse_args(_CPU_ARGS + [
        "--l1_weight", "0.5", "--no-remat", "--attention_levels", "3,4", "--lr_schedule",
        "cosine", "--override", "model.extra.lambda_edge=0.3"])
    cfg = train_cli.config_from_args(args)
    assert cfg.mode.criterion == "Combined" and cfg.mode.l1_weight == 0.5
    assert cfg.model.extra["remat"] is False and cfg.model.extra["lambda_edge"] == 0.3
    assert cfg.model.attention_levels == (3, 4) and cfg.mode.lr_schedule == "cosine"
    assert cfg.dataset.images_size == 32


@pytest.mark.parametrize("flags,item", [
    (["--num_devices", "8"], "A8"), (["--num_devices", "2"], "A8"),
    (["--num_devices", "4"], "A8"),
])
def test_cli_refuses_unported_flags(flags, item):
    with pytest.raises(SystemExit, match=f"ROADMAP.md {item}"):
        train_cli.main(_CPU_ARGS + flags)


# ---------------------------------------------------------------------------
# unet_baseline (the main training path) against the JAX task and engine
# ---------------------------------------------------------------------------

UNET_SMALL = {"dataset.images_size": 32, "mode.compute_dtype": "float64"}


def _unet_pair(extra=None, batch_size=2):
    """(JAX config and task, f64 variables, port config and task on the CPU
    holding them, numpy train batches): both tasks carry the JAX tests'
    small UNet (5 downs, ngf 8) at 32², seeded by the port's init (the
    reference's normal(0, 0.02)) and carried to flax by the JAX package's
    importer."""
    from audiodepth_tpu.tools.import_torch import import_unet

    overrides = dict(UNET_SMALL, **(extra or {}))
    jcfg = jax_load_config("synthetic", "train", model_name="unet_baseline", overrides=overrides)
    cfg = load_config("synthetic", "train", model_name="unet_baseline", overrides=overrides)
    batches = list(make_dataset(cfg, "train", num_samples=3 * batch_size)
                   .batches(batch_size, shuffle=False))
    depth_norm = cfg.dataset.depth_norm
    task = make_task(cfg, device="cpu")
    task.model = UNetGenerator(input_nc=2, output_nc=1, num_downs=5, ngf=8,
                               depth_norm=depth_norm, dtype=torch.float64).double()
    init_weights(task.model, torch.Generator().manual_seed(0))
    variables = import_unet({k: v.numpy() for k, v in task.model.state_dict().items()},
                            num_downs=5)
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
    jtask = jax_make_task(jcfg)
    jtask.model = FlaxUNet(input_nc=2, output_nc=1, num_downs=5, ngf=8, depth_norm=depth_norm,
                           dtype=jnp.float64)
    return jcfg, jtask, variables, cfg, task, batches


def _unet_sd(tree, stats):
    return unet_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                                    jax.tree_util.tree_map(np.asarray, stats), num_downs=5)


@pytest.mark.parametrize("depth_norm", [False, True])
def test_unet_loss_fn_gradients_match_jax_f64(depth_norm, f64):
    jcfg, jtask, variables, cfg, task, batches = _unet_pair(
        {"dataset.depth_norm": depth_norm})
    batch = batches[0]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(params):
        loss, (_, aux) = jtask.loss_fn(params, variables["batch_stats"], jbatch,
                                       jax.random.PRNGKey(1), jnp.float64(0.0))
        return loss, aux

    (want_loss, want_aux), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])
    loss, aux = task.loss_fn({k: torch.from_numpy(v) for k, v in batch.items()}, 0.0)
    loss.backward()
    assert set(aux) == set(want_aux) == {"loss"}
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-10)
    want = _unet_sd(jgrads, variables["batch_stats"])
    got = {n: p.grad for n, p in task.model.named_parameters()}
    assert all(float(g.abs().max()) > 0 for g in got.values())
    _assert_close_rel(got, want, 1e-8, "unet gradient", keys=list(got))


# The trajectories run with depth_norm on (the sigmoid head), as the JAX
# package's own UNet trajectory test does: with it off, the untrained net's
# outputs sit near zero, at the SIlog's clamp, where the loss's gradient is
# discontinuous, and a 1e-13 relative perturbation of the port's own init
# moves its 3-step parameters by 5e-5; no comparison at 1e-8 means anything
# there. The clip threshold is lowered to 0.25 so that every step clips
# (the gradient norms of this small net are 0.5-1.1).
UNET_TRAJECTORY = {"dataset.depth_norm": True, "mode.grad_clip_norm": 0.25}


@pytest.mark.parametrize("optimizer,loss_tol,param_tol", [("SGD", 1e-8, 1e-8),
                                                          ("AdamW", 1e-6, 1e-5)])
def test_unet_train_step_trajectory_matches_jax_f64(optimizer, loss_tol, param_tol, f64):
    jcfg, jtask, variables, cfg, task, batches = _unet_pair(
        dict(UNET_TRAJECTORY, **{"mode.optimizer": optimizer}))
    assert cfg.mode.weight_decay == 0.01
    jeng = JaxEngine(jcfg, jtask)
    jstate = _jax_state(jeng, variables)
    eng = Engine(cfg, task)
    state = eng.init_state()
    for batch in batches:
        jstate, jmetrics = jeng.train_step(jstate, batch, epoch=0.0)
        state, metrics = eng.train_step(state, batch, epoch=0.0)
        np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]),
                                   rtol=loss_tol)
        assert float(metrics["grad_norm"]) > cfg.mode.grad_clip_norm  # every step clips
        np.testing.assert_allclose(float(metrics["grad_norm"]), float(jmetrics["grad_norm"]),
                                   rtol=1e-6)  # JAX reports its norm in float32
    assert state.step == 3
    want = _unet_sd(jstate.params, jstate.batch_stats)
    got = state.model.state_dict()
    params_keys = [n for n, _ in state.model.named_parameters()]
    _assert_close_rel(got, want, param_tol, "unet parameter", keys=params_keys)
    for stat in ("running_mean", "running_var"):
        _assert_close_rel(got, want, 1e-6, stat, keys=[k for k in want if k.endswith(stat)])
    start = _unet_sd(variables["params"], variables["batch_stats"])
    assert all(not np.array_equal(got[k].numpy(), start[k].numpy()) for k in params_keys)


@pytest.mark.parametrize("depth_norm", [False, True])
def test_unet_evaluate_criterion_loss_ragged_matches_jax(depth_norm, f64):
    jcfg, jtask, variables, cfg, task, batches = _unet_pair({"dataset.depth_norm": depth_norm})
    full = batches[0]
    tail = {k: np.concatenate([v[:1], v[:1]]) for k, v in batches[1].items()}  # pad row = row 0
    tail["_valid"] = np.array([1, 0], np.int32)
    jeng = JaxEngine(jcfg, jtask)
    want = jeng.evaluate(_jax_state(jeng, variables), [full, tail])
    eng = Engine(cfg, task)
    got = eng.evaluate(eng.init_state(), [full, tail])
    assert set(got) == set(want) == set(errors.METRIC_NAMES) | {"loss", "criterion_loss"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    # the pad row is excluded from the criterion: the tail's criterion is its one row's
    one = eng.evaluate(eng.init_state(), [{k: v[:1] for k, v in batches[1].items()}])
    two = eng.evaluate(eng.init_state(), [full])
    np.testing.assert_allclose(got["criterion_loss"],
                               (two["criterion_loss"] + one["criterion_loss"]) / 2, rtol=1e-12)


def test_unet_eval_batch_runs_one_forward():
    """The metrics and the criterion share one forward, so an eval batch
    runs the front end once (chip_smoke.py counts B1 launches by it)."""
    cfg = load_config("synthetic", "train", model_name="unet_baseline",
                      overrides={"dataset.images_size": 32, "mode.compute_dtype": "float32"})
    task = make_task(cfg, device="cpu")
    task.model = UNetGenerator(input_nc=2, output_nc=1, num_downs=5, ngf=4, depth_norm=False)
    calls = []
    frontend = task._frontend
    task._frontend = lambda wave: calls.append(1) or frontend(wave)
    batch = next(make_dataset(cfg, "val").batches(2, shuffle=False))
    out = Engine(cfg, task).eval_step(None, batch)
    assert len(calls) == 1 and "_batch_criterion_loss" in out


def test_cli_trains_unet_two_steps_and_validates(capsys):
    eng, state = train_cli.main([
        "--device", "cpu", "--dataset", "synthetic", "--model", "unet_baseline",
        "--override", "model.generator=unet_128", "--override", "model.ngf=2",
        "--override", "dataset.images_size=128", "--num_samples", "4", "--batch_size", "2",
        "--epochs", "1", "--validation_iter", "1"])
    assert state.step == 2 and eng.task.name == "unet_baseline"
    (record,) = eng.history
    assert np.isfinite(record["loss"]) and np.isfinite(record["grad_norm"])
    assert set(record["val"]) == set(errors.METRIC_NAMES) | {"loss", "criterion_loss"}
    assert '"start_epoch": 1' in capsys.readouterr().out
