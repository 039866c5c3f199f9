"""The port's rgb_depth and adabins_distillation families against the JAX
package, on the CPU.

rgb_depth (the teacher UNet, camera image in):
  * `rgb_depth_state_dict_from_jax` equals `export_for_config` key for key
    and loads with strict=True; 17,262,977 parameters at base 64;
  * the forward in eval and train mode matches flax in f64 at 1e-10 (base
    4, 32²), also when output_size differs from the input's (the head is
    resized with `jax.image.resize`'s antialiased "linear");
  * `loss_fn`'s loss and gradients match `jax.grad` at 1e-10 and 1e-8, and
    three AdamW steps of the engines (no clipping, the rgb training
    script's) agree at 2e-6;
  * `cli.train` trains two steps on the synthetic corpus's images.

adabins_distillation (twin AdaBins nets, frozen teacher):
  * `adabins_state_dict_from_jax` equals `export_for_config` key for key and
    loads with strict=True; 42,614,529 parameters at base 64, n_bins 128;
  * the forward of both branches in eval mode matches flax in f64 at 1e-10
    (base 4, n_bins 8, 32²), also when output_size differs (the logits and
    the residual resized by half-pixel "nearest", torch's nearest-exact);
    in train mode too, with the same dropout keep masks fed to both sides
    (`jax.random.bernoulli` and the port's `dropout_keep`);
  * the loss pieces (feature cosine, bin KL, the five-term loss with and
    without the teacher, the adaptive weights) match at 1e-12;
  * gradients of the five-term loss in eval mode match at 1e-8 (as the JAX
    package's own gradient test runs it), and `loss_fn` in train mode with
    fed masks and the adaptive weights at 1e-10 and 1e-8; the teacher gets
    no gradient, and the shared residual head its audio-path gradient only;
  * three AdamW steps with weight decay of the engines (fed masks, every
    step clipped) agree at 2e-6 on the student; the teacher's parameters
    are bit-unchanged (it is left out of the optimizer) while its
    BatchNorm running statistics moved and equal JAX's at 1e-10;
  * `cli.train` trains two steps on paired audio and images; 2 epochs and
    a `--resume`d third equal 3 uninterrupted epochs bit for bit (the
    dropout draws are reseeded from the step; the optimizer state holds
    the student alone);
  * `model.extra.remat`: the loss, the gradients and the running
    statistics of a train step with the student recomputed in the backward
    equal those without, bit for bit in f64 (the keep mask is drawn from
    the task's generator before the recomputed region, and BatchNorm folds
    once); the statistics after one step equal JAX's `remat=True` step at
    1e-10 and three AdamW steps agree at 2e-6.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from audiodepth_tpu.configs import load_config as jax_load_config
from audiodepth_tpu.losses import distillation as jdist
from audiodepth_tpu.models import make_task as jax_make_task
from audiodepth_tpu.models.adabins import AdaBinsDistillationModel as FlaxAdaBins
from audiodepth_tpu.models.rgb_depth import RGBDepthNet as FlaxRGB
from audiodepth_tpu.tools.import_torch import export_for_config
from audiodepth_tpu.train.engine import Engine as JaxEngine

from audiodepth_tpu_torch.cli import train as train_cli
from audiodepth_tpu_torch.configs import load_config
from audiodepth_tpu_torch.data.batvision import make_dataset
from audiodepth_tpu_torch.losses import distillation as dist
from audiodepth_tpu_torch.models import adabins, make_task
from audiodepth_tpu_torch.models.adabins import AdaBinsDistillationModel
from audiodepth_tpu_torch.models.rgb_depth import RGBDepthNet
from audiodepth_tpu_torch.tools.import_jax import (adabins_state_dict_from_jax,
                                                   rgb_depth_state_dict_from_jax)
from audiodepth_tpu_torch.train.engine import Engine

from tests.torch_parity import (assert_close_rel, f64, jax_state, n_params,  # noqa: F401
                                nchw, nhwc, one_torch_thread, randomize, shapes, to_np,
                                torch_batch)

F64 = {"dataset.images_size": 32, "mode.compute_dtype": "float64", "model.base_channels": 4,
       "model.n_bins": 8}


def _rgb_sd(v):
    return rgb_depth_state_dict_from_jax(to_np(v["params"]), to_np(v["batch_stats"]))


def _ada_sd(v):
    return adabins_state_dict_from_jax(to_np(v["params"]), to_np(v["batch_stats"]))


@pytest.mark.parametrize("family,size", [("rgb_depth", 17_262_977),
                                         ("adabins_distillation", 42_614_529)])
def test_state_dict_equals_jax_export_and_param_count(family, size):
    cfg = jax_load_config("batvisionv2", "test", model_name=family, overrides=F64)
    model = jax_make_task(cfg).model
    img = jnp.zeros((1, 32, 32, 3))
    args = (img,) if family == "rgb_depth" else (jnp.zeros((1, 32, 32, 2)), img)
    variables = randomize(shapes(model.init, *args, train=False), 3, np.float32)
    want = export_for_config(cfg, variables)
    got = (_rgb_sd if family == "rgb_depth" else _ada_sd)(variables)
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    port = make_task(load_config("batvisionv2", "test", model_name=family, overrides=F64),
                     device="cpu").model
    result = port.load_state_dict(got, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    full = make_task(load_config("batvisionv2", "test", model_name=family), device="cpu").model
    flax_full = FlaxRGB() if family == "rgb_depth" else FlaxAdaBins()
    want_n = n_params(shapes(flax_full.init, *args, train=False)["params"])
    assert sum(p.numel() for p in full.parameters()) == want_n == size


# ---------------------------------------------------------------------------
# rgb_depth
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _rgb_vars():
    return randomize(shapes(FlaxRGB(base_channels=4).init, jnp.zeros((1, 32, 32, 3)),
                            train=False), 5)


def _rgb_port(output_size=32):
    model = RGBDepthNet(base_channels=4, output_size=output_size,
                        dtype=torch.float64).double()
    model.load_state_dict(_rgb_sd(_rgb_vars()), strict=True)
    return model


@pytest.mark.parametrize("train,output_size", [(False, 32), (True, 32), (False, 24)])
def test_rgb_forward_matches_flax_f64(train, output_size, f64):
    flax_model = FlaxRGB(base_channels=4, output_size=output_size, dtype=jnp.float64)
    x = np.random.default_rng(1).uniform(size=(2, 32, 32, 3))
    out = jax.jit(lambda v, x: flax_model.apply(v, x, train=train, mutable=["batch_stats"]))(
        _rgb_vars(), jnp.asarray(x))
    want, upd = out
    port = _rgb_port(output_size).train(train)
    with torch.no_grad():
        got = nhwc(port(nchw(x)))
    want = np.asarray(want)
    assert got.shape == want.shape == (2, output_size, output_size, 1)
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
    if train:
        want_sd = _rgb_sd({"params": _rgb_vars()["params"], "batch_stats": upd["batch_stats"]})
        stats = [k for k in want_sd if k.endswith(("running_mean", "running_var"))]
        assert_close_rel(port.state_dict(), want_sd, 1e-10, "running statistic", keys=stats)


def _rgb_pair(extra=None):
    overrides = dict(F64, **(extra or {}))
    jcfg = jax_load_config("synthetic", "train", model_name="rgb_depth", overrides=overrides)
    cfg = load_config("synthetic", "train", model_name="rgb_depth", overrides=overrides)
    batches = list(make_dataset(cfg, "train", num_samples=6, with_image=True)
                   .batches(2, shuffle=False))
    task = make_task(cfg, device="cpu")
    task.model = _rgb_port()
    return jcfg, jax_make_task(jcfg), _rgb_vars(), cfg, task, batches


def test_rgb_loss_fn_gradients_match_jax_f64(f64):
    jcfg, jtask, variables, cfg, task, batches = _rgb_pair()
    batch = batches[0]
    assert task.prepare(torch_batch(batch)).shape == (2, 32, 32, 3)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jfn(params):
        out, (_, aux) = jtask.loss_fn(params, variables["batch_stats"], jbatch,
                                      jax.random.PRNGKey(1), jnp.float64(0.0))
        return out, aux

    (want_loss, want_aux), jgrads = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        variables["params"])
    value, aux = task.loss_fn(torch_batch(batch), 0.0)
    value.backward()
    assert set(aux) == set(want_aux) == {"loss", "l1", "smooth"}
    np.testing.assert_allclose(value.item(), float(want_loss), rtol=1e-10)
    got = {n: p.grad for n, p in task.model.named_parameters()}
    want = _rgb_sd({"params": jgrads, "batch_stats": variables["batch_stats"]})
    assert all(float(g.abs().max()) > 0 for g in got.values())
    assert_close_rel(got, want, 1e-8, "gradient", keys=list(got))


def test_rgb_trajectory_matches_jax_f64(f64):
    jcfg, jtask, variables, cfg, task, batches = _rgb_pair({"mode.grad_clip_norm": 0.0})
    jeng = JaxEngine(jcfg, jtask)
    jstate = jax_state(jeng, variables)
    eng = Engine(cfg, task)
    state = eng.init_state()
    for batch in batches:
        jstate, jm = jeng.train_step(jstate, batch)
        state, m = eng.train_step(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=2e-6)
    want = _rgb_sd({"params": jstate.params, "batch_stats": jstate.batch_stats})
    got = state.model.state_dict()
    assert_close_rel(got, want, 2e-6, "parameter",
                     keys=[n for n, _ in state.model.named_parameters()])
    for stat in ("running_mean", "running_var"):
        assert_close_rel(got, want, 2e-6, stat, keys=[k for k in want if k.endswith(stat)])


def test_rgb_cli_trains_two_steps_on_images():
    eng, state = train_cli.main([
        "--device", "cpu", "--dataset", "synthetic", "--model", "rgb_depth",
        "--base_channels", "4", "--override", "dataset.images_size=32", "--num_samples", "4",
        "--batch_size", "2", "--epochs", "1", "--validation_iter", "1", "--lambda_l1", "0.5"])
    assert state.step == 2 and eng.task.lambda_l1 == 0.5
    (record,) = eng.history
    assert {"loss", "l1", "smooth", "grad_norm"} <= set(record)
    assert np.isfinite(record["loss"]) and np.isfinite(record["val"]["rmse"])


# ---------------------------------------------------------------------------
# adabins_distillation
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ada_vars():
    return randomize(shapes(FlaxAdaBins(n_bins=8, base_channels=4, output_size=32).init,
                            jnp.zeros((1, 32, 32, 2)), jnp.zeros((1, 32, 32, 3)),
                            train=False), 7)


def _ada_flax(output_size=32):
    return FlaxAdaBins(n_bins=8, base_channels=4, output_size=output_size, dtype=jnp.float64)


def _ada_port(output_size=32):
    model = AdaBinsDistillationModel(n_bins=8, base_channels=4, output_size=output_size,
                                     dtype=torch.float64).double()
    model.load_state_dict(_ada_sd(_ada_vars()), strict=True)
    return model


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(2, 32, 32, 2)), rng.uniform(size=(2, 32, 32, 3))


def _feed_masks(monkeypatch, seed=3):
    """The same dropout keep masks on both sides, audio's then rgb's, for
    as many forwards as are run: JAX draws them while it traces."""
    rng = np.random.default_rng(seed)
    masks = [rng.uniform(size=(2, 256)) < 0.9 for _ in range(2)]
    calls = {"torch": 0, "jax": 0}

    def port_keep(h, generator):
        m = masks[calls["torch"] % 2]
        calls["torch"] += 1
        return torch.from_numpy(m)

    def jax_keep(key, p=0.5, shape=None):
        m = masks[calls["jax"] % 2]
        calls["jax"] += 1
        return jnp.asarray(m)

    monkeypatch.setattr(adabins, "dropout_keep", port_keep)
    monkeypatch.setattr(jax.random, "bernoulli", jax_keep)
    return masks


def _compare_outputs(got, want, tol=1e-10):
    for branch in ("audio", "rgb"):
        for k in ("final_depth", "base_depth", "residual", "bin_logits"):
            w = np.asarray(want[branch][k])
            g = nhwc(got[branch][k].detach())
            assert g.shape == w.shape, (branch, k)
            assert np.abs(g - w).max() <= tol * np.abs(w).max(), (branch, k)
        for k in ("bin_centers", "bin_widths"):
            np.testing.assert_allclose(got[branch][k].detach().numpy(),
                                       np.asarray(want[branch][k]),
                                       rtol=tol, atol=tol, err_msg=f"{branch} {k}")


@pytest.mark.parametrize("output_size", [32, 48])
def test_adabins_eval_forward_matches_flax_f64(output_size, f64):
    audio, img = _inputs()
    flax_model = _ada_flax(output_size)
    want = jax.jit(lambda v, a, r: flax_model.apply(v, a, r, train=False, mode="train"))(
        _ada_vars(), jnp.asarray(audio), jnp.asarray(img))
    port = _ada_port(output_size).eval()
    with torch.no_grad():
        got = port(nchw(audio), nchw(img), mode="train")
    _compare_outputs(got, want)
    with torch.no_grad():
        alone = port(nchw(audio), None, mode="inference")
    assert alone["rgb"] is None
    assert torch.equal(alone["audio"]["final_depth"], got["audio"]["final_depth"])


def test_adabins_train_forward_with_fed_masks_matches_flax_f64(f64, monkeypatch):
    _feed_masks(monkeypatch)
    audio, img = _inputs(2)
    flax_model = _ada_flax()
    want, upd = jax.jit(lambda v, a, r: flax_model.apply(
        v, a, r, train=True, mode="train", mutable=["batch_stats"],
        rngs={"dropout": jax.random.PRNGKey(0)}))(_ada_vars(), jnp.asarray(audio),
                                                   jnp.asarray(img))
    port = _ada_port().train()
    got = port(nchw(audio), nchw(img), mode="train")
    _compare_outputs(got, want)
    assert got["rgb"]["final_depth"].grad_fn is None  # the teacher ran under no_grad
    want_sd = _ada_sd({"params": _ada_vars()["params"], "batch_stats": upd["batch_stats"]})
    stats = [k for k in want_sd if k.endswith(("running_mean", "running_var"))]
    assert_close_rel(port.state_dict(), want_sd, 1e-10, "running statistic", keys=stats)


def test_distillation_loss_pieces_match_jax_f64(f64):
    rng = np.random.default_rng(4)

    def branch():
        return {"features": {f"x{i}": rng.normal(size=(2, 3 + i, 8, 8)) for i in range(1, 6)},
                "bin_logits": rng.normal(size=(2, 8, 8, 8)),
                "bin_centers": np.sort(rng.uniform(0, 30, (2, 8)), axis=1),
                "final_depth": rng.uniform(0, 30, (2, 1, 8, 8)),
                "residual": rng.normal(0, 1, (2, 1, 8, 8))}

    audio, rgb = branch(), branch()
    gt = rng.uniform(0, 30, (2, 1, 8, 8))
    gt[:, :, :2] = 0.0

    def to_jax(b):  # NCHW → NHWC
        return {k: ({kk: jnp.asarray(vv.transpose(0, 2, 3, 1)) for kk, vv in v.items()}
                    if isinstance(v, dict) else jnp.asarray(
                        v.transpose(0, 2, 3, 1) if v.ndim == 4 else v))
                for k, v in b.items()}

    def to_torch(b):
        # the model gives the logits' spatial mean beside them (`bin_logit_mean`),
        # which the KL term reads: computed here from the same logits
        out = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()} if isinstance(v, dict)
                   else torch.from_numpy(v)) for k, v in b.items()}
        out["bin_logit_mean"] = out["bin_logits"].mean(dim=(2, 3))
        return out

    jgt = jnp.asarray(gt.transpose(0, 2, 3, 1))
    for teacher in (True, False):
        out_t = {"audio": to_torch(audio), "rgb": to_torch(rgb) if teacher else None}
        out_j = {"audio": to_jax(audio), "rgb": to_jax(rgb) if teacher else None}
        got_total, got = dist.distillation_loss(out_t, torch.from_numpy(gt),
                                                torch.from_numpy(gt > 0), 1.0, 0.5, 0.3, 0.2,
                                                0.1, temperature=3.0)
        want_total, want = jdist.distillation_loss(out_j, jgt, jgt > 0, 1.0, 0.5, 0.3, 0.2, 0.1,
                                                   temperature=3.0)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-12, atol=1e-15,
                                       err_msg=k)
    for progress in (0.0, 0.05, 0.15, 0.3, 0.6, 1.0, 1.4):
        got = dist.adaptive_distillation_weights(progress)
        want = jdist.adaptive_distillation_weights(jnp.float64(progress))
        for k in want:
            np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-14, err_msg=k)


def test_adabins_eval_mode_gradients_match_jax_f64(f64):
    """The five-term loss (the class's weights) through both nets in eval
    mode, as the JAX package's gradient test runs it."""
    audio, img = _inputs(5)
    gt = np.random.default_rng(6).uniform(0.5, 30.0, (2, 32, 32, 1))
    flax_model = _ada_flax()
    variables = _ada_vars()

    def jfn(params):
        out = flax_model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                               jnp.asarray(audio), jnp.asarray(img), train=False, mode="train")
        return jdist.distillation_loss(out, jnp.asarray(gt), jnp.asarray(gt) > 0)[0]

    want_loss, jgrads = jax.jit(jax.value_and_grad(jfn))(variables["params"])
    port = _ada_port().eval()
    gt_t = torch.from_numpy(gt).permute(0, 3, 1, 2)
    value, _ = dist.distillation_loss(port(nchw(audio), nchw(img), mode="train"), gt_t, gt_t > 0)
    value.backward()
    np.testing.assert_allclose(value.item(), float(want_loss), rtol=1e-10)
    want = _ada_sd({"params": jgrads, "batch_stats": variables["batch_stats"]})
    teacher = {n for n, _ in port.named_parameters() if n.startswith("rgb_")}
    assert all(p.grad is None for n, p in port.named_parameters() if n in teacher)
    assert all(float(np.abs(want[n].numpy()).max()) == 0.0 for n in teacher)
    got = {n: p.grad for n, p in port.named_parameters() if n not in teacher}
    assert float(got["residual_head.weight"].abs().max()) > 0
    assert_close_rel(got, want, 1e-8, "gradient", keys=list(got))


def _ada_pair(extra=None):
    overrides = dict(F64, **(extra or {}))
    jcfg = jax_load_config("synthetic", "train", model_name="adabins_distillation",
                           overrides=overrides)
    cfg = load_config("synthetic", "train", model_name="adabins_distillation",
                      overrides=overrides)
    batches = list(make_dataset(cfg, "train", num_samples=6, with_image=True)
                   .batches(2, shuffle=False))
    task = make_task(cfg, device="cpu")
    task.model = _ada_port()
    jtask = jax_make_task(jcfg)
    jtask.model = _ada_flax()
    return jcfg, jtask, _ada_vars(), cfg, task, batches


def test_adabins_loss_fn_with_fed_masks_matches_jax_f64(f64, monkeypatch):
    """The adaptive weights at 0-based epoch 3 of 10 (the fixed weights
    run in the trajectory below)."""
    _feed_masks(monkeypatch)
    jcfg, jtask, variables, cfg, task, batches = _ada_pair(
        {"model.extra.use_adaptive_loss": True, "mode.epochs": 10})
    batch = batches[0]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jfn(params):
        out, (_, aux) = jtask.loss_fn(params, variables["batch_stats"], jbatch,
                                      jax.random.PRNGKey(1), jnp.float64(3.0))
        return out, aux

    (want_loss, want_aux), jgrads = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        variables["params"])
    value, aux = task.loss_fn(torch_batch(batch), 3.0)
    value.backward()
    assert set(aux) == set(want_aux) == {"loss", "task", "response", "feature", "bin", "sparse"}
    for k in want_aux:
        np.testing.assert_allclose(aux[k].item(), float(want_aux[k]), rtol=1e-10, err_msg=k)
    want = _ada_sd({"params": jgrads, "batch_stats": variables["batch_stats"]})
    got = {n: p.grad for n, p in task.model.named_parameters() if not n.startswith("rgb_")}
    assert_close_rel(got, want, 1e-8, "gradient", keys=list(got))


def test_adabins_frozen_teacher_trajectory_matches_jax_f64(f64, monkeypatch):
    _feed_masks(monkeypatch)
    jcfg, jtask, variables, cfg, task, batches = _ada_pair({"mode.weight_decay": 0.05})
    jeng = JaxEngine(jcfg, jtask)
    jstate = jax_state(jeng, variables)
    eng = Engine(cfg, task)
    state = eng.init_state()
    teacher = {n for n, _ in task.model.named_parameters() if n.startswith("rgb_")}
    in_opt = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    assert all((id(p) in in_opt) == (n not in teacher) for n, p in task.model.named_parameters())
    start = {k: v.clone() for k, v in task.model.state_dict().items()}
    for batch in batches:
        jstate, jm = jeng.train_step(jstate, batch)
        state, m = eng.train_step(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=2e-6)
        assert float(m["grad_norm"]) > 1.0  # every step clips
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=2e-6)
    got = state.model.state_dict()
    want = _ada_sd({"params": jstate.params, "batch_stats": jstate.batch_stats})
    for n in teacher:
        assert torch.equal(got[n], start[n]), n  # bit-unchanged under weight decay
    student = [n for n, _ in task.model.named_parameters() if n not in teacher]
    assert all(not torch.equal(got[n], start[n]) for n in student)
    assert_close_rel(got, want, 2e-6, "student parameter", keys=student)
    rgb_stats = [k for k in want if k.startswith("rgb_") and k.endswith(
        ("running_mean", "running_var"))]
    assert all(not torch.equal(got[k], start[k]) for k in rgb_stats)
    assert_close_rel(got, want, 1e-10, "teacher running statistic", keys=rgb_stats)


def test_adabins_cli_trains_two_steps_on_paired_batches():
    eng, state = train_cli.main([
        "--device", "cpu", "--dataset", "synthetic", "--model", "adabins_distillation",
        "--base_channels", "4", "--n_bins", "8", "--override", "dataset.images_size=32",
        "--num_samples", "4", "--batch_size", "2", "--epochs", "1", "--validation_iter", "1",
        "--use_adaptive_loss", "--temperature", "2.0"])
    assert state.step == 2 and eng.task.adaptive and eng.task.temperature == 2.0
    (record,) = eng.history
    assert {"loss", "task", "response", "feature", "bin", "sparse"} <= set(record)
    assert record["response"] > 0 and np.isfinite(record["val"]["rmse"])


def test_adabins_resume_equals_uninterrupted_bit_for_bit(tmp_path):
    def run(root, *flags):
        return train_cli.main([
            "--device", "cpu", "--dataset", "synthetic", "--model", "adabins_distillation",
            "--base_channels", "4", "--n_bins", "8", "--override", "dataset.images_size=32",
            "--num_samples", "4", "--batch_size", "2", "--validation", "false",
            "--ckpt_dir", str(root), "--saving_checkpoints", "1", *flags])

    eng_full, full = run(tmp_path / "full", "--epochs", "3")
    run(tmp_path / "cut", "--epochs", "2")
    eng_res, resumed = run(tmp_path / "cut", "--epochs", "3", "--resume")
    assert [r["epoch"] for r in eng_res.history] == [3] and resumed.step == full.step == 6
    assert eng_res.history[0]["loss"] == eng_full.history[2]["loss"]
    want = full.model.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in resumed.model.state_dict().items())
    a, b = resumed.optimizer.state_dict()["state"], full.optimizer.state_dict()["state"]
    assert a.keys() == b.keys() and len(a) == len(eng_full.task.trainable_parameters())
    assert all(torch.equal(a[i][k], b[i][k]) for i in a for k in a[i])


def test_adabins_remat_equals_no_remat_bit_for_bit_f64():
    """Drawn masks (no feeding): the generator must advance as without remat."""
    cfg = load_config("synthetic", "train", model_name="adabins_distillation", overrides=F64)
    batch = next(make_dataset(cfg, "train", num_samples=2, with_image=True)
                 .batches(2, shuffle=False))
    runs = {}
    for remat in (False, True):
        task = make_task(cfg, device="cpu")
        task.model = _ada_port()
        task.model.remat = remat
        calls = []
        task.model.audio_encoder.inc.register_forward_hook(lambda *a: calls.append(1))
        eng = Engine(cfg, task)
        state, m = eng.train_step(eng.init_state(), batch)
        assert len(calls) == (2 if remat else 1)  # recomputed in the backward
        runs[remat] = (m, task.model, task.generator.get_state())
    (m0, model0, gen0), (m1, model1, gen1) = runs[False], runs[True]
    assert m0["loss"].item() == m1["loss"].item()
    assert m0["grad_norm"].item() == m1["grad_norm"].item()
    assert torch.equal(gen0, gen1)
    want = model0.state_dict()
    for k, v in model1.state_dict().items():  # parameters after the step, statistics
        assert torch.equal(v, want[k]), k


def test_adabins_remat_trajectory_matches_jax_f64(f64, monkeypatch):
    _feed_masks(monkeypatch)
    jcfg, jtask, variables, cfg, task, batches = _ada_pair({"model.extra.remat": True})
    jtask.model = FlaxAdaBins(n_bins=8, base_channels=4, output_size=32, dtype=jnp.float64,
                              remat=True)
    assert task.model.remat is False and make_task(cfg, device="cpu").model.remat is True
    task.model.remat = True
    jeng = JaxEngine(jcfg, jtask)
    jstate = jax_state(jeng, variables)
    eng = Engine(cfg, task)
    state = eng.init_state()
    stats = [k for k in task.model.state_dict() if k.endswith(("running_mean", "running_var"))]
    for i, batch in enumerate(batches):
        jstate, jm = jeng.train_step(jstate, batch)
        state, m = eng.train_step(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=2e-6)
        if i == 0:
            want = _ada_sd({"params": jstate.params, "batch_stats": jstate.batch_stats})
            assert_close_rel(state.model.state_dict(), want, 1e-10, "running statistic",
                             keys=stats)
    got = state.model.state_dict()
    want = _ada_sd({"params": jstate.params, "batch_stats": jstate.batch_stats})
    student = [n for n, _ in task.model.named_parameters() if not n.startswith("rgb_")]
    assert_close_rel(got, want, 2e-6, "student parameter", keys=student)
