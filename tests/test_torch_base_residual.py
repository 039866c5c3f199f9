"""The port's base_residual family against the JAX package, on the CPU.

  * `base_residual_state_dict_from_jax` equals the JAX package's own
    flax→torch export (`export_for_config`) key for key and value for
    value, and the port's BaseResidualNet loads it with strict=True; at
    base 64 the parameter count is 23,589,074 (the JAX model's, from its
    variables' shapes);
  * the forward (base and residual) in eval and train mode, and the running
    statistics a train-mode forward folds, match flax in f64 at 1e-10 (base
    4, 32²);
  * the loss pieces match in f64: the low-pass target, the adaptive
    weights, the three-term loss for each recon at 1e-12, and the
    frequency-aware variant at 1e-6 (its FFT runs in float32 on both sides,
    as the JAX package defines it);
  * `loss_fn`'s loss and gradients match `jax.grad` of the JAX task in f64
    at 1e-10 and 1e-8, on both sides of the warmup boundary (the detach
    flip at a 0-based epoch ≥ warmup_epochs), without the adaptive loss,
    and for the frequency-aware variant at 1e-6; the flip changes the
    gradients, not the loss;
  * four AdamW + clip steps of the engines across the warmup boundary,
    with per-step resynchronisation (the test says why), agree at 2e-6
    (losses, parameters, BatchNorm statistics);
  * `Engine.evaluate` with a ragged tail, its criterion at the current
    epoch's weights included, matches the JAX engine at 1e-6 (float32
    metrics), and an eval batch runs one forward;
  * `cli.train` trains two steps and validates on the CPU.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from audiodepth_tpu.configs import load_config as jax_load_config
from audiodepth_tpu.losses import base_residual as jloss
from audiodepth_tpu.models import make_task as jax_make_task
from audiodepth_tpu.models.base_residual import BaseResidualNet as FlaxNet
from audiodepth_tpu.tools.import_torch import export_for_config
from audiodepth_tpu.train.engine import Engine as JaxEngine

from audiodepth_tpu_torch.cli import train as train_cli
from audiodepth_tpu_torch.configs import load_config
from audiodepth_tpu_torch.data.batvision import make_dataset
from audiodepth_tpu_torch.losses import base_residual as loss
from audiodepth_tpu_torch.metrics import METRIC_NAMES
from audiodepth_tpu_torch.models import make_task
from audiodepth_tpu_torch.tools.import_jax import base_residual_state_dict_from_jax
from audiodepth_tpu_torch.train.engine import Engine

from tests.torch_parity import (assert_close_rel, f64, jax_state, n_params,  # noqa: F401
                                nchw, nhwc, one_torch_thread, randomize, shapes, to_np,
                                torch_batch)

SMALL = {"model.base_channels": 4, "dataset.images_size": 32, "mode.compute_dtype": "float64"}


def _sd(variables):
    return base_residual_state_dict_from_jax(to_np(variables["params"]),
                                             to_np(variables["batch_stats"]))


def test_state_dict_equals_jax_export_and_param_count():
    cfg = jax_load_config("batvisionv2", "test", model_name="base_residual", overrides=SMALL)
    flax_model = jax_make_task(cfg).model
    variables = randomize(shapes(flax_model.init, jnp.zeros((1, 32, 32, 2)), train=False), 3)
    want = export_for_config(cfg, variables)
    got = _sd(variables)
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    port = make_task(load_config("batvisionv2", "test", model_name="base_residual",
                                 overrides=SMALL), device="cpu").model
    result = port.load_state_dict(got, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    assert port.base_up1.conv.double_conv[3].weight.shape == (128, 32, 3, 3)
    full = make_task(load_config("batvisionv2", "test", model_name="base_residual"),
                     device="cpu").model
    want_n = n_params(shapes(FlaxNet(base_channels=64).init, jnp.zeros((1, 32, 32, 2)),
                             train=False)["params"])
    assert sum(p.numel() for p in full.parameters()) == want_n == 23_589_074


@functools.lru_cache(maxsize=None)
def _variables():
    flax_model = FlaxNet(base_channels=4, dtype=jnp.float64)
    return randomize(shapes(flax_model.init, jnp.zeros((1, 32, 32, 2)), train=False), 5)


def _pair(extra=None):
    """(JAX config and task, f64 variables, port config and task holding
    them on the CPU, three numpy train batches of 2)."""
    overrides = dict(SMALL, **(extra or {}))
    jcfg = jax_load_config("synthetic", "train", model_name="base_residual", overrides=overrides)
    cfg = load_config("synthetic", "train", model_name="base_residual", overrides=overrides)
    batches = list(make_dataset(cfg, "train", num_samples=6).batches(2, shuffle=False))
    variables = _variables()
    task = make_task(cfg, device="cpu")
    task.model.double().load_state_dict(_sd(variables), strict=True)
    return jcfg, jax_make_task(jcfg), variables, cfg, task, batches


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_flax_f64(train, f64):
    variables = _variables()
    flax_model = FlaxNet(base_channels=4, dtype=jnp.float64)
    x = np.random.default_rng(1).uniform(size=(2, 32, 32, 2))
    if train:
        (base, residual), upd = jax.jit(lambda v, x: flax_model.apply(
            v, x, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    else:
        base, residual = jax.jit(lambda v, x: flax_model.apply(v, x, train=False))(
            variables, jnp.asarray(x))
    _, _, _, _, task, _ = _pair()
    task.model.train(train)
    with torch.no_grad():
        b, r = task.model(nchw(x))
    for got, want in ((b, base), (r, residual)):
        want = np.asarray(want)
        assert np.abs(nhwc(got) - want).max() <= 1e-10 * np.abs(want).max()
    assert float(r.abs().max()) <= 0.3 * 30.0 and 0.0 <= float(b.min())
    if train:
        want_sd = _sd({"params": variables["params"], "batch_stats": upd["batch_stats"]})
        got_sd = task.model.state_dict()
        stats = [k for k in want_sd if k.endswith(("running_mean", "running_var"))]
        assert_close_rel(got_sd, want_sd, 1e-10, "running statistic", keys=stats)


def test_loss_pieces_match_jax_f64(f64):
    rng = np.random.default_rng(2)
    gt = rng.uniform(0.0, 30.0, size=(2, 32, 32, 1))
    gt[:, :5] = 0.0
    base, residual = rng.uniform(0, 30, gt.shape), rng.normal(0, 3, gt.shape)
    final = np.clip(base + residual, 0, 30)
    t = [torch.from_numpy(a) for a in (base, residual, final, gt)]
    want = np.asarray(jloss.lowpass_avgpool(jnp.asarray(gt)))
    np.testing.assert_allclose(loss.lowpass_avgpool(t[3]).numpy(), want, rtol=1e-12, atol=1e-12)
    for epoch in (0.0, 3.0, 7.5, 50.0, 80.0):
        got = loss.adaptive_weights(epoch, 10, recon_init=0.5, base_init=2.4)
        want = jloss.adaptive_weights(jnp.float64(epoch), 10, recon_init=0.5, base_init=2.4)
        np.testing.assert_allclose(got, [float(w) for w in want], rtol=1e-15)
    for recon in ("l1", "l2", "silog"):
        got_total, got = loss.base_residual_loss(*t, t[3] > 0, 0.7, 1.3, 0.2, recon=recon)
        want_total, want = jloss.base_residual_loss(*map(jnp.asarray, (base, residual, final, gt)),
                                                    jnp.asarray(gt > 0), 0.7, 1.3, 0.2,
                                                    recon=recon)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-12, err_msg=k)
    low, high = loss.separate_frequencies(t[3])
    jlow, jhigh = jloss.separate_frequencies(jnp.asarray(gt))
    for a, b in ((low, jlow), (high, jhigh)):
        assert a.dtype == torch.float32
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-6 * np.abs(np.asarray(b)).max()
    got_total, got = loss.frequency_aware_base_residual_loss(*t)
    _, want = jloss.frequency_aware_base_residual_loss(*map(jnp.asarray, (base, residual,
                                                                          final, gt)))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)


@functools.lru_cache(maxsize=None)
def _jax_grad_fn(extra):
    """The JAX task's jitted value_and_grad at a config (the epoch is an
    argument, so both sides of the warmup share one compile)."""
    jtask = _pair(dict(extra))[1]

    def jfn(params, batch_stats, batch, epoch):
        value, (_, aux) = jtask.loss_fn(params, batch_stats, batch, jax.random.PRNGKey(1), epoch)
        return value, aux

    return jax.jit(jax.value_and_grad(jfn, has_aux=True))


def _grads(extra, epoch):
    jcfg, jtask, variables, cfg, task, batches = _pair(dict(extra))
    # float64 depth on both sides: the low-pass target is computed in the
    # depth's dtype, and two float32 sums in other orders differ at 1e-7
    batch = {k: v.astype(np.float64) for k, v in batches[0].items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (want_loss, want_aux), jgrads = _jax_grad_fn(extra)(
        variables["params"], variables["batch_stats"], jbatch, jnp.float64(epoch))
    value, aux = task.loss_fn(torch_batch(batch), epoch)
    value.backward()
    got = {n: p.grad for n, p in task.model.named_parameters()}
    want = _sd({"params": jgrads, "batch_stats": variables["batch_stats"]})
    return value.item(), float(want_loss), set(aux), set(want_aux), got, want


@pytest.mark.parametrize("extra,epoch,loss_tol,tol", [
    ((("model.extra.warmup_epochs", 2),), 1.0, 1e-10, 1e-8),   # attached, mid-anneal
    ((("model.extra.warmup_epochs", 2),), 2.0, 1e-10, 1e-8),   # detached
    ((("model.extra.use_adaptive_loss", False), ("model.extra.recon", "l1")), 5.0, 1e-10,
     1e-8),
    ((("model.extra.recon", "frequency_aware"),), 0.0, 1e-6, 1e-6),
])
def test_loss_fn_gradients_match_jax_f64(extra, epoch, loss_tol, tol, f64):
    got_loss, want_loss, aux, want_aux, got, want = _grads(extra, epoch)
    assert aux == want_aux
    np.testing.assert_allclose(got_loss, want_loss, rtol=loss_tol)
    assert all(float(g.abs().max()) > 0 for g in got.values())
    assert_close_rel(got, want, tol, "gradient", keys=list(got))


def test_detach_flip_changes_gradients_not_the_loss(f64):
    """At a detached epoch, final = detach(base) + residual: the loss is the
    attached one's, and the recon term no longer reaches the base decoder."""
    _, _, _, cfg, task, batches = _pair({"model.extra.warmup_epochs": 2})
    batch = torch_batch(batches[0])
    value, _ = task.loss_fn(batch, 2.0)
    value.backward()
    detached = {n: p.grad.clone() for n, p in task.model.named_parameters()}
    task.model.zero_grad(set_to_none=True)
    base, residual = task._parts(batch, train=True)
    gt = task.to_meters(batch["depth"])
    final = torch.clamp(base + residual, 0.0, task.max_depth)  # attached
    attached, _ = task._loss(base, residual, final, gt, gt > 0, 2.0)
    attached.backward()
    assert float(attached) == float(value)
    head = "base_head.weight"
    assert not torch.equal(detached[head], task.model.base_head.weight.grad)
    assert torch.equal(detached["res_head.weight"], task.model.res_head.weight.grad)


def test_trajectory_across_warmup_matches_jax_f64(f64, monkeypatch):
    """Four AdamW + clip steps of both engines at 0-based epochs 0, 1, 1, 1
    with warmup 1: attached, then detached. Compared with per-step
    resynchronisation, as the JAX package's own base_residual trajectory
    test does (tests/test_trajectory_parity.py:658-680): before each step
    the JAX parameters are set to the port's, the optimizer moments and the
    BatchNorm statistics run free on both sides, and after the step the
    parameters must agree. Free-running, the clamp of final at [0, 30] has
    gradient kinks that amplify rounding differences step by step.

    The batches are float64 on both sides (the low-pass target is computed
    in the depth's dtype). The JAX engine passes the epoch as float32, so
    its adaptive weights are float32 values; λ_base = 1.25 makes the
    schedule's start value 2.5 exact in float32 (1.2's 2.4 is 4e-8 off, and
    Adam's first step turns that into 4e-6 on the encoder). After the flip
    λ_base is float32's nearest to 0.3 on the JAX side, 6e-8 off."""
    from audiodepth_tpu.tools import import_torch as itorch

    monkeypatch.setattr(itorch._Builder, "param_dtype", np.float64)
    jcfg, jtask, variables, cfg, task, batches = _pair(
        {"model.extra.warmup_epochs": 1, "model.extra.lambda_base": 1.25})
    batches = [{k: v.astype(np.float64) for k, v in b.items()} for b in batches]
    assert cfg.mode.optimizer == "AdamW" and cfg.mode.grad_clip_norm == 1.0
    jeng = JaxEngine(jcfg, jtask)
    jstate = jax_state(jeng, variables)
    eng = Engine(cfg, task)
    state = eng.init_state()
    keys = [n for n, _ in state.model.named_parameters()]
    start = {k: v.clone() for k, v in state.model.state_dict().items()}
    for batch, epoch in zip(batches + batches[:1], (0.0, 1.0, 1.0, 1.0)):
        port_sd = {k: v.numpy() for k, v in state.model.state_dict().items()}
        jstate = jstate.replace(params=jax.tree_util.tree_map(
            jnp.asarray, itorch.import_base_residual(port_sd)["params"]))
        jstate, jm = jeng.train_step(jstate, batch, epoch=epoch)
        state, m = eng.train_step(state, batch, epoch=epoch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=2e-6)
        assert float(m["grad_norm"]) > 1.0  # every step clips
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=2e-6)
        want = _sd({"params": jstate.params, "batch_stats": jstate.batch_stats})
        got = state.model.state_dict()
        assert_close_rel(got, want, 2e-6, f"epoch {epoch} parameter", keys=keys)
    for stat in ("running_mean", "running_var"):
        assert_close_rel(got, want, 2e-6, stat, keys=[k for k in want if k.endswith(stat)])
    assert all(not torch.equal(got[k], start[k]) for k in keys)


def test_evaluate_ragged_and_criterion_match_jax(f64):
    jcfg, jtask, variables, cfg, task, batches = _pair({"model.extra.warmup_epochs": 4})
    full = batches[0]
    tail = {k: np.concatenate([v[:1], v[:1]]) for k, v in batches[1].items()}
    tail["_valid"] = np.array([1, 0], np.int32)
    jeng = JaxEngine(jcfg, jtask)
    want = jeng.evaluate(jax_state(jeng, variables), [full, tail], epoch=2.0)
    eng = Engine(cfg, task)
    calls = []
    frontend = task._frontend
    task._frontend = lambda wave: calls.append(1) or frontend(wave)
    got = eng.evaluate(eng.init_state(), [full, tail], epoch=2.0)
    assert len(calls) == 2  # one forward an eval batch
    assert set(got) == set(want) == set(METRIC_NAMES) | {"loss", "criterion_loss"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    base, residual, final = task.predict_parts(torch_batch(full))
    np.testing.assert_array_equal(final.numpy(),
                                  torch.clamp(base + residual, 0, 30).numpy())


def test_cli_trains_two_steps_and_validates():
    eng, state = train_cli.main([
        "--device", "cpu", "--dataset", "synthetic", "--model", "base_residual",
        "--base_channels", "4", "--override", "dataset.images_size=32", "--num_samples", "4",
        "--batch_size", "2", "--epochs", "1", "--validation_iter", "1", "--warmup_epochs", "0",
        "--recon", "l1", "--lambda_base", "0.9", "--lowpass_kernel", "8"])
    assert state.step == 2 and eng.task.name == "base_residual"
    task = eng.task
    assert (task.warmup_epochs, task.recon, task.lambda_base, task.lowpass_kernel) == (
        0, "l1", 0.9, 8)
    (record,) = eng.history
    assert {"loss", "recon", "base", "sparse", "grad_norm"} <= set(record)
    assert np.isfinite(record["loss"]) and np.isfinite(record["val"]["criterion_loss"])
