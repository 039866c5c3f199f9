"""The port's unet_cvae family against the JAX package, on the CPU.

  * `unet_cvae_state_dict_from_jax` equals the JAX package's own flax→torch
    export (`export_for_config`, unet_128) key for key and value for value,
    the three BatchNorms the reference registers and never runs included,
    and the port's UNetCVAE loads it with strict=True; at unet_256 / ngf 64
    / latent 128 the port holds 50,413,059 parameters, the JAX model's
    50,411,905 plus the dead modules' 1,154;
  * the forward with z = μ (`sample=False`, as the JAX package's own tests
    run it) in eval and train mode, its KL and the running statistics a
    train-mode forward folds, match flax in f64 at 1e-10 (5 downs, ngf 8,
    latent 16, 32²); the sampled forward matches too when JAX's
    `jax.random.normal` is given the eps the port drew from its generator;
  * `loss_fn`'s loss and gradients, latent sampled from the task's
    generator (the same eps fed to JAX), match `jax.grad` of the JAX task
    at 1e-10 and 1e-8, with depth_norm on (identity head) and off (ReLU);
  * four AdamW + clip steps of the engines agree at 2e-6, compared with
    per-step resynchronisation and eps = 0 on both sides, as the JAX
    package's own cVAE trajectory test does (its docstring says why: the
    bottleneck BatchNorms normalize batch·1·1 elements, and a free run
    amplifies rounding exponentially);
  * the eval forward samples from a generator reseeded to 0 on every call:
    two calls agree bit for bit, and `Engine.evaluate` matches the JAX
    engine at 1e-6 when JAX is given that eps;
  * `cli.train` trains two steps and validates on the CPU; 2 epochs and a
    `--resume`d third equal 3 uninterrupted epochs bit for bit (the
    latent's draws are reseeded from the step).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from audiodepth_tpu.configs import load_config as jax_load_config
from audiodepth_tpu.models import make_task as jax_make_task
from audiodepth_tpu.models.unet_cvae import UNetCVAE as FlaxCVAE
from audiodepth_tpu.tools.import_torch import export_for_config
from audiodepth_tpu.train.engine import Engine as JaxEngine

from audiodepth_tpu_torch.cli import train as train_cli
from audiodepth_tpu_torch.configs import load_config
from audiodepth_tpu_torch.data.batvision import make_dataset
from audiodepth_tpu_torch.metrics import METRIC_NAMES
from audiodepth_tpu_torch.models import make_task
from audiodepth_tpu_torch.models.unet_cvae import UNetCVAE
from audiodepth_tpu_torch.tools.import_jax import unet_cvae_state_dict_from_jax
from audiodepth_tpu_torch.train.engine import Engine

from tests.torch_parity import (assert_close_rel, f64, jax_state, n_params,  # noqa: F401
                                nchw, nhwc, one_torch_thread, randomize, shapes, to_np,
                                torch_batch)

DOWNS, NGF, LATENT = 5, 8, 16


def _sd(variables, num_downs=DOWNS, ngf=NGF):
    return unet_cvae_state_dict_from_jax(to_np(variables["params"]),
                                         to_np(variables["batch_stats"]), num_downs, ngf)


def _dead_keys(sd, num_downs):
    inner = "model" + ".submodule" * (num_downs - 1)
    return [k for k in sd if k.startswith(("model.downnorm.", "model.upnorm.",
                                           f"{inner}.downnorm."))]


def test_state_dict_equals_jax_export_with_dead_modules_and_param_count():
    over = {"model.generator": "unet_128", "model.ngf": 4, "model.latent_dim": 8,
            "dataset.images_size": 128}
    cfg = jax_load_config("batvisionv2", "test", model_name="unet_cvae", overrides=over)
    flax_model = jax_make_task(cfg).model
    variables = randomize(shapes(flax_model.init, jnp.zeros((1, 128, 128, 2)), train=False,
                                 sample=False), 3, np.float32)
    want = export_for_config(cfg, variables)
    got = _sd(variables, num_downs=7, ngf=4)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == torch.from_numpy(np.asarray(v)).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    dead = _dead_keys(got, 7)
    assert len(dead) == 3 * 5  # weight, bias, running_mean, running_var, num_batches_tracked
    port = make_task(load_config("batvisionv2", "test", model_name="unet_cvae", overrides=over),
                     device="cpu").model
    result = port.load_state_dict(got, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    assert port.model.submodule.upconv.weight.shape == (16, 4, 4, 4)  # 2·(2·ngf) in: a concat
    inner_parent = port.model
    for _ in range(5):
        inner_parent = inner_parent.submodule
    assert inner_parent.upconv.weight.shape == (32, 32, 4, 4)  # above the bottleneck: no concat

    full = make_task(load_config("batvisionv2", "test", model_name="unet_cvae"),
                     device="cpu").model
    want_n = n_params(shapes(FlaxCVAE(num_downs=8, ngf=64, latent_dim=128).init,
                             jnp.zeros((1, 256, 256, 2)), train=False, sample=False)["params"])
    n_dead = sum(full.state_dict()[k].numel() for k in _dead_keys(full.state_dict(), 8)
                 if not k.endswith(("running_mean", "running_var", "num_batches_tracked")))
    assert want_n == 50_411_905 and n_dead == 1_154
    assert sum(p.numel() for p in full.parameters()) == want_n + n_dead


@functools.lru_cache(maxsize=None)
def _variables():
    return randomize(shapes(_flax(False).init, jnp.zeros((1, 32, 32, 2)), train=False,
                            sample=False), 5)


def _flax(depth_norm):
    return FlaxCVAE(input_nc=2, output_nc=1, num_downs=DOWNS, ngf=NGF, depth_norm=depth_norm,
                    latent_dim=LATENT, dtype=jnp.float64)


def _port(depth_norm):
    model = UNetCVAE(input_nc=2, output_nc=1, num_downs=DOWNS, ngf=NGF, depth_norm=depth_norm,
                     latent_dim=LATENT, dtype=torch.float64).double()
    model.load_state_dict(_sd(_variables()), strict=True)
    return model


def _pair(extra=None):
    """(JAX config and task, f64 variables, port config and task, both
    holding the small cVAE, three numpy train batches of 2)."""
    overrides = {"dataset.images_size": 32, "mode.compute_dtype": "float64",
                 "model.kl_weight": 0.1, **(extra or {})}
    jcfg = jax_load_config("synthetic", "train", model_name="unet_cvae", overrides=overrides)
    cfg = load_config("synthetic", "train", model_name="unet_cvae", overrides=overrides)
    depth_norm = cfg.dataset.depth_norm
    batches = list(make_dataset(cfg, "train", num_samples=6).batches(2, shuffle=False))
    task = make_task(cfg, device="cpu")
    task.model = _port(depth_norm)
    jtask = jax_make_task(jcfg)
    jtask.model = _flax(depth_norm)
    return jcfg, jtask, _variables(), cfg, task, batches


def _eps(seed, shape=(2, LATENT)):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed), dtype=torch.float64)


def _feed_eps(monkeypatch, eps):
    """jax.random.normal returns `eps` (the port's draw) while JAX traces."""
    monkeypatch.setattr(jax.random, "normal", lambda key, shape=(), dtype=None: jnp.asarray(
        eps.numpy()).reshape(shape))


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_flax_f64(train, f64):
    variables = _variables()
    x = np.random.default_rng(1).uniform(size=(2, 32, 32, 2))
    flax_model = _flax(False)
    if train:
        (want, want_kl), upd = jax.jit(lambda v, x: flax_model.apply(
            v, x, train=True, sample=False, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    else:
        want, want_kl = jax.jit(lambda v, x: flax_model.apply(v, x, train=False, sample=False))(
            variables, jnp.asarray(x))
    port = _port(False).train(train)
    with torch.no_grad():
        got, kl = port(nchw(x), sample=False)
    want = np.asarray(want)
    assert np.abs(nhwc(got) - want).max() <= 1e-10 * np.abs(want).max()
    np.testing.assert_allclose(float(kl), float(want_kl), rtol=1e-10)
    if train:
        want_sd = _sd({"params": variables["params"], "batch_stats": upd["batch_stats"]})
        stats = [k for k in want_sd if k.endswith(("running_mean", "running_var"))]
        assert_close_rel(port.state_dict(), want_sd, 1e-10, "running statistic", keys=stats)


def test_sampled_forward_matches_flax_given_the_same_eps(f64, monkeypatch):
    x = np.random.default_rng(2).uniform(size=(2, 32, 32, 2))
    port = _port(True).train()
    with torch.no_grad():
        got, kl = port(nchw(x), sample=True, generator=torch.Generator().manual_seed(9))
        mean, _ = port(nchw(x), sample=False)
    _feed_eps(monkeypatch, _eps(9))
    flax_model = _flax(True)
    (want, want_kl), _ = jax.jit(lambda v, x: flax_model.apply(
        v, x, train=True, sample=True, mutable=["batch_stats"],
        rngs={"latent": jax.random.PRNGKey(0)}))(_variables(), jnp.asarray(x))
    want = np.asarray(want)
    assert np.abs(nhwc(got) - want).max() <= 1e-10 * np.abs(want).max()
    np.testing.assert_allclose(float(kl), float(want_kl), rtol=1e-10)
    assert float((got - mean).abs().max()) > 1e-3  # the draw reaches the output


@pytest.mark.parametrize("depth_norm", [True, False])
def test_loss_fn_gradients_match_jax_f64(depth_norm, f64, monkeypatch):
    jcfg, jtask, variables, cfg, task, batches = _pair({"dataset.depth_norm": depth_norm})
    batch = batches[0]
    task.begin_step(3)
    value, aux = task.loss_fn(torch_batch(batch), 0.0)
    value.backward()
    # the eps the port drew: its generator, reseeded for step 3
    _feed_eps(monkeypatch, _eps(int(cfg.mode.seed) * 2**32 + 3))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jfn(params):
        out, (_, jaux) = jtask.loss_fn(params, variables["batch_stats"], jbatch,
                                       jax.random.PRNGKey(1), jnp.float64(0.0))
        return out, jaux

    (want_loss, want_aux), jgrads = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        variables["params"])
    assert set(aux) == set(want_aux) == {"loss", "depth_loss", "kl"}
    np.testing.assert_allclose(value.item(), float(want_loss), rtol=1e-10)
    np.testing.assert_allclose(aux["kl"].item(), float(want_aux["kl"]), rtol=1e-10)
    want = _sd({"params": jgrads, "batch_stats": variables["batch_stats"]})
    got = {n: p.grad for n, p in task.model.named_parameters() if p.grad is not None}
    dead = set(_dead_keys(want, DOWNS))
    assert set(got) == {n for n, _ in task.model.named_parameters()} - dead
    assert all(float(g.abs().max()) > 0 for g in got.values())
    assert_close_rel(got, want, 1e-8, "gradient", keys=list(got))


def test_trajectory_resynced_matches_jax_f64(f64, monkeypatch):
    from audiodepth_tpu.tools import import_torch as itorch

    monkeypatch.setattr(itorch._Builder, "param_dtype", np.float64)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=None: jnp.zeros(shape, jnp.float64))
    monkeypatch.setattr(torch, "randn", lambda shape, generator=None, dtype=None, device=None:
                        torch.zeros(shape, dtype=dtype, device=device))
    jcfg, jtask, variables, cfg, task, batches = _pair({"dataset.depth_norm": True})
    assert cfg.mode.optimizer == "AdamW" and cfg.mode.grad_clip_norm == 1.0
    jeng = JaxEngine(jcfg, jtask)
    jstate = jax_state(jeng, variables)
    eng = Engine(cfg, task)
    state = eng.init_state()
    dead = set(_dead_keys(state.model.state_dict(), DOWNS))
    keys = [n for n, _ in state.model.named_parameters() if n not in dead]
    for batch in batches + batches[:1]:
        port_sd = {k: v.numpy() for k, v in state.model.state_dict().items()}
        jstate = jstate.replace(params=jax.tree_util.tree_map(
            jnp.asarray, itorch.import_unet_cvae(port_sd, num_downs=DOWNS)["params"]))
        jstate, jm = jeng.train_step(jstate, batch, epoch=0.0)
        state, m = eng.train_step(state, batch, epoch=0.0)
        for k in ("loss", "kl", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2e-6, err_msg=k)
        want = _sd({"params": jstate.params, "batch_stats": jstate.batch_stats})
        got = state.model.state_dict()
        assert_close_rel(got, want, 2e-6, "parameter", keys=keys)
    for stat in ("running_mean", "running_var"):
        assert_close_rel(got, want, 2e-6, stat,
                         keys=[k for k in want if k.endswith(stat) and k not in dead])


def test_eval_draw_is_fixed_and_evaluate_matches_jax(f64, monkeypatch):
    jcfg, jtask, variables, cfg, task, batches = _pair({"dataset.depth_norm": True})
    full = batches[0]
    tail = {k: np.concatenate([v[:1], v[:1]]) for k, v in batches[1].items()}
    tail["_valid"] = np.array([1, 0], np.int32)
    first = task.predict_raw(torch_batch(full))
    assert torch.equal(first, task.predict_raw(torch_batch(full)))
    task.model.eval()
    with torch.no_grad():
        mean, _ = task.model(task.prepare(torch_batch(full)).permute(0, 3, 1, 2), sample=False)
    assert float((first - mean.permute(0, 2, 3, 1)).abs().max()) > 1e-3
    _feed_eps(monkeypatch, _eps(0))
    jeng = JaxEngine(jcfg, jtask)
    want = jeng.evaluate(jax_state(jeng, variables), [full, tail])
    eng = Engine(cfg, task)
    got = eng.evaluate(eng.init_state(), [full, tail])
    assert set(got) == set(want) == set(METRIC_NAMES) | {"loss"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def test_cli_trains_two_steps_and_validates():
    eng, state = train_cli.main([
        "--device", "cpu", "--dataset", "synthetic", "--model", "unet_cvae",
        "--generator", "unet_128", "--ngf", "2", "--override", "dataset.images_size=128",
        "--num_samples", "4", "--batch_size", "2", "--epochs", "1", "--validation_iter", "1",
        "--kl_weight", "0.01", "--latent_dim", "8"])
    assert state.step == 2 and eng.task.name == "unet_cvae"
    assert eng.task.kl_weight == 0.01 and eng.cfg.model.latent_dim == 8
    (record,) = eng.history
    assert {"loss", "depth_loss", "kl", "grad_norm"} <= set(record)
    assert np.isfinite(record["loss"]) and np.isfinite(record["val"]["rmse"])


def test_resume_equals_uninterrupted_bit_for_bit(tmp_path):
    def run(root, *flags):
        return train_cli.main([
            "--device", "cpu", "--dataset", "synthetic", "--model", "unet_cvae",
            "--generator", "unet_128", "--ngf", "2", "--override", "dataset.images_size=128",
            "--num_samples", "4", "--batch_size", "2", "--validation", "false",
            "--ckpt_dir", str(root), "--saving_checkpoints", "1", *flags])

    eng_full, full = run(tmp_path / "full", "--epochs", "3")
    run(tmp_path / "cut", "--epochs", "2")
    eng_res, resumed = run(tmp_path / "cut", "--epochs", "3", "--resume")
    assert [r["epoch"] for r in eng_res.history] == [3] and resumed.step == full.step == 6
    assert eng_res.history[0]["kl"] == eng_full.history[2]["kl"]
    want = full.model.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in resumed.model.state_dict().items())
