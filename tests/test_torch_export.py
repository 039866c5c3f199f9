"""The port's exported inference graph and its registered ops, on the CPU.

  * `tools/export.py`: for unet_baseline, binaural_attention (every γ
    drawn non-zero), unet_cvae and the coarse unet, the program exported by
    `torch.export`, saved and reloaded from its `.pt2`, against the JAX
    package's `build_inference_fn` on the same weights (the JAX exporter's
    reference-format state_dict, loaded strict) and a numpy-seeded
    waveform: in float64 at 1e-10 (that graph has no B1 op: the f64 front
    end is plain tensor ops) and in float32 at JAX's own 1e-5, where the
    graph holds `audiodepth.fused_mel_frontend` once and, for the binaural
    net, `audiodepth.flash_cross_attention_fwd` once per attention level;
    no graph mutates a buffer. The reloaded program equals the port's eager
    `predict_meters` bit for bit. The cVAE's eval eps (a generator reseeded
    to 0) is held in the graph and fed to JAX's `jax.random.normal`;
  * `main --ckpt_dir --use_best` exports the best epoch of a one-epoch CLI
    run, and `main --torch_checkpoint` a coarse reference wrapper whose
    linear bins are baked into the graph;
  * the registered ops pass `torch.library.opcheck` (their CPU
    implementations and fakes), and `cross_attention`'s gradients through
    `register_autograd` equal the wrappers' forward and backward at 1e-12.
"""

from __future__ import annotations

import functools
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from audiodepth_tpu.configs import load_config as jax_load_config
from audiodepth_tpu.models import make_task as jax_make_task
from audiodepth_tpu.tools.export import build_inference_fn as jax_build_inference_fn
from audiodepth_tpu.tools.import_torch import export_for_config

from audiodepth_tpu_torch.configs import load_config
from audiodepth_tpu_torch.models import init_weights, make_task
from audiodepth_tpu_torch.ops.cuda import flash_attention as fa
from audiodepth_tpu_torch.ops.cuda import fused_frontend as ff
from audiodepth_tpu_torch.tools import export as texport

from tests.torch_parity import one_torch_thread, randomize  # noqa: F401

B1_OP = "audiodepth.fused_mel_frontend.default"
B2_OP = "audiodepth.flash_cross_attention_fwd.default"
FAMILIES = {
    "unet_baseline": {"model.generator": "unet_128", "model.ngf": 4,
                      "dataset.images_size": 128},
    "binaural_attention": {"model.base_channels": 8, "dataset.images_size": 32},
    "unet_cvae": {"model.generator": "unet_128", "model.ngf": 4, "model.latent_dim": 8,
                  "dataset.images_size": 128},
    "coarse_depth": {"model.base_channels": 8, "model.n_bins": 8, "dataset.images_size": 32},
}
BATCH = 2


def _configs(family, dtype, extra=None):
    over = dict(FAMILIES[family], **{"mode.compute_dtype": dtype}, **(extra or {}))
    return (jax_load_config("batvisionv2", "test", "x", family, overrides=over),
            load_config("batvisionv2", "test", "x", family, overrides=over))


@functools.lru_cache(maxsize=None)
def _variables(family):
    """numpy-drawn float32 variables of the JAX model (γ non-zero)."""
    jcfg, _ = _configs(family, "float32")
    wave = jnp.zeros((1, 2, texport.wave_length(jcfg)), jnp.float32)
    init = jax_make_task(jcfg).init
    shapes = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), {"waveform": wave}))
    return randomize(shapes, 5, np.float32)


def _wave(cfg, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((BATCH, 2, texport.wave_length(cfg))) * 0.05).astype(np.float32)


def _graph_ops(ep):
    return [str(n.target) for n in ep.graph.nodes if n.op == "call_function"
            and str(n.target).startswith("audiodepth.")]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_exported_graph_matches_jax_and_eager(family, dtype, tmp_path, monkeypatch):
    jax.config.update("jax_enable_x64", dtype == "float64")
    try:
        jcfg, cfg = _configs(family, dtype)
        variables = _variables(family)
        task = make_task(cfg, device="cpu")
        if dtype == "float64":
            task.model.double()
        sd = {k: torch.from_numpy(np.asarray(v)) for k, v in
              export_for_config(jcfg, variables).items()}
        task.model.load_state_dict(sd, strict=True)
        if family == "binaural_attention":
            assert all(float(m.gamma) != 0.0 for m in task.model.attention_modules.values())
        ep, path = texport.export_inference(cfg, task, BATCH, str(tmp_path / "g.pt2"))
        assert not ep.graph_signature.buffers_to_mutate
        ops = _graph_ops(ep)
        levels = len(cfg.model.attention_levels) if family == "binaural_attention" else 0
        assert ops.count(B2_OP) == levels
        assert ops.count(B1_OP) == (1 if dtype == "float32" else 0)
        assert len(ops) == ops.count(B1_OP) + levels

        wave = _wave(cfg)
        with torch.no_grad():
            got = texport.load_exported(path).module()(torch.from_numpy(wave))
        assert got.shape == (BATCH, cfg.dataset.images_size, cfg.dataset.images_size, 1)
        with torch.no_grad():
            eager = torch.clamp(task.predict_meters({"waveform": torch.from_numpy(wave)}),
                                0.0, cfg.dataset.max_depth)
        assert torch.equal(got, eager)

        jdt = jnp.float64 if dtype == "float64" else jnp.float32
        jv = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), variables)
        if family == "unet_cvae":
            eps = texport.InferenceGraph(cfg, task, BATCH).eps.numpy()
            monkeypatch.setattr(jax.random, "normal", lambda key, shape=(), dtype=None:
                                jnp.asarray(eps, dtype).reshape(shape))
        jtask = jax_make_task(jcfg)
        if family == "coarse_depth":
            np.testing.assert_array_equal(task.bin_centers, np.asarray(jtask.bin_centers))
        want = jax.jit(jax_build_inference_fn(jcfg, jtask))(
            jv["params"], jv.get("batch_stats"), jnp.asarray(wave))
        tol = 1e-10 if dtype == "float64" else 1e-5
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)
    finally:
        jax.config.update("jax_enable_x64", False)


def test_export_cli_from_best_checkpoint(tmp_path):
    """One CLI epoch with checkpoints; `main --ckpt_dir --use_best` exports
    the best epoch, which answers what the restored task answers."""
    from audiodepth_tpu_torch.ckpt import CheckpointManager
    from audiodepth_tpu_torch.cli import train as train_cli

    ck = str(tmp_path / "ck")
    train_cli.main(["--device", "cpu", "--dataset", "synthetic", "--model", "unet_baseline",
                    "--generator", "unet_128", "--ngf", "4", "--epochs", "1",
                    "--batch_size", "2", "--num_samples", "2", "--compute_dtype", "float32",
                    "--validation_iter", "1", "--ckpt_dir", ck, "--no_visualize"])
    (exp,) = os.listdir(ck)
    assert json.load(open(os.path.join(ck, exp, "best.json")))["epoch"] == 1
    out = str(tmp_path / "trained.pt2")
    path = texport.main(["--device", "cpu", "--model", "unet_baseline", "--generator",
                         "unet_128", "--ngf", "4", "--out", out, "--ckpt_dir", ck,
                         "--experiment_name", exp, "--use_best"])
    assert path == out and os.path.getsize(out) > 10_000
    cfg = load_config("batvisionv2", "test", "x", "unet_baseline",
                      overrides={"model.generator": "unet_128", "model.ngf": 4})
    task = make_task(cfg, device="cpu")
    sd, _, epoch = CheckpointManager(ck, exp, create=False).restore_eval("best")
    task.model.load_state_dict(sd, strict=True)
    wave = torch.from_numpy(_wave(cfg)[:1])
    with torch.no_grad():
        got = texport.load_exported(out).module()(wave)
    want = torch.clamp(task.predict_meters({"waveform": wave}), 0.0, 30.0)
    assert epoch == 1 and torch.equal(got, want)


def test_export_cli_torch_checkpoint_bakes_coarse_bins(tmp_path):
    """A reference wrapper {state_dict, bin_centers, bin_edges}: the
    exported coarse unet answers with the wrapper's linear bins."""
    from audiodepth_tpu_torch.data.bins import compute_bin_edges

    over = {"model.base_channels": 4, "model.n_bins": 8}  # the CLI's 256²
    cfg = load_config("batvisionv2", "test", "x", "coarse_depth", overrides=over)
    task = make_task(cfg, device="cpu")
    init_weights(task.model, torch.Generator().manual_seed(0))
    edges, centers = compute_bin_edges(8, 0.1, 30.0, "linear")
    pth = str(tmp_path / "coarse.pth")
    torch.save({"state_dict": task.model.state_dict(), "bin_centers": torch.from_numpy(centers),
                "bin_edges": torch.from_numpy(edges), "epoch": 3}, pth)
    out = str(tmp_path / "coarse.pt2")
    texport.main(["--device", "cpu", "--model", "coarse_depth", "--base_channels", "4",
                  "--n_bins", "8", "--torch_checkpoint", pth, "--out", out])
    wave = torch.from_numpy(_wave(load_config("batvisionv2", "test", overrides=over))[:1])
    with torch.no_grad():
        sid = task.predict_meters({"waveform": wave})
        task.restore_aux({"bin_centers": centers, "bin_edges": edges})
        linear = torch.clamp(task.predict_meters({"waveform": wave}), 0.0, 30.0)
        got = texport.load_exported(out).module()(wave)
    assert torch.equal(got, linear)
    assert float((got - sid).abs().max()) > 0.05


def test_export_refuses_image_models():
    with pytest.raises(SystemExit, match="waveform→depth"):
        texport.main(["--device", "cpu", "--model", "rgb_depth"])


# ---------------------------------------------------------------------------
# the registered ops
# ---------------------------------------------------------------------------

def test_opcheck_fused_mel_frontend():
    rng = np.random.default_rng(0)
    wave = torch.from_numpy(rng.standard_normal((2, 2, 700)).astype(np.float32))
    torch.library.opcheck(ff.fused_mel_frontend_op, (wave,))
    # the strided time-of-flight view, and the op's other arguments
    torch.library.opcheck(ff.fused_mel_frontend_op,
                          (wave[..., :600], 512, 64, 16, 24, 44100, 30.0, 18000.0))
    assert ff.fused_mel_frontend_op(wave[..., :600]).shape == (2, 2, 32, 19)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_opcheck_flash_cross_attention(dtype):
    rng = np.random.default_rng(1)

    def t(*shape, grad=True):
        return torch.from_numpy(rng.standard_normal(shape)).to(dtype).requires_grad_(grad)

    q, k, v = t(2, 9, 4), t(2, 7, 4), t(2, 7, 6)
    torch.library.opcheck(fa.flash_cross_attention_fwd_op, (q, k, v, 0.5))
    o, lse = fa.flash_cross_attention_fwd_plain(q.detach(), k.detach(), v.detach(), 0.5)
    torch.library.opcheck(fa.flash_cross_attention_bwd_op,
                          (q.detach(), k.detach(), v.detach(), o, lse, t(2, 9, 6, grad=False),
                           0.5))


def test_cross_attention_gradients_through_register_autograd():
    """The op's autograd equals the wrappers' forward then backward at 1e-12."""
    rng = np.random.default_rng(2)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s)) for s in
                   ((2, 40, 8), (2, 30, 8), (2, 30, 12), (2, 40, 12)))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = fa.cross_attention(*leaves, 0.3)
    o.backward(do)
    want_o, lse = fa.flash_cross_attention(q, k, v, 0.3)
    want = fa.flash_cross_attention_bwd(q, k, v, want_o, lse, do, 0.3)
    np.testing.assert_allclose(o.detach().numpy(), want_o.numpy(), rtol=1e-12, atol=1e-12)
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), w.numpy(), rtol=1e-12, atol=1e-12)
    _, lse_out = fa.flash_cross_attention_fwd_op(*leaves, 0.3)
    assert not lse_out.requires_grad  # lse is not differentiable
