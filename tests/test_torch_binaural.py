"""The port's binaural_attention family against the JAX package.

  * `binaural_state_dict_from_jax` equals the JAX package's own flax→torch
    export (`export_for_config`) key for key and value for value, and the
    port's BinauralAttentionNet loads it with strict=True; at base 64 the
    param count is 29,260,773 (the JAX model's, from its variables' shapes);
  * the cross-attention block alone, and the eval forward of the whole net
    (base 8, 64², levels 2-5, every γ drawn non-zero), match flax at 1e-10
    in f64 (the same math; only summation order differs); the f32 forward
    within 5e-4 abs (the JAX package's own fp32 transplant tolerance against
    torch, on outputs in meters up to 30); the bf16 forward within 4e-2 of
    the output's max: both frameworks round every conv, BN and projection
    output to bf16 (2^-9 relative per rounding) at different points and in
    different orders over ~25 layers, and the sigmoid·30 head turns an
    error of the logit into meters. Each framework's bf16 forward is itself
    1.5e-2 to 2.9e-2 of the max away from its f32 forward, and the two bf16
    forwards differ by 1.2e-2 to 2.9e-2 (four seeds);
  * `predict_meters` on 7782-sample waveforms (mel front end, 64², base 4)
    matches the JAX task in f64 at 1e-10 and in f32 at 5e-4;
  * `upsample2x_align_corners` matches the JAX package's in f64, and the
    family's init is kaiming fan_out with γ = 0, which makes each attention
    block the identity.

Weights are drawn with numpy (fan-in scaled, random BN statistics, γ from
N(0, 0.5)) so that activations stay O(1) and the comparisons are sharp.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from audiodepth_tpu.configs import load_config as jax_load_config
from audiodepth_tpu.models import make_task as jax_make_task
from audiodepth_tpu.models.binaural_attention import BinauralAttentionNet as FlaxNet
from audiodepth_tpu.models.binaural_attention import BinauralCrossAttention as FlaxAttention
from audiodepth_tpu.models.layers import upsample2x_align_corners as jax_upsample
from audiodepth_tpu.tools.import_torch import export_for_config

from audiodepth_tpu_torch.configs import load_config
from audiodepth_tpu_torch.models import init_binaural_weights, make_task
from audiodepth_tpu_torch.models.binaural_attention import (
    BinauralAttentionNet, BinauralCrossAttention)
from audiodepth_tpu_torch.models.layers import upsample2x_align_corners
from audiodepth_tpu_torch.tools.import_jax import binaural_state_dict_from_jax


@pytest.fixture
def f64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _randomize(variables, seed, dtype=np.float32):
    """numpy-drawn weights: fan-in scaled kernels, random BN affine/stats,
    γ ~ N(0, 0.5)."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(variables)[0]:
        keys = [getattr(k, "key", str(k)) for k in path]
        shape = np.shape(leaf)
        name = keys[-1]
        if name == "kernel":
            v = rng.normal(0.0, 1.0 / np.sqrt(np.prod(shape[:-1]) / 2), shape)
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "gamma":
            v = rng.normal(0.0, 0.5, shape)
        else:  # bias, mean
            v = rng.normal(0.0, 0.1, shape)
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[name] = v.astype(dtype)
    return out


def _shapes(init, *args, **kwargs):
    """The variables' shapes only: every leaf is redrawn by `_randomize`."""
    return jax.eval_shape(lambda: init(jax.random.PRNGKey(0), *args, **kwargs))


_LEVELS = (2, 3, 4, 5)


def _flax_and_port(dtype_jax, dtype_torch, np_dtype, seed=0, size=64):
    flax_model = FlaxNet(base_channels=8, output_size=size, remat=False, dtype=dtype_jax)
    x0 = jnp.zeros((1, size, size, 2), np_dtype)
    variables = _randomize(_shapes(flax_model.init, x0, train=False), seed, np_dtype)
    port = BinauralAttentionNet(base_channels=8, output_size=size, dtype=dtype_torch)
    if np_dtype == np.float64:
        port = port.double()
    port.load_state_dict(binaural_state_dict_from_jax(
        variables["params"], variables["batch_stats"]), strict=True)
    return flax_model, variables, port.to(memory_format=torch.channels_last).eval()


def _forward_both(flax_model, variables, port, x_nhwc):
    apply = jax.jit(lambda v, x: flax_model.apply(v, x, train=False))
    want = np.asarray(apply(variables, jnp.asarray(x_nhwc)))
    with torch.no_grad():
        got = port(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return got.numpy(), want


def _input(dtype, size=64, seed=1):
    return np.random.default_rng(seed).uniform(size=(2, size, size, 2)).astype(dtype)


@pytest.mark.parametrize("levels", [(2, 3, 4, 5), (3, 4)])
def test_state_dict_equals_jax_export(levels):
    cfg = jax_load_config("batvisionv2", "test", model_name="binaural_attention", overrides={
        "model.base_channels": 4, "model.attention_levels": ",".join(map(str, levels)),
        "dataset.images_size": 32})
    flax_model = jax_make_task(cfg).model  # remat on, as the JAX task builds it
    variables = _randomize(_shapes(flax_model.init, jnp.zeros((1, 32, 32, 2)), train=False), 3)
    want = export_for_config(cfg, variables)
    got = binaural_state_dict_from_jax(variables["params"], variables["batch_stats"], levels)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == torch.from_numpy(np.asarray(v)).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    port = make_task(load_config("batvisionv2", "test", model_name="binaural_attention",
                                 overrides={"model.base_channels": 4,
                                            "model.attention_levels": list(levels)}),
                     device="cpu").model
    result = port.load_state_dict(got, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    assert port.attention_modules["attn_3"].query.weight.shape == (2, 16, 1, 1)


def test_base64_strict_load_and_param_count():
    model = make_task(load_config("batvisionv2", "test", model_name="binaural_attention"),
                      device="cpu").model
    assert sum(p.numel() for p in model.parameters()) == 29_260_773
    # the JAX package's variables shape for shape (parameter shapes do not
    # depend on the input size, so a 32² input gives the 256² model's)
    flax_model = FlaxNet(base_channels=64, remat=False)
    shapes = _shapes(flax_model.init, jnp.zeros((1, 32, 32, 2)), train=False)
    assert sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"])) \
        == 29_260_773
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = binaural_state_dict_from_jax(zeros["params"], zeros["batch_stats"])
    result = model.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys


@pytest.mark.parametrize("seed", [0, 1])
def test_cross_attention_block_f64(seed, f64):
    c, b, h, w = 32, 2, 8, 6
    flax_block = FlaxAttention(channels=c, dtype=jnp.float64)
    rng = np.random.default_rng(seed)
    left, right = (rng.normal(size=(b, h, w, c)) for _ in range(2))
    variables = _randomize(_shapes(flax_block.init, jnp.asarray(left), jnp.asarray(right)),
                           seed + 10, np.float64)
    want_l, want_r = flax_block.apply(variables, jnp.asarray(left), jnp.asarray(right))
    port = BinauralCrossAttention(c, dtype=torch.float64).double()
    with torch.no_grad():
        for i, proj in enumerate((port.query, port.key, port.value, port.out)):
            dense = variables["params"][f"Dense_{i}"]
            proj.weight.copy_(torch.from_numpy(dense["kernel"].T[:, :, None, None]))
            proj.bias.copy_(torch.from_numpy(dense["bias"]))
        port.gamma.copy_(torch.from_numpy(variables["params"]["gamma"]))
        nchw = [torch.from_numpy(a).permute(0, 3, 1, 2) for a in (left, right)]
        got_l, got_r = port(*nchw)
    assert float(port.gamma.detach()) != 0.0
    for got, want in ((got_l, want_l), (got_r, want_r)):
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                                   rtol=0, atol=1e-10)


def test_eval_forward_f64(f64):
    fm, v, port = _flax_and_port(jnp.float64, torch.float64, np.float64)
    got, want = _forward_both(fm, v, port, _input(np.float64))
    assert got.dtype == want.dtype == np.float64 and got.shape == (2, 64, 64, 1)
    assert all(float(v["params"][f"attn_{lv}"]["gamma"][0]) != 0.0 for lv in _LEVELS)
    assert np.abs(want).max() > 1.0 and want.min() > 0.0  # O(1) meters, not saturated
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_eval_forward_resizes_to_output_size(f64):
    """The head's resize branch: a 64² input served at output_size 32."""
    flax_model = FlaxNet(base_channels=8, output_size=32, remat=False, dtype=jnp.float64)
    x = _input(np.float64)
    variables = _randomize(_shapes(flax_model.init, jnp.asarray(x[:1]), train=False), 4,
                           np.float64)
    port = BinauralAttentionNet(base_channels=8, output_size=32, dtype=torch.float64).double()
    port.load_state_dict(binaural_state_dict_from_jax(variables["params"],
                                                      variables["batch_stats"]), strict=True)
    got, want = _forward_both(flax_model, variables, port.eval(), x)
    assert got.shape == want.shape == (2, 32, 32, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_eval_forward_f32():
    fm, v, port = _flax_and_port(jnp.float32, torch.float32, np.float32)
    got, want = _forward_both(fm, v, port, _input(np.float32))
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)


def test_eval_forward_bf16():
    fm, v, port = _flax_and_port(jnp.bfloat16, torch.bfloat16, np.float32)
    got, want = _forward_both(fm, v, port, _input(np.float32))
    assert got.dtype == want.dtype == np.float32  # the head is promoted to f32
    scale = np.abs(want).max()
    assert scale > 1.0
    assert np.abs(got - want).max() <= 4e-2 * scale


@pytest.fixture(params=["float32", "float64"])
def slice_dtype(request):
    """The compute dtype of the whole-slice test; float64 enables x64."""
    if request.param == "float64":
        jax.config.update("jax_enable_x64", True)
    try:
        yield request.param
    finally:
        jax.config.update("jax_enable_x64", False)


def test_predict_meters_slice(slice_dtype):
    overrides = {"model.base_channels": 4, "dataset.images_size": 64,
                 "mode.compute_dtype": slice_dtype}
    jcfg = jax_load_config("batvisionv2", "test", model_name="binaural_attention",
                           overrides=overrides)
    jtask = jax_make_task(jcfg)
    wave = np.random.default_rng(4).normal(scale=0.1, size=(2, 2, 7782)).astype(np.float32)
    variables = _randomize(_shapes(jtask.init, {"waveform": wave}), 5)
    want = np.asarray(jtask.predict_meters(variables["params"], variables["batch_stats"],
                                           {"waveform": wave}))

    task = make_task(load_config("batvisionv2", "test", model_name="binaural_attention",
                                 overrides=overrides), device="cpu")
    sd = binaural_state_dict_from_jax(variables["params"], variables["batch_stats"])
    task.model.load_state_dict(sd, strict=True)
    got = task.predict_meters({"waveform": wave})
    assert got.shape == want.shape == (2, 64, 64, 1)
    assert str(got.dtype) == f"torch.{want.dtype}" == f"torch.{slice_dtype}"
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-10 if slice_dtype == "float64" else 5e-4)


@pytest.mark.parametrize("h,w", [(4, 4), (3, 5), (2, 16)])
def test_upsample_align_corners_matches_jax(h, w, f64):
    x = np.random.default_rng(h * w).normal(size=(2, h, w, 3))
    want = np.asarray(jax_upsample(jnp.asarray(x)))
    got = upsample2x_align_corners(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_family_init_and_zero_gamma_identity():
    model = BinauralAttentionNet(base_channels=8)
    init_binaural_weights(model, torch.Generator().manual_seed(0))
    again = BinauralAttentionNet(base_channels=8)
    init_binaural_weights(again, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                   again.state_dict().values()))
    # kaiming fan_out: std sqrt(2 / (out_channels * 9)) for a 3x3 conv
    w = model.up1.conv.double_conv[0].weight
    assert abs(float(w.detach().std()) / (2.0 / (w.shape[0] * 9)) ** 0.5 - 1.0) < 0.05
    q = model.attention_modules["attn_4"].query
    assert abs(float(q.weight.detach().std()) / (2.0 / q.weight.shape[0]) ** 0.5 - 1.0) < 0.1
    assert float(q.bias.detach().abs().max()) == 0.0
    bn = model.fusion_layers["fusion_2"][1]
    assert torch.equal(bn.weight, torch.ones_like(bn.weight))
    assert torch.equal(bn.running_var, torch.ones_like(bn.running_var))
    # γ = 0: each attention block returns its inputs unchanged
    attn = model.attention_modules["attn_2"]
    assert float(attn.gamma.detach()) == 0.0
    left, right = torch.randn(2, 16, 4, 4), torch.randn(2, 16, 4, 4)
    with torch.no_grad():
        out_l, out_r = attn(left, right)
    assert torch.equal(out_l, left) and torch.equal(out_r, right)
