"""The port's UNet and the whole inference slice against the JAX package.

  * `unet_state_dict_from_jax` equals the JAX package's own flax→torch
    export (`export_for_config`) key for key and value for value, and the
    port's UNetGenerator loads it with strict=True; at unet_256 / ngf 64 the
    param count is the reference's 54,408,833;
  * the eval forward (5 downs, ngf 8, 32²) matches flax at 1e-10 in f64
    (the same math; only summation order differs) and 5e-4 abs in f32
    (the JAX package's own fp32 transplant tolerance against torch);
  * a bf16 forward matches flax within 2e-2 of the output's max magnitude:
    both round every conv output and BN result to bf16 (8 significand
    bits, 2^-9 ≈ 2e-3 relative per rounding) but not at identical points
    and with different accumulation orders, and ~10 layers compound that
    (observed 3e-3..6.4e-3 over four seeds);
  * `predict_meters` on 7782-sample waveforms (mel front end + unet_128)
    matches the JAX task in f32 (5e-4) and f64 (1e-10).

Weights are drawn with numpy (fan-in scaled, random BN statistics) so that
activations stay O(1) and the comparisons are sharp.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from audiodepth_tpu.configs import load_config as jax_load_config
from audiodepth_tpu.models import make_task as jax_make_task
from audiodepth_tpu.models.unet import UNetGenerator as FlaxUNet
from audiodepth_tpu.tools.import_torch import export_for_config

from audiodepth_tpu_torch.configs import load_config
from audiodepth_tpu_torch.models import UNetGenerator, build_unet, make_task
from audiodepth_tpu_torch.tools.import_jax import unet_state_dict_from_jax

_SMALL = dict(input_nc=2, output_nc=1, num_downs=5, ngf=8, depth_norm=False)


@pytest.fixture
def f64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _randomize(variables, seed, dtype=np.float32):
    """numpy-drawn weights: fan-in scaled kernels, random BN affine/stats."""
    rng = np.random.default_rng(seed)
    flat = jax.tree_util.tree_flatten_with_path(variables)[0]
    out = {}
    for path, leaf in flat:
        keys = [getattr(k, "key", str(k)) for k in path]
        shape = np.shape(leaf)
        name = keys[-1]
        if name == "kernel":
            v = rng.normal(0.0, 1.0 / np.sqrt(np.prod(shape[:-1]) / 2), shape)
        elif name == "scale":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
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


def _flax_and_port(dtype_jax, dtype_torch, np_dtype, seed=0):
    flax_model = FlaxUNet(**_SMALL, dtype=dtype_jax)
    x0 = jnp.zeros((1, 32, 32, 2), np_dtype)
    variables = _randomize(_shapes(flax_model.init, x0, train=False), seed, np_dtype)
    port = UNetGenerator(**_SMALL, dtype=dtype_torch)
    if np_dtype == np.float64:
        port = port.double()
    port.load_state_dict(unet_state_dict_from_jax(
        variables["params"], variables["batch_stats"], num_downs=5), strict=True)
    return flax_model, variables, port.eval()


def _forward_both(flax_model, variables, port, x_nhwc):
    apply = jax.jit(lambda v, x: flax_model.apply(v, x, train=False))
    want = np.asarray(apply(variables, jnp.asarray(x_nhwc)))
    with torch.no_grad():
        got = port(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy(), want


def _input(dtype, seed=1):
    return np.random.default_rng(seed).uniform(size=(2, 32, 32, 2)).astype(dtype)


def test_state_dict_equals_jax_export():
    cfg = jax_load_config("batvisionv2", "test", overrides={
        "model.generator": "unet_128", "model.ngf": 4})
    flax_model = FlaxUNet(input_nc=2, num_downs=7, ngf=4, depth_norm=False)
    variables = _randomize(
        _shapes(flax_model.init, jnp.zeros((1, 128, 128, 2)), train=False), 3)
    want = export_for_config(cfg, variables)
    got = unet_state_dict_from_jax(variables["params"], variables["batch_stats"], num_downs=7)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == torch.from_numpy(np.asarray(v)).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    # flattened '/'-keyed input gives the same state_dict
    flat = {f"{a}/{b}": v for a, sub in variables["params"].items() for b, v in sub.items()}
    again = unet_state_dict_from_jax(flat, variables["batch_stats"], num_downs=7)
    assert all(torch.equal(again[k], got[k]) for k in got)


def test_unet256_strict_load_and_param_count():
    cfg = load_config("batvisionv2", "test")
    model = build_unet(cfg)
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == 54_408_833
    # the JAX package's variables shape-for-shape
    flax_model = FlaxUNet(input_nc=2, num_downs=8, ngf=64, depth_norm=False)
    shapes = _shapes(flax_model.init, jnp.zeros((1, 256, 256, 2)), train=False)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = unet_state_dict_from_jax(zeros["params"], zeros["batch_stats"], num_downs=8)
    result = model.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys


def test_eval_forward_f64(f64):
    fm, v, port = _flax_and_port(jnp.float64, torch.float64, np.float64)
    got, want = _forward_both(fm, v, port, _input(np.float64))
    assert got.dtype == want.dtype == np.float64
    assert np.abs(want).max() > 0.1  # O(1) outputs: the check is sharp
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_eval_forward_f32():
    fm, v, port = _flax_and_port(jnp.float32, torch.float32, np.float32)
    got, want = _forward_both(fm, v, port, _input(np.float32))
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)


def test_eval_forward_bf16():
    fm, v, port = _flax_and_port(jnp.bfloat16, torch.bfloat16, np.float32)
    got, want = _forward_both(fm, v, port, _input(np.float32))
    assert got.dtype == want.dtype == np.float32  # the head is promoted to f32
    scale = np.abs(want).max()
    assert scale > 0.1
    assert np.abs(got - want).max() <= 2e-2 * scale


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
    overrides = {"model.generator": "unet_128", "model.ngf": 4,
                 "dataset.images_size": 128, "mode.compute_dtype": slice_dtype}
    jcfg = jax_load_config("batvisionv2", "test", overrides=overrides)
    jtask = jax_make_task(jcfg)
    wave = np.random.default_rng(4).normal(scale=0.1, size=(2, 2, 7782)).astype(np.float32)
    variables = _randomize(_shapes(jtask.init, {"waveform": wave}), 5)
    want = np.asarray(jtask.predict_meters(variables["params"], variables["batch_stats"],
                                           {"waveform": wave}))

    task = make_task(load_config("batvisionv2", "test", overrides=overrides), device="cpu")
    task.model.load_state_dict(unet_state_dict_from_jax(
        variables["params"], variables["batch_stats"], num_downs=7), strict=True)
    got = task.predict_meters({"waveform": wave})
    assert got.shape == want.shape == (2, 128, 128, 1)
    assert str(got.dtype) == f"torch.{want.dtype}" == f"torch.{slice_dtype}"
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-10 if slice_dtype == "float64" else 5e-4)
    # a pre-computed NHWC input takes the same path after the front end
    assert torch.equal(task.predict_meters({"input": task.prepare({"waveform": wave})}), got)
