"""The port's cross-attention (kernel B2's plain version, the blockwise CPU
path and the wrapper's dispatch) against the JAX package.

  * `flash_cross_attention_fwd_plain` against the Pallas forward kernel
    `_flash_fwd` run in interpret mode, o and lse, in f32 at 1e-5: several
    q- and k-blocks, dk ≠ dv, N ≠ M, dk = 8 and 40. The Pallas kernel folds
    scale·log2e into an f32 copy of q and sums in another order; those are
    the only differences, each about 1e-7 relative;
  * the plain version against the port's `blockwise_cross_attention` in f64
    at 1e-12 (the same math, another order of operations);
  * the port's `blockwise_cross_attention` against the JAX package's, in
    f64 at 1e-12 and f32 at 1e-5;
  * the wrapper takes the plain version for a CPU tensor and launches
    nothing, and so does the model's dispatch `cross_attention` (through
    FlashCrossAttentionFn); bad shapes and dtypes raise; importing it builds
    nothing.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import audiodepth_tpu.ops.pallas.flash_attention as jfa
from audiodepth_tpu.ops.attention import blockwise_cross_attention as jax_blockwise

from audiodepth_tpu_torch.ops.attention import blockwise_cross_attention
from audiodepth_tpu_torch.ops.cuda import KERNELS
from audiodepth_tpu_torch.ops.cuda import flash_attention as fa


@pytest.fixture
def f64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _qkv(seed, b, n, m, dk, dv, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(dtype)
                 for s in ((b, n, dk), (b, m, dk), (b, m, dv)))


@pytest.mark.parametrize("b,n,m,dk,dv,block_q,block_k", [
    (2, 128, 96, 8, 24, 64, 32),     # 2 q-blocks x 3 k-blocks, dk = 8
    (1, 64, 128, 40, 16, 32, 64),    # dk = 40 > dv, N < M
    (3, 96, 64, 16, 128, 32, 16),    # the level-2 head widths, 4 k-blocks
])
def test_plain_matches_pallas_interpret(b, n, m, dk, dv, block_q, block_k):
    q, k, v = _qkv(n + m + dk, b, n, m, dk, dv)
    scale = 1.0 / np.sqrt(dv)
    want_o, want_lse = jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                                      block_q=block_q, block_k=block_k, interpret=True)
    got_o, got_lse = fa.flash_cross_attention_fwd_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale)
    assert got_o.shape == (b, n, dv) and got_o.dtype == torch.float32
    assert got_lse.shape == (b, n, 1) and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), rtol=0, atol=1e-5)


@pytest.mark.parametrize("block_q", [16, 50, 1024])
def test_plain_matches_blockwise_f64(block_q):
    q, k, v = (torch.from_numpy(a) for a in _qkv(7, 2, 100, 77, 8, 24, np.float64))
    o, lse = fa.flash_cross_attention_fwd_plain(q, k, v, 0.3, block_q=block_q)
    assert o.dtype == lse.dtype == torch.float64
    want = blockwise_cross_attention(q, k, v, 0.3, block_q=block_q)
    np.testing.assert_allclose(o.numpy(), want.numpy(), rtol=0, atol=1e-12)
    s = torch.einsum("bnd,bmd->bnm", q, k) * 0.3
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1, keepdim=True).numpy(),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype,atol", [("float64", 1e-12), ("float32", 1e-5)])
def test_blockwise_matches_jax(dtype, atol, f64):
    q, k, v = _qkv(3, 2, 130, 90, 16, 40, np.dtype(dtype))
    want = np.asarray(jax_blockwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.25,
                                    block_q=64))
    got = blockwise_cross_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), 0.25, block_q=64)
    assert str(got.dtype) == f"torch.{want.dtype}" == f"torch.{dtype}"
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


def test_blockwise_bf16_keeps_fp32_statistics():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(5, 1, 64, 48, 8, 16))
    got = blockwise_cross_attention(q, k, v, 0.5)
    assert got.dtype == torch.bfloat16
    want = torch.softmax(q.float() @ k.float().transpose(1, 2) * 0.5, -1) @ v.float()
    # only the output is rounded to bf16: half an ulp of 2^-8
    assert float((got.float() - want).abs().max()) <= 2 ** -8 * float(want.abs().max())


def test_wrapper_cpu_goes_to_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv(9, 2, 70, 50, 8, 16))
    before = fa.flash_cross_attention.launches
    o, lse = fa.flash_cross_attention(q, k, v, 0.2)
    want_o, want_lse = fa.flash_cross_attention_fwd_plain(q, k, v, 0.2)
    assert fa.flash_cross_attention.launches == before
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    # the model's dispatch: FlashCrossAttentionFn over the plain version on the CPU
    assert torch.equal(fa.cross_attention(q, k, v, 0.2), want_o)
    assert fa.flash_cross_attention.launches == before


def _bad_inputs():
    q, k, v = torch.zeros(2, 8, 16), torch.zeros(2, 6, 16), torch.zeros(2, 6, 32)
    return [
        ((q[0], k, v), ValueError),                              # not [B, N, Dk]
        ((q, torch.zeros(2, 6, 8), v), ValueError),              # Dk of q ≠ Dk of k
        ((q, k, torch.zeros(2, 5, 32)), ValueError),             # M of k ≠ M of v
        ((q, k, torch.zeros(3, 6, 32)), ValueError),             # batch differs
        ((torch.zeros(2, 0, 16), k, v), ValueError),             # empty
        ((q, k, v.double()), TypeError),                         # mixed dtypes
    ]


@pytest.mark.parametrize("case", range(len(_bad_inputs())))
def test_wrapper_rejects_bad_input(case):
    args, err = _bad_inputs()[case]
    with pytest.raises(err):
        fa.flash_cross_attention(*args, 0.1)


def test_registered_and_nothing_built_on_import():
    assert any(w is fa.flash_cross_attention for w, _, _ in KERNELS)
    entry = next(e for e in KERNELS if e[0] is fa.flash_cross_attention)
    assert entry[1] == "audiodepth_tpu_torch/csrc/flash_attention.cu"
    assert entry[2] == "audiodepth_tpu/ops/pallas/flash_attention.py:103"
    with open(jfa.__file__) as f:
        assert f.read().splitlines()[102].startswith("def _fwd_kernel(")
    assert fa._library.cache_info().currsize == 0
