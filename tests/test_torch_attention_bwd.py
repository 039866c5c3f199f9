"""Kernel B3's plain version, the autograd Function around B2 and B3, and
the γ trap, on the CPU against the JAX package.

  * `flash_cross_attention_bwd_plain` against the Pallas backward kernel
    `_flash_bwd` run in interpret mode, at the shapes of
    tests/test_attention.py:69-106, in f32 at 1e-5 of the gradients' scale:
    both take the same o and lse (from the Pallas forward); the Pallas
    kernel folds scale·log2e into an f32 copy of q and sums in another
    order, about 1e-7 relative each;
  * the plain version against `jax.vjp` of the JAX package's
    `blockwise_cross_attention` in f64 at 1e-10, ragged N and M included
    (the same math in another order);
  * `torch.autograd.gradcheck` of `FlashCrossAttentionFn` in f64, and its
    gradients equal to autograd of the blockwise CPU path;
  * on a CPU tensor the B3 wrapper takes the plain version and launches
    nothing; bad shapes and dtypes raise; B3 is registered with its TPU
    kernel's file:line;
  * the γ trap: with γ = 0 the attention projections' gradients are exactly
    zero (so a wrong B3 would pass unseen), with γ ≠ 0 they are not.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import audiodepth_tpu.ops.pallas.flash_attention as jfa
from audiodepth_tpu.ops.attention import blockwise_cross_attention as jax_blockwise

from audiodepth_tpu_torch.models.binaural_attention import BinauralCrossAttention
from audiodepth_tpu_torch.ops.attention import blockwise_cross_attention
from audiodepth_tpu_torch.ops.cuda import KERNELS
from audiodepth_tpu_torch.ops.cuda import flash_attention as fa
from tests.test_torch_attention import PLAN_SHAPES, check_plan_limits


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


def _arrays(seed, shapes, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(dtype) for s in shapes)


@pytest.mark.parametrize("b,n,m,dk,dv,block_q,block_k", [
    (2, 128, 128, 16, 32, 32, 64),   # test_flash_bwd_kernel_interpret
    (2, 128, 128, 8, 32, 64, 32),    # test_flash_bwd_odd_head_dims_interpret, dk 8
    (2, 128, 128, 40, 32, 64, 32),   # ... dk 40
])
def test_bwd_plain_matches_pallas_interpret(b, n, m, dk, dv, block_q, block_k):
    q, k, v, do = _arrays(dk + dv, ((b, n, dk), (b, m, dk), (b, m, dv), (b, n, dv)))
    scale = 1.0 / 4.0
    o, lse = jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                            block_q=block_q, block_k=block_k, interpret=True)
    want = jfa._flash_bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, lse,
                          jnp.asarray(do), scale, block_q=block_q, block_k=block_k,
                          interpret=True)
    t = torch.from_numpy
    got = fa.flash_cross_attention_bwd_plain(t(q), t(k), t(v), t(np.asarray(o)),
                                             t(np.asarray(lse)), t(do), scale)
    for g, w, ref in zip(got, want, (q, k, v)):
        w = np.asarray(w)
        assert g.shape == ref.shape and g.dtype == torch.float32
        assert np.abs(w).max() > 0.1
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("b,n,m,dk,dv", [
    (2, 100, 77, 8, 24),     # ragged N and M, N > M
    (1, 33, 130, 40, 16),    # dk > dv, N < M
    (3, 64, 64, 16, 128),    # the level-2 head widths
])
def test_bwd_plain_matches_jax_vjp_f64(b, n, m, dk, dv, f64):
    q, k, v, do = _arrays(n + m, ((b, n, dk), (b, m, dk), (b, m, dv), (b, n, dv)),
                          np.float64)
    scale = 0.3
    _, vjp = jax.vjp(lambda q_, k_, v_: jax_blockwise(q_, k_, v_, scale, block_q=32),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    t = torch.from_numpy
    o, lse = fa.flash_cross_attention_fwd_plain(t(q), t(k), t(v), scale)
    got = fa.flash_cross_attention_bwd_plain(t(q), t(k), t(v), o, lse, t(do), scale,
                                             block_q=32)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-10)


def test_function_gradcheck_f64():
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _arrays(1, ((2, 9, 8), (2, 7, 8), (2, 7, 16)), np.float64))
    assert torch.autograd.gradcheck(
        lambda a, b_, c: fa.FlashCrossAttentionFn.apply(a, b_, c, 0.4), (q, k, v))


@pytest.mark.parametrize("dtype,atol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_function_matches_autograd_of_blockwise(dtype, atol):
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(
        5, ((2, 70, 16), (2, 50, 16), (2, 50, 24), (2, 70, 24)), np_dtype))
    grads = []
    for fn in (fa.cross_attention, blockwise_cross_attention):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves, 0.25)
        grads.append((out.detach(), torch.autograd.grad(out, leaves, do)))
    (o1, g1), (o2, g2) = grads
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), rtol=0, atol=atol)
    for a, b_ in zip(g1, g2):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=0, atol=atol)


def test_bwd_wrapper_cpu_goes_to_plain_version():
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(
        9, ((2, 30, 8), (2, 20, 8), (2, 20, 16), (2, 30, 16))))
    o, lse = fa.flash_cross_attention(q, k, v, 0.2)
    before = fa.flash_cross_attention_bwd.launches
    got = fa.flash_cross_attention_bwd(q, k, v, o, lse, do, 0.2)
    want = fa.flash_cross_attention_bwd_plain(q, k, v, o, lse, do, 0.2)
    assert fa.flash_cross_attention_bwd.launches == before
    assert all(torch.equal(a, b_) for a, b_ in zip(got, want))
    # under autograd, the CPU path goes through the same wrappers
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.cross_attention(*leaves, 0.2).backward(do)
    assert all(torch.equal(t.grad, w) for t, w in zip(leaves, want))
    assert fa.flash_cross_attention_bwd.launches == before


def _bad_bwd_inputs():
    q, k, v = torch.zeros(2, 8, 16), torch.zeros(2, 6, 16), torch.zeros(2, 6, 32)
    o, lse, do = torch.zeros(2, 8, 32), torch.zeros(2, 8, 1), torch.zeros(2, 8, 32)
    return [
        ((q, k, v, o[:, :4], lse, do), ValueError),              # o has the wrong N
        ((q, k, v, o, lse, do[..., :16]), ValueError),           # do has the wrong Dv
        ((q, k, v, o, lse[:, :, 0], do), ValueError),            # lse is not [B, N, 1]
        ((q, k, v, o, lse, do.double()), TypeError),             # do's dtype differs
        ((q, k[:1], v, o, lse, do), ValueError),                 # batch differs
    ]


@pytest.mark.parametrize("case", range(len(_bad_bwd_inputs())))
def test_bwd_wrapper_rejects_bad_input(case):
    args, err = _bad_bwd_inputs()[case]
    with pytest.raises(err):
        fa.flash_cross_attention_bwd(*args, 0.1)


def test_bwd_registered_and_nothing_built_on_import():
    entry = next(e for e in KERNELS if e[0] is fa.flash_cross_attention_bwd)
    assert entry[1] == "audiodepth_tpu_torch/csrc/flash_attention.cu"
    assert entry[2] == "audiodepth_tpu/ops/pallas/flash_attention.py:148"
    with open(jfa.__file__) as f:
        assert f.read().splitlines()[147].startswith("def _bwd_kernel(")
    assert fa._library.cache_info().currsize == 0


@pytest.mark.parametrize("gamma", [0.0, 0.7])
def test_gamma_trap(gamma):
    """γ = 0 sends do = 0 to B3, so every projection gradient is exactly 0;
    a non-zero γ is what makes a training check see the attention."""
    block = BinauralCrossAttention(16)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
        block.gamma.fill_(gamma)
    left, right = (torch.randn(2, 16, 4, 5, generator=gen) for _ in range(2))
    out_l, out_r = block(left, right)
    (out_l.square().sum() + out_r.square().sum()).backward()
    proj = {n: float(p.grad.abs().max()) for n, p in block.named_parameters()
            if n != "gamma"}
    assert len(proj) == 8
    if gamma == 0.0:
        assert all(g == 0.0 for g in proj.values()), proj
    else:
        assert all(g > 0.0 for g in proj.values()), proj
    assert float(block.gamma.grad.abs()) > 0.0  # γ itself always learns


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bwd_plan(shape, dtype):
    """B3's plan at every model level, the chip-smoke shapes and the edges:
    wgmma for bf16 (one warpgroup per 64 keys and all of dv ≤ 256, two
    warpgroups splitting dv above), f32 for f32; shared memory, grid and
    padding."""
    b, n, m, dk, dv = shape
    plan = fa.bwd_plan(b, n, m, dk, dv, getattr(torch, dtype))
    check_plan_limits(plan)
    if dtype == "float32":
        assert plan.variant == "f32" and plan.grid == (-(-m // 32), b, 1)
        return
    wgs = 1 if dv <= 256 else 2
    assert plan.variant == "wgmma" and plan.block == 128 * wgs and plan.n_slices == 1
    assert plan.grid == (-(-m // fa.TILE), b, 1)
    assert plan.dkp == min(w for w in (16, 32, 64) if w >= dk)
    # each warpgroup's dv padded to 64, by less than one 64-column sub-tile
    assert plan.dvs % 64 == 0 and plan.dvs <= 256
    assert dv <= plan.dvs * wgs < dv + 64 * wgs
    # the most stages (of 2, 1) that leave two blocks an SM
    assert plan.stages in (1, 2)
    assert plan.blocks_per_sm >= 2 or plan.stages == 1
