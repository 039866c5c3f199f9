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
    nothing;
  * B2's plan (`fwd_plan`, what the wrapper launches on the card) at every
    model level, the chip-smoke shapes and the accepted edges: its variant,
    shared memory, grid and padding;
  * the build hash (`_build.library_path`) changes with any header of
    `csrc/`, so an edited header is never served by a stale library.
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


# (2B, N, M, dk, dv): the binaural levels 2-5 at a batch of 16 and level 2 at
# a batch of 1, chip_smoke.py's other kernel shapes, and the accepted edges
PLAN_SHAPES = [
    (32, 16384, 16384, 16, 128), (32, 4096, 4096, 32, 256), (32, 1024, 1024, 64, 512),
    (32, 256, 256, 64, 512), (2, 16384, 16384, 16, 128),
    (4, 1000, 777, 32, 256), (2, 300, 200, 8, 64), (2, 333, 129, 40, 136),
    (2, 200, 150, 24, 320), (2, 1, 70, 16, 128),
    (1, 1, 1, 8, 8), (3, 1, 5000, 64, 512), (3, 5000, 1, 8, 8), (65535, 64, 64, 64, 8),
]
GRID_LIMITS = (2 ** 31 - 1, 65535, 65535)


def check_plan_limits(plan):
    """What every plan must hold on the card, whatever its variant."""
    assert plan.smem_bytes <= fa.SMEM_PER_BLOCK and plan.blocks_per_sm >= 1
    assert all(1 <= g <= lim for g, lim in zip(plan.grid, GRID_LIMITS))
    assert plan.block in (128, 256) and plan.stages >= 1


def check_fwd_bf16x3_plan(plan, dk, dv):
    """B2's float32 plan: the wgmma design on three bf16 pieces, q/k rows
    padded as in bf16, dv in slices of 64, and the most stages of
    FWD_BF16X3_STAGES that leave two blocks an SM (else the most that fit
    one)."""
    dkw, dvw = -(-dk // 8) * 8, -(-dv // 8) * 8
    assert plan.variant == "wgmma_bf16x3" and plan.code == 4 and plan.pieces == 3
    assert plan.block == 128 and plan.dkp == min(w for w in (16, 32, 64, 128) if w >= dkw)
    assert plan.dvs == 64 and plan.n_slices == -(-dvw // 64)
    assert plan.smem_bytes == fa._fwd_wgmma_bytes(plan.dkp, 64, plan.stages, 3)
    fits = {blocks: [st for st in fa.FWD_BF16X3_STAGES if blocks * (fa._fwd_wgmma_bytes(
        plan.dkp, 64, st, 3) + 1024) <= fa.SMEM_PER_SM] for blocks in (2, 1)}
    assert plan.stages == (fits[2] or fits[1])[0]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_fwd_plan(shape, dtype):
    b, n, m, dk, dv = shape
    plan = fa.fwd_plan(b, n, m, dk, dv, getattr(torch, dtype))
    check_plan_limits(plan)
    q_tiles = -(-n // fa.TILE)
    assert plan.grid == (q_tiles * plan.n_slices, b, 1)
    if dtype == "float32":
        check_fwd_bf16x3_plan(plan, dk, dv)
        return
    assert plan.variant == "wgmma" and plan.block == 128
    # q/k rows padded to one swizzle span; dv slices of ≤ 256 padded to 64,
    # by less than one 64-column sub-tile each
    assert plan.dkp == min(w for w in (16, 32, 64) if w >= dk)
    assert plan.dvs % 64 == 0 and plan.dvs <= 256
    assert dv <= plan.dvs * plan.n_slices < dv + 64 * plan.n_slices
    assert plan.n_slices == -(-dv // 256)
    # the most stages (of 3, 2) that leave two blocks an SM
    assert plan.stages in (2, 3)
    assert plan.blocks_per_sm >= 2 or plan.stages == 2


@pytest.mark.parametrize("suffix", ["cuh", "h"])
def test_build_hash_covers_headers(tmp_path, monkeypatch, suffix):
    """Editing a header alone changes the library's path, so `load` builds
    anew; nothing is compiled to find the path."""
    from audiodepth_tpu_torch.ops.cuda import _build

    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: pytest.fail("library_path must not compile"))
    (tmp_path / "kern.cu").write_text('#include "common.%s"\n' % suffix)
    header = tmp_path / f"common.{suffix}"
    header.write_text("// v1\n")
    first = _build.library_path("kern")
    assert _build.library_path("kern") == first  # stable
    header.write_text("// v2\n")
    edited = _build.library_path("kern")
    assert edited != first and edited.parent == _build.BUILD_DIR
    header.write_text("// v1\n")
    assert _build.library_path("kern") == first
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.library_path("kern") != first
    assert not list(tmp_path.glob("*.so"))


# ---------------------------------------------------------------------------
# every width the JAX package takes (the binaural levels of other bases)
# ---------------------------------------------------------------------------

BASES = (8, 16, 48, 96, 128)


def level_shape(base, level, batch=16):
    """(2B, N, M, dk, dv) of binaural level `level` of base `base` at 256²:
    C = 2c, 4c, 8c, 8c at levels 2-5, dk = C/8, dv = C, N = M = (256/2^(l-1))²."""
    c = {2: 2, 3: 4, 4: 8, 5: 8}[level] * base
    n = (256 >> (level - 1)) ** 2
    return 2 * batch, n, n, c // 8, c


def instantiated(pattern):
    """The template arguments csrc/flash_attention.cu instantiates, read from
    its launch switches."""
    import re
    from pathlib import Path

    src = (Path(fa.__file__).resolve().parents[2] / "csrc" / "flash_attention.cu").read_text()
    return {tuple(map(int, m if isinstance(m, tuple) else (m,)))
            for m in re.findall(pattern, src)}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("level", [2, 3, 4, 5])
@pytest.mark.parametrize("base", BASES)
def test_fwd_plan_every_width(base, level, dtype):
    b, n, m, dk, dv = level_shape(base, level)
    plan = fa.fwd_plan(b, n, m, dk, dv, getattr(torch, dtype))
    check_plan_limits(plan)
    dkw, dvw = -(-dk // 8) * 8, -(-dv // 8) * 8  # the wrapper's zero-padded widths
    if dtype == "float32":
        check_fwd_bf16x3_plan(plan, dk, dv)
        dkps = {p for (p,) in instantiated(r"launch_fwd_bf16x3<(\d+)>")}
        dvss = {s for (s,) in instantiated(r"launch_fwd_wgmma<DKP, (\d+), 3>")}
        assert plan.dkp in dkps and plan.dvs in dvss
        return
    assert plan.variant == "wgmma" and plan.dkp == min(w for w in (16, 32, 64, 128) if w >= dkw)
    assert dvw <= plan.dvs * plan.n_slices < dvw + 64 * plan.n_slices
    dkps = {p for (p,) in instantiated(r"launch_fwd_wgmma_dvs<(\d+)>")}
    dvss = {s for (s,) in instantiated(r"launch_fwd_wgmma<DKP, (\d+), 1>")}
    assert plan.dkp in dkps and plan.dvs in dvss


@pytest.mark.parametrize("shape", [level_shape(64, lv) for lv in (2, 3, 4, 5)],
                         ids=lambda s: "x".join(map(str, s)))
def test_base64_plans_unchanged(shape):
    """The main path's plans, as the parent design planned them."""
    want_fwd = {16384: (16, 128, 1, 3, 58400, 256), 4096: (32, 256, 1, 2, 78872, 64),
                1024: (64, 256, 2, 2, 91160, 32), 256: (64, 256, 2, 2, 91160, 8)}
    want_bwd = {16384: (16, 128, 2, 73752, 256, 128), 4096: (32, 256, 1, 99856, 64, 128),
                1024: (64, 256, 1, 206352, 16, 256), 256: (64, 256, 1, 206352, 4, 256)}
    b, n, m, dk, dv = shape
    dkp, dvs, n_slices, stages, smem, gx = want_fwd[n]
    assert fa.fwd_plan(*shape, torch.bfloat16) == fa.Plan(
        "wgmma", 1, dkp, dvs, n_slices, stages, smem, (gx, 32, 1), 128)
    dkp, dvs, stages, smem, gx, block = want_bwd[n]
    assert fa.bwd_plan(*shape, torch.bfloat16) == fa.Plan(
        "wgmma", 2, dkp, dvs, 1, stages, smem, (gx, 32, 1), block)


@pytest.mark.parametrize("shape", [level_shape(64, lv) for lv in (2, 3, 4, 5)],
                         ids=lambda s: "x".join(map(str, s)))
def test_base64_f32_plans(shape):
    """The main path's float32 plans (`--compute_dtype float32`): B2 on
    three pieces in dv slices of 64, B3's split design on three pieces in
    slices of 128, each with the stages its shared memory allows."""
    want_fwd = {16384: (16, 64, 2, 3, 99360, 512), 4096: (32, 64, 4, 2, 87064, 256),
                1024: (64, 64, 8, 1, 74768, 128), 256: (64, 64, 8, 1, 74768, 32)}
    want_bwd = {16384: (16, 128, 1, 1, 95768, 512, 1, 2), 4096: (32, 128, 2, 1, 108056, 192, 1, 1),
                1024: (64, 128, 4, 2, 231464, 80, 2, 2), 256: (64, 128, 4, 2, 231464, 20, 2, 2)}
    b, n, m, dk, dv = shape
    dkp, dvs, n_slices, stages, smem, gx = want_fwd[n]
    assert fa.fwd_plan(*shape, torch.float32) == fa.Plan(
        "wgmma_bf16x3", 4, dkp, dvs, n_slices, stages, smem, (gx, 32, 1), 128, pieces=3)
    dkp, dvs, n_slices, stages, smem, gx, chunk_stages, dq_bufs = want_bwd[n]
    assert fa.bwd_plan(*shape, torch.float32) == fa.Plan(
        "split_bf16x3", 5, dkp, dvs, n_slices, stages, smem, (gx, 32, 1), 128, chunk_stages,
        dq_bufs, 3)


@pytest.mark.parametrize("dk,dv", [(4, 32), (12, 96), (12, 36), (100, 20), (2, 16)])
def test_padding_helper_matches_plain_f64(dk, dv):
    """`fwd_padded` / `bwd_padded` (zero columns to a multiple of 8, cut
    back) around the plain versions give the plain versions' own answer."""
    rng = np.random.default_rng(dk * 1000 + dv)
    q, k, v = (torch.from_numpy(rng.normal(size=s)) for s in ((2, 70, dk), (2, 50, dk), (2, 50, dv)))
    do = torch.from_numpy(rng.normal(size=(2, 70, dv)))
    scale = 1.0 / np.sqrt(dk)
    o, lse = fa.fwd_padded(fa.flash_cross_attention_fwd_plain, q, k, v, scale)
    want_o, want_lse = fa.flash_cross_attention_fwd_plain(q, k, v, scale)
    assert o.shape == want_o.shape and o.is_contiguous()
    np.testing.assert_allclose(o.numpy(), want_o.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), rtol=0, atol=1e-12)
    got = fa.bwd_padded(fa.flash_cross_attention_bwd_plain, q, k, v, want_o, want_lse, do, scale)
    want = fa.flash_cross_attention_bwd_plain(q, k, v, want_o, want_lse, do, scale)
    for a, w in zip(got, want):
        assert a.shape == w.shape and a.is_contiguous()
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=0, atol=1e-12)


def test_padding_helper_matches_pallas_interpret():
    """At dk 4 and dv 12 the padded plain forward gives the TPU kernel's
    answer (which pads to 128 lanes itself), f32 at 1e-5 as above."""
    q, k, v = _qkv(11, 2, 96, 64, 4, 12)
    scale = 0.5
    want_o, want_lse = jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                                      block_q=32, block_k=32, interpret=True)
    got_o, got_lse = fa.fwd_padded(fa.flash_cross_attention_fwd_plain, torch.from_numpy(q),
                                   torch.from_numpy(k), torch.from_numpy(v), scale)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), rtol=0, atol=1e-5)


@pytest.mark.parametrize("base", BASES)
def test_kernel_check_takes_every_level_width(base):
    """`_check_kernel_inputs` refuses none of the padded widths of the
    binaural levels (on a stand-in for CUDA tensors), and only dk > 128."""
    from types import SimpleNamespace

    def cuda_like(*shape):
        return SimpleNamespace(device=torch.device("cuda", 0), dtype=torch.bfloat16, shape=shape,
                               is_contiguous=lambda: True, data_ptr=lambda: 0)

    for level in (2, 3, 4, 5):
        b, n, m, dk, dv = level_shape(base, level)
        dkw, dvw = -(-dk // 8) * 8, -(-dv // 8) * 8
        fa._check_kernel_inputs((cuda_like(b, n, dkw), cuda_like(b, m, dkw),
                                 cuda_like(b, m, dvw)), dkw)
    with pytest.raises(ValueError, match="up to 128"):
        fa._check_kernel_inputs((cuda_like(2, 8, 136),), 136)


@pytest.mark.parametrize("tool,source", [("flash_ablation", "flash_attention.cu"),
                                         ("frontend_ablation", "fused_frontend.cu")])
def test_ablation_patches_match_once(tool, source):
    """The ablation tools patch the kernel sources by text and stop on a
    patch that does not match exactly once: every patch still does."""
    import importlib
    from pathlib import Path

    mod = importlib.import_module(f"audiodepth_tpu_torch.tools.{tool}")
    src = (Path(fa.__file__).resolve().parents[2] / "csrc" / source).read_text()
    for name, patches in mod.VARIANTS.items():
        for old, _ in patches:
            assert src.count(old) == 1, (name, old)
