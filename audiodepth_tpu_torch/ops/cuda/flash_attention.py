"""Flash cross-attention: wrappers of the CUDA kernels in
`csrc/flash_attention.cu`, the forward (kernel B2) and the backward (kernel
B3), their plain PyTorch versions, and the autograd Function that joins them
(port of `ops/pallas/flash_attention.py`).

    o   = softmax(q·kᵀ·scale)·v          [B, N, Dv], in the input dtype
    lse = log Σ_m exp(q·kᵀ·scale)        [B, N, 1], natural log
    dq, dk, dv from do and the saved q, k, v, o, lse (B3)

q [B, N, Dk], k [B, M, Dk], v [B, M, Dv].

`cross_attention` is the dispatch the model calls: every call goes through
the registered op `audiodepth::flash_cross_attention_fwd`, whose backward
(`register_autograd`) is the op `audiodepth::flash_cross_attention_bwd`.
Their CUDA implementations are the wrappers (B2, B3, counted), their CPU
implementations the plain versions, and their fakes give the shapes without
touching the library, so `torch.export` traces the model. On a CUDA tensor
a wrapper launches its kernel or raises; nothing falls back. The JAX package
sent N, M ≤ 256 to XLA because of the TPU's per-grid-step overhead, which
has no counterpart here, so the kernels take every shape.

Widths: the kernels take every dk up to MAX_HEAD_DK and every dv, as the
TPU kernel (which zero-pads to 128 lanes) does. A TMA row stride must be a
multiple of 16 bytes, so the wrapper zero-pads q and k (and v, o, do) to a
width that is a multiple of 8 (`_aligned`, `fwd_padded`, `bwd_padded`):
zero columns change no score and no product, the softmax scale stays the
caller's, and the outputs are cut back to the caller's widths.

Which kernel design runs, with which tiles, is decided by shape alone in
`fwd_plan` / `bwd_plan` (pure Python, tested on the CPU); the wrappers
launch what the plan says and the C entry points check it against the
kernels' own layouts:
  B2 bf16: "wgmma" (wgmma + TMA, one warpgroup per 64 q rows and a dv slice
           of ≤ 256 columns; q/k rows padded to dkp 16, 32, 64 or 128);
           B2 f32: "wgmma_bf16x3" (the same design on three bf16 pieces of
           each fp32 operand, six piece products a product; dv slices of
           64, the stages by shared memory).
  B3 bf16: "wgmma" for dkp ≤ 64 and dv ≤ 512 (one warpgroup per 64 keys and
           all of dv ≤ 256, two warpgroups sharing dv above; dq by bulk
           reduce-add); "split" beyond (dkp 128 or dv > 512: per key tile,
           one block per dv slice of ≤ 256 adds dV, and one block adds dK
           and dQ, taking dPᵀ over dv in chunks of 64, so that no block
           holds both dK and dV in registers); B3 f32: "split_bf16x3" (the
           split design on the pieces at every width, dv slices of ≤ 128).

In f32 the C call first splits q, k, v (and do) into a bf16 scratch buffer
of three pieces each (`_pieces`), which the wrapper allocates.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Tuple

import torch

from ..attention import score_blocks
from ._build import Launcher, cdiv, device_args

SOURCE = "audiodepth_tpu_torch/csrc/flash_attention.cu"
# the TPU kernels these replace (file:line of `_fwd_kernel` and `_bwd_kernel`)
REPLACES = "audiodepth_tpu/ops/pallas/flash_attention.py:103"
REPLACES_BWD = "audiodepth_tpu/ops/pallas/flash_attention.py:148"
MAX_HEAD_DK = 128  # the kernels' largest q/k width: dkp 128 (dv has no limit)

# shared memory of an H100 SM and the most one block may take (opt-in), and
# what the runtime keeps of it for each resident block
SMEM_PER_SM = 233472
SMEM_PER_BLOCK = 232448
SMEM_RESERVED_PER_BLOCK = 1024
TILE = 64  # q rows and keys a tile, the wgmma's M


@dataclass(frozen=True)
class Plan:
    """How one kernel call runs: the design (`variant`, with `code` its
    number in the C entry point), q/k width padded to `dkp`, the dv tile
    width `dvs` of one warpgroup (wgmma: ≤ 256, a multiple of 64; B2's
    `n_slices` blocks, B3's `block // 128` warpgroups cover dv), the ring's
    `stages`, the dynamic shared memory in bytes, the grid and the block;
    B3's split designs also the stages of their V/dO chunk ring and their
    fp32 dq tile buffers. `pieces` is 3 where fp32 operands go in as three
    bf16 pieces, else 1."""

    variant: str
    code: int
    dkp: int
    dvs: int
    n_slices: int
    stages: int
    smem_bytes: int
    grid: Tuple[int, int, int]
    block: int
    chunk_stages: int = 0
    dq_bufs: int = 0
    pieces: int = 1

    @property
    def blocks_per_sm(self) -> int:
        """Resident blocks an SM's shared memory allows."""
        return SMEM_PER_SM // (self.smem_bytes + SMEM_RESERVED_PER_BLOCK)


def _aligned(width: int) -> int:
    """The width a row is zero-padded to: a multiple of 8 elements, so that
    a bf16 row is whole 16-byte units (TMA's stride rule)."""
    return 8 * cdiv(width, 8)


def _wgmma_dkp(dk: int) -> int:
    """q/k rows are one swizzle span of 32, 64 or 128 bytes, or at dk > 64
    two 128-byte boxes."""
    return 16 if dk <= 16 else 32 if dk <= 32 else 64 if dk <= 64 else 128


def _fwd_wgmma_bytes(dkp: int, dvs: int, stages: int, pieces: int = 1) -> int:
    # Q tile, `stages` K and V tiles (each as `pieces` pieces), 1 + stages
    # mbarriers, 1 KB of alignment slack (csrc/flash_attention.cu: fwd_layout)
    bar = pieces * (TILE * dkp * 2 + stages * TILE * (dkp + dvs) * 2)
    return bar + 8 * (1 + stages) + 1024


def _bwd_wgmma_bytes(dkp: int, dvt: int, dk: int, stages: int, wgs: int) -> int:
    # K, V (dvt columns), `stages` Q and dO tiles, dSᵀ, two fp32 dq tiles,
    # with two warpgroups the fp32 dPᵀ exchange, `stages` lse/D tiles, 1 +
    # stages mbarriers, alignment slack (bwd_wg_layout)
    bar = (TILE * (dkp + dvt) * 2 + stages * TILE * (dkp + dvt) * 2 + TILE * TILE * 2
           + 2 * TILE * dk * 4 + (TILE * TILE * 4 if wgs == 2 else 0) + stages * 2 * TILE * 4)
    return bar + 8 * (1 + stages) + 1024


def _bwd_split_bytes(dkp: int, dvs: int, dk: int, stages: int, chunk_stages: int = 2,
                     dq_bufs: int = 2, pieces: int = 1) -> int:
    # K, `stages` Q tiles, then the larger of a dV block's `stages` dO slices
    # and a dK/dQ block's ring of `chunk_stages` V/dO chunks, dSᵀ and
    # `dq_bufs` fp32 dq tiles; every bf16 tile as `pieces` pieces; `stages`
    # lse/D tiles, 1 + stages + chunk_stages mbarriers, alignment slack
    # (bwd_split_layout)
    x_off = pieces * TILE * dkp * 2 * (1 + stages)
    dq_end = (x_off + pieces * (chunk_stages * 2 * TILE * 64 * 2 + TILE * TILE * 2)
              + dq_bufs * TILE * dk * 4)
    stat_off = max(x_off + stages * pieces * TILE * dvs * 2, dq_end)
    return stat_off + stages * 2 * TILE * 4 + 8 * (1 + stages + chunk_stages) + 1024


def _most_stages(bytes_of, options) -> int:
    """The most stages that leave two blocks an SM, else the fewest."""
    for stages in options:
        if 2 * (bytes_of(stages) + SMEM_RESERVED_PER_BLOCK) <= SMEM_PER_SM:
            return stages
    return options[-1]


def _first_fit(options, bytes_of):
    """The first of `options` whose shared memory leaves two blocks an SM,
    else the first that fits one block."""
    for blocks in (2, 1):
        for option in options:
            smem = bytes_of(option)
            if (smem <= SMEM_PER_BLOCK
                    and blocks * (smem + SMEM_RESERVED_PER_BLOCK) <= SMEM_PER_SM):
                return option, smem
    raise ValueError("no tiling fits the card's shared memory")


def _slices(dv: int, most: int) -> Tuple[int, int]:
    """(n_slices, slice width): dv in the fewest slices of ≤ `most`
    columns, each padded to a multiple of 64."""
    n_slices = cdiv(dv, most)
    return n_slices, TILE * cdiv(cdiv(dv, n_slices), TILE)


# fp32 as three bf16 pieces triples every tile in shared memory: B2's
# stages and B3's split design's (stages, chunk stages, dq buffers), in
# order of preference; B2's dv slices of 64 columns (its registers hold O,
# a tile's P·V, S and P's pieces), B3's of ≤ 128 (a dV block's registers)
FWD_BF16X3_STAGES = (3, 2, 1)
BWD_BF16X3_TILINGS = ((2, 2, 2), (2, 1, 2), (1, 1, 2), (1, 1, 1))
FWD_BF16X3_DV_SLICE, BWD_BF16X3_DV_SLICE = 64, 128


def fwd_plan(b: int, n: int, m: int, dk: int, dv: int, dtype: torch.dtype) -> Plan:
    """B2's design and tiles for q [b, n, dk], k [b, m, dk], v [b, m, dv]
    (at the widths the wrapper pads them to)."""
    dk, dv = _aligned(dk), _aligned(dv)
    q_tiles = cdiv(n, TILE)
    dkp = _wgmma_dkp(dk)
    if dtype == torch.float32:
        n_slices, dvs = _slices(dv, FWD_BF16X3_DV_SLICE)
        stages, smem = _first_fit(FWD_BF16X3_STAGES, lambda st: _fwd_wgmma_bytes(dkp, dvs, st, 3))
        return Plan("wgmma_bf16x3", 4, dkp, dvs, n_slices, stages, smem,
                    (q_tiles * n_slices, b, 1), 128, pieces=3)
    n_slices, dvs = _slices(dv, 256)
    stages = _most_stages(lambda s: _fwd_wgmma_bytes(dkp, dvs, s), (3, 2))
    return Plan("wgmma", 1, dkp, dvs, n_slices, stages, _fwd_wgmma_bytes(dkp, dvs, stages),
                (q_tiles * n_slices, b, 1), 128)


def bwd_plan(b: int, n: int, m: int, dk: int, dv: int, dtype: torch.dtype) -> Plan:
    """B3's design and tiles for the same shapes."""
    dk, dv = _aligned(dk), _aligned(dv)
    dkp = _wgmma_dkp(dk)
    if dtype == torch.float32:
        # the split design at every width, on three pieces
        n_slices, dvs = _slices(dv, BWD_BF16X3_DV_SLICE)
        (stages, chunk_stages, dq_bufs), smem = _first_fit(
            BWD_BF16X3_TILINGS, lambda o: _bwd_split_bytes(dkp, dvs, dk, *o, pieces=3))
        return Plan("split_bf16x3", 5, dkp, dvs, n_slices, stages, smem,
                    (cdiv(m, TILE) * (n_slices + 1), b, 1), 128, chunk_stages, dq_bufs, 3)
    if dkp > 64 or dv > 512:
        # the split design: dV blocks per dv slice of ≤ 256 beside a dK/dQ
        # block per key tile (their registers hold dV or dK, never both)
        n_slices, dvs = _slices(dv, 256)
        return Plan("split", 3, dkp, dvs, n_slices, 2, _bwd_split_bytes(dkp, dvs, dk, 2),
                    (cdiv(m, TILE) * (n_slices + 1), b, 1), 128, 2, 2)
    wgs = 1 if dv <= 256 else 2  # one warpgroup's registers hold 256 fp32 columns of dv
    dvs = TILE * cdiv(cdiv(dv, wgs), TILE)
    stages = _most_stages(lambda s: _bwd_wgmma_bytes(dkp, dvs * wgs, dk, s, wgs), (2, 1))
    return Plan("wgmma", 2, dkp, dvs, 1, stages, _bwd_wgmma_bytes(dkp, dvs * wgs, dk, stages, wgs),
                (cdiv(m, TILE), b, 1), 128 * wgs)


def flash_cross_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                    scale: float, block_q: int = 1024
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: (o in v.dtype, natural-log lse [B, N, 1]).

    Blockwise over q; scores, softmax statistics and the value product in
    `promote_types(dtype, float32)` (f64 stays f64, and so does its lse).
    """
    vv = v.to(torch.promote_types(q.dtype, torch.float32))
    outs, lses = [], []
    for _, s in score_blocks(q, k, scale, block_q):
        lse = torch.logsumexp(s, dim=-1, keepdim=True)
        outs.append(torch.matmul(torch.exp(s - lse), vv))
        lses.append(lse)
    return torch.cat(outs, dim=1).to(v.dtype), torch.cat(lses, dim=1)


def flash_cross_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                    o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                                    scale: float, block_q: int = 1024
                                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the backward: (dq, dk, dv) in the input
    dtypes, written out blockwise over q (no autograd graph of the forward,
    whose per-block scores would not fit at level 2).

    p is recomputed from lse, then D = rowsum(do⊙o), dp = do·vᵀ,
    ds = p⊙(dp − D), dv += pᵀ·do, dk += dsᵀ·q·scale and dq = ds·k·scale,
    all in `promote_types(dtype, float32)`.
    """
    acc = torch.promote_types(q.dtype, torch.float32)
    vv, dd, qq, kk = v.to(acc), do.to(acc), q.to(acc), k.to(acc)
    dsum = (dd * o.to(acc)).sum(-1, keepdim=True)
    dq = torch.empty(q.shape, dtype=acc, device=q.device)
    dk = torch.zeros(k.shape, dtype=acc, device=q.device)
    dv = torch.zeros(v.shape, dtype=acc, device=q.device)
    for rows, s in score_blocks(q, k, scale, block_q):
        p = torch.exp(s - lse[:, rows].to(acc))
        dv += torch.matmul(p.transpose(1, 2), dd[:, rows])
        ds = p * (torch.matmul(dd[:, rows], vv.transpose(1, 2)) - dsum[:, rows])
        dk += torch.matmul(ds.transpose(1, 2), qq[:, rows])
        dq[:, rows] = torch.matmul(ds, kk)
    return (dq.mul_(scale).to(q.dtype), dk.mul_(scale).to(k.dtype), dv.to(v.dtype))


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Tuple[int, ...]:
    """(B, N, M, Dk, Dv) of q [B, N, Dk], k [B, M, Dk], v [B, M, Dv]."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be [B, N, Dk], [B, M, Dk], [B, M, Dv]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, n, dk = q.shape
    m, dv = v.shape[1], v.shape[2]
    if k.shape != (b, m, dk) or v.shape[0] != b or min(b, n, m, dk, dv) == 0:
        raise ValueError("q, k, v must be [B, N, Dk], [B, M, Dk], [B, M, Dv]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v lie on {q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v must share a dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    return b, n, m, dk, dv


def _check_kernel_inputs(tensors, dk: int) -> None:
    """What the kernels take on the card, beyond matching shapes (the
    widths already padded to multiples of 8)."""
    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the kernel takes bfloat16 or float32, got {q.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel's inputs must be contiguous")
    if dk > MAX_HEAD_DK:
        raise ValueError(f"the kernel takes Dk up to {MAX_HEAD_DK}; got Dk={dk}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the kernel's inputs must start on a 16-byte boundary")
    if q.shape[0] > 65535:
        raise ValueError(f"the kernel's grid takes at most 65535 batch rows, got {q.shape[0]}")


def _pad_cols(t: torch.Tensor, width: int) -> torch.Tensor:
    """t with zero columns appended up to `width` (a new contiguous tensor),
    or t itself."""
    return t if t.shape[-1] == width else torch.nn.functional.pad(t, (0, width - t.shape[-1]))


def _cut_cols(t: torch.Tensor, width: int) -> torch.Tensor:
    return t if t.shape[-1] == width else t[..., :width].contiguous()


def fwd_padded(launch, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`launch(q, k, v, scale)` → (o, lse) on q and k zero-padded to an
    aligned width and v likewise, with o cut back to v's width."""
    dkw, dv = _aligned(q.shape[-1]), v.shape[-1]
    o, lse = launch(_pad_cols(q, dkw), _pad_cols(k, dkw), _pad_cols(v, _aligned(dv)), scale)
    return _cut_cols(o, dv), lse


def bwd_padded(launch, q, k, v, o, lse, do, scale: float):
    """`launch(q, k, v, o, lse, do, scale)` → (dq, dk, dv) on every operand
    zero-padded as in `fwd_padded` (o and do like v), with the gradients cut
    back to the caller's widths."""
    dk, dv = q.shape[-1], v.shape[-1]
    dkw, dvw = _aligned(dk), _aligned(dv)
    dq, dk_, dv_ = launch(_pad_cols(q, dkw), _pad_cols(k, dkw), _pad_cols(v, dvw),
                          _pad_cols(o, dvw), lse, _pad_cols(do, dvw), scale)
    return _cut_cols(dq, dk), _cut_cols(dk_, dk), _cut_cols(dv_, dv)


def _plan_args(plan: Plan):
    return plan.code, plan.dkp, plan.dvs, plan.block, plan.stages, plan.smem_bytes, plan.grid[0]


def _pieces(plan: Plan, *operands: torch.Tensor):
    """The bf16 scratch buffer a call on three pieces splits its fp32
    operands into (three elements for each of theirs), or None in bf16."""
    if plan.pieces == 1:
        return None
    return torch.empty(3 * sum(t.numel() for t in operands), dtype=torch.bfloat16,
                       device=operands[0].device)


def _ptr(t):
    return None if t is None else t.data_ptr()


class FlashCrossAttention(Launcher):
    """Callable wrapper of kernel B2; `launches` counts kernel launches and
    `variant_launches` the same launches by the plan's variant."""

    name = "flash_cross_attention_fwd"

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
        _check_qkv(q, k, v)
        if q.device.type == "cpu":
            return flash_cross_attention_fwd_plain(q, k, v, scale)
        return fwd_padded(self._launch, q, k, v, scale)

    def _launch(self, q, k, v, scale):
        b, n, m, dk, dv = _check_qkv(q, k, v)
        _check_kernel_inputs((q, k, v), dk)
        plan = fwd_plan(b, n, m, dk, dv, q.dtype)
        o = torch.empty((b, n, dv), dtype=q.dtype, device=q.device)
        lse = torch.empty((b, n, 1), dtype=torch.float32, device=q.device)
        pieces = _pieces(plan, q, k, v)
        err = self.library().adepth_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            _ptr(pieces), b, n, m, dk, dv, float(scale), *_plan_args(plan),
            *device_args(q.device))
        self._check(err, plan.variant)
        return o, lse


class FlashCrossAttentionBwd(Launcher):
    """Callable wrapper of kernel B3: (q, k, v, o, lse, do, scale) →
    (dq, dk, dv); `launches` counts kernel launches (one a call) and
    `variant_launches` the same by the plan's variant.

    D = rowsum(do⊙o) in fp32: a small kernel of B3
    (`flash_bwd_prep_kernel`, launched by the same C call) writes it with
    lse·log2e into a padded [B, q_tiles, 2, 64] buffer, from bf16 or fp32 o
    and do. dq accumulates in a zeroed fp32 buffer that is cast to q's
    dtype afterwards."""

    name = "flash_cross_attention_bwd"

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                 lse: torch.Tensor, do: torch.Tensor, scale: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        b, n, m, dk, dv = _check_qkv(q, k, v)
        if o.shape != (b, n, dv) or do.shape != (b, n, dv) or lse.shape != (b, n, 1):
            raise ValueError(f"o, do must be {(b, n, dv)} and lse {(b, n, 1)}; got "
                             f"{tuple(o.shape)}, {tuple(do.shape)}, {tuple(lse.shape)}")
        if not (o.device == do.device == lse.device == q.device):
            raise ValueError(f"o, lse, do lie on {o.device}, {lse.device}, {do.device}, "
                             f"q on {q.device}")
        if o.dtype != q.dtype or do.dtype != q.dtype:
            raise TypeError(f"o and do must be {q.dtype}, got {o.dtype}, {do.dtype}")
        if q.device.type == "cpu":
            return flash_cross_attention_bwd_plain(q, k, v, o, lse, do, scale)
        if lse.dtype != torch.float32:
            raise TypeError(f"lse must be float32, got {lse.dtype}")
        return bwd_padded(self._launch, q, k, v, o.contiguous(), lse, do.contiguous(), scale)

    def _launch(self, q, k, v, o, lse, do, scale):
        b, n, m, dk, dv = _check_qkv(q, k, v)
        _check_kernel_inputs((q, k, v, do, o, lse), dk)
        plan = bwd_plan(b, n, m, dk, dv, q.dtype)
        stat = torch.empty((b, cdiv(n, TILE), 2, TILE), dtype=torch.float32, device=q.device)
        pieces = _pieces(plan, q, k, v, do)
        dq = torch.zeros((b, n, dk), dtype=torch.float32, device=q.device)
        dk_out = torch.empty_like(k)
        dv_out = torch.empty_like(v)
        err = self.library().adepth_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), o.data_ptr(),
            lse.data_ptr(), stat.data_ptr(), _ptr(pieces), dq.data_ptr(), dk_out.data_ptr(),
            dv_out.data_ptr(), b, n, m, dk, dv, float(scale), *_plan_args(plan),
            plan.chunk_stages, plan.dq_bufs, *device_args(q.device))
        self._check(err, plan.variant)
        return dq.to(q.dtype), dk_out, dv_out


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a library built from
    `csrc/flash_attention.cu` on it."""
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    plan = [i, i, i, i, i, ll, i]  # _plan_args
    lib.adepth_flash_attention_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, f, *plan, i, p]
    lib.adepth_flash_attention_fwd.restype = i
    lib.adepth_flash_attention_bwd.argtypes = [p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i,
                                               f, *plan, i, i, i, p]
    lib.adepth_flash_attention_bwd.restype = i
    lib.adepth_flash_layout_probe.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.adepth_flash_layout_probe.restype = i
    lib.adepth_cuda_error_string.argtypes = [i]
    lib.adepth_cuda_error_string.restype = ctypes.c_char_p
    return lib


flash_cross_attention = FlashCrossAttention()
flash_cross_attention_bwd = FlashCrossAttentionBwd()


# ---- the registered ops ---------------------------------------------------------


@torch.library.custom_op("audiodepth::flash_cross_attention_fwd", mutates_args=(),
                         device_types="cuda")
def flash_cross_attention_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """B2 as a PyTorch op: (o, lse); on CUDA tensors, the kernel through
    `flash_cross_attention`."""
    return flash_cross_attention(q, k, v, scale)


@flash_cross_attention_fwd_op.register_kernel("cpu")
def _fwd_cpu(q, k, v, scale):
    _check_qkv(q, k, v)
    return flash_cross_attention_fwd_plain(q, k, v, scale)


@flash_cross_attention_fwd_op.register_fake
def _fwd_fake(q, k, v, scale):
    b, n, _, _, dv = _check_qkv(q, k, v)
    return (q.new_empty((b, n, dv), dtype=v.dtype),
            q.new_empty((b, n, 1), dtype=torch.promote_types(q.dtype, torch.float32)))


@torch.library.custom_op("audiodepth::flash_cross_attention_bwd", mutates_args=(),
                         device_types="cuda")
def flash_cross_attention_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                                 scale: float
                                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B3 as a PyTorch op: (dq, dk, dv); on CUDA tensors, the kernel through
    `flash_cross_attention_bwd`."""
    return flash_cross_attention_bwd(q, k, v, o, lse, do, scale)


@flash_cross_attention_bwd_op.register_kernel("cpu")
def _bwd_cpu(q, k, v, o, lse, do, scale):
    return flash_cross_attention_bwd(q, k, v, o, lse, do, scale)  # checks, then plain


@flash_cross_attention_bwd_op.register_fake
def _bwd_fake(q, k, v, o, lse, do, scale):
    _check_qkv(q, k, v)
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _setup_context(ctx, inputs, output):
    q, k, v, scale = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.scale = scale
    ctx.mark_non_differentiable(lse)


def _backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = flash_cross_attention_bwd_op(q, k, v, o, lse, do, ctx.scale)
    return dq, dk, dv, None


flash_cross_attention_fwd_op.register_autograd(_backward, setup_context=_setup_context)


class FlashCrossAttentionFn:
    """o = softmax(q·kᵀ·scale)·v through the registered ops: B2 forward and
    B3 backward on the card (the plain versions on the CPU). The forward
    saves q, k, v, o and lse for the backward."""

    @staticmethod
    def apply(q, k, v, scale):
        return flash_cross_attention_fwd_op(q, k, v, scale)[0]


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """The model's attention: B2 forward and, under grad, B3 backward on the
    card (every shape; they raise on what they do not take), the plain
    versions on the CPU."""
    return flash_cross_attention_fwd_op(q, k, v, float(scale))[0]
