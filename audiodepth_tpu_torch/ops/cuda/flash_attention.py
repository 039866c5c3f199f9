"""Flash cross-attention: wrappers of the CUDA kernels in
`csrc/flash_attention.cu`, the forward (kernel B2) and the backward (kernel
B3), their plain PyTorch versions, and the autograd Function that joins them
(port of `ops/pallas/flash_attention.py`).

    o   = softmax(q·kᵀ·scale)·v          [B, N, Dv], in the input dtype
    lse = log Σ_m exp(q·kᵀ·scale)        [B, N, 1], natural log
    dq, dk, dv from do and the saved q, k, v, o, lse (B3)

q [B, N, Dk], k [B, M, Dk], v [B, M, Dv].

`cross_attention` is the dispatch the model calls: every call goes through
`FlashCrossAttentionFn`, whose forward is B2 and whose backward is B3 on a
CUDA tensor, and the two plain versions on a CPU tensor. On a CUDA tensor a
wrapper launches its kernel or raises; nothing falls back. The JAX package
sent N, M ≤ 256 to XLA because of the TPU's per-grid-step overhead, which
has no counterpart here, so the kernels take every shape.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..attention import score_blocks

SOURCE = "audiodepth_tpu_torch/csrc/flash_attention.cu"
# the TPU kernels these replace (file:line of `_fwd_kernel` and `_bwd_kernel`)
REPLACES = "audiodepth_tpu/ops/pallas/flash_attention.py:103"
REPLACES_BWD = "audiodepth_tpu/ops/pallas/flash_attention.py:148"
MAX_HEAD_DK = 64   # the kernels' largest q/k width (the binaural levels use 16..64)
MAX_HEAD_DV = 512  # B3's largest value width (its V and dO tiles fill shared memory)


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


def _check_kernel_inputs(tensors, dk: int, dv: int, max_dv: Optional[int] = None) -> None:
    """What the kernels take on the card, beyond matching shapes."""
    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the kernel takes bfloat16 or float32, got {q.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel's inputs must be contiguous")
    if dk % 8 or dk > MAX_HEAD_DK or dv % 8 or (max_dv is not None and dv > max_dv):
        limit = "" if max_dv is None else f" up to {max_dv}"
        raise ValueError(f"the kernel takes Dk in 8, 16, ..., {MAX_HEAD_DK} and Dv a "
                         f"multiple of 8{limit}; got Dk={dk}, Dv={dv}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the kernel's inputs must start on a 16-byte boundary")
    if q.shape[0] > 65535:
        raise ValueError(f"the kernel's grid takes at most 65535 batch rows, got {q.shape[0]}")


def _device_args(dev: torch.device):
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(dev).cuda_stream


class FlashCrossAttention:
    """Callable wrapper of kernel B2; `launches` counts kernel launches."""

    name = "flash_cross_attention_fwd"

    def __init__(self):
        self.launches = 0

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
        b, n, m, dk, dv = _check_qkv(q, k, v)
        if q.device.type == "cpu":
            return flash_cross_attention_fwd_plain(q, k, v, scale)
        _check_kernel_inputs((q, k, v), dk, dv)

        lib = _library()
        o = torch.empty((b, n, dv), dtype=q.dtype, device=q.device)
        lse = torch.empty((b, n, 1), dtype=torch.float32, device=q.device)
        err = lib.adepth_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, n, m, dk, dv, float(scale), int(q.dtype == torch.bfloat16),
            *_device_args(q.device))
        if err != 0:
            raise RuntimeError("flash_cross_attention launch failed: "
                               + lib.adepth_cuda_error_string(err).decode())
        self.launches += 1
        return o, lse


class FlashCrossAttentionBwd:
    """Callable wrapper of kernel B3: (q, k, v, o, lse, do, scale) →
    (dq, dk, dv); `launches` counts kernel launches.

    D = rowsum(do⊙o) is computed here in fp32 with plain tensor ops, as the
    JAX package computes it outside its kernel; dq accumulates in a zeroed
    fp32 buffer that is cast to q's dtype afterwards."""

    name = "flash_cross_attention_bwd"

    def __init__(self):
        self.launches = 0

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
        do = do.contiguous()
        _check_kernel_inputs((q, k, v, do, lse), dk, dv, max_dv=MAX_HEAD_DV)

        lib = _library()
        dsum = (do.float() * o.float()).sum(-1)
        dq = torch.zeros((b, n, dk), dtype=torch.float32, device=q.device)
        dk_out = torch.empty_like(k)
        dv_out = torch.empty_like(v)
        err = lib.adepth_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            dsum.data_ptr(), dq.data_ptr(), dk_out.data_ptr(), dv_out.data_ptr(),
            b, n, m, dk, dv, float(scale), int(q.dtype == torch.bfloat16),
            *_device_args(q.device))
        if err != 0:
            raise RuntimeError("flash_cross_attention backward launch failed: "
                               + lib.adepth_cuda_error_string(err).decode())
        self.launches += 1
        return dq.to(q.dtype), dk_out, dv_out


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from ._build import load

    lib = load("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.adepth_flash_attention_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                               ctypes.c_float, i, i, p]
    lib.adepth_flash_attention_fwd.restype = i
    lib.adepth_flash_attention_bwd.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i,
                                               ctypes.c_float, i, i, p]
    lib.adepth_flash_attention_bwd.restype = i
    lib.adepth_cuda_error_string.argtypes = [i]
    lib.adepth_cuda_error_string.restype = ctypes.c_char_p
    return lib


flash_cross_attention = FlashCrossAttention()
flash_cross_attention_bwd = FlashCrossAttentionBwd()


class FlashCrossAttentionFn(torch.autograd.Function):
    """o = softmax(q·kᵀ·scale)·v with B2 forward and B3 backward on the card
    (the plain versions on the CPU). Saves q, k, v, o and lse."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = flash_cross_attention(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_cross_attention_bwd(q, k, v, o, lse, do, ctx.scale)
        return dq, dk, dv, None


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """The model's attention: B2 forward and, under grad, B3 backward on the
    card (every shape; they raise on what they do not take), the plain
    versions on the CPU."""
    return FlashCrossAttentionFn.apply(q, k, v, scale)
