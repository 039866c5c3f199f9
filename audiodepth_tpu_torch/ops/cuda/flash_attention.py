"""Flash cross-attention forward: wrapper of the CUDA kernel
`csrc/flash_attention.cu` (kernel B2) and its plain PyTorch version (port
of the forward half of `ops/pallas/flash_attention.py`).

    o   = softmax(q·kᵀ·scale)·v          [B, N, Dv], in the input dtype
    lse = log Σ_m exp(q·kᵀ·scale)        [B, N, 1], natural log

q [B, N, Dk], k [B, M, Dk], v [B, M, Dv]. `lse` is what the backward (B3,
not ported yet) needs; serving discards it.

`cross_attention` is the dispatch the model calls. A CPU tensor goes to
`blockwise_cross_attention`. A CUDA tensor goes to B2 at every shape: the
JAX package sent N, M ≤ 256 to XLA because of the TPU's per-grid-step
overhead, which has no counterpart here. On a CUDA tensor the wrapper
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..attention import blockwise_cross_attention, score_blocks

# the TPU kernel this one replaces (file:line of `_fwd_kernel`)
REPLACES = "audiodepth_tpu/ops/pallas/flash_attention.py:103"
SOURCE = "audiodepth_tpu_torch/csrc/flash_attention.cu"
MAX_HEAD_DK = 64  # the kernel's largest q/k width (the binaural levels use 16..64)


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


class FlashCrossAttention:
    """Callable wrapper of kernel B2; `launches` counts kernel launches."""

    name = "flash_cross_attention_fwd"

    def __init__(self):
        self.launches = 0

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
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
        if q.device.type == "cpu":
            return flash_cross_attention_fwd_plain(q, k, v, scale)
        if q.device.type != "cuda":
            raise ValueError(f"unsupported device {q.device}")
        if q.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"the kernel takes bfloat16 or float32, got {q.dtype}")
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            raise RuntimeError("flash_cross_attention has no backward on the card yet "
                               "(kernel B3, ROADMAP.md A4); call it under torch.no_grad()")
        if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
            raise ValueError("q, k, v must be contiguous")
        if dk % 8 or dk > MAX_HEAD_DK or dv % 8:
            raise ValueError(f"the kernel takes Dk in 8, 16, ..., {MAX_HEAD_DK} and Dv a "
                             f"multiple of 8; got Dk={dk}, Dv={dv}")
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("q, k, v must start on a 16-byte boundary")
        if b > 65535:
            raise ValueError(f"the kernel's grid takes at most 65535 batch rows, got {b}")

        lib = _library()
        dev = q.device
        o = torch.empty((b, n, dv), dtype=q.dtype, device=dev)
        lse = torch.empty((b, n, 1), dtype=torch.float32, device=dev)
        err = lib.adepth_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, n, m, dk, dv, float(scale), int(q.dtype == torch.bfloat16),
            dev.index if dev.index is not None else torch.cuda.current_device(),
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError("flash_cross_attention launch failed: "
                               + lib.adepth_cuda_error_string(err).decode())
        self.launches += 1
        return o, lse


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from ._build import load

    lib = load("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.adepth_flash_attention_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                               ctypes.c_float, i, i, p]
    lib.adepth_flash_attention_fwd.restype = i
    lib.adepth_cuda_error_string.argtypes = [i]
    lib.adepth_cuda_error_string.restype = ctypes.c_char_p
    return lib


flash_cross_attention = FlashCrossAttention()


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """The model's attention: the plain blockwise path on the CPU, kernel B2
    on the card (every shape; it raises on what it does not take)."""
    if q.device.type == "cpu":
        return blockwise_cross_attention(q, k, v, scale)
    return flash_cross_attention(q, k, v, scale)[0]
