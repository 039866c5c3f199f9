"""Blockwise spatial cross-attention (port of `ops/attention.py`).

softmax(q·kᵀ·scale)·v computed in query blocks: the scores of one
[block_q, M] tile at a time, the softmax in at least fp32, then the value
contraction, so peak memory is O(block_q·M) instead of the reference's
full N×M matrix. This is the model's path on the CPU and the core of kernel
B2's plain version (`ops/cuda/flash_attention.py`).
"""

from __future__ import annotations

from typing import Iterator, Tuple

import torch


def score_blocks(q: torch.Tensor, k: torch.Tensor, scale: float,
                 block_q: int = 1024) -> Iterator[Tuple[slice, torch.Tensor]]:
    """Yield (query rows, q·kᵀ·scale for those rows) block by block.

    Scores are in `promote_types(q.dtype, float32)`: fp32 statistics for
    bf16/f32 inputs, and never a downcast of f64.
    """
    acc_t = torch.promote_types(q.dtype, torch.float32)
    kt = k.to(acc_t).transpose(1, 2)
    n = q.shape[1]
    bq = max(1, min(block_q, n))
    for start in range(0, n, bq):
        rows = slice(start, min(start + bq, n))
        yield rows, torch.matmul(q[:, rows].to(acc_t), kt) * scale


def blockwise_cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              scale: float, block_q: int = 1024) -> torch.Tensor:
    """softmax(q @ kᵀ * scale) @ v, computed in query blocks.

    q [B, N, Dk], k [B, M, Dk], v [B, M, Dv] → [B, N, Dv] in v.dtype.
    """
    vv = v.to(torch.promote_types(q.dtype, torch.float32))
    out = [torch.matmul(torch.softmax(s, dim=-1), vv)
           for _, s in score_blocks(q, k, scale, block_q)]
    return torch.cat(out, dim=1).to(v.dtype)
