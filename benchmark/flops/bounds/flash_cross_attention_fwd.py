"""B2, the flash cross-attention forward (`chip_smoke.py`'s
`attention_bound`, frozen), q [B, N, dk], k [B, M, dk], v [B, M, dv]:
2·B·N·M·(dk + dv) at the bf16 tensor rate (six passes in float32), B·N·M
exp2 at the special-function unit's rate, and q, k, v, o and lse once."""

from __future__ import annotations

from typing import Dict, Sequence

from ..kernels import dtype_bytes, tensor_core_bound_s

OP = "audiodepth::flash_cross_attention_fwd"


def bound_s(shapes: Sequence[Sequence[int]], dtype: str, peak: Dict[str, float],
            cfg: Dict) -> float:
    (b, n, dk), (_, m, _), (_, _, dv) = shapes[0], shapes[1], shapes[2]
    es = dtype_bytes(dtype)
    flops = 2.0 * b * n * m * (dk + dv)
    nbytes = es * b * (n * dk + m * dk + m * dv + n * dv) + 4.0 * b * n
    return tensor_core_bound_s(flops, float(b) * n * m, nbytes, dtype, peak)
