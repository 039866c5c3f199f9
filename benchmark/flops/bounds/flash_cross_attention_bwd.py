"""B3, the flash cross-attention backward (`chip_smoke.py`'s
`attention_bound`, frozen): 2·B·N·M·(3·dk + 2·dv) (the scores again,
pᵀ·do, do·vᵀ, dsᵀ·q, ds·k), B·N·M exp2, and q, k, v, o, do, lse read and
dq, dk, dv written once."""

from __future__ import annotations

from typing import Dict, Sequence

from ..kernels import dtype_bytes, tensor_core_bound_s

OP = "audiodepth::flash_cross_attention_bwd"


def bound_s(shapes: Sequence[Sequence[int]], dtype: str, peak: Dict[str, float],
            cfg: Dict) -> float:
    (b, n, dk), (_, m, _), (_, _, dv) = shapes[0], shapes[1], shapes[2]
    es = dtype_bytes(dtype)
    flops = 2.0 * b * n * m * (3 * dk + 2 * dv)
    nbytes = es * b * (2 * n * dk + 2 * m * dk + 2 * m * dv + 2 * n * dv) + 4.0 * b * n
    return tensor_core_bound_s(flops, float(b) * n * m, nbytes, dtype, peak)
