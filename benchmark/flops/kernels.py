"""Least time of one call of each hand-written op, from its input shapes.

A frozen copy of `chip_smoke.py`'s arithmetic (`_b1_bounds`,
`attention_bound` and the flop and byte counts beside them):

- `audiodepth::fused_mel_frontend` (B1), B·C channels of L samples, T =
  1 + L // 32 frames: the DFT over the bins the mel bank reads, as six bf16
  passes of three-piece products at the bf16 tensor rate, plus the bank's
  non-zeros at the fp32 rate; bytes: the waveform and the packed constants
  read once, the log-mel written once.
- `audiodepth::flash_cross_attention_fwd` (B2), q [B, N, dk], k [B, M, dk],
  v [B, M, dv]: 2·B·N·M·(dk + dv) at the bf16 tensor rate (six passes in
  float32), B·N·M exp2 at the special-function unit's rate, and q, k, v, o
  and lse once.
- `audiodepth::flash_cross_attention_bwd` (B3): 2·B·N·M·(3·dk + 2·dv)
  (the scores again, pᵀ·do, do·vᵀ, dsᵀ·q, ds·k), B·N·M exp2, and q, k, v,
  o, do, lse read and dq, dk, dv written once.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from reference.frontend import HOP, N_MELS, WIN, mel_bank

OPS = ("audiodepth::fused_mel_frontend", "audiodepth::flash_cross_attention_fwd",
       "audiodepth::flash_cross_attention_bwd")


def _bank_shape(sample_rate: int):
    """(bins the bank reads, the bank's non-zeros, the packed constants'
    bytes: the basis of those bins as three bf16 pieces, each filter's
    first bin and length as int32 and its float32 weights)."""
    fb = mel_bank(sample_rate)
    rows = np.nonzero(fb.any(axis=1))[0]
    n_bins = int(rows[-1] - rows[0] + 1)
    nnz = int(np.count_nonzero(fb))
    nbytes = WIN * 2 * n_bins * 3 * 2 + N_MELS * 8 + nnz * 4
    return n_bins, nnz, nbytes


def _dtype_bytes(dtype: str) -> int:
    """2 for a 16-bit float ("c10::BFloat16", "c10::Half", "bfloat16"), else 4."""
    name = dtype.lower()
    return 2 if "bfloat16" in name or "half" in name or "float16" in name else 4


def kernel_bound_s(op: str, shapes: Sequence[Sequence[int]], dtype: str,
                   peak: Dict[str, float], sample_rate: int = 44100) -> float:
    """Seconds of the bound of one call of `op` with input shapes `shapes`
    (as the profiler records them) and input dtype `dtype`."""
    if op == OPS[0]:
        b, c, length = shapes[0]
        bc, frames = b * c, 1 + length // HOP
        n_bins, nnz, cbytes = _bank_shape(sample_rate)
        ops_s = (6 * 2.0 * bc * frames * WIN * 2 * n_bins / peak["bf16"]
                 + 2.0 * bc * frames * nnz / peak["fp32"])
        bytes_s = (4.0 * (bc * length + bc * N_MELS * frames) + cbytes) / peak["hbm"]
        return max(ops_s, bytes_s)
    (b, n, dk), (_, m, _), (_, _, dv) = shapes[0], shapes[1], shapes[2]
    es = _dtype_bytes(dtype)
    passes = 6 if es == 4 else 1
    ex2 = float(b) * n * m / (peak["sms"] * peak["clock"] * peak["ex2_per_clock_sm"])
    if op == OPS[1]:
        flops = 2.0 * b * n * m * (dk + dv)
        nbytes = es * b * (n * dk + m * dk + m * dv + n * dv) + 4.0 * b * n
    elif op == OPS[2]:
        flops = 2.0 * b * n * m * (3 * dk + 2 * dv)
        nbytes = es * b * (2 * n * dk + 2 * m * dk + 2 * m * dv + 2 * n * dv) + 4.0 * b * n
    else:
        raise ValueError(f"no bound for {op!r}")
    return max(passes * flops / peak["bf16"], ex2, nbytes / peak["hbm"])

