"""B1, the fused mel front end, B·C channels of L samples, T = 1 + L // 32
frames (`chip_smoke.py`'s `_b1_bounds`, frozen): the DFT over the bins the
mel bank reads, as six bf16 passes of three-piece products at the bf16
tensor rate, plus the bank's non-zeros at the fp32 rate; bytes: the
waveform and the packed constants read once, the log-mel written once."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from reference.frontend import HOP, N_MELS, WIN, mel_bank

OP = "audiodepth::fused_mel_frontend"


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


def bound_s(shapes: Sequence[Sequence[int]], dtype: str, peak: Dict[str, float],
            cfg: Dict) -> float:
    b, c, length = shapes[0]
    bc, frames = b * c, 1 + length // HOP
    n_bins, nnz, cbytes = _bank_shape(int(cfg.get("sample_rate", 44100)))
    ops_s = (6 * 2.0 * bc * frames * WIN * 2 * n_bins / peak["bf16"]
             + 2.0 * bc * frames * nnz / peak["fp32"])
    bytes_s = (4.0 * (bc * length + bc * N_MELS * frames) + cbytes) / peak["hbm"]
    return max(ops_s, bytes_s)
