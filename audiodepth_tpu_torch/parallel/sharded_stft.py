"""Chunked STFT with halo exchange: the frame axis split over a group
(port of `parallel/sharded_stft.py`).

For the plain `spectrogram` input format under a ('data', 'model') group,
the STFT's frames are split over the model axis: rank i computes the frames
whose windows start in its chunk of the padded signal, and reads the
(win_length − hop_length) samples past the chunk's end from its right
neighbour, point to point (`DataGroup.from_right`, the JAX package's
ppermute i + 1 → i); the last rank reads the padded signal's absolute tail,
which it holds. The frames are a product with the windowed DFT basis
(`ops/stft.py`) in float32 (TF32 off on the card), then the magnitude;
the frame slabs are all-gathered in rank order and cut to the frame count,
so every rank of the group holds the whole spectrogram (everything after
the STFT is replicated over the model axis).

The arithmetic is the JAX package's: the waveform is cast to float32 even
in float64 mode, and reflect-padded as `jnp.pad(mode="reflect")` pads,
repeatedly where the pad exceeds the signal, so its refusal of a chunk
shorter than the halo is reached. The caller-visible result is
`ops.stft.magnitude_stft`'s: [..., n_freq, 1 + L // hop].
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.stft import basis_tensor, num_frames
from .mesh import DataGroup


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """`x` padded by `pad` on both ends of its last axis, reflected without
    repeating the edge, as numpy and JAX reflect: repeatedly when `pad` is
    not below the length (an index gather)."""
    n = x.shape[-1]
    i = torch.arange(-pad, n + pad, device=x.device)
    if n == 1:
        return x[..., torch.zeros_like(i)]
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return x[..., torch.where(i >= n, period - i, i)]


def sharded_magnitude_stft(waveform: torch.Tensor, group: Optional[DataGroup],
                           n_fft: int = 512, win_length: int = 64,
                           hop_length: int = 16) -> torch.Tensor:
    """Magnitude STFT of [..., L] with the frame axis split over `group`
    (None: one rank); every rank passes the same waveform and gets the
    whole [..., n_freq, 1 + L // hop] float32 spectrogram."""
    n = 1 if group is None else group.size
    rank = 0 if group is None else group.rank
    length = waveform.shape[-1]
    n_freq = n_fft // 2 + 1
    t_frames = num_frames(length, hop_length)
    off = (n_fft - win_length) // 2
    halo = win_length - hop_length

    # realign so frame t reads y[t*hop : t*hop + win]
    y = reflect_pad(waveform.to(torch.float32), n_fft // 2)[..., off:]
    t_per = -(-t_frames // n)          # frames a rank
    lc = t_per * hop_length            # chunk length (hop-aligned)
    if lc < halo:
        # a chunk shorter than the halo cannot forward its first `halo` samples
        raise ValueError(
            f"sharded STFT needs >= win-hop = {halo} samples per shard, got "
            f"{lc} ({t_per} frames x hop {hop_length} over {n} 'model' "
            f"shards) — shard the frame axis over fewer devices or use a "
            f"longer signal")
    need = n * lc + halo               # the last frame's window tail
    if y.shape[-1] < need:
        y = F.pad(y, (0, need - y.shape[-1]))
    chunk = y[..., rank * lc:(rank + 1) * lc]
    if n == 1:
        recv = None
    else:
        recv = group.from_right(chunk[..., :halo])
    if recv is None:                   # the last rank: the absolute tail
        recv = y[..., n * lc:n * lc + halo]
    ext = torch.cat([chunk, recv], dim=-1)
    frames = ext.unfold(-1, win_length, hop_length)          # [..., t_per, win]
    spec = torch.matmul(frames, basis_tensor(n_fft, win_length, torch.float32, ext.device))
    re, im = spec[..., :n_freq], spec[..., n_freq:]
    mag = torch.sqrt(re * re + im * im).transpose(-1, -2)   # [..., F, t_per]
    if n > 1:
        mag = group.all_gather_cat(mag, dim=-1)
    return mag[..., :t_frames]
