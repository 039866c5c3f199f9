"""Plain mel front end of BatVision V2: waveform [B, C, L] → NHWC [B, S, S, C].

time-of-flight cut (int(2·max_depth/340·sr) samples) → STFT as one DFT
product (n_fft 512, a periodic Hann window of 64 centred in it, hop 32,
reflect padding of 256, magnitude) → HTK mel bank (32 filters, 20 Hz to
20 kHz, no normalisation) → log(x + 1e-8) → min-max to [0, 1] per channel
→ antialiased bilinear resize to S × S (triangle weights, half-pixel
centres, support widened when downscaling, rows summing to 1).

The constants are built in float64 and cast to float32; every product runs
in float32 with TF32 off (`Precision.setup`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

SPEED_OF_SOUND = 340.0
N_FFT, WIN, HOP, N_MELS = 512, 64, 32, 32
F_MIN, F_MAX = 20.0, 20000.0


def tof_cut_samples(max_depth: float, sample_rate: int) -> int:
    return int((2.0 * max_depth / SPEED_OF_SOUND) * sample_rate)


def dft_basis() -> np.ndarray:
    """[WIN, 2·n_freq]: the windowed cos and −sin columns over the window's
    support inside the n_fft frame."""
    n_freq = N_FFT // 2 + 1
    off = (N_FFT - WIN) // 2
    n = np.arange(WIN, dtype=np.float64)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / WIN))
    phase = 2.0 * np.pi * np.arange(n_freq)[None, :] * (off + n[:, None]) / N_FFT
    return np.concatenate([np.cos(phase) * w[:, None], -np.sin(phase) * w[:, None]], axis=1)


def mel_bank(sample_rate: int) -> np.ndarray:
    """[n_freq, N_MELS] triangular HTK filters, no normalisation."""
    n_freq = N_FFT // 2 + 1
    freqs = np.linspace(0.0, sample_rate / 2.0, n_freq)

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    mels = np.linspace(hz_to_mel(F_MIN), hz_to_mel(F_MAX), N_MELS + 2)
    pts = 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    diff = pts[1:] - pts[:-1]
    slopes = pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / diff[:-1]
    up = slopes[:, 2:] / diff[1:]
    return np.maximum(0.0, np.minimum(down, up))


def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] antialiased bilinear (triangle) resampling weights."""
    inv = in_size / out_size
    support = max(inv, 1.0)
    centre = (np.arange(out_size, dtype=np.float64) + 0.5) * inv - 0.5
    w = np.maximum(0.0, 1.0 - np.abs(centre[:, None] - np.arange(in_size)[None, :]) / support)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0.0, total, 1.0), 0.0)
    inside = (centre >= -0.5) & (centre <= in_size - 0.5)
    return np.where(inside[:, None], w, 0.0)


def mel_frontend(wave: torch.Tensor, images_size: int, max_depth: float,
                 sample_rate: int) -> torch.Tensor:
    """[B, C, L] float32 → [B, S, S, C] float32 in [0, 1]."""
    dev = wave.device
    x = wave.to(torch.float32)[..., :tof_cut_samples(max_depth, sample_rate)]
    b, c, length = x.shape
    frames_n = 1 + length // HOP
    x = F.pad(x.reshape(b * c, 1, length), (N_FFT // 2, N_FFT // 2), mode="reflect")
    off = (N_FFT - WIN) // 2
    frames = x[:, 0, off:].unfold(-1, WIN, HOP)[:, :frames_n]          # [BC, T, WIN]
    basis = torch.from_numpy(dft_basis()).to(dev, torch.float32)
    spec = frames @ basis                                             # [BC, T, 2·n_freq]
    n_freq = N_FFT // 2 + 1
    mag = torch.sqrt(spec[..., :n_freq] ** 2 + spec[..., n_freq:] ** 2)
    mel = (mag @ torch.from_numpy(mel_bank(sample_rate)).to(dev, torch.float32))
    logmel = torch.log(mel.transpose(1, 2) + 1e-8)                    # [BC, n_mels, T]
    lo = logmel.amin(dim=(1, 2), keepdim=True)
    hi = logmel.amax(dim=(1, 2), keepdim=True)
    rng = hi - lo
    ok = rng > 0
    norm = torch.where(ok, (logmel - lo) / torch.where(ok, rng, torch.ones_like(rng)),
                       torch.zeros_like(logmel))
    wh = torch.from_numpy(resize_matrix(N_MELS, images_size)).to(dev, torch.float32)
    ww = torch.from_numpy(resize_matrix(frames_n, images_size)).to(dev, torch.float32)
    out = wh @ norm @ ww.T                                            # [BC, S, S]
    return out.reshape(b, c, images_size, images_size).permute(0, 2, 3, 1)
