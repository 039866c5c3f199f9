"""STFT / mel-spectrogram ops as matrix products (port of `ops/stft.py`).

The short-time transform is one product per channel: frames
[.., n_frames, win_length] × a precomputed windowed DFT basis
[win_length, 2*n_freq]. The analysis window (64) is much shorter than the
FFT size (512), so the basis spans only the window's support.

Conventions match the reference front end (torchaudio defaults):
  * center=True with reflect padding of n_fft//2 samples per side
    (`F.pad(mode="reflect")`, no edge repeat — `jnp.pad(mode="reflect")`),
  * periodic Hann window of win_length, zero-padded symmetrically to n_fft,
  * power=1.0 (magnitude),
  * HTK mel scale, no filterbank normalization, f_min=20, f_max=20000.

The numpy constructions are copied verbatim from the JAX package so the
basis and the mel bank are the same bits. Products run at full precision:
on the card `_device.configure_precision` keeps TF32 off.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def hann_window_periodic(win_length: int,
                         dtype=np.float32) -> np.ndarray:
    """Periodic Hann window (matches torch.hann_window default)."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))).astype(dtype)


def stft_basis(n_fft: int, win_length: int, dtype=np.float32) -> np.ndarray:
    """Windowed real-DFT basis restricted to the window support.

    The centered window occupies frame positions [off, off + win_length) with
    off = (n_fft - win_length) // 2. Returns [win_length, 2*n_freq] with the
    cos block then the -sin block (real, imag parts of X).
    """
    n_freq = n_fft // 2 + 1
    off = (n_fft - win_length) // 2
    w = hann_window_periodic(win_length).astype(np.float64)
    m = np.arange(win_length, dtype=np.float64)[:, None]
    k = np.arange(n_freq, dtype=np.float64)[None, :]
    phase = 2.0 * np.pi * k * (off + m) / n_fft
    cos = np.cos(phase) * w[:, None]
    sin = -np.sin(phase) * w[:, None]
    return np.concatenate([cos, sin], axis=1).astype(dtype)


def num_frames(length: int, hop_length: int) -> int:
    """Frame count with center=True (torch.stft): 1 + length // hop."""
    return 1 + length // hop_length


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(
    n_freq: int,
    n_mels: int = 32,
    sample_rate: int = 44100,
    f_min: float = 20.0,
    f_max: float = 20000.0,
    norm: Optional[str] = None,
    dtype=np.float32,
) -> np.ndarray:
    """Triangular mel filterbank [n_freq, n_mels], HTK scale, norm=None.

    Matches torchaudio.functional.melscale_fbanks(mel_scale='htk').
    """
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freq)
    m_pts = np.linspace(_hz_to_mel_htk(f_min), _hz_to_mel_htk(f_max), n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]                       # [n_mels+1]
    slopes = f_pts[None, :] - all_freqs[:, None]          # [n_freq, n_mels+2]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    if norm == "slaney":
        enorm = 2.0 / (f_pts[2 : n_mels + 2] - f_pts[:n_mels])
        fb *= enorm[None, :]
    return fb.astype(dtype)


_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


@functools.lru_cache(maxsize=32)
def basis_tensor(n_fft: int, win_length: int, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """`stft_basis` as a tensor, built once per (shape, dtype, device)."""
    return torch.from_numpy(stft_basis(n_fft, win_length, _NP_DTYPE[dtype])).to(device)


@functools.lru_cache(maxsize=32)
def mel_tensor(n_freq: int, n_mels: int, sample_rate: int, f_min: float,
               f_max: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """`mel_filterbank` as a tensor, built once per (shape, dtype, device)."""
    fb = mel_filterbank(n_freq, n_mels, sample_rate, f_min, f_max,
                        dtype=_NP_DTYPE[dtype])
    return torch.from_numpy(fb).to(device)


def _reflect_pad_last(x: torch.Tensor, pad: int) -> torch.Tensor:
    lead = x.shape[:-1]
    y = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
    return y.reshape(*lead, y.shape[-1])


def magnitude_stft(
    waveform: torch.Tensor,
    n_fft: int = 512,
    win_length: int = 64,
    hop_length: int = 16,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Magnitude STFT of [..., L] → [..., n_freq, n_frames] (power=1.0)."""
    length = waveform.shape[-1]
    n_freq = n_fft // 2 + 1
    frames_n = num_frames(length, hop_length)
    off = (n_fft - win_length) // 2

    x = _reflect_pad_last(waveform.to(dtype), n_fft // 2)
    # frames start at t*hop + off: [..., n_frames, win_length] (a view)
    frames = x[..., off:].unfold(-1, win_length, hop_length)[..., :frames_n, :]
    basis = basis_tensor(n_fft, win_length, dtype, x.device)
    spec = torch.matmul(frames, basis)
    re, im = spec[..., :n_freq], spec[..., n_freq:]
    mag = torch.sqrt(re * re + im * im)
    # [..., n_frames, n_freq] -> [..., n_freq, n_frames]
    return mag.transpose(-1, -2)


def mel_spectrogram(
    waveform: torch.Tensor,
    n_fft: int = 512,
    win_length: int = 64,
    hop_length: Optional[int] = None,
    n_mels: int = 32,
    sample_rate: int = 44100,
    f_min: float = 20.0,
    f_max: float = 20000.0,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Magnitude mel spectrogram of [..., L] → [..., n_mels, n_frames].

    Default hop = win_length // 2 (the torchaudio MelSpectrogram default).
    """
    if hop_length is None:
        hop_length = win_length // 2
    mag = magnitude_stft(waveform, n_fft=n_fft, win_length=win_length,
                         hop_length=hop_length, dtype=dtype)
    fb = mel_tensor(n_fft // 2 + 1, n_mels, sample_rate, f_min, f_max,
                    dtype, mag.device)
    # [..., n_freq, T] x [n_freq, n_mels] -> [..., n_mels, T]
    return torch.einsum("...ft,fm->...mt", mag, fb)


def log_minmax_per_channel(spec: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """log(spec + eps) then per-channel min-max normalize to [0, 1].

    Channel axis is -3 ([..., C, F, T]); channels with max == min map to
    zeros (BatvisionV2_Dataset.py:119-132 semantics).
    """
    x = torch.log(spec + eps)
    lo = x.amin(dim=(-2, -1), keepdim=True)
    hi = x.amax(dim=(-2, -1), keepdim=True)
    rng = hi - lo
    ok = rng > 0
    return torch.where(ok, (x - lo) / torch.where(ok, rng, torch.ones_like(rng)),
                       torch.zeros_like(x))
