"""Fused mel front end: wrapper of the CUDA kernel `csrc/fused_frontend.cu`
and its plain PyTorch version (port of `ops/pallas/fused_frontend.py`).

[B, C, L] float32 waveform → [B, C, n_mels, T] log-mel, min-max normalised
per channel: `mel_spectrogram` + `log_minmax_per_channel` in one kernel,
with the reflect pad and the frame gather folded into it.

The wrapper takes the plain version only for a tensor that lies on the CPU.
A CUDA tensor goes to the kernel, or the wrapper raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..stft import basis_tensor, log_minmax_per_channel, mel_spectrogram, mel_tensor, num_frames

# the TPU kernel this one replaces (file:line of `_frontend_kernel`)
REPLACES = "audiodepth_tpu/ops/pallas/fused_frontend.py:39"
SOURCE = "audiodepth_tpu_torch/csrc/fused_frontend.cu"
# a block may use 227 KB of shared memory, less the kernel's static part (< 1 KB)
MAX_DYNAMIC_SMEM = 232_448 - 1024


def fused_mel_frontend_plain(waveform: torch.Tensor, n_fft: int = 512,
                             win_length: int = 64, hop_length: int = 32,
                             n_mels: int = 32, sample_rate: int = 44100,
                             f_min: float = 20.0, f_max: float = 20000.0) -> torch.Tensor:
    """The plain PyTorch version: mel_spectrogram + log_minmax_per_channel."""
    mel = mel_spectrogram(waveform, n_fft=n_fft, win_length=win_length,
                          hop_length=hop_length, n_mels=n_mels,
                          sample_rate=sample_rate, f_min=f_min, f_max=f_max,
                          dtype=torch.float32)
    return log_minmax_per_channel(mel)


class FusedMelFrontend:
    """Callable wrapper of kernel B1; `launches` counts kernel launches."""

    name = "fused_mel_frontend"

    def __init__(self):
        self.launches = 0

    def __call__(self, waveform: torch.Tensor, n_fft: int = 512,
                 win_length: int = 64, hop_length: int = 32, n_mels: int = 32,
                 sample_rate: int = 44100, f_min: float = 20.0,
                 f_max: float = 20000.0) -> torch.Tensor:
        if waveform.dim() != 3:
            raise ValueError(f"waveform must be [B, C, L], got {tuple(waveform.shape)}")
        if waveform.dtype != torch.float32:
            raise TypeError(f"waveform must be float32, got {waveform.dtype}")
        b, c, length = waveform.shape
        if length <= n_fft // 2:
            raise ValueError(f"reflect padding of {n_fft // 2} needs L > {n_fft // 2}, got {length}")
        if waveform.device.type == "cpu":
            return fused_mel_frontend_plain(waveform, n_fft, win_length, hop_length,
                                            n_mels, sample_rate, f_min, f_max)
        if waveform.device.type != "cuda":
            raise ValueError(f"unsupported device {waveform.device}")
        if not waveform.is_contiguous():
            raise ValueError("waveform must be contiguous")
        if win_length % 4 or n_mels % 4:
            raise ValueError("the kernel needs win_length and n_mels divisible by 4, "
                             f"got {win_length} and {n_mels}")

        lib = _library()
        n_freq = n_fft // 2 + 1
        t_frames = num_frames(length, hop_length)
        smem = lib.adepth_fused_mel_smem_bytes(t_frames, win_length, n_freq, n_mels)
        if smem > MAX_DYNAMIC_SMEM:
            raise ValueError(f"L={length} gives {t_frames} frames, {smem} B of shared "
                             f"memory per block; a block holds at most {MAX_DYNAMIC_SMEM} B")
        dev = waveform.device
        basis = basis_tensor(n_fft, win_length, torch.float32, dev)
        fb = mel_tensor(n_freq, n_mels, sample_rate, f_min, f_max, torch.float32, dev)
        out = torch.empty((b, c, n_mels, t_frames), dtype=torch.float32, device=dev)
        start = (n_fft - win_length) // 2 - n_fft // 2
        err = lib.adepth_fused_mel_frontend(
            waveform.data_ptr(), basis.data_ptr(), fb.data_ptr(), out.data_ptr(),
            b * c, length, t_frames, win_length, n_freq, n_mels, hop_length,
            start, dev.index if dev.index is not None else torch.cuda.current_device(),
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError("fused_mel_frontend launch failed: "
                               + lib.adepth_cuda_error_string(err).decode())
        self.launches += 1
        return out


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from ._build import load

    lib = load("fused_frontend")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.adepth_fused_mel_smem_bytes.argtypes = [i, i, i, i]
    lib.adepth_fused_mel_smem_bytes.restype = ctypes.c_size_t
    lib.adepth_fused_mel_frontend.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, p]
    lib.adepth_fused_mel_frontend.restype = i
    lib.adepth_cuda_error_string.argtypes = [i]
    lib.adepth_cuda_error_string.restype = ctypes.c_char_p
    return lib


fused_mel_frontend = FusedMelFrontend()
