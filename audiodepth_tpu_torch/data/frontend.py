"""Audio front end: waveform → model-ready NHWC spectrogram (port of
`data/frontend.py`).

time-of-flight cut → STFT/mel → log → per-channel min-max → bilinear
resize, on the device the waveform lies on. Sample semantics:
  * BV2 (max_depth set): cut = int((2*max_depth/340)*sr) samples; STFT
    n_fft=512/win=64/hop=16 or mel(sr=44100, n_fft=512, win=64, hop=32,
    n_mels=32, f in [20, 20k]); log(spec+1e-8); per-channel min-max to
    [0,1]; resize to images_size².
  * BV1: full waveform, STFT n_fft=512/win=64/hop=16, NO log/min-max.

The float32 mel path (BV2's default) is the fused front end
`ops/cuda/fused_frontend.py`, called as the registered op
`audiodepth::fused_mel_frontend` (so `torch.export` traces it): kernel B1
on a CUDA tensor, its plain version on a CPU tensor. The float64 mode (parity/debug) computes the same function
with plain tensor ops on either device, since B1 is float32 by definition.
The plain-STFT path and the waveform passthrough are plain tensor ops.
Under a ('data', 'model') group whose model axis has more than one rank,
the plain-STFT path (not the mel path, which stays local) is the
halo-exchange sharded STFT of `parallel/sharded_stft.py`, frames split over
the model axis: float32 whatever the compute dtype, as in the JAX package.

The result is NHWC ([B, H, W, C]) like the JAX package's and laid out NHWC
in memory, so the model's `permute(0, 3, 1, 2)` is a channels-last NCHW view
that cuDNN takes without a layout conversion.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..configs import Config
from ..ops.cuda.fused_frontend import fused_mel_frontend_op
from ..ops.resize import resize_bilinear
from ..ops.stft import log_minmax_per_channel, magnitude_stft, mel_spectrogram
from ..parallel.sharded_stft import sharded_magnitude_stft

SPEED_OF_SOUND = 340.0


def tof_cut_samples(max_depth: float, sample_rate: int) -> int:
    """Time-of-flight window: samples for sound to travel 2*max_depth."""
    return int((2.0 * max_depth / SPEED_OF_SOUND) * sample_rate)


def make_frontend(cfg: Config, group=None,
                  frame_axis: str = "model") -> Callable[[torch.Tensor], torch.Tensor]:
    """Build the waveform → NHWC input op for a config.

    The returned fn maps [B, C, L] float waveforms to [B, S, S, C] inputs
    (S = cfg.dataset.images_size). For audio_format='waveform' it returns the
    (cut) waveform unchanged as [B, C, L'].

    group: a `parallel.MeshGroup`; when its `frame_axis` has more than one
    rank, the plain-STFT path runs through `parallel.sharded_magnitude_stft`
    over that axis (a collective: every rank of the axis calls the front end
    on the same rows).
    """
    ds = cfg.dataset
    size = ds.images_size
    is_v1 = ds.name == "batvisionv1"
    fmt = ds.audio_format
    cut = None if is_v1 else tof_cut_samples(ds.max_depth, ds.sample_rate) if ds.max_depth else None
    # true fp32 by definition; float64 mode keeps the whole front end f64
    fdt = torch.float64 if cfg.mode.compute_dtype == "float64" else torch.float32
    frames_over = (group.axis(frame_axis) if group is not None
                   and frame_axis in getattr(group, "axis_names", ())
                   and group.axis_size(frame_axis) > 1 and "spectrogram" in fmt
                   and "mel" not in fmt else None)

    def frontend(waveform: torch.Tensor) -> torch.Tensor:
        x = waveform.to(fdt)
        if cut is not None:
            x = x[..., :cut]
        if "spectrogram" not in fmt:
            return x  # waveform passthrough
        if "mel" in fmt and fdt == torch.float32:
            spec = fused_mel_frontend_op(x, sample_rate=ds.sample_rate)  # the cut stays a view
        else:
            if "mel" in fmt:
                spec = mel_spectrogram(x, n_fft=512, win_length=64, n_mels=32,
                                       sample_rate=ds.sample_rate, f_min=20.0,
                                       f_max=20000.0, dtype=fdt)
            elif frames_over is not None:
                spec = sharded_magnitude_stft(x, frames_over, n_fft=512, win_length=64,
                                              hop_length=16)
            else:
                spec = magnitude_stft(x, n_fft=512, win_length=64, hop_length=16,
                                      dtype=fdt)
            if not is_v1:
                spec = log_minmax_per_channel(spec)
        if "resize" in (ds.preprocess or ""):
            spec = resize_bilinear(spec, size, size)
        # [B, C, H, W] -> NHWC, laid out NHWC in memory
        return spec.permute(0, 2, 3, 1).contiguous()

    return frontend
