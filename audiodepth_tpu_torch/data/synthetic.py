"""Synthetic echo dataset (port of `data/synthetic.py`, numpy only, the same
samples as the JAX package's class from the same seed).

A deterministic, dataset-free source with the sample semantics of the
BatVision pipelines: binaural waveforms of the time-of-flight length plus
256 samples, and depth maps in meters with invalid (zero) pixels. The
mapping audio→depth is learnable by construction: each scene is a smooth
random depth field, and the waveform is a sum of chirp echoes whose delays
encode the scene's depth quantiles, with the inter-channel delay encoding
left/right placement.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from ..configs import Config
from .batvision import _batch_iter
from .frontend import SPEED_OF_SOUND, tof_cut_samples


def _smooth_field(rng: np.random.Generator, size: int, cells: int = 8) -> np.ndarray:
    coarse = rng.uniform(0.0, 1.0, size=(cells, cells)).astype(np.float32)
    # bilinear upsample by separable linear interpolation
    xs = np.linspace(0, cells - 1, size)
    x0 = np.floor(xs).astype(int)
    x1 = np.minimum(x0 + 1, cells - 1)
    fx = (xs - x0).astype(np.float32)
    rows = coarse[x0] * (1 - fx)[:, None] + coarse[x1] * fx[:, None]
    return rows[:, x0] * (1 - fx)[None, :] + rows[:, x1] * fx[None, :]


class SyntheticEchoDataset:
    """Iterable of {'waveform': [B,2,L], 'depth': [B,S,S,1]} numpy batches."""

    def __init__(self, cfg: Config, num_samples: int = 256, seed: int = 0,
                 with_image: bool = False):
        ds = cfg.dataset
        self.size = ds.images_size
        self.max_depth = float(ds.max_depth)
        self.depth_norm = bool(ds.depth_norm)
        self.sr = ds.sample_rate
        self.length = tof_cut_samples(self.max_depth, self.sr) + 256
        self.num_samples = num_samples
        self.seed = seed
        self.with_image = with_image

    def sample(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed * 100003 + idx)
        s = self.size
        depth_m = _smooth_field(rng, s) * (0.9 * self.max_depth) + 0.05 * self.max_depth
        # invalid pixels (sensor dropout), like real BatVision depth
        invalid = _smooth_field(rng, s) < 0.15
        depth_m = np.where(invalid, 0.0, depth_m).astype(np.float32)

        wave = np.zeros((2, self.length), np.float32)
        qs = np.quantile(depth_m[depth_m > 0], [0.1, 0.3, 0.5, 0.7, 0.9])
        t = np.arange(256, dtype=np.float32)
        chirp = np.sin(2 * np.pi * (0.01 + 0.0008 * t) * t) * np.hanning(256).astype(np.float32)
        pan = rng.uniform(0.2, 0.8)
        for q, amp in zip(qs, [1.0, 0.8, 0.6, 0.4, 0.3]):
            delay = int((2 * q / SPEED_OF_SOUND) * self.sr)
            if delay + 256 + 4 >= self.length:
                continue
            wave[0, delay : delay + 256] += amp * pan * chirp
            itd = int(4 * (pan - 0.5))
            wave[1, delay + itd : delay + itd + 256] += amp * (1 - pan) * chirp
        wave += rng.normal(0, 0.01, size=wave.shape).astype(np.float32)

        depth = depth_m / self.max_depth if self.depth_norm else depth_m
        out = {"waveform": wave, "depth": depth[..., None]}  # NHWC single channel
        if self.with_image:
            # paired RGB view: shaded rendering of the scene (teacher input)
            shade = depth_m / self.max_depth
            out["image"] = np.stack(
                [shade, np.clip(shade + rng.normal(0, 0.05, shade.shape), 0, 1), 1.0 - shade],
                axis=-1).astype(np.float32)
        return out

    def __len__(self) -> int:
        return self.num_samples

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                drop_last: bool = True, shard=None) -> Iterator[Dict[str, np.ndarray]]:
        """`shard=(rank, world_size)`: that rank's rows of each global batch."""
        yield from _batch_iter(self, batch_size, shuffle, seed, drop_last, shard)
