"""The RGB teacher UNet, the `rgb_depth` family (port of
`models/rgb_depth.py`).

A plain UNet for 3-channel camera images whose feature widths (c, 2c, 4c,
8c, 8c at x1-x5; 4c, 2c, c, c at d4-d1) match the binaural student's fused
pyramid. The head is a 1×1 conv clamped to [0, max_depth] (no sigmoid);
when its size differs from `output_size` it is resized first with
`jax.image.resize`'s "linear" (antialiased when it shrinks).

Module names are the reference's (`tools/import_torch.py::_spec_rgb_depth`
of the JAX package): `inc`, `down1..4`, `up1..4`, `outc`. The model takes
and returns NCHW.
"""

from __future__ import annotations

import torch

from ..ops.resize import resize_bilinear
from .base_residual import SharedEncoder
from .layers import Conv2d, UpBilinear, at_least_f32


class RGBDepthNet(SharedEncoder):
    def __init__(self, base_channels: int = 64, max_depth: float = 30.0,
                 output_size: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__(3, base_channels, dtype=dtype)
        self.max_depth = float(max_depth)
        self.output_size = int(output_size)
        c = base_channels
        self.up1 = UpBilinear(c * 16, c * 4, dtype=dtype)
        self.up2 = UpBilinear(c * 8, c * 2, dtype=dtype)
        self.up3 = UpBilinear(c * 4, c, dtype=dtype)
        self.up4 = UpBilinear(c * 2, c, dtype=dtype)
        self.outc = Conv2d(c, 1, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = SharedEncoder.forward(self, x)
        d = self.up1(f["x5"], f["x4"])
        d = self.up2(d, f["x3"])
        d = self.up3(d, f["x2"])
        d = self.up4(d, f["x1"])
        depth = at_least_f32(self.outc(d))
        if depth.shape[-2] != self.output_size:
            depth = resize_bilinear(depth, self.output_size, self.output_size)
        return torch.clamp(depth, 0.0, self.max_depth)
