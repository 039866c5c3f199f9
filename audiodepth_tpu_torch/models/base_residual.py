"""The shared residual encoder (port of `models/base_residual.py`,
`SharedEncoder` only; `BaseResidualNet` waits for its family's slice).

inc + down1..4 with base_channels × {1, 2, 4, 8, 8} (bilinear factor 2),
under the reference's module names (`inc.double_conv.*`,
`down{i}.maxpool_conv.1.double_conv.*`). With `remat`, a train-mode forward
under grad keeps none of its activations and recomputes them in the
backward (`layers.remat`).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from .layers import DoubleConv, Down, remat


class SharedEncoder(nn.Module):
    def __init__(self, in_ch: int, base_channels: int = 64, dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        c = base_channels
        self.inc = DoubleConv(in_ch, c, dtype=dtype)
        self.down1 = Down(c, c * 2, dtype=dtype)
        self.down2 = Down(c * 2, c * 4, dtype=dtype)
        self.down3 = Down(c * 4, c * 8, dtype=dtype)
        self.down4 = Down(c * 8, c * 8, dtype=dtype)  # 16 // factor

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.remat and self.training and torch.is_grad_enabled():
            return remat(self._forward, x)
        return self._forward(x)

    def _forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        return {"x1": x1, "x2": x2, "x3": x3, "x4": x4, "x5": x5}
