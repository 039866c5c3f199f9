"""The shared residual encoder and the `base_residual` family (port of
`models/base_residual.py`).

`SharedEncoder`: inc + down1..4 with base_channels × {1, 2, 4, 8, 8}
(bilinear factor 2), under the reference's module names
(`inc.double_conv.*`, `down{i}.maxpool_conv.1.double_conv.*`; the
coarse-depth family's `inc.conv.*`, `down{i}.pool_conv.1.conv.*` with
inner="conv", pool="pool_conv"). With
`remat`, a train-mode forward under grad keeps none of its activations and
recomputes them in the backward (`layers.remat`).

`BaseResidualNet`: the encoder feeding
  * a thin base decoder whose widths are 128/64/32/16 whatever
    base_channels is (`base_up1..4`), head `base_head`: sigmoid·max_depth;
  * a full-width residual decoder (4c/2c/c/c, `res_up1..4`), head
    `res_head`: tanh·(0.3·max_depth).
forward → (base, residual), both NCHW in at least fp32; the task computes
final = clip(base + residual, 0, max_depth) and decides where gradients
flow (the detach curriculum). Module names are the reference's
(`tools/import_torch.py::_spec_base_residual` of the JAX package).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

from .layers import Conv2d, DoubleConv, Down, UpBilinear, at_least_f32, remat


class SharedEncoder(nn.Module):
    def __init__(self, in_ch: int, base_channels: int = 64, dtype: torch.dtype = torch.float32,
                 remat: bool = False, inner: str = "double_conv", pool: str = "maxpool_conv"):
        super().__init__()
        self.remat = remat
        c = base_channels
        names = {"inner": inner, "pool": pool}
        self.inc = DoubleConv(in_ch, c, dtype=dtype, inner=inner)
        self.down1 = Down(c, c * 2, dtype=dtype, **names)
        self.down2 = Down(c * 2, c * 4, dtype=dtype, **names)
        self.down3 = Down(c * 4, c * 8, dtype=dtype, **names)
        self.down4 = Down(c * 8, c * 8, dtype=dtype, **names)  # 16 // factor

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


# the thin base decoder's widths (fixed in the reference's design)
BASE_WIDTHS = (128, 64, 32, 16)


class BaseResidualNet(SharedEncoder):
    """The encoder's modules sit at the top level (`inc`, `down1..4`), as in
    the reference."""

    def __init__(self, input_channels: int = 2, base_channels: int = 64,
                 max_depth: float = 30.0, dtype: torch.dtype = torch.float32):
        super().__init__(input_channels, base_channels, dtype=dtype)
        self.max_depth = float(max_depth)
        c = base_channels
        skips = (c * 8, c * 4, c * 2, c)  # x4, x3, x2, x1
        ins = (c * 8,) + BASE_WIDTHS[:3]
        for i, (w_in, skip, w_out) in enumerate(zip(ins, skips, BASE_WIDTHS)):
            setattr(self, f"base_up{i + 1}", UpBilinear(w_in + skip, w_out, dtype=dtype))
        self.base_head = Conv2d(BASE_WIDTHS[-1], 1, 1, dtype=dtype)
        res = (c * 4, c * 2, c, c)
        ins = (c * 8,) + res[:3]
        for i, (w_in, skip, w_out) in enumerate(zip(ins, skips, res)):
            setattr(self, f"res_up{i + 1}", UpBilinear(w_in + skip, w_out, dtype=dtype))
        self.res_head = Conv2d(c, 1, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        f = SharedEncoder.forward(self, x)
        b = self.base_up1(f["x5"], f["x4"])
        b = self.base_up2(b, f["x3"])
        b = self.base_up3(b, f["x2"])
        b = self.base_up4(b, f["x1"])
        base = torch.sigmoid(at_least_f32(self.base_head(b))) * self.max_depth
        r = self.res_up1(f["x5"], f["x4"])
        r = self.res_up2(r, f["x3"])
        r = self.res_up3(r, f["x2"])
        r = self.res_up4(r, f["x1"])
        residual = torch.tanh(at_least_f32(self.res_head(r))) * (0.3 * self.max_depth)
        return base, residual
