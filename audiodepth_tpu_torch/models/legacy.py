"""Legacy generic blocks (port of `models/legacy.py`, the reference's
models/utils_models.py).

The reference keeps encode / fc / decode blocks that no current model uses
(utils_models.py:6-65); they are here for parity with it:
  * `EncodeBlock`: k4 s2 p1 conv (with bias) → BatchNorm → LeakyReLU 0.2;
  * `FCBlock`: Linear → BatchNorm over [B, F] → LeakyReLU 0.2;
  * `DecodeBlock`: k4 s2 p1 transposed conv (with bias, exactly 2× up) →
    BatchNorm → LeakyReLU 0.2.
Each is a Sequential (`0` the conv or linear, `1` the BatchNorm). The
BatchNorm is the port's: at least fp32, torch's unbiased running variance.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import BatchNorm, ConvDown, ConvUp


class _Linear(nn.Linear):
    """A Linear that computes in the model's compute dtype (flax
    `nn.Dense(dtype=...)`)."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return nn.functional.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class EncodeBlock(nn.Sequential):
    def __init__(self, in_ch: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__(ConvDown(in_ch, features, dtype=dtype), BatchNorm(features, dtype),
                         nn.LeakyReLU(0.2))


class FCBlock(nn.Sequential):
    def __init__(self, in_features: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__(_Linear(in_features, features, dtype), BatchNorm(features, dtype),
                         nn.LeakyReLU(0.2))


class DecodeBlock(nn.Sequential):
    def __init__(self, in_ch: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__(ConvUp(in_ch, features, dtype=dtype), BatchNorm(features, dtype),
                         nn.LeakyReLU(0.2))
