"""Building blocks of the UNet baseline (port of part of `models/layers.py`).

The port runs NCHW inside the model. Cast points follow the JAX package
exactly, with no autocast:
  * params are fp32; a conv casts its input, kernel and bias to the model's
    compute dtype (flax `nn.Conv(dtype=...)`), so its output is in that
    dtype;
  * BatchNorm computes in at least fp32 and casts back to the compute dtype;
  * the head is promoted with `at_least_f32`.

The residual/attention blocks (`DoubleConv`, `Down`, `UpBilinear`) wait for
the binaural slice.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def normal_init(std: float = 0.02) -> Callable[[torch.Tensor, Optional[torch.Generator]], None]:
    """Initializer filling a tensor with N(0, std) drawn in float32 on the
    CPU from an explicit generator, so a seed gives the same weights on
    every device."""

    def init(t: torch.Tensor, generator: Optional[torch.Generator] = None) -> None:
        draw = torch.empty(t.shape, dtype=torch.float32).normal_(0.0, std, generator=generator)
        with torch.no_grad():
            t.copy_(draw)

    return init


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """Cast to fp32 for numerics-critical math without ever DOWNcasting
    (the float64 mode stays float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d (momentum 0.1, eps 1e-5, affine) that normalizes in at
    least fp32 and casts the result back to the compute dtype."""

    def __init__(self, num_features: int, dtype: torch.dtype = torch.float32):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sdt = torch.promote_types(x.dtype, torch.float32)
        # `.to` returns the buffer itself when the dtype already matches, so
        # a train-mode forward still updates the running statistics in place
        y = F.batch_norm(
            x.to(sdt), self.running_mean.to(sdt), self.running_var.to(sdt),
            self.weight.to(sdt), self.bias.to(sdt),
            training=self.training, momentum=self.momentum, eps=self.eps)
        return y.to(self.compute_dtype)


class _InstanceNorm(nn.Module):
    """Per-sample, per-channel spatial normalization; no params, no stats."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
        return (x - mean) * torch.rsqrt(var + 1e-5)


def make_norm(norm: str, num_features: int, dtype: torch.dtype) -> nn.Module:
    """norm in {batch, instance, none} (unetbaseline_model.py:59-77)."""
    if norm == "batch":
        return BatchNorm(num_features, dtype=dtype)
    if norm == "instance":
        return _InstanceNorm()
    if norm == "none":
        return nn.Identity()
    raise ValueError(f"unknown norm {norm!r}")


class ConvDown(nn.Conv2d):
    """k4 s2 p1 strided conv (the pix2pix down-sampling conv)."""

    def __init__(self, in_ch: int, out_ch: int, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, out_ch, kernel_size=4, stride=2, padding=1, bias=use_bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class ConvUp(nn.ConvTranspose2d):
    """k4 s2 p1 transposed conv producing exactly 2x spatial (pix2pix up conv).

    flax's `ConvTranspose(padding="SAME")` holds the spatially flipped kernel
    of this one (tools/import_jax.py flips it on transfer)."""

    def __init__(self, in_ch: int, out_ch: int, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, out_ch, kernel_size=4, stride=2, padding=1, bias=use_bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), bias,
                                  stride=2, padding=1)
