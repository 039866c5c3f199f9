"""The coarse-depth family: depth as classification over bins (port of
`models/coarse_depth.py`).

  * `CoarseDepthUNet`: the shared encoder (`inc`, `down1..4`), a 4-Up
    decoder (`up1..4`) and an n_bins 1×1 head (`outc`); depth is
    Σ softmax(logits)·bin_centers (soft binning), the logits resized
    bilinearly to output_size when they are not that size already.
  * `CoarseDepthLite`: five strided convs (`encoder`, LeakyReLU 0.2) and five
    transposed convs (`decoder`, ReLU), each with a BatchNorm, and a 3×3
    n_bins `head`.
  * `CoarseWithOffsetModel` (hybrid): the encoder, a classification decoder
    (`coarse_up1..4`, `coarse_head`) and an offset decoder (`offset_up1..4`)
    whose fusion (`offset_fusion`, `offset_head`) consumes the coarse depth
    detached from the graph; final = coarse + offset.
  * `DualRegressionModel` (dual_reg): the same two decoders with a 1-channel
    regression `coarse_head`; no bins.

Module names are the reference's (`tools/import_torch.py::_spec_coarse_*`
of the JAX package), its blocks spelt `conv` / `pool_conv`. The unet, lite
and hybrid models hold `bin_centers` as a buffer, as reference `.pth` files
do, and soft-bin over it; the task writes its own centers into it (the
JAX package passes them as a forward argument). The logits and the depth
are in at least fp32 whatever the compute dtype; models run NCHW.

Spans (`obs.spans`): `coarse.bins` around each soft binning (one a
forward), `coarse.offset` around the offset branch (`_TwoDecoders._offset`:
the offset decoder, the resize, the concatenation of the detached coarse
depth, the fusion and the head).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

from ..obs.spans import span
from ..ops.resize import resize_bilinear
from .base_residual import SharedEncoder
from .layers import BatchNorm, Conv2d, ConvDown, ConvUp, UpBilinear, at_least_f32

# the reference's spelling of the DoubleConv / Down blocks
_NAMES = {"inner": "conv", "pool": "pool_conv"}


def soft_binning(logits: torch.Tensor, bin_centers: torch.Tensor) -> torch.Tensor:
    """Expected depth [B, 1, H, W] from [B, n_bins, H, W] logits and [n_bins]
    centers, the softmax in at least fp32."""
    probs = torch.softmax(at_least_f32(logits), dim=1)
    return (probs * bin_centers.to(probs.dtype)[None, :, None, None]).sum(dim=1, keepdim=True)


def _resize_bilinear_to(x: torch.Tensor, size: int) -> torch.Tensor:
    """`jax.image.resize(..., "linear")` of NCHW to size² (half-pixel
    centres, antialiased when it shrinks); the identity at size²."""
    if x.shape[2] == size and x.shape[3] == size:
        return x
    return resize_bilinear(x, size, size)


def _decoder(owner: nn.Module, prefix: str, c: int, dtype: torch.dtype) -> None:
    """The 4-Up UNet decoder over the encoder's pyramid: `{prefix}1..4`."""
    for i, (w_in, w_out) in enumerate(((c * 16, c * 4), (c * 8, c * 2), (c * 4, c), (c * 2, c))):
        setattr(owner, f"{prefix}{i + 1}", UpBilinear(w_in, w_out, dtype=dtype, inner="conv"))


def _decode(owner: nn.Module, prefix: str, f: Dict[str, torch.Tensor]) -> torch.Tensor:
    x = getattr(owner, f"{prefix}1")(f["x5"], f["x4"])
    x = getattr(owner, f"{prefix}2")(x, f["x3"])
    x = getattr(owner, f"{prefix}3")(x, f["x2"])
    return getattr(owner, f"{prefix}4")(x, f["x1"])


class CoarseDepthUNet(SharedEncoder):
    def __init__(self, input_channels: int = 2, n_bins: int = 128, base_channels: int = 64,
                 output_size: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__(input_channels, base_channels, dtype=dtype, **_NAMES)
        self.register_buffer("bin_centers", torch.linspace(0.0, 1.0, n_bins))
        self.output_size = output_size
        _decoder(self, "up", base_channels, dtype)
        self.outc = Conv2d(base_channels, n_bins, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = _decode(self, "up", SharedEncoder.forward(self, x))
        logits = _resize_bilinear_to(at_least_f32(self.outc(h)), self.output_size)
        with span("coarse.bins", logits.device):
            return logits, soft_binning(logits, self.bin_centers)


class CoarseDepthLite(nn.Module):
    def __init__(self, input_channels: int = 2, n_bins: int = 128, base_channels: int = 48,
                 output_size: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.register_buffer("bin_centers", torch.linspace(0.0, 1.0, n_bins))
        self.output_size = output_size
        c = base_channels
        layers, w_in = [], input_channels
        for w in (c, c * 2, c * 4, c * 8, c * 8):
            layers += [ConvDown(w_in, w, dtype=dtype), BatchNorm(w, dtype), nn.LeakyReLU(0.2)]
            w_in = w
        self.encoder = nn.Sequential(*layers)
        layers = []
        for w in (c * 8, c * 4, c * 2, c, c):
            layers += [ConvUp(w_in, w, dtype=dtype), BatchNorm(w, dtype), nn.ReLU()]
            w_in = w
        self.decoder = nn.Sequential(*layers)
        self.head = Conv2d(c, n_bins, 3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.decoder(self.encoder(x))
        logits = _resize_bilinear_to(at_least_f32(self.head(h)), self.output_size)
        with span("coarse.bins", logits.device):
            return logits, soft_binning(logits, self.bin_centers)


class _TwoDecoders(SharedEncoder):
    """The encoder, the coarse decoder and its 1×1 head (`head_out`
    channels), and the offset decoder with its fusion: conv3(c+1→c)+BN+ReLU
    → conv3(c→c/2)+BN+ReLU (`offset_fusion`) → 1×1 (`offset_head`)."""

    def __init__(self, input_channels: int, head_out: int, base_channels: int,
                 output_size: int, dtype: torch.dtype):
        super().__init__(input_channels, base_channels, dtype=dtype, **_NAMES)
        c = base_channels
        self.output_size = output_size
        _decoder(self, "coarse_up", c, dtype)
        self.coarse_head = Conv2d(c, head_out, 1, dtype=dtype)
        _decoder(self, "offset_up", c, dtype)
        self.offset_fusion = nn.Sequential(
            Conv2d(c + 1, c, 3, dtype=dtype), BatchNorm(c, dtype), nn.ReLU(),
            Conv2d(c, c // 2, 3, dtype=dtype), BatchNorm(c // 2, dtype), nn.ReLU())
        self.offset_head = Conv2d(c // 2, 1, 1, dtype=dtype)

    def _offset(self, f: Dict[str, torch.Tensor], coarse: torch.Tensor) -> torch.Tensor:
        """The offset from the offset decoder and the coarse depth, which
        enters detached (no gradient reaches the coarse branch through it)."""
        with span("coarse.offset", coarse.device):
            oh = _resize_bilinear_to(_decode(self, "offset_up", f), self.output_size)
            h = torch.cat([oh, coarse.detach().to(oh.dtype)], dim=1)
            return at_least_f32(self.offset_head(self.offset_fusion(h)))


class CoarseWithOffsetModel(_TwoDecoders):
    def __init__(self, input_channels: int = 2, n_bins: int = 8, base_channels: int = 64,
                 output_size: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__(input_channels, n_bins, base_channels, output_size, dtype)
        self.register_buffer("bin_centers", torch.linspace(0.0, 1.0, n_bins))

    def forward(self, x: torch.Tensor):
        """(logits, coarse, offset, final)."""
        f = SharedEncoder.forward(self, x)
        logits = self.coarse_head(_decode(self, "coarse_up", f))
        logits = _resize_bilinear_to(at_least_f32(logits), self.output_size)
        with span("coarse.bins", logits.device):
            coarse = soft_binning(logits, self.bin_centers)
        offset = self._offset(f, coarse)
        return logits, coarse, offset, coarse + offset


class DualRegressionModel(_TwoDecoders):
    def __init__(self, input_channels: int = 2, base_channels: int = 64,
                 output_size: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__(input_channels, 1, base_channels, output_size, dtype)

    def forward(self, x: torch.Tensor):
        """(coarse, offset, final)."""
        f = SharedEncoder.forward(self, x)
        coarse = at_least_f32(self.coarse_head(_decode(self, "coarse_up", f)))
        coarse = _resize_bilinear_to(coarse, self.output_size)
        offset = self._offset(f, coarse)
        return coarse, offset, coarse + offset


def build_coarse(model_type: str, input_channels: int, n_bins: int, base_channels: int,
                 output_size: int, dtype: torch.dtype) -> nn.Module:
    """The model of a coarse `model_type` (unet | lite | hybrid | dual_reg)."""
    common = dict(input_channels=input_channels, base_channels=base_channels,
                  output_size=output_size, dtype=dtype)
    if model_type == "unet":
        return CoarseDepthUNet(n_bins=n_bins, **common)
    if model_type == "lite":
        return CoarseDepthLite(n_bins=n_bins, **common)
    if model_type == "hybrid":
        return CoarseWithOffsetModel(n_bins=n_bins, **common)
    if model_type == "dual_reg":
        return DualRegressionModel(**common)
    raise ValueError(f"unknown coarse model_type {model_type!r}")
