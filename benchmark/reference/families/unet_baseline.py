"""unet_baseline: the pix2pix UNet generator (`unet_256`: 8 downsamplings,
`unet_128`: 7; k4 s2 p1 convs, BatchNorm, LeakyReLU 0.2 down, ReLU up,
skip concat, ReLU head in meters when the depth is not normalised) on the
mel front end's image of the two channels, trained on the Combined loss.
Initialisation: N(0, 0.02) kernels, BatchNorm 1/0."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from ..nets import BatchNorm, Conv, ConvTranspose, LeakyRelu, Relu, state_specs
from ..train import mel_combined_loss as train_loss  # noqa: F401
from ..train import mel_predict as predict  # noqa: F401


class UnetBlock(nn.Module):
    def __init__(self, outer, inner, input_nc=None, sub=None, outermost=False,
                 innermost=False, prec=None):
        super().__init__()
        self.outermost = outermost
        input_nc = outer if input_nc is None else input_nc
        down = Conv(input_nc, inner, 4, 2, 1, bias=False, prec=prec)
        if outermost:
            layers = [down, sub, Relu(), ConvTranspose(inner * 2, outer, True, prec), Relu()]
        elif innermost:
            layers = [LeakyRelu(), down, Relu(), ConvTranspose(inner, outer, False, prec),
                      BatchNorm(outer)]
        else:
            layers = [LeakyRelu(), down, BatchNorm(inner), sub, Relu(),
                      ConvTranspose(inner * 2, outer, False, prec), BatchNorm(outer)]
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        if self.outermost:
            return self.model(x)
        return torch.cat([x, self.model(x)], 1)


class UNet(nn.Module):
    def __init__(self, input_nc=2, output_nc=1, num_downs=8, ngf=64, prec=None):
        super().__init__()
        block = UnetBlock(ngf * 8, ngf * 8, innermost=True, prec=prec)
        for _ in range(num_downs - 5):
            block = UnetBlock(ngf * 8, ngf * 8, sub=block, prec=prec)
        block = UnetBlock(ngf * 4, ngf * 8, sub=block, prec=prec)
        block = UnetBlock(ngf * 2, ngf * 4, sub=block, prec=prec)
        block = UnetBlock(ngf, ngf * 2, sub=block, prec=prec)
        self.model = UnetBlock(output_nc, ngf, input_nc=input_nc, sub=block, outermost=True,
                               prec=prec)

    def forward(self, x):
        """NHWC in, NHWC depth in meters out."""
        return self.model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def build_net(cfg: Dict, prec=None, checkpointed: bool = False) -> nn.Module:
    """The UNet of the configuration's `generator` and `ngf` (it keeps every
    activation: `checkpointed` changes nothing)."""
    downs = {"unet_256": 8, "unet_128": 7}[cfg.get("generator", "unet_256")]
    return UNet(num_downs=downs, ngf=int(cfg["ngf"]), prec=prec)


def param_specs(cfg: Dict):
    with torch.device("meta"):
        net = build_net(cfg)
    return state_specs(net, lambda shape: 0.02)
