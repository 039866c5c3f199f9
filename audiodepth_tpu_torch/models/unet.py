"""pix2pix-style UNet generator, the `unet_baseline` family (port of
`models/unet.py`).

Built as the reference's recursive skip-connection blocks
(models/unetbaseline_model.py:123-235) so that the state_dict keys are
exactly the reference's (`model.model.1.model.3.…`): a reference `.pth`
loads with `strict=True`, and `tools/import_jax.py` maps the JAX package's
variables onto the same keys. Each block's `nn.Sequential`:
  outermost: 0=downconv 1=submodule 2=uprelu 3=upconv 4=head
  middle:    0=downrelu 1=downconv 2=downnorm 3=submodule 4=uprelu
             5=upconv 6=upnorm [7=dropout]
  innermost: 0=downrelu 1=downconv 2=uprelu 3=upconv 4=upnorm
A non-outermost block returns cat([x, block(x)]) on channels, the JAX
package's cat([skip, h]).

The model takes and returns NCHW. Head: Sigmoid when depth_norm else ReLU,
after `at_least_f32` (unet.py:88 of the JAX package).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from .layers import ConvDown, ConvUp, at_least_f32, init_modules, make_norm, normal_init


class _Head(nn.Module):
    def __init__(self, depth_norm: bool):
        super().__init__()
        self.depth_norm = depth_norm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = at_least_f32(x)
        return torch.sigmoid(x) if self.depth_norm else torch.relu(x)


class UnetSkipConnectionBlock(nn.Module):
    def __init__(self, outer_nc: int, inner_nc: int, input_nc: Optional[int] = None,
                 submodule: Optional[nn.Module] = None, outermost: bool = False,
                 innermost: bool = False, norm: str = "batch",
                 use_dropout: bool = False, depth_norm: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.outermost = outermost
        input_nc = outer_nc if input_nc is None else input_nc
        use_bias = norm == "instance"
        downconv = ConvDown(input_nc, inner_nc, use_bias, dtype)
        if outermost:
            layers = [downconv, submodule, nn.ReLU(),
                      ConvUp(inner_nc * 2, outer_nc, True, dtype), _Head(depth_norm)]
        elif innermost:
            layers = [nn.LeakyReLU(0.2), downconv, nn.ReLU(),
                      ConvUp(inner_nc, outer_nc, use_bias, dtype),
                      make_norm(norm, outer_nc, dtype)]
        else:
            layers = [nn.LeakyReLU(0.2), downconv, make_norm(norm, inner_nc, dtype),
                      submodule, nn.ReLU(),
                      ConvUp(inner_nc * 2, outer_nc, use_bias, dtype),
                      make_norm(norm, outer_nc, dtype)]
            if use_dropout:
                layers.append(nn.Dropout(0.5))
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.outermost:
            return self.model(x)
        return torch.cat([x, self.model(x)], 1)


class UNetGenerator(nn.Module):
    def __init__(self, input_nc: int = 2, output_nc: int = 1, num_downs: int = 8,
                 ngf: int = 64, norm: str = "batch", use_dropout: bool = False,
                 depth_norm: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(norm=norm, depth_norm=depth_norm, dtype=dtype)
        block = UnetSkipConnectionBlock(ngf * 8, ngf * 8, innermost=True, **kw)
        for _ in range(num_downs - 5):
            block = UnetSkipConnectionBlock(ngf * 8, ngf * 8, submodule=block,
                                            use_dropout=use_dropout, **kw)
        block = UnetSkipConnectionBlock(ngf * 4, ngf * 8, submodule=block, **kw)
        block = UnetSkipConnectionBlock(ngf * 2, ngf * 4, submodule=block, **kw)
        block = UnetSkipConnectionBlock(ngf, ngf * 2, submodule=block, **kw)
        self.model = UnetSkipConnectionBlock(output_nc, ngf, input_nc=input_nc,
                                             submodule=block, outermost=True, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C, H, W] → [B, output_nc, H, W]."""
        return self.model(x)


def init_unet_weights(model: nn.Module, generator: torch.Generator,
                      std: float = 0.02) -> None:
    """The JAX package's init: N(0, std) conv kernels, zero biases, BN
    scale 1 / bias 0 and running stats 0 / 1. Draws in module order from
    `generator`."""
    init_modules(model, generator, normal_init(std))


def build_unet(cfg) -> UNetGenerator:
    """Factory from a Config (define_G twin, unetbaseline_model.py:84-120)."""
    gen = cfg.model.generator
    if gen == "unet_256":
        num_downs = 8
    elif gen == "unet_128":
        num_downs = 7
    else:
        raise NotImplementedError(f"generator {gen!r} not recognized")
    from ..configs import resolve_compute_dtype

    return UNetGenerator(
        input_nc=cfg.model.input_nc,
        output_nc=cfg.model.output_nc,
        num_downs=num_downs,
        ngf=cfg.model.ngf,
        norm=cfg.model.norm,
        use_dropout=cfg.model.use_dropout,
        depth_norm=cfg.dataset.depth_norm,
        dtype=resolve_compute_dtype(cfg),
    )
