"""UNet with a VAE bottleneck at its innermost 1×1 block, the `unet_cvae`
family (port of `models/unet_cvae.py`).

Differences from the baseline UNet, all the reference's:
  * the innermost block's bottleneck feature [B, C, 1, 1] is flattened and
    run through fc_mu / fc_logvar / reparameterize / fc_dec, with
    KL = mean_B(−½ Σ(1 + logvar − μ² − e^logvar));
  * the innermost block does not concatenate its skip, so the up-conv
    directly above it takes inner_nc channels;
  * the outermost head is the identity when depth_norm, else ReLU (not
    sigmoid, unlike the baseline).

The blocks are the reference's recursive blocks with named members, so the
state_dict keys are the reference's (`model.submodule.….downconv`, `.vae.fc_mu`,
...; `tools/import_torch.py::_spec_unet_cvae` of the JAX package). Every
block registers `downnorm` (inner_nc) and `upnorm` (outer_nc) as the
reference does, including the three it never runs (the outermost block's
two and the innermost block's `downnorm`), so a reference `.pth` loads with
strict=True.

The latent: with `sample`, eps ~ N(0, 1) is drawn from the `generator`
passed to `forward` (an explicit torch.Generator on the model's device),
for the global batch of a data-parallel step, each rank keeping its rows
(`parallel.draw_global`); without it, z = μ. The KL's batch mean is the
global batch's. forward(x) → (depth NCHW in at least fp32, kl).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.mesh import draw_global, global_mean
from .layers import ConvDown, ConvUp, at_least_f32, make_norm


class VAEBottleneck(nn.Module):
    def __init__(self, features: int, latent_dim: int = 128):
        super().__init__()
        self.fc_mu = nn.Linear(features, latent_dim)
        self.fc_logvar = nn.Linear(features, latent_dim)
        self.fc_dec = nn.Linear(latent_dim, features)

    def forward(self, h: torch.Tensor, sample: bool = True,
                generator: Optional[torch.Generator] = None, eps: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(recon, kl); with `sample`, eps is drawn from `generator` unless
        given (the exported inference graph gives its eps)."""
        b, c, hh, ww = h.shape
        # flattened in NHWC order, the JAX package's
        flat = at_least_f32(h.permute(0, 2, 3, 1).reshape(b, -1))
        mu = self.fc_mu(flat)
        logvar = self.fc_logvar(flat)
        if sample:
            if eps is None:
                # drawn for the global batch, this rank's rows kept
                eps = draw_global(lambda n: torch.randn(
                    (n,) + tuple(mu.shape[1:]), generator=generator, dtype=mu.dtype,
                    device=mu.device), b)
            z = mu + eps * torch.exp(0.5 * logvar)
        else:
            z = mu  # the posterior mean (parity tests)
        recon = self.fc_dec(z)
        kl = global_mean(-0.5 * torch.sum(1.0 + logvar - mu * mu - torch.exp(logvar), dim=1))
        recon = recon.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        return recon.to(h.dtype), kl


class _CVAEBlock(nn.Module):
    def __init__(self, outer_nc: int, inner_nc: int, input_nc: Optional[int] = None,
                 submodule: Optional[nn.Module] = None, outermost: bool = False,
                 innermost: bool = False, norm: str = "batch", use_dropout: bool = False,
                 depth_norm: bool = True, latent_dim: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.outermost, self.innermost = outermost, innermost
        self.depth_norm = depth_norm
        input_nc = outer_nc if input_nc is None else input_nc
        use_bias = norm == "instance"
        self.downconv = ConvDown(input_nc, inner_nc, use_bias, dtype)
        self.downnorm = make_norm(norm, inner_nc, dtype)  # never run outer- and innermost
        self.upnorm = make_norm(norm, outer_nc, dtype)  # never run outermost
        if outermost:
            self.upconv = ConvUp(inner_nc * 2, outer_nc, True, dtype)
        elif innermost:
            self.upconv = ConvUp(inner_nc, outer_nc, use_bias, dtype)
            self.vae = VAEBottleneck(inner_nc, latent_dim)
        else:
            # the block directly above the innermost gets no skip concat
            in_up = inner_nc if getattr(submodule, "innermost", False) else inner_nc * 2
            self.upconv = ConvUp(in_up, outer_nc, use_bias, dtype)
        self.submodule = submodule
        self.dropout = nn.Dropout(0.5) if use_dropout else None

    def forward(self, x: torch.Tensor, sample: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.outermost:
            h, kl = self.submodule(self.downconv(x), sample, generator)
            h = at_least_f32(self.upconv(F.relu(h)))
            return (h if self.depth_norm else F.relu(h)), kl
        h = self.downconv(F.leaky_relu(x, 0.2))
        if self.innermost:
            h, kl = self.vae(h, sample, generator)
        else:
            h, kl = self.submodule(self.downnorm(h), sample, generator)
        h = self.upnorm(self.upconv(F.relu(h)))
        if self.dropout is not None:
            h = self.dropout(h)
        if self.innermost:
            return h, kl
        return torch.cat([x, h], 1), kl


class UNetCVAE(nn.Module):
    def __init__(self, input_nc: int = 2, output_nc: int = 1, num_downs: int = 8,
                 ngf: int = 64, norm: str = "batch", use_dropout: bool = False,
                 depth_norm: bool = True, latent_dim: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self._num_downs = num_downs
        kw = dict(norm=norm, depth_norm=depth_norm, latent_dim=latent_dim, dtype=dtype)
        block = _CVAEBlock(ngf * 8, ngf * 8, innermost=True, **kw)
        for _ in range(num_downs - 5):
            block = _CVAEBlock(ngf * 8, ngf * 8, submodule=block, use_dropout=use_dropout, **kw)
        block = _CVAEBlock(ngf * 4, ngf * 8, submodule=block, **kw)
        block = _CVAEBlock(ngf * 2, ngf * 4, submodule=block, **kw)
        block = _CVAEBlock(ngf, ngf * 2, submodule=block, **kw)
        self.model = _CVAEBlock(output_nc, ngf, input_nc=input_nc, submodule=block,
                                outermost=True, **kw)

    def forward(self, x: torch.Tensor, sample: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, C, H, W] → ([B, output_nc, H, W], kl)."""
        return self.model(x, sample, generator)

    def never_run(self):
        """The names of the parameters of the three BatchNorms the reference
        registers and never runs (they get no gradient)."""
        inner = "model" + ".submodule" * (self._num_downs - 1)
        prefixes = ("model.downnorm.", "model.upnorm.", f"{inner}.downnorm.")
        return [n for n, _ in self.named_parameters() if n.startswith(prefixes)]


def build_unet_cvae(cfg) -> UNetCVAE:
    """Factory from a Config (the JAX package's `build_unet_cvae`)."""
    from ..configs import resolve_compute_dtype

    return UNetCVAE(
        input_nc=cfg.model.input_nc,
        output_nc=cfg.model.output_nc,
        num_downs=8 if cfg.model.generator == "unet_256" else 7,
        ngf=cfg.model.ngf,
        norm=cfg.model.norm,
        use_dropout=cfg.model.use_dropout,
        depth_norm=cfg.dataset.depth_norm,
        latent_dim=cfg.model.latent_dim,
        dtype=resolve_compute_dtype(cfg),
    )
