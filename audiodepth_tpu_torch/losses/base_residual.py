"""The three-component base + residual loss and its curriculum (port of
`losses/base_residual.py`).

  L = λ_recon · recon(final, gt)            (L1 | L2 | SIlog, masked)
    + λ_base  · L1(base, AvgPool_k16(gt))   (the low-pass target is taken
                of the unmasked gt, without gradient)
    + λ_sparse· mean|residual|              (masked)

The adaptive schedule anneals λ_recon and λ_base linearly over
warmup_epochs, then holds them. The frequency-aware variant splits the gt
with a centred 2-D FFT. Maps are NHWC, single channel. Every mean is over
the global batch (`parallel.global_sum`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..parallel.mesh import global_mean
from .basic import l1_loss, l2_loss, masked_mean, silog_loss


@torch.no_grad()
def lowpass_avgpool(gt: torch.Tensor, kernel: int = 16) -> torch.Tensor:
    """AvgPool(k, stride 1, pad k//2, count_include_pad) of NHWC gt, which
    gives H+1 × W+1 for even k, brought back to H × W by a bilinear resize
    (align_corners=False, no antialias)."""
    x = gt.permute(0, 3, 1, 2)
    pooled = F.avg_pool2d(x, kernel, stride=1, padding=kernel // 2, count_include_pad=True)
    if pooled.shape[-2:] != x.shape[-2:]:
        pooled = F.interpolate(pooled, size=x.shape[-2:], mode="bilinear",
                               align_corners=False, antialias=False)
    return pooled.permute(0, 2, 3, 1)


def adaptive_weights(epoch: float, warmup_epochs: int = 50, recon_init: float = 0.3,
                     recon_final: float = 1.0, base_init: float = 2.0,
                     base_final: float = 0.3) -> Tuple[float, float]:
    """(λ_recon, λ_base) at a 0-based epoch: a linear anneal over warmup."""
    alpha = min(max(float(epoch) / max(warmup_epochs, 1), 0.0), 1.0)
    return (recon_init + alpha * (recon_final - recon_init),
            base_init + alpha * (base_final - base_init))


def separate_frequencies(depth: torch.Tensor, freq_cutoff: float = 0.1
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(low, high) pass of NHWC depth maps: a centred 2-D FFT, a square
    low-pass mask of half-width cutoff·dim (rows and columns [c − cut,
    c + cut)), the inverse transforms' real parts, in float32 whatever the
    maps' dtype, as the JAX package computes them (also in its float64
    mode)."""
    h, w = depth.shape[1], depth.shape[2]
    x = torch.fft.fftshift(torch.fft.fft2(depth.to(torch.float32), dim=(1, 2)), dim=(1, 2))
    ch, cw = h // 2, w // 2
    cut_h, cut_w = int(h * freq_cutoff), int(w * freq_cutoff)
    ys = torch.arange(h, device=depth.device)[None, :, None, None]
    xs = torch.arange(w, device=depth.device)[None, None, :, None]
    mask = (ys >= ch - cut_h) & (ys < ch + cut_h) & (xs >= cw - cut_w) & (xs < cw + cut_w)
    low = torch.fft.ifft2(torch.fft.ifftshift(x * mask, dim=(1, 2)), dim=(1, 2)).real
    high = torch.fft.ifft2(torch.fft.ifftshift(x * ~mask, dim=(1, 2)), dim=(1, 2)).real
    return low, high


def frequency_aware_base_residual_loss(base, residual, final, gt, lambda_recon: float = 1.0,
                                       lambda_base_low: float = 0.5,
                                       lambda_res_high: float = 0.3,
                                       lambda_sparse: float = 0.1, freq_cutoff: float = 0.1):
    """The experimental frequency-domain variant (unmasked): base matches
    the gt's low frequencies, residual its high frequencies."""
    loss_recon = l1_loss(final, gt)
    gt_low, gt_high = (t.detach() for t in separate_frequencies(gt, freq_cutoff))
    loss_base_low = l1_loss(base, gt_low)
    loss_res_high = l1_loss(residual, gt_high)
    loss_sparse = global_mean(residual.abs())
    total = (lambda_recon * loss_recon + lambda_base_low * loss_base_low
             + lambda_res_high * loss_res_high + lambda_sparse * loss_sparse)
    return total, {"recon": loss_recon, "base_low": loss_base_low, "res_high": loss_res_high,
                   "sparse": loss_sparse, "total": total}


def base_residual_loss(base, residual, final, gt, mask, lambda_recon=1.0, lambda_base=1.2,
                       lambda_sparse=0.05, lowpass_kernel: int = 16, recon: str = "l1",
                       silog_lambda: float = 0.5
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """recon in {l1, l2, silog}."""
    gt_struct = lowpass_avgpool(gt, lowpass_kernel)
    if recon == "silog":
        loss_recon = silog_loss(final, gt, mask, lambda_scale=silog_lambda)
    elif recon == "l2":
        loss_recon = l2_loss(final, gt, mask)
    else:
        loss_recon = l1_loss(final, gt, mask)
    loss_base = l1_loss(base, gt_struct, mask)
    loss_sparse = masked_mean(residual.abs(), mask)
    total = lambda_recon * loss_recon + lambda_base * loss_base + lambda_sparse * loss_sparse
    return total, {"recon": loss_recon, "base": loss_base, "sparse": loss_sparse,
                   "total": total}
