"""Edge-aware loss family of the binaural attention model (port of
`losses/binaural.py`).

Components, on NHWC single-channel maps with the gt > 0 validity mask m:
  recon  = Σ|pred·m − gt·m| / (Σm + 1e-6)
  edge   = L1 between Sobel gradient magnitudes, weighted by the DILATED
           mask (a 3×3 max-pool of m; the reference calls it "eroded")
  smooth = Σ (|∇x pred| + |∇y pred|) · exp(−|∇gt|) · m / (Σm + 1e-6)
The Sobel maps are computed in float32, as the JAX package computes them
(also in its float64 mode). Every sum is over the global batch
(`parallel.global_sum`), the `+ 1e-6` added once to the global mask sums.

Also the RGB teacher's loss: unmasked L1 + mean first-difference smoothness.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..parallel.mesh import global_mean, global_sum

_SOBEL = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))


@functools.lru_cache(maxsize=8)
def _sobel_taps(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The [2, 1, 3, 3] Sobel weight (x, then y), made once per (device,
    dtype): an upload inside a train step would wait for the card."""
    kx = torch.tensor(_SOBEL, dtype=dtype, device=device)
    return torch.stack([kx, kx.t()])[:, None]


def _sobel(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sobel gradients (x, y) of NHWC single-channel maps, zero 'same'
    padding, in float32."""
    weight = _sobel_taps(x.device, torch.float32)
    g = F.conv2d(x.to(torch.float32).permute(0, 3, 1, 2), weight, padding=1)
    g = g.permute(0, 2, 3, 1)
    return g[..., 0:1], g[..., 1:2]


def _grad_mag(x: torch.Tensor) -> torch.Tensor:
    gx, gy = _sobel(x)
    return torch.sqrt(gx * gx + gy * gy + 1e-6)


def binaural_attention_loss(pred: torch.Tensor, gt: torch.Tensor, lambda_recon=1.0,
                            lambda_edge=0.2, lambda_smooth=0.1
                            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    m = (gt > 0).to(torch.float32)
    recon_sum = global_sum((pred * m - gt * m).abs().sum())

    pred_grad = _grad_mag(pred)
    gt_grad = _grad_mag(gt)
    m_dil = F.max_pool2d(m.permute(0, 3, 1, 2), 3, stride=1, padding=1).permute(0, 2, 3, 1)
    pgx, pgy = _sobel(pred)
    smooth = pgx.abs() + pgy.abs()
    # the float32 sums in one all-reduce: Σm, Σm_dil, the edge and the
    # smoothness numerators
    sums = global_sum(torch.stack([
        m.sum(), m_dil.sum(), (pred_grad * m_dil - gt_grad * m_dil).abs().sum(),
        (smooth * torch.exp(-gt_grad) * m).sum()]))
    msum = sums[0] + 1e-6
    loss_recon = recon_sum / msum
    loss_edge = sums[2] / (sums[1] + 1e-6)
    loss_smooth = sums[3] / msum

    total = lambda_recon * loss_recon + lambda_edge * loss_edge + lambda_smooth * loss_smooth
    return total, {"recon": loss_recon, "edge": loss_edge, "smooth": loss_smooth,
                   "total": total}


def adaptive_binaural_weights(epoch: float, warmup_epochs: int = 20):
    """3-phase curriculum (utils_binaural_attention_loss.py:199-218):
    (λ_recon, λ_edge, λ_smooth) at a 0-based epoch."""
    w = float(warmup_epochs)
    epoch = float(epoch)
    lam_edge = 0.0 if epoch < w else (0.2 * (epoch - w) / (2 * w) if epoch < 3 * w else 0.2)
    lam_smooth = 0.0 if epoch < 3 * w else 0.1 * min((epoch - 3 * w) / w, 1.0)
    return 1.0, lam_edge, lam_smooth


def rgb_depth_loss(pred: torch.Tensor, gt: torch.Tensor, lambda_l1: float = 1.0,
                   lambda_smooth: float = 0.1):
    """RGB teacher loss: UNMASKED L1 + first-difference smoothness."""
    l1 = global_mean((pred - gt).abs())
    dx = global_mean((pred[:, :, :-1, :] - pred[:, :, 1:, :]).abs())
    dy = global_mean((pred[:, :-1, :, :] - pred[:, 1:, :, :]).abs())
    smooth = dx + dy
    total = lambda_l1 * l1 + lambda_smooth * smooth
    return total, {"l1": l1, "smooth": smooth, "total": total}
