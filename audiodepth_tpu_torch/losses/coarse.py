"""Classification losses of the coarse-depth family (port of
`losses/coarse.py`).

Logits are [B, H, W, N] (NHWC, the tasks' layout) and bin targets
[B, H, W] integers. The classification terms compute in `CE_DTYPE`,
float32, whatever the compute dtype (the float64 mode included): the JAX
package casts them with `astype(jnp.float32)`.
  * `ordinal_regression_loss`: cumulative BCE (bins ≤ target positive),
    mean over everything;
  * `soft_cross_entropy_loss`: Gaussian soft labels (σ) around the target
    bin against log-softmax;
  * `hard_cross_entropy_loss`: one-hot CE, with optional label smoothing;
  * `focal_loss`: (1 − p_t)^γ · CE;
  * `coarse_depth_loss`: CE (soft / focal / hard) + masked L1 on the
    soft-binned depth;
  * `coarse_offset_loss`: hard CE + UNMASKED L1(final, gt) + offset-L1
    regularization (+ coarse L1 for monitoring);
  * `dual_regression_loss`: masked L1 on coarse and final + offset
    regularization.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .basic import l1_loss, l2_loss


# the dtype of the classification terms (the JAX package's jnp.float32)
CE_DTYPE = torch.float32


def _log_softmax_bins(logits: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(logits.to(CE_DTYPE), dim=-1)


def ordinal_regression_loss(logits: torch.Tensor, target_bins: torch.Tensor) -> torch.Tensor:
    x = logits.to(CE_DTYPE)
    bin_idx = torch.arange(x.shape[-1], device=x.device)
    labels = (bin_idx <= target_bins[..., None]).to(CE_DTYPE)
    # BCE with logits: max(x, 0) - x·z + log(1 + exp(-|x|))
    bce = x.clamp_min(0) - x * labels + torch.log1p(torch.exp(-x.abs()))
    return bce.mean()


def soft_cross_entropy_loss(logits: torch.Tensor, target_bins: torch.Tensor,
                            sigma: float = 2.0) -> torch.Tensor:
    logp = _log_softmax_bins(logits)
    bin_idx = torch.arange(logits.shape[-1], device=logp.device, dtype=CE_DTYPE)
    t = target_bins[..., None].to(CE_DTYPE)
    soft = torch.exp(-0.5 * ((bin_idx - t) / sigma) ** 2)
    soft = soft / (soft.sum(dim=-1, keepdim=True) + 1e-8)
    return (-(soft * logp).sum(dim=-1)).mean()


def hard_cross_entropy_loss(logits: torch.Tensor, target_bins: torch.Tensor,
                            label_smoothing: float = 0.0) -> torch.Tensor:
    n = logits.shape[-1]
    logp = _log_softmax_bins(logits)
    onehot = F.one_hot(target_bins.long(), n).to(logp.dtype)
    if label_smoothing > 0:
        onehot = onehot * (1 - label_smoothing) + label_smoothing / n
    return (-(onehot * logp).sum(dim=-1)).mean()


def focal_loss(logits: torch.Tensor, target_bins: torch.Tensor,
               gamma: float = 2.0) -> torch.Tensor:
    logp = _log_softmax_bins(logits)
    ce = -torch.gather(logp, -1, target_bins[..., None].long())[..., 0]
    pt = torch.exp(-ce)
    return (((1.0 - pt) ** gamma) * ce).mean()


def coarse_depth_loss(logits, pred_depth, target_bins, target_depth, mask=None,
                      ce_weight: float = 1.0, regression_weight: float = 0.5,
                      mode: str = "soft_ce", focal_gamma: float = 2.0,
                      soft_ce_sigma: float = 2.0
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    if mode == "focal":
        ce = focal_loss(logits, target_bins, focal_gamma)
    elif mode == "soft_ce":
        ce = soft_cross_entropy_loss(logits, target_bins, soft_ce_sigma)
    else:
        ce = hard_cross_entropy_loss(logits, target_bins)
    reg = l1_loss(pred_depth, target_depth, mask)
    total = ce_weight * ce + regression_weight * reg
    return total, {"ce": ce, "regression": reg, "total": total}


def coarse_offset_loss(logits, coarse_depth, offset, final_depth, target_depth, target_bins,
                       ce_weight: float = 1.0, regression_weight: float = 1.0,
                       offset_reg_weight: float = 0.1, regression: str = "l1",
                       label_smoothing: float = 0.0
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    ce = hard_cross_entropy_loss(logits, target_bins, label_smoothing)
    reg_fn = l1_loss if regression == "l1" else l2_loss
    reg = reg_fn(final_depth, target_depth)          # unmasked (the reference's)
    offset_reg = offset.abs().mean()
    total = ce_weight * ce + regression_weight * reg + offset_reg_weight * offset_reg
    return total, {"ce": ce, "regression": reg, "offset_reg": offset_reg,
                   "coarse_l1": l1_loss(coarse_depth, target_depth), "total": total}


def dual_regression_loss(coarse_depth, offset, final_depth, target_depth,
                         coarse_weight: float = 1.0, final_weight: float = 1.0,
                         offset_reg_weight: float = 0.01
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    mask = target_depth > 0
    coarse = l1_loss(coarse_depth, target_depth, mask)
    final = l1_loss(final_depth, target_depth, mask)
    offset_reg = offset.abs().mean()
    total = coarse_weight * coarse + final_weight * final + offset_reg_weight * offset_reg
    return total, {"coarse": coarse, "final": final, "offset_reg": offset_reg, "total": total}
