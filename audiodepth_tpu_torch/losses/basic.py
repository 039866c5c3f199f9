"""Core depth losses: masked L1, L2, SIlog and the Combined criterion (port
of `losses/basic.py`).

Functions of tensors in any layout (the tasks pass NHWC, as the JAX package
does). Every loss takes an optional `mask` and computes the weighted mean
over the valid pixels, which equals the reference's mean over gathered
pixels without a data-dependent shape.

SIlog (the reference's utils_loss.py):
    d = log(clamp(pred, eps)) - log(clamp(target, eps))
    SIlog = sqrt(max(mean(d^2) - lam * mean(d)^2, 0))

Every mean is over the global batch: its sums go through
`parallel.global_sum`, the count's clamp applies once to the global count,
and SIlog takes the square root of the global moments. On one rank the
sums are the local ones.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.mesh import global_mean, global_sum


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Σ x·m / max(Σ m, 1) over the global batch (the plain mean without a
    mask)."""
    if mask is None:
        return global_mean(x)
    w = mask.to(x.dtype)
    sums = global_sum(torch.stack([(x * w).sum(), w.sum()]))
    return sums[0] / sums[1].clamp_min(1.0)


def l1_loss(pred, target, mask=None):
    return masked_mean((pred - target).abs(), mask)


def l2_loss(pred, target, mask=None):
    d = pred - target
    return masked_mean(d * d, mask)


def silog_loss(pred, target, mask=None, lambda_scale: float = 0.5, eps: float = 1e-6):
    d = torch.log(pred.clamp_min(eps)) - torch.log(target.clamp_min(eps))
    m2 = masked_mean(d * d, mask)
    m1 = masked_mean(d, mask)
    return torch.sqrt((m2 - lambda_scale * m1 * m1).clamp_min(0.0))


def combined_loss(pred, target, mask=None, l1_weight: float = 0.237,
                  silog_weight: float = 0.637, silog_lambda: float = 0.869):
    """Weighted L1 + SIlog (the swept defaults of conf/mode/train.yaml)."""
    return (l1_weight * l1_loss(pred, target, mask)
            + silog_weight * silog_loss(pred, target, mask, lambda_scale=silog_lambda))


def make_criterion(name: str, *, l1_weight=0.237, silog_weight=0.637, silog_lambda=0.869):
    """loss_fn(pred, target, mask) for a criterion name (L1|L2|SIlog|Combined)."""
    key = name.lower()
    if key == "l1":
        return l1_loss
    if key in ("l2", "mse"):
        return l2_loss
    if key == "silog":
        return lambda p, t, m=None: silog_loss(p, t, m, lambda_scale=silog_lambda)
    if key == "combined":
        return lambda p, t, m=None: combined_loss(
            p, t, m, l1_weight=l1_weight, silog_weight=silog_weight, silog_lambda=silog_lambda)
    raise ValueError(f"unknown criterion: {name!r}")
