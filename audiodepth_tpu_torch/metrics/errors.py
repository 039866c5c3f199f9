"""Depth evaluation metrics (port of `metrics/errors.py`).

Two implementations of one metric definition:
  * `compute_errors_np`: the host-side numpy reference, whose semantics
    (valid-pixel masking, adaptive epsilon, fallbacks for degenerate
    predictions) replicate the reference's evaluation function and define
    metric parity;
  * `compute_errors_batch`: batched tensor metrics on the device, the
    common (non-degenerate) branch with weighted means, equal to the numpy
    version when predictions are clipped to [EVAL_PRED_MIN, max_depth].

Metric order everywhere: (abs_rel, rmse, delta1, delta2, delta3, log10, mae).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

METRIC_NAMES = ("abs_rel", "rmse", "delta1", "delta2", "delta3", "log10", "mae")

# Lower clip bound of predictions entering `compute_errors_batch`: one f32 ulp
# above the 1e-3 meter epsilon, so that every clipped pixel is on the common
# branch of both versions (the batch version compares in f32, the numpy one
# in f64, where f32(1e-3) > 1e-3).
EVAL_PRED_MIN = float(np.nextafter(np.float32(1e-3), np.float32(np.inf)))


def _nan_to_zero(x: float) -> float:
    if x != x or x == np.inf:
        return 0.0
    return float(x)


def compute_errors_np(gt, pred):
    """Numpy reference metrics between gt and predicted depth.

    Pixels with gt == 0 are invalid; an adaptive epsilon (1e-3 in meters,
    1e-6 normalized) filters near-zero values; degenerate predictions fall
    through a chain of fallbacks ending in the failure sentinel
    ``(1.0, gt.max(), 0, 0, 0, 1.0, gt.max())``.
    """
    gt = np.asarray(gt, dtype=np.float64).reshape(-1)
    pred = np.asarray(pred, dtype=np.float64).reshape(-1)

    mask = gt != 0.0
    if mask.sum() == 0:
        return 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0
    pred = pred[mask]
    gt = gt[mask]

    eps = 1e-3 if gt.max() > 1.0 else 1e-6
    valid = (pred > eps) & (gt > eps)
    if valid.sum() == 0:
        valid = gt > eps
        if valid.sum() == 0:
            return 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0
        valid = valid & (pred > 0)
        if valid.sum() == 0:
            # every prediction non-positive: the failure sentinel
            return 1.0, float(gt.max()), 0.0, 0.0, 0.0, 1.0, float(gt.max())
    pred = pred[valid]
    gt = gt[valid]

    eps = 1e-3 if gt.max() > 1.0 else 1e-6
    thresh = np.maximum(gt / np.maximum(pred, eps), np.maximum(pred, eps) / gt)
    a1 = _nan_to_zero((thresh < 1.25).mean())
    a2 = _nan_to_zero((thresh < 1.25 ** 2).mean())
    a3 = _nan_to_zero((thresh < 1.25 ** 3).mean())
    rmse = _nan_to_zero(np.sqrt(((gt - pred) ** 2).mean()))
    abs_rel = _nan_to_zero(np.mean(np.abs(gt - pred) / gt))
    log10 = _nan_to_zero(
        np.abs(np.log10(np.maximum(gt, eps)) - np.log10(np.maximum(pred, eps))).mean())
    mae = _nan_to_zero(np.abs(gt - pred).mean())
    return abs_rel, rmse, a1, a2, a3, log10, mae


def compute_errors_batch(gt: torch.Tensor, pred: torch.Tensor,
                         metric_scale: bool = True) -> Dict[str, torch.Tensor]:
    """Per-sample metrics [B] of gt and pred [B, ...] in float32 (the common
    branch of the numpy version); pixels with gt == 0 are invalid, and a
    sample with no valid pixel reports zeros. `metric_scale`: depth in
    meters (eps 1e-3) or normalized (eps 1e-6)."""
    b = gt.shape[0]
    gt = gt.reshape(b, -1).to(torch.float32)
    pred = pred.reshape(b, -1).to(torch.float32)
    eps = 1e-3 if metric_scale else 1e-6

    valid = (gt > eps) & (pred > eps)
    w = valid.to(torch.float32)
    n = w.sum(dim=1)
    safe_n = n.clamp_min(1.0)
    has = n > 0

    def wmean(x):
        return (x * w).sum(dim=1) / safe_n

    gt_s = torch.where(valid, gt, 1.0)
    pred_s = torch.where(valid, pred.clamp_min(eps), 1.0)

    ratio = torch.maximum(gt_s / pred_s, pred_s / gt_s)
    a1 = wmean((ratio < 1.25).to(torch.float32))
    a2 = wmean((ratio < 1.25 ** 2).to(torch.float32))
    a3 = wmean((ratio < 1.25 ** 3).to(torch.float32))
    diff = gt_s - pred_s
    rmse = torch.sqrt(wmean(diff * diff))
    abs_rel = wmean(diff.abs() / gt_s)
    log10 = wmean((torch.log10(gt_s) - torch.log10(pred_s)).abs())
    mae = wmean(diff.abs())
    out = dict(zip(METRIC_NAMES, (abs_rel, rmse, a1, a2, a3, log10, mae)))
    return {k: torch.where(has, v, 0.0) for k, v in out.items()}
