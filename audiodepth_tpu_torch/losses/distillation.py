"""The five-term RGB → audio distillation loss and its adaptive curriculum
(port of `losses/distillation.py`).

  total = λ_task · L1(audio_final, gt | mask)
        + λ_response · MSE(audio_final, rgb_final | mask)
        + λ_feature · mean over levels of (1 − cos(audio_xk, rgb_xk))
             (each channel's spatial vector normalized, the cosines
              averaged over batch and channels)
        + λ_bin · (KL(softmax(rgb/T) ‖ softmax(audio/T)) of the spatial-mean
              logits, batchmean, no T² factor, + MSE(audio_centers, rgb_centers))
        + λ_sparse · mean|audio_residual| (masked)

The output dict is the model's (`models/adabins.py`), NCHW; gt and mask
are NCHW too ([B, 1, H, W]). The teacher's tensors carry no gradient (the
model computes them under no_grad). Every mean over the batch is the global
batch's (`parallel.global_sum`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..models.layers import at_least_f32
from ..parallel.mesh import global_mean
from .basic import l1_loss, l2_loss, masked_mean

LEVELS = ("x1", "x2", "x3", "x4", "x5")


def feature_cosine_distance(audio_feats: Dict, rgb_feats: Dict) -> torch.Tensor:
    total, count = 0.0, 0
    for level in LEVELS:
        if level in audio_feats and level in rgb_feats:
            a, r = at_least_f32(audio_feats[level]), at_least_f32(rgb_feats[level])
            b, c = a.shape[:2]
            a2, r2 = a.reshape(b, c, -1), r.reshape(b, c, -1)  # [B, C, HW]
            an = a2 / torch.linalg.vector_norm(a2, dim=2, keepdim=True).clamp_min(1e-12)
            rn = r2 / torch.linalg.vector_norm(r2, dim=2, keepdim=True).clamp_min(1e-12)
            total = total + (1.0 - global_mean(torch.sum(an * rn, dim=2)))
            count += 1
    return total / max(count, 1)


def bin_distribution_kl(audio_logits, rgb_logits, temperature: float = 4.0) -> torch.Tensor:
    """KL of the spatial-mean logits' tempered softmaxes, batchmean."""
    a = at_least_f32(audio_logits).mean(dim=(2, 3)) / temperature
    r = at_least_f32(rgb_logits).mean(dim=(2, 3)) / temperature
    log_p_audio = torch.log_softmax(a, dim=1)
    log_p_rgb = torch.log_softmax(r, dim=1)
    return global_mean(torch.sum(log_p_rgb.exp() * (log_p_rgb - log_p_audio), dim=1))


def distillation_loss(output: Dict, gt: torch.Tensor, mask: torch.Tensor,
                      lambda_task=2.0, lambda_response=0.3, lambda_feature=0.2,
                      lambda_bin=0.05, lambda_sparse=0.1, temperature: float = 4.0
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss class's defaults; the task passes the training script's."""
    audio, rgb = output["audio"], output.get("rgb")
    loss_task = l1_loss(audio["final_depth"], gt, mask)
    loss_sparse = masked_mean(audio["residual"].abs(), mask)
    if rgb is not None:
        loss_response = l2_loss(audio["final_depth"], rgb["final_depth"], mask)
        loss_feature = feature_cosine_distance(audio["features"], rgb["features"])
        loss_bin = bin_distribution_kl(audio["bin_logits"], rgb["bin_logits"], temperature)
        loss_centers = global_mean((audio["bin_centers"] - rgb["bin_centers"]) ** 2)
    else:
        loss_response = loss_feature = loss_bin = loss_centers = torch.zeros(
            (), dtype=torch.float32, device=gt.device)
    total = (lambda_task * loss_task + lambda_response * loss_response
             + lambda_feature * loss_feature + lambda_bin * (loss_bin + loss_centers)
             + lambda_sparse * loss_sparse)
    return total, {"task": loss_task, "response": loss_response, "feature": loss_feature,
                   "bin": loss_bin, "bin_centers": loss_centers, "sparse": loss_sparse,
                   "total": total}


def adaptive_distillation_weights(progress: float) -> Dict[str, float]:
    """The three-phase curriculum's weights at progress ∈ [0, 1]."""
    p = min(max(float(progress), 0.0), 1.0)
    lam_response = 0.1 if p < 0.1 else 0.1 + 0.4 * (p - 0.1) / 0.9
    if p < 0.2:
        lam_feature = 0.05
    elif p < 0.5:
        lam_feature = 0.05 + 0.25 * (p - 0.2) / 0.3
    else:
        lam_feature = 0.3 - 0.1 * (p - 0.5) / 0.5
    return {"task": 2.0 + p, "response": lam_response, "feature": lam_feature,
            "bin": 0.05 - 0.03 * p}
