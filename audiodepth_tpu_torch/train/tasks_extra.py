"""Tasks of the non-baseline families (port of `train/tasks_extra.py`).
Only `binaural_attention` is ported so far."""

from __future__ import annotations

import torch

from .._device import DeviceLike
from ..configs import Config
from ..losses.binaural import adaptive_binaural_weights, binaural_attention_loss
from ..models.binaural_attention import build_binaural
from .tasks import Task


class BinauralAttentionTask(Task):
    """binaural_attention: the model emits meters (sigmoid·max_depth head),
    so `pred_is_normalized` stays False.

    loss_type in {standard, edge_aware, adaptive} mirrors the reference's
    create_binaural_loss: `standard` is the training script's criterion on gt ≠ 0
    (train_binaural_attention.py:292-311), `edge_aware` the edge-aware loss
    with fixed λ, `adaptive` the same loss on the epoch curriculum. The
    encoders are rematerialized in training unless model.extra.remat is off.
    """

    name = "binaural_attention"

    def __init__(self, cfg: Config, device: DeviceLike = None):
        super().__init__(cfg, device)
        extra = cfg.model.extra
        self.loss_type = str(extra.get("loss_type", "standard"))
        if self.loss_type not in ("standard", "edge_aware", "adaptive"):
            raise ValueError(f"unknown binaural loss_type {self.loss_type!r}")
        # edge-aware weights (utils_binaural_attention_loss.py:15 defaults)
        self.lambda_recon = float(extra.get("lambda_recon", 1.0))
        self.lambda_edge = float(extra.get("lambda_edge", 0.2))
        self.lambda_smooth = float(extra.get("lambda_smooth", 0.1))
        # channels-last: the encoders' conv outputs stay NHWC in memory, so
        # the attention's token view [B, H·W, C] is free
        self.model = build_binaural(cfg).to(self.device, memory_format=torch.channels_last)

    def loss_fn(self, batch, epoch):
        pred = self.apply_train(self.prepare(batch))
        gt = self.to_meters(batch["depth"])
        if self.loss_type == "standard":
            loss = self.criterion(pred, gt, gt != 0)
            return loss, {"loss": loss}
        if self.loss_type == "adaptive":
            lam = adaptive_binaural_weights(epoch)
        else:
            lam = (self.lambda_recon, self.lambda_edge, self.lambda_smooth)
        loss, parts = binaural_attention_loss(pred, gt, *lam)
        return loss, {"loss": loss, "recon": parts["recon"], "edge": parts["edge"],
                      "smooth": parts["smooth"]}
