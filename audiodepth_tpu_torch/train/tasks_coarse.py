"""The coarse-depth family's task (port of `train/tasks_coarse.py`, the
reference's train_coarse_depth.py semantics).

`model_type` picks unet | lite | hybrid (CoarseWithOffset) | dual_reg.
The bin edges and centers come from the config (n_bins, bin_strategy,
model.extra depth_min / sid_alpha), the centers ÷ max_depth when
depth_norm (then the predictions are normalized), or from a checkpoint's
aux (`restore_aux`), never from a state_dict's `bin_centers`: after every
`load_state_dict` the task writes its own centers into that buffer. Batches
carry int 'bins' targets [B, H, W] beside 'depth' (the target in model
units). The loss weights are the training script's defaults
(train_coarse_depth.py:148-186): ce 1.0, regression 0.5, offset_reg 0.01,
coarse / final 1.0, soft-CE σ 2.0, and label smoothing 0.1 for the hybrid
(:342); --use_focal turns soft CE into focal (:348-352). The loss runs in
the span `loss.coarse` (`obs.spans`), whatever the variant.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .._device import DeviceLike
from ..configs import Config, resolve_compute_dtype
from ..data.bins import compute_bin_edges
from ..losses.coarse import coarse_depth_loss, coarse_offset_loss, dual_regression_loss
from ..models.coarse_depth import build_coarse
from ..obs.spans import span
from .tasks import Task
from .tasks_extra import _nchw, _nhwc, _on


class CoarseDepthTask(Task):
    name = "coarse_depth"

    def __init__(self, cfg: Config, device: DeviceLike = None):
        super().__init__(cfg, device)
        extra = cfg.model.extra
        self.model_type = cfg.model.model_type
        self.n_bins = int(cfg.model.n_bins)
        self.bin_mode = str(cfg.model.bin_strategy)
        self.ce_mode = ("focal" if bool(extra.get("use_focal", False))
                        else str(extra.get("ce_mode", "soft_ce")))
        self.ce_weight = float(extra.get("ce_weight", 1.0))
        self.regression_weight = float(extra.get("regression_weight", 0.5))
        self.offset_reg_weight = float(extra.get("offset_reg_weight", 0.01))
        self.coarse_weight = float(extra.get("coarse_weight", 1.0))
        self.final_weight = float(extra.get("final_weight", 1.0))
        self.soft_ce_sigma = float(extra.get("soft_ce_sigma", 2.0))
        edges, centers = compute_bin_edges(
            self.n_bins, depth_min=float(extra.get("depth_min", 0.1)),
            depth_max=self.max_depth, mode=self.bin_mode,
            sid_alpha=float(extra.get("sid_alpha", 0.6)))
        if self.depth_norm:
            centers = centers / self.max_depth  # the model's output units
        self.bin_edges, self.bin_centers = edges, centers
        self.model = _on(self, build_coarse(
            self.model_type, cfg.model.input_nc, self.n_bins, cfg.model.base_channels,
            cfg.dataset.images_size, resolve_compute_dtype(cfg)))
        self.model.register_load_state_dict_post_hook(lambda module, keys: self._write_centers())
        self._write_centers()

    def _write_centers(self) -> None:
        buf = getattr(self.model, "bin_centers", None)
        if buf is not None:
            with torch.no_grad():
                buf.copy_(torch.from_numpy(np.asarray(self.bin_centers)))

    @property
    def pred_is_normalized(self):
        return self.depth_norm  # the centers are normalized when depth_norm

    def checkpoint_aux(self) -> Dict[str, Any]:
        """The bin parameters a checkpoint carries (train_coarse_depth.py:620-640)."""
        return {"bin_edges": torch.from_numpy(np.array(self.bin_edges)),
                "bin_centers": torch.from_numpy(np.array(self.bin_centers))}

    def restore_aux(self, aux) -> None:
        """Adopt a checkpoint's trained bins: a model trained with another
        bin_strategy / depth_min / sid_alpha has the same parameter shapes,
        so without this the forward would soft-bin over the config's
        centers."""
        if not aux:
            return
        if aux.get("bin_edges") is not None:
            self.bin_edges = np.asarray(aux["bin_edges"])
        if aux.get("bin_centers") is not None:
            centers = np.asarray(aux["bin_centers"])
            if centers.shape != (self.n_bins,):
                raise ValueError(
                    f"checkpoint bin_centers have {centers.shape[0]} bins, "
                    f"model is configured for {self.n_bins} — pass --n_bins")
            self.bin_centers = centers
            self._write_centers()

    def loss_fn(self, batch, epoch):
        self.model.train()
        out = [_nhwc(t) for t in self.model(_nchw(self.prepare(batch)))]
        gt = batch["depth"]           # the target in model units
        bins = batch["bins"]          # [B, H, W] int targets
        with span("loss.coarse", gt.device):
            if self.model_type in ("unet", "lite"):
                logits, depth = out
                loss, parts = coarse_depth_loss(
                    logits, depth, bins, gt, gt > 0, mode=self.ce_mode,
                    ce_weight=self.ce_weight, regression_weight=self.regression_weight,
                    soft_ce_sigma=self.soft_ce_sigma)
                keys = ("ce", "regression")
            elif self.model_type == "hybrid":
                logits, coarse, offset, final = out
                loss, parts = coarse_offset_loss(
                    logits, coarse, offset, final, gt, bins, ce_weight=self.ce_weight,
                    regression_weight=self.regression_weight,
                    offset_reg_weight=self.offset_reg_weight, label_smoothing=0.1)
                keys = ("ce", "regression", "offset_reg", "coarse_l1")
            else:  # dual_reg
                coarse, offset, final = out
                loss, parts = dual_regression_loss(
                    coarse, offset, final, gt, coarse_weight=self.coarse_weight,
                    final_weight=self.final_weight, offset_reg_weight=self.offset_reg_weight)
                keys = ("coarse", "final", "offset_reg")
        return loss, {"loss": loss, **{k: parts[k] for k in keys}}

    @torch.no_grad()
    def predict_raw(self, batch):
        self.model.eval()
        out = self.model(_nchw(self.prepare(batch)))
        return _nhwc(out[1] if self.model_type in ("unet", "lite") else out[-1])
