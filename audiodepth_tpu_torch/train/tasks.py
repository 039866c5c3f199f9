"""Task definitions, inference half (port of `train/tasks.py`).

A Task owns the model, the input preparation (the device front end) and the
output semantics of its family. The loss and the eval metrics come with the
training slice. Unlike the JAX package, the parameters and BatchNorm
statistics live in the task's `nn.Module`, so the predict methods take the
batch alone.

Batch convention: dict with leading batch dim —
  * 'waveform' [B, C, L] raw audio, or
  * 'input'    [B, H, W, C] pre-computed model input (NHWC).
Values may be numpy arrays or tensors; they are moved to the task's device.
Predictions are NHWC, [B, H, W, 1], as the JAX package returns them.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .._device import DeviceLike, configure_precision, resolve_device
from ..configs import Config
from ..data.frontend import make_frontend
from ..models.unet import build_unet


class Task:
    """Base task: subclasses set self.model."""

    name = "base"
    # UNet-type heads emit normalized depth when depth_norm (sigmoid head)
    pred_is_normalized = False

    def __init__(self, cfg: Config, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        configure_precision()
        self.max_depth = float(cfg.dataset.max_depth)
        self.depth_norm = bool(cfg.dataset.depth_norm)
        self._frontend = make_frontend(cfg)
        self.model: Optional[torch.nn.Module] = None  # set by subclass

    # -- input ---------------------------------------------------------
    def prepare(self, batch: Dict[str, object]) -> torch.Tensor:
        if "input" in batch:
            return torch.as_tensor(batch["input"], device=self.device)
        return self._frontend(torch.as_tensor(batch["waveform"], device=self.device))

    # -- depth-unit helpers ---------------------------------------------
    def to_meters(self, depth_like: torch.Tensor) -> torch.Tensor:
        return depth_like * self.max_depth if self.depth_norm else depth_like

    def pred_to_meters(self, pred: torch.Tensor) -> torch.Tensor:
        if self.pred_is_normalized and self.depth_norm:
            return pred * self.max_depth
        return pred

    # -- evaluation -------------------------------------------------------
    @torch.no_grad()
    def predict_raw(self, batch: Dict[str, object]) -> torch.Tensor:
        """Final depth prediction in model units (one eval-mode forward), NHWC."""
        x = self.prepare(batch)
        self.model.eval()
        out = self.model(x.permute(0, 3, 1, 2))
        return out.permute(0, 2, 3, 1)

    def predict_meters(self, batch: Dict[str, object]) -> torch.Tensor:
        return self.pred_to_meters(self.predict_raw(batch))


class UNetBaselineTask(Task):
    """unet_baseline: UNet-256 (or -128) on the mel front end."""

    name = "unet_baseline"
    pred_is_normalized = True

    def __init__(self, cfg: Config, device: DeviceLike = None):
        super().__init__(cfg, device)
        # channels-last: the NHWC front-end output permuted to NCHW is
        # already in this layout, so cuDNN runs NHWC kernels without copies
        self.model = build_unet(cfg).to(
            self.device, memory_format=torch.channels_last)
