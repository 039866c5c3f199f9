"""Task definitions (port of `train/tasks.py`).

A Task owns the model, the criterion, the input preparation (the device
front end) and the train- and eval-time output semantics of its family.
Unlike the JAX package, the parameters and BatchNorm statistics live in the
task's `nn.Module`, so the methods take the batch (and the epoch) alone.

Batch convention: dict with leading batch dim —
  * 'waveform' [B, C, L] raw audio, or
  * 'input'    [B, H, W, C] pre-computed model input (NHWC), and/or
  * 'image'    [B, H, W, 3] camera image in [0, 1] (read by a model with
               input_nc 3, the --eval_img baseline, and by the rgb_depth
               and adabins_distillation families), and
  * 'depth'    [B, H, W, 1] ground truth in dataset units (normalized to
               [0, 1] when cfg.dataset.depth_norm, meters otherwise).
Values may be numpy arrays or tensors; they are moved to the task's device.
Predictions are NHWC, [B, H, W, 1], as the JAX package returns them.

Random draws (the cVAE's latent, AdaBins' dropout) come from the task's
`generator`, a torch.Generator on its device that `begin_step` reseeds
from (mode.seed, step) before every train step, as the JAX engine folds the
step into its key: a step's draws do not depend on the steps before it, so
a resumed run draws what the uninterrupted one did.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from .._device import DeviceLike, configure_precision, resolve_device
from ..configs import Config
from ..data.frontend import make_frontend
from ..losses import make_criterion
from ..metrics import EVAL_PRED_MIN, compute_errors_batch
from ..models.unet import build_unet


class Task:
    """Base task: subclasses set self.model and define `loss_fn`."""

    name = "base"
    # UNet-type heads emit normalized depth when depth_norm (sigmoid head)
    pred_is_normalized = False

    def __init__(self, cfg: Config, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        configure_precision()
        self.max_depth = float(cfg.dataset.max_depth)
        self.depth_norm = bool(cfg.dataset.depth_norm)
        self.criterion = make_criterion(cfg.mode.criterion, l1_weight=cfg.mode.l1_weight,
                                        silog_weight=cfg.mode.silog_weight,
                                        silog_lambda=cfg.mode.silog_lambda)
        self._frontend = make_frontend(cfg)
        self.model: Optional[torch.nn.Module] = None  # set by subclass
        self.generator: Optional[torch.Generator] = None  # set by tasks that draw

    def restore_aux(self, aux) -> None:
        """Adopt a checkpoint's aux payload before evaluating (the coarse
        family's bins); nothing for the other families."""

    def attach_group(self, group) -> None:
        """Rebuild the front end for a ('data', 'model') group (the engine
        calls this when the group's model axis has more than one rank):
        plain-STFT waveforms then run through the halo-exchange sharded STFT
        (`parallel/sharded_stft.py`)."""
        self._frontend = make_frontend(self.cfg, group=group)

    def begin_step(self, step: int) -> None:
        """Reseed the task's generator for train step `step` (the engine
        calls this before each step's loss)."""
        if self.generator is not None:
            self.generator.manual_seed(int(self.cfg.mode.seed) * 2**32 + int(step))

    def trainable_parameters(self) -> List[torch.nn.Parameter]:
        """The parameters the optimizer updates (all of them but a frozen
        part's)."""
        return list(self.model.parameters())

    # -- input ---------------------------------------------------------
    def prepare(self, batch: Dict[str, object]) -> torch.Tensor:
        if "input" in batch:
            return torch.as_tensor(batch["input"], device=self.device)
        if self.cfg.model.input_nc == 3 and "image" in batch:
            # the --eval_img baseline: the camera image instead of audio
            return torch.as_tensor(batch["image"], device=self.device)
        return self._frontend(torch.as_tensor(batch["waveform"], device=self.device))

    # -- depth-unit helpers ---------------------------------------------
    def to_meters(self, depth_like: torch.Tensor) -> torch.Tensor:
        return depth_like * self.max_depth if self.depth_norm else depth_like

    def pred_to_meters(self, pred: torch.Tensor) -> torch.Tensor:
        if self.pred_is_normalized and self.depth_norm:
            return pred * self.max_depth
        return pred

    # -- training ---------------------------------------------------------
    def apply_train(self, x: torch.Tensor) -> torch.Tensor:
        """A train-mode forward (BatchNorm on batch statistics, folding them
        into its running buffers) of an NHWC input; NHWC out."""
        self.model.train()
        return self.model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def loss_fn(self, batch: Dict[str, torch.Tensor], epoch: float
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, scalar aux) of one decoded device batch at a 0-based epoch."""
        raise NotImplementedError

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

    def eval_metrics(self, batch: Dict[str, torch.Tensor],
                     pred: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Per-sample metric tensors [B] (train.py:782-844 validation
        semantics) and the per-sample masked-L1 'loss' in model units, of
        `pred`, the batch's `predict_raw`."""
        gt = batch["depth"]
        # EVAL_PRED_MIN, one f32 ulp above the 1e-3 eps, keeps every clipped
        # pixel on the common branch of both metric versions
        pred_m = torch.clamp(self.pred_to_meters(pred), EVAL_PRED_MIN, self.max_depth)
        out = compute_errors_batch(self.to_meters(gt), pred_m, metric_scale=True)
        # eval loss: masked L1 in model units (test.py:240), per sample, so
        # the split mean does not depend on the batch size; gt is brought to
        # the prediction's units
        gt_model_units = (gt if (self.pred_is_normalized or not self.depth_norm)
                          else gt * self.max_depth)
        w = (gt != 0).to(torch.float32)
        axes = tuple(range(1, gt.dim()))
        out["loss"] = (((pred - gt_model_units).abs() * w).sum(dim=axes)
                       / w.sum(dim=axes).clamp_min(1.0))
        return out


class UNetBaselineTask(Task):
    """unet_baseline: UNet-256 (or -128) on the mel front end, with the
    masked Combined/L1/SIlog loss in meters.

    Loss semantics (train.py:646-669): the valid mask is gt != 0; when
    depth_norm, the loss is computed on denormalized (meter-scale) pred and
    gt, with no clamping of predictions.
    """

    name = "unet_baseline"
    pred_is_normalized = True

    def __init__(self, cfg: Config, device: DeviceLike = None):
        super().__init__(cfg, device)
        # channels-last: the NHWC front-end output permuted to NCHW is
        # already in this layout, so cuDNN runs NHWC kernels without copies
        self.model = build_unet(cfg).to(
            self.device, memory_format=torch.channels_last)

    def loss_fn(self, batch, epoch):
        pred = self.apply_train(self.prepare(batch))
        gt = batch["depth"]
        loss = self.criterion(self.pred_to_meters(pred), self.to_meters(gt), gt != 0)
        return loss, {"loss": loss}

    @torch.no_grad()
    def eval_criterion_loss(self, batch, epoch, pred: torch.Tensor,
                            valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The reference training script's per-batch validation loss: the training
        criterion on the eval-mode forward `pred` (the batch's
        `predict_raw`), pooled over the valid pixels of the whole batch, in
        meters, mask gt > 0 (train.py:744-771); `Engine.evaluate` takes the
        equal-weight mean over batches (train.py:842). `valid` is the ragged
        tail's row mask: pad rows repeat row 0 and would otherwise add
        fabricated pixels."""
        gt = batch["depth"]
        mask = gt > 0
        if valid is not None:
            mask = mask & (valid.reshape((-1,) + (1,) * (gt.dim() - 1)) > 0)
        return self.criterion(self.pred_to_meters(pred), self.to_meters(gt), mask)
