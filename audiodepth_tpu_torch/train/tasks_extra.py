"""Tasks of the non-baseline families (port of `train/tasks_extra.py`):
base_residual, binaural_attention, rgb_depth, unet_cvae and
adabins_distillation. The curriculum phases are functions of the 0-based
epoch the engine passes, as in the JAX package: the detach flip is a
`detach()` switch and the adaptive weights are plain functions of the
epoch or of the progress. Models run NCHW; the tasks take and return NHWC.
"""

from __future__ import annotations

from typing import Optional

import torch

from .._device import DeviceLike
from ..configs import Config, resolve_compute_dtype
from ..losses.base_residual import (adaptive_weights, base_residual_loss,
                                    frequency_aware_base_residual_loss)
from ..losses.binaural import adaptive_binaural_weights, binaural_attention_loss, rgb_depth_loss
from ..losses.distillation import adaptive_distillation_weights, distillation_loss
from ..models.adabins import AdaBinsDistillationModel
from ..models.base_residual import BaseResidualNet
from ..models.binaural_attention import build_binaural
from ..models.rgb_depth import RGBDepthNet
from ..models.unet_cvae import build_unet_cvae
from ..obs.spans import span
from .tasks import Task


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _on(task: Task, model: torch.nn.Module) -> torch.nn.Module:
    # channels-last: the NHWC inputs permuted to NCHW are already laid out so
    return model.to(task.device, memory_format=torch.channels_last)


class BaseResidualTask(Task):
    """base_residual: the two-headed forward, the three-term loss and the
    detach curriculum (train_base_residual.py:344-516): mask gt > 0; with the
    adaptive loss, from warmup_epochs on, final = detach(base) + residual in
    training (the flip changes gradients, not values); final clipped to
    [0, max_depth]; SIlog recon by default."""

    name = "base_residual"

    def __init__(self, cfg: Config, device: DeviceLike = None):
        super().__init__(cfg, device)
        extra = cfg.model.extra
        self.use_adaptive = bool(extra.get("use_adaptive_loss", True))
        self.warmup_epochs = int(extra.get("warmup_epochs", 50))
        self.recon = str(extra.get("recon", "silog"))
        # the training script's loss weights (train_base_residual.py:136-142);
        # the adaptive schedule starts from λ_recon·0.5 and λ_base·2.0 (:261-269)
        self.lambda_recon = float(extra.get("lambda_recon", 1.0))
        self.lambda_base = float(extra.get("lambda_base", 1.2))
        self.lambda_sparse = float(extra.get("lambda_sparse", 0.05))
        self.lowpass_kernel = int(extra.get("lowpass_kernel", 16))
        self.silog_lambda = float(extra.get("silog_lambda", 0.5))
        self.model = _on(self, BaseResidualNet(
            input_channels=cfg.model.input_nc, base_channels=cfg.model.base_channels,
            max_depth=self.max_depth, dtype=resolve_compute_dtype(cfg)))
        # (final, base, residual) of the last eval forward, for the criterion
        self._last_parts = None

    def _parts(self, batch, train: bool):
        self.model.train(train)
        base, residual = self.model(_nchw(self.prepare(batch)))
        return _nhwc(base), _nhwc(residual)

    def _loss(self, base, residual, final, gt, mask, epoch):
        if self.recon == "frequency_aware":
            return frequency_aware_base_residual_loss(base, residual, final, gt)
        if self.use_adaptive:
            lam_recon, lam_base = adaptive_weights(
                epoch, self.warmup_epochs, recon_init=self.lambda_recon * 0.5,
                base_init=self.lambda_base * 2.0)
        else:
            lam_recon, lam_base = self.lambda_recon, self.lambda_base
        return base_residual_loss(base, residual, final, gt, mask, lambda_recon=lam_recon,
                                  lambda_base=lam_base, lambda_sparse=self.lambda_sparse,
                                  lowpass_kernel=self.lowpass_kernel, recon=self.recon,
                                  silog_lambda=self.silog_lambda)

    def loss_fn(self, batch, epoch):
        base, residual = self._parts(batch, train=True)
        # the reference flips on its 1-based epoch (`epoch > warmup_epochs`),
        # i.e. at a 0-based epoch >= warmup_epochs
        detach = self.use_adaptive and epoch >= self.warmup_epochs
        final = torch.clamp((base.detach() if detach else base) + residual, 0.0, self.max_depth)
        gt = self.to_meters(batch["depth"])
        loss, parts = self._loss(base, residual, final, gt, gt > 0, epoch)
        return loss, {"loss": loss, **{k: v for k, v in parts.items() if k != "total"}}

    @torch.no_grad()
    def predict_parts(self, batch):
        """(base, residual, final) of one eval-mode forward, NHWC."""
        base, residual = self._parts(batch, train=False)
        return base, residual, torch.clamp(base + residual, 0.0, self.max_depth)

    def predict_raw(self, batch):
        base, residual, final = self.predict_parts(batch)
        self._last_parts = (final, base, residual)
        return final

    @torch.no_grad()
    def eval_criterion_loss(self, batch, epoch, pred: torch.Tensor,
                            valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The training script's per-batch validation loss: the training loss
        on the eval-mode forward at the current epoch's weights
        (train_base_residual.py:436-452), over gt > 0 of the valid rows.
        `pred` is the batch's `predict_raw`, whose base and residual are
        reused, so an eval batch runs one forward."""
        if self._last_parts is not None and self._last_parts[0] is pred:
            final, base, residual = self._last_parts
        else:
            base, residual, final = self.predict_parts(batch)
        gt = self.to_meters(batch["depth"])
        mask = gt > 0
        if valid is not None:
            mask = mask & (valid.reshape((-1,) + (1,) * (gt.dim() - 1)) > 0)
        return self._loss(base, residual, final, gt, mask, epoch)[0]


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


class RGBDepthTask(Task):
    """rgb_depth, the teacher: the camera image in, unmasked L1 +
    smoothness (train_rgb_depth.py:43-87)."""

    name = "rgb_depth"

    def __init__(self, cfg: Config, device: DeviceLike = None):
        super().__init__(cfg, device)
        extra = cfg.model.extra
        # the training script's weights (train_rgb_depth.py:126-128)
        self.lambda_l1 = float(extra.get("lambda_l1", 1.0))
        self.lambda_smooth = float(extra.get("lambda_smooth", 0.1))
        self.model = _on(self, RGBDepthNet(
            base_channels=cfg.model.base_channels, max_depth=self.max_depth,
            output_size=cfg.dataset.images_size, dtype=resolve_compute_dtype(cfg)))

    def prepare(self, batch):
        return torch.as_tensor(batch["image"], device=self.device)

    def loss_fn(self, batch, epoch):
        pred = self.apply_train(self.prepare(batch))
        loss, parts = rgb_depth_loss(pred, self.to_meters(batch["depth"]),
                                     lambda_l1=self.lambda_l1, lambda_smooth=self.lambda_smooth)
        return loss, {"loss": loss, "l1": parts["l1"], "smooth": parts["smooth"]}


class UNetCVAETask(Task):
    """unet_cvae: the depth criterion + kl_weight·KL (train_cvae.py:444-473).

    Training draws the latent's eps from the task's generator. The eval
    forward samples too, as the JAX task's does (with the fixed key
    PRNGKey(0)): from a generator reseeded to 0 on every call, so it is
    deterministic; its draws are torch's, not threefry's."""

    name = "unet_cvae"
    pred_is_normalized = True

    def __init__(self, cfg: Config, device: DeviceLike = None):
        super().__init__(cfg, device)
        self.kl_weight = float(cfg.model.kl_weight)
        self.model = _on(self, build_unet_cvae(cfg))
        self.generator = torch.Generator(device=self.device)
        self._eval_generator = torch.Generator(device=self.device)

    def loss_fn(self, batch, epoch):
        self.model.train()
        pred, kl = self.model(_nchw(self.prepare(batch)), sample=True, generator=self.generator)
        gt = batch["depth"]
        depth_loss = self.criterion(self.pred_to_meters(_nhwc(pred)), self.to_meters(gt), gt > 0)
        loss = depth_loss + self.kl_weight * kl
        return loss, {"loss": loss, "depth_loss": depth_loss, "kl": kl}

    @torch.no_grad()
    def predict_raw(self, batch):
        self.model.eval()
        self._eval_generator.manual_seed(0)
        pred, _ = self.model(_nchw(self.prepare(batch)), sample=True,
                             generator=self._eval_generator)
        return _nhwc(pred)


class AdaBinsDistillationTask(Task):
    """adabins_distillation: paired audio and camera batches, the five-term
    loss. Training runs the frozen teacher (the `rgb` branch, under no_grad,
    left out of the optimizer: no decay, no moments); validation and serving
    run the student alone on audio (train_adabins_distillation.py:481-522).
    The bin predictors' dropout masks come from the task's generator. The
    loss runs in the span `loss.distillation` (`obs.spans`)."""

    name = "adabins_distillation"

    def __init__(self, cfg: Config, device: DeviceLike = None):
        super().__init__(cfg, device)
        extra = cfg.model.extra
        self.adaptive = bool(extra.get("use_adaptive_loss", False))
        self.total_epochs = int(cfg.mode.epochs)
        self.temperature = float(extra.get("temperature", 4.0))
        # the training script's defaults (train_adabins_distillation.py:179-187,
        # passed to the loss at :358-365), not the loss class's
        self.lambda_task = float(extra.get("lambda_task", 1.0))
        self.lambda_response = float(extra.get("lambda_response", 0.5))
        self.lambda_feature = float(extra.get("lambda_feature", 0.3))
        self.lambda_bin = float(extra.get("lambda_bin", 0.2))
        self.lambda_sparse = float(extra.get("lambda_sparse", 0.1))
        self.model = _on(self, AdaBinsDistillationModel(
            n_bins=cfg.model.n_bins, base_channels=cfg.model.base_channels,
            output_size=cfg.dataset.images_size, max_depth=self.max_depth,
            dtype=resolve_compute_dtype(cfg),
            # off by default, as in the JAX package: the student's activations
            # recomputed in the backward (the teacher keeps none under no_grad)
            remat=bool(extra.get("remat", False))))
        self.generator = torch.Generator(device=self.device)

    def trainable_parameters(self):
        frozen = set(map(id, self.model.teacher_parameters()))
        return [p for p in self.model.parameters() if id(p) not in frozen]

    def loss_fn(self, batch, epoch):
        audio = _nchw(self.prepare(batch))
        rgb = batch.get("image")
        rgb = None if rgb is None else _nchw(torch.as_tensor(rgb, device=self.device))
        self.model.train()
        out = self.model(audio, rgb, mode="train" if rgb is not None else "inference",
                         generator=self.generator)
        gt = _nchw(self.to_meters(batch["depth"]))
        if self.adaptive:
            w = adaptive_distillation_weights(epoch / max(self.total_epochs, 1))
            lam = (w["task"], w["response"], w["feature"], w["bin"])
        else:
            lam = (self.lambda_task, self.lambda_response, self.lambda_feature, self.lambda_bin)
        with span("loss.distillation", gt.device):
            loss, parts = distillation_loss(out, gt, gt > 0, *lam,
                                            lambda_sparse=self.lambda_sparse,
                                            temperature=self.temperature)
        return loss, {"loss": loss, **{k: parts[k] for k in
                                       ("task", "response", "feature", "bin", "sparse")}}

    @torch.no_grad()
    def predict_raw(self, batch):
        self.model.eval()
        out = self.model(_nchw(self.prepare(batch)), None, mode="inference")
        return _nhwc(out["audio"]["final_depth"])
