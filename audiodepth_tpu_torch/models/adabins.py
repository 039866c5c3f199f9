"""Twin AdaBins networks, an RGB teacher and an audio student, the
`adabins_distillation` family (port of `models/adabins.py`).

Each branch is a five-scale encoder (the `SharedEncoder`), an adaptive-bin
predictor (global average pool → Linear(256) → ReLU → Dropout(0.1) →
Linear(n_bins) → softmax widths → cumsum edges × max_depth → centres) and a
UNet decoder with an n_bins classification head, whose soft-binning
expectation Σ softmax(logits)·centres is the base depth. One residual 1×1
head, shared by the two branches, adds tanh·(0.05·max_depth) over the
decoder's last features, and final = clip(base + residual, 0, max_depth).
The decoder returns its logits and its features from one pass (the
reference runs it twice for them).

The teacher (`rgb`) runs only in mode "train" with an image, in the mode
the module is in (train: BatchNorm on batch statistics, folding them into
its running buffers, and dropout on), under `torch.no_grad()`: it is
frozen, and the shared residual head gets its gradient through the audio
branch alone. The bin predictor's dropout mask is drawn from the
`generator` passed to `forward` (audio first, then rgb).

With `remat` (the config's `model.extra.remat`, off by default as in the
JAX package), a train-mode forward under grad keeps none of the student
branch's activations and recomputes them in the backward (`layers.remat`:
BatchNorm folds its statistics once). The student's keep mask is drawn
before the recomputed region and passed into it, so the recomputation uses
the same mask and the generator advances once, as without remat.

Spans (`obs.spans`): `adabins.teacher` around the teacher's forward,
`adabins.bins` around a branch's bin predictor and its soft binning (the
decoder runs before them: it draws nothing, so the masks' order holds);
with remat the student's is entered again by the recomputation.

The soft binning (Σ softmax(logits)·centres) and the logits' spatial mean,
which the KL term of the loss reads as a branch's `bin_logit_mean`, are
one computation, `ops/cuda/soft_binning.py::soft_binning`: the hand-written
kernel pair where it takes the logits (bf16 channels-last on a card; with
or without grad, so the student, the teacher and a remat recompute
alike), which reads them once each way; every other input takes the same
chain in PyTorch (cast to at least fp32, softmax, product, sum, mean). A
branch's `bin_logits` are the class head's, in its compute dtype.

Resizes of the logits and of the residual to `output_size`, where their
size differs, take `jax.image.resize`'s "nearest" (half-pixel centres:
torch's "nearest-exact"). Everything is NCHW, the output dict's tensors
too. Module names are the reference's (`tools/import_torch.py::_spec_adabins`
of the JAX package): `{audio,rgb}_encoder`, `{audio,rgb}_bin_predictor.predictor.{0,3}`,
`{audio,rgb}_decoder.{up1..4,class_head}`, `residual_head`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..obs.spans import span
from ..ops.cuda.soft_binning import soft_binning
from ..parallel.mesh import draw_global
from .base_residual import SharedEncoder
from .layers import Conv2d, UpBilinear, at_least_f32, remat

DROPOUT = 0.1


def dropout_keep(h: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """The bin predictor's dropout keep mask over `h` [B, F], drawn from
    `generator` for the global batch of a data-parallel step, this rank's
    rows kept (`parallel.draw_global`)."""
    return draw_global(lambda n: torch.empty((n,) + tuple(h.shape[1:]), dtype=h.dtype,
                                             device=h.device).bernoulli_(
        1.0 - DROPOUT, generator=generator) > 0, h.shape[0])


class BinPredictor(nn.Module):
    def __init__(self, in_features: int, n_bins: int = 128, max_depth: float = 30.0):
        super().__init__()
        self.max_depth = float(max_depth)
        self.predictor = nn.Sequential(nn.Linear(in_features, 256), nn.ReLU(),
                                       nn.Dropout(DROPOUT), nn.Linear(256, n_bins))

    def draw_keep(self, batch: int, generator: Optional[torch.Generator],
                  device: torch.device) -> torch.Tensor:
        """The train-mode keep mask of a batch, drawn as `forward` draws it."""
        linear = self.predictor[0]
        h = torch.empty((batch, linear.out_features), dtype=linear.weight.dtype, device=device)
        return dropout_keep(h, generator)

    def forward(self, feats: torch.Tensor, generator: Optional[torch.Generator] = None,
                keep: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(centers, widths); in train mode the dropout keeps `keep`, else a
        mask drawn from `generator`."""
        g = at_least_f32(feats.mean(dim=(2, 3)))
        h = F.relu(self.predictor[0](g))
        if self.training:
            keep = dropout_keep(h, generator) if keep is None else keep
            h = torch.where(keep, h / (1.0 - DROPOUT), torch.zeros_like(h))
        widths = torch.softmax(self.predictor[3](h), dim=1)
        edges = torch.cumsum(widths, dim=1)
        edges = torch.cat([torch.zeros_like(edges[:, :1]), edges], dim=1) * self.max_depth
        centers = 0.5 * (edges[:, :-1] + edges[:, 1:])
        return centers, widths


def _resize_nearest(x: torch.Tensor, size: int) -> torch.Tensor:
    if x.shape[-2] == size:
        return x
    return F.interpolate(x, size=(size, size), mode="nearest-exact")


class AdaBinsDecoder(nn.Module):
    """UNet decoder → (bin logits in the compute dtype, its last features)."""

    def __init__(self, base_channels: int = 64, n_bins: int = 128, output_size: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = base_channels
        self.output_size = int(output_size)
        self.up1 = UpBilinear(c * 16, c * 8, dtype=dtype)
        self.up2 = UpBilinear(c * 12, c * 4, dtype=dtype)
        self.up3 = UpBilinear(c * 6, c * 2, dtype=dtype)
        self.up4 = UpBilinear(c * 3, c, dtype=dtype)
        self.class_head = Conv2d(c, n_bins, 1, dtype=dtype)

    def forward(self, f: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.up1(f["x5"], f["x4"])
        x = self.up2(x, f["x3"])
        x = self.up3(x, f["x2"])
        x = self.up4(x, f["x1"])
        return _resize_nearest(self.class_head(x), self.output_size), x


class AdaBinsDistillationModel(nn.Module):
    def __init__(self, n_bins: int = 128, base_channels: int = 64, output_size: int = 256,
                 max_depth: float = 30.0, dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.max_depth = float(max_depth)
        self.output_size = int(output_size)
        self.remat = remat
        c = base_channels
        for branch, in_ch in (("audio", 2), ("rgb", 3)):
            setattr(self, f"{branch}_encoder", SharedEncoder(in_ch, c, dtype=dtype))
            setattr(self, f"{branch}_bin_predictor", BinPredictor(c * 8, n_bins, max_depth))
            setattr(self, f"{branch}_decoder",
                    AdaBinsDecoder(c, n_bins, output_size, dtype=dtype))
        self.residual_head = Conv2d(c, 1, 1, dtype=dtype)

    def teacher_parameters(self):
        """The frozen teacher's parameters (the `rgb` branch)."""
        return [p for n, p in self.named_parameters() if n.startswith("rgb_")]

    def _branch(self, name: str, x: torch.Tensor, generator,
                keep: Optional[torch.Tensor] = None) -> Dict[str, object]:
        feats = getattr(self, f"{name}_encoder")(x)
        logits, dec = getattr(self, f"{name}_decoder")(feats)
        with span("adabins.bins", x.device):
            centers, widths = getattr(self, f"{name}_bin_predictor")(feats["x5"], generator,
                                                                       keep)
            base, logit_mean = soft_binning(logits, centers)
        raw = _resize_nearest(at_least_f32(self.residual_head(dec)), self.output_size)
        residual = torch.tanh(raw) * (0.05 * self.max_depth)
        return {"features": feats, "bin_centers": centers, "bin_widths": widths,
                "bin_logits": logits, "bin_logit_mean": logit_mean, "base_depth": base,
                "decoder_features": dec, "residual": residual,
                "final_depth": torch.clamp(base + residual, 0.0, self.max_depth)}

    def forward(self, audio: torch.Tensor, rgb: Optional[torch.Tensor] = None,
                mode: str = "train", generator: Optional[torch.Generator] = None):
        if self.remat and self.training and torch.is_grad_enabled():
            keep = self.audio_bin_predictor.draw_keep(audio.shape[0], generator, audio.device)
            student = remat(lambda x, k: self._branch("audio", x, None, k), audio, keep)
        else:
            student = self._branch("audio", audio, generator)
        out = {"audio": student, "rgb": None}
        if mode == "train" and rgb is not None:
            with span("adabins.teacher", rgb.device), torch.no_grad():
                out["rgb"] = self._branch("rgb", rgb, generator)
        return out
