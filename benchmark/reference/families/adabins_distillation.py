"""adabins_distillation: twin AdaBins nets, an audio student (the mel
front end's two channels) and a camera teacher (the frame's three), and the
five-term RGB → audio distillation loss of the reference repository's
`train_adabins_distillation.py`, `models/adabins_distillation_model.py` and
`utils_distillation_loss.py`.

Each branch: a five-scale encoder (`DoubleConv` then four `Down`, widths
c·{1, 2, 4, 8, 8}); an adaptive-bin predictor (global average pool of the
last level → Linear(8c, 256) → ReLU → Dropout(0.1) → Linear(256, n_bins) →
softmax widths → cumsum edges × max_depth → centres); a UNet decoder (four
bilinear align_corners up blocks, 16c → 8c, 12c → 4c, 6c → 2c, 3c → c) and a
1×1 n_bins class head; depth = Σ softmax(logits)·centres. One residual 1×1
head, shared by the branches, adds tanh·(0.05·max_depth); final =
clip(base + residual, 0, max_depth). In training the teacher runs its whole
forward under no_grad, in train mode (BatchNorm on its batch statistics,
dropout on), and is left out of AdamW (`trainable`). The loss:

  λ_task·L1(final_a, gt) + λ_response·MSE(final_a, final_r)
  + λ_feature·mean over the five levels of (1 − cos), each channel's
    spatial vector normalised, the cosines averaged over rows and channels
  + λ_bin·(KL(softmax(r̄/T) ‖ softmax(ā/T)) of the spatial-mean logits,
    batchmean, + MSE of the centres) + λ_sparse·mean|residual_a|

the L1, MSE and sparsity over the pixels with gt > 0, the weights from the
configuration's `extra` (the training script's defaults). Initialisation:
kaiming fan_out N(0, 2 / fan_out) for every convolution and Linear kernel
(fan_out: out features × receptive field), zero biases, BatchNorm 1/0.
Where `checkpointed`, the student's encoder levels, up blocks and soft
binning are recomputed in the backward.

Departures from an independent draw and from the training script:
- the dropout keep masks are the program's, drawn as the port documents its
  stream: before each train step its task's generator is reseeded to
  mode.seed · 2³² + step (mode.seed is the configuration's `seed`, the
  port's default 0 where it sets none; the step counts from 0 at the first
  step), and a [rows, 256] float32 `bernoulli_(0.9)` on the batch's device
  is drawn for the student first, then one for the teacher (over the
  global batch's rows, each process keeping its own). Without the same
  masks no comparison could agree;
- the learning rate is constant (the script anneals it by a cosine over
  200 epochs, which moves it by under 10⁻⁶ of itself over the checked
  steps);
- the teacher is random from the seed (no trained teacher checkpoint is
  public), and the camera frames are synthetic (`extra_inputs`).
The Linears of the bin predictors run in float32 in the program, so the
float8 control leaves them unrounded.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..frontend import mel_frontend
from ..nets import Conv, DoubleConv, Down, UpBilinear, state_specs

HIDDEN = 256
DROPOUT = 0.1
LEVELS = ("x1", "x2", "x3", "x4", "x5")


class Encoder(nn.Module):
    def __init__(self, cin, c, prec=None):
        super().__init__()
        self.inc = DoubleConv(cin, c, prec=prec)
        self.down1 = Down(c, 2 * c, prec)
        self.down2 = Down(2 * c, 4 * c, prec)
        self.down3 = Down(4 * c, 8 * c, prec)
        self.down4 = Down(8 * c, 8 * c, prec)


class BinPredictor(nn.Module):
    def __init__(self, features, n_bins):
        super().__init__()
        self.predictor = nn.Sequential(nn.Linear(features, HIDDEN), nn.ReLU(),
                                       nn.Dropout(DROPOUT), nn.Linear(HIDDEN, n_bins))


class Decoder(nn.Module):
    def __init__(self, c, n_bins, prec=None):
        super().__init__()
        self.up1 = UpBilinear(16 * c, 8 * c, prec)
        self.up2 = UpBilinear(12 * c, 4 * c, prec)
        self.up3 = UpBilinear(6 * c, 2 * c, prec)
        self.up4 = UpBilinear(3 * c, c, prec)
        self.class_head = Conv(c, n_bins, 1, prec=prec)


def _soft_bins(logits, centres):
    return (torch.softmax(logits, dim=1) * centres[:, :, None, None]).sum(1, keepdim=True)


def _resize_nearest(x, size):
    return x if x.shape[-1] == size else F.interpolate(x, size=(size, size),
                                                         mode="nearest-exact")


class AdaBinsNet(nn.Module):
    def __init__(self, c=64, n_bins=128, max_depth=30.0, output_size=256, checkpointed=False,
                 prec=None, mask_seed=0):
        super().__init__()
        self.max_depth, self.output_size = float(max_depth), int(output_size)
        self.checkpointed = checkpointed
        # the dropout masks' stream: the program's mode.seed, the steps drawn so far
        self.mask_seed, self.steps_drawn = int(mask_seed), 0
        for branch, cin in (("audio", 2), ("rgb", 3)):
            setattr(self, f"{branch}_encoder", Encoder(cin, c, prec))
            setattr(self, f"{branch}_bin_predictor", BinPredictor(8 * c, n_bins))
            setattr(self, f"{branch}_decoder", Decoder(c, n_bins, prec))
        self.residual_head = Conv(c, 1, 1, prec=prec)

    def _run(self, fn, *args):
        if self.checkpointed and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def branch(self, name: str, x, keep=None) -> Dict[str, object]:
        """One branch on an NCHW input; `keep` the dropout's keep mask in
        train mode."""
        enc = getattr(self, f"{name}_encoder")
        feats, h = {}, x
        for level, block in zip(LEVELS, (enc.inc, enc.down1, enc.down2, enc.down3,
                                         enc.down4)):
            h = feats[level] = self._run(block, h)
        mlp = getattr(self, f"{name}_bin_predictor").predictor
        g = F.relu(mlp[0](feats["x5"].mean(dim=(2, 3))))
        if self.training:
            g = torch.where(keep, g / (1.0 - DROPOUT), torch.zeros_like(g))
        widths = torch.softmax(mlp[3](g), dim=1)
        edges = torch.cumsum(widths, dim=1)
        edges = torch.cat([torch.zeros_like(edges[:, :1]), edges], dim=1) * self.max_depth
        centres = 0.5 * (edges[:, :-1] + edges[:, 1:])
        dec = getattr(self, f"{name}_decoder")
        d = self._run(dec.up1, feats["x5"], feats["x4"])
        d = self._run(dec.up2, d, feats["x3"])
        d = self._run(dec.up3, d, feats["x2"])
        d = self._run(dec.up4, d, feats["x1"])
        logits = _resize_nearest(dec.class_head(d), self.output_size)
        base = self._run(_soft_bins, logits, centres)
        raw = _resize_nearest(self.residual_head(d), self.output_size)
        residual = torch.tanh(raw) * (0.05 * self.max_depth)
        return {"features": feats, "centres": centres, "logits": logits, "residual": residual,
                "final": torch.clamp(base + residual, 0.0, self.max_depth)}

    def forward(self, x):
        """The student's evaluation depth: NHWC [B, S, S, 2] in, NHWC out."""
        return self.branch("audio", x.permute(0, 3, 1, 2))["final"].permute(0, 2, 3, 1)


def build_net(cfg: Dict, prec=None, checkpointed: bool = False) -> nn.Module:
    return AdaBinsNet(int(cfg["base_channels"]), int(cfg["n_bins"]), float(cfg["max_depth"]),
                      int(cfg["images_size"]), checkpointed, prec, int(cfg.get("seed", 0)))


def param_specs(cfg: Dict):
    with torch.device("meta"):
        net = build_net(cfg)
    specs = state_specs(net, lambda shape: math.sqrt(2.0 / (shape[0] * shape[2] * shape[3])))
    # the bin predictors' Linear kernels [out, in]: kaiming fan_out too
    return [(n, s, "normal", math.sqrt(2.0 / s[0])) if n.endswith("weight") and len(s) == 2
            else (n, s, r, std) for n, s, r, std in specs]


def trainable(name: str) -> bool:
    return not name.startswith("rgb_")


def extra_inputs(depth, gen, cfg: Dict) -> Dict[str, torch.Tensor]:
    """The camera frame [n, S, S, 3] in [0, 1], the port's synthetic
    shading of the depth: (shade, clip(shade + N(0, 0.05), 0, 1),
    1 − shade), shade = depth / max_depth, on the k/255 grid that the
    cache's uint8 carries exactly."""
    shade = depth / float(cfg["max_depth"])
    noise = torch.randn(shade.shape, generator=gen, device=depth.device) * 0.05
    frame = torch.cat([shade, (shade + noise).clamp(0.0, 1.0), 1.0 - shade], dim=-1)
    return {"image": torch.round(frame.clamp(0.0, 1.0) * 255.0) / 255.0}


def _extra(cfg: Dict, key: str, default: float) -> float:
    return float(cfg.get("extra", {}).get(key, default))


def keep_masks(net, rows: int, device, shards):
    """(student's, teacher's) keep masks of this step, this process's rows
    of the global batch's; the step counter advances."""
    ranks = shards.ranks
    start = 0 if shards.group is None else dist.get_rank(shards.group) * rows
    gen = torch.Generator(device=device)
    gen.manual_seed(net.mask_seed * 2 ** 32 + net.steps_drawn)
    net.steps_drawn += 1
    return [(torch.empty(rows * ranks, HIDDEN, device=device).bernoulli_(
        1.0 - DROPOUT, generator=gen) > 0)[start:start + rows] for _ in range(2)]


def loss_terms(a: Dict, r: Dict, gt, cfg: Dict, shards) -> Dict[str, torch.Tensor]:
    """The loss's terms from the branches' outputs (`AdaBinsNet.branch`)
    and the NCHW depth: `task`, `response`, `feature`, `bin` (the KL),
    `bin_centres`, `sparse`."""
    w = (gt > 0).to(gt.dtype)

    def mean(t):
        return shards.total(t.sum()) / (t.numel() * shards.ranks)

    sums = shards.total(torch.stack([w.sum(), ((a["final"] - gt).abs() * w).sum(),
                                     ((a["final"] - r["final"]) ** 2 * w).sum(),
                                     (a["residual"].abs() * w).sum()]))
    count = sums[0].clamp_min(1.0)
    feature = 0.0
    for level in LEVELS:
        fa, fr = a["features"][level].flatten(2), r["features"][level].flatten(2)
        fa = fa / torch.linalg.vector_norm(fa, dim=2, keepdim=True).clamp_min(1e-12)
        fr = fr / torch.linalg.vector_norm(fr, dim=2, keepdim=True).clamp_min(1e-12)
        feature = feature + (1.0 - mean((fa * fr).sum(2)))
    temp = _extra(cfg, "temperature", 4.0)
    log_a = torch.log_softmax(a["logits"].mean(dim=(2, 3)) / temp, dim=1)
    log_r = torch.log_softmax(r["logits"].mean(dim=(2, 3)) / temp, dim=1)
    return {"task": sums[1] / count, "response": sums[2] / count,
            "feature": feature / len(LEVELS), "bin": mean((log_r.exp() * (log_r - log_a)).sum(1)),
            "bin_centres": mean((a["centres"] - r["centres"]) ** 2), "sparse": sums[3] / count}


def train_loss(net, batch: Dict[str, torch.Tensor], cfg: Dict, shards) -> torch.Tensor:
    x = mel_frontend(batch["waveform"], int(cfg["images_size"]), float(cfg["max_depth"]),
                     int(cfg["sample_rate"])).permute(0, 3, 1, 2)
    keep_a, keep_r = keep_masks(net, x.shape[0], x.device, shards)
    a = net.branch("audio", x, keep_a)
    with torch.no_grad():
        r = net.branch("rgb", batch["image"].permute(0, 3, 1, 2), keep_r)
    t = loss_terms(a, r, batch["depth"].permute(0, 3, 1, 2), cfg, shards)
    return (_extra(cfg, "lambda_task", 1.0) * t["task"]
            + _extra(cfg, "lambda_response", 0.5) * t["response"]
            + _extra(cfg, "lambda_feature", 0.3) * t["feature"]
            + _extra(cfg, "lambda_bin", 0.2) * (t["bin"] + t["bin_centres"])
            + _extra(cfg, "lambda_sparse", 0.1) * t["sparse"])


def predict(net, batch: Dict[str, torch.Tensor], cfg: Dict) -> torch.Tensor:
    x = mel_frontend(batch["waveform"], int(cfg["images_size"]), float(cfg["max_depth"]),
                     int(cfg["sample_rate"]))
    return net(x)[..., 0]
