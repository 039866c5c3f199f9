"""coarse_depth: the hybrid of the coarse-depth family, `CoarseWithOffsetModel`
with `CoarseOffsetLoss`, of the reference repository's
`models/coarse_depth_model.py` (:591-850) and `train_coarse_depth.py`.

The net, on the mel image's two channels: a five-scale encoder (`inc`,
`down1..4`: a 3×3 conv, BatchNorm, ReLU twice, a 2×2 max-pool before each
`down`; widths c·{1, 2, 4, 8, 8}); two UNet decoders over its pyramid,
`coarse_up1..4` and `offset_up1..4` (an align_corners bilinear ×2, the skip
concatenated first, the two convolutions with a mid width of half the
input's: 16c → 4c, 8c → 2c, 4c → c, 2c → c); on the first a 1×1 n_bins
class head (`coarse_head`), whose softmax expectation over a fixed [K]
buffer of bin centres (`bin_centers`) is the coarse depth; on the second
the offset branch: the coarse depth, detached from the graph, concatenated
after the decoder's c channels, then conv3 (c+1 → c), BatchNorm, ReLU,
conv3 (c → c/2), BatchNorm, ReLU (`offset_fusion`), and a 1×1 head
(`offset_head`). final = coarse + offset. The blocks' convolutions have no
bias; the fusion's and the heads' have one.

The bins: SID spacing, edges d_min·(d_max/d_min)^(t^α) at t = linspace(0,
1, K + 1) in float64, cast to float32, the centres the edges' midpoints
(d_min and α from the configuration's `extra`, d_max its `max_depth`); a
pixel's bin is the number of inner edges below its depth in meters
(searchsorted on the left), clipped to [0, K − 1]. The training script
writes the centres into the net's buffer; so does a load of the state
dict here, whatever the buffer held.

The loss (the script's `CoarseOffsetLoss` with the training script's weights):
  ce_weight · CE + regression_weight · L1(final, gt) + offset_reg_weight · mean|offset|
CE the label-smoothed (0.1, the script's for the hybrid) cross entropy of
the logits against the bins over every pixel, (1 − ε)·(−log p_bin) +
ε·mean over the bins of (−log p), in float32; the L1 over every pixel,
unmasked (the reference's); every mean over the global batch's pixels.
Initialisation (`define_coarse_depth_model`, :475-538): kaiming fan_out
N(0, 2 / fan_out) for every convolution kernel, zero biases, BatchNorm 1/0.
Where `checkpointed`, the encoder's levels, the up blocks, the soft binning
and the offset branch's fusion and head are recomputed in the backward;
the cross entropy always is.

Departures from the published model and its training:
- the logits and the offset decoder's output are taken at the decoder's
  resolution, which equals the output size whenever the input image is
  the output's size (the configurations here): the published model's
  bilinear resize to `output_size` is then the identity, and a
  configuration where it is not is refused;
- the learning rate is constant (the script restarts a cosine every 20
  epochs, CosineAnnealingWarmRestarts, T_0 = 20);
- the targets are the benchmark's synthetic dense depth, the bins
  bucketised from it (`extra_inputs`), in place of the `downup_015` sparse
  targets of the published training;
- the weights are random from the seed.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..frontend import mel_frontend
from ..nets import BatchNorm, Conv, Relu, state_specs

LABEL_SMOOTHING = 0.1


def _extra(cfg: Dict, key: str, default: float) -> float:
    return float(cfg.get("extra", {}).get(key, default))


def _sid_edges64(cfg: Dict) -> np.ndarray:
    t = np.linspace(0.0, 1.0, int(cfg["n_bins"]) + 1)
    d_min, d_max = _extra(cfg, "depth_min", 0.1), float(cfg["max_depth"])
    return d_min * (d_max / d_min) ** (t ** _extra(cfg, "sid_alpha", 0.6))


def sid_edges(cfg: Dict) -> np.ndarray:
    """The K + 1 SID bin edges in meters, float32."""
    return _sid_edges64(cfg).astype(np.float32)


def sid_centres(cfg: Dict) -> np.ndarray:
    """The K bin centres, the edges' midpoints (in float64, cast to float32)."""
    edges = _sid_edges64(cfg)
    return (0.5 * (edges[:-1] + edges[1:])).astype(np.float32)


def _double_conv(cin, cout, mid, prec):
    return nn.Sequential(Conv(cin, mid, 3, padding=1, bias=False, prec=prec), BatchNorm(mid),
                         Relu(), Conv(mid, cout, 3, padding=1, bias=False, prec=prec),
                         BatchNorm(cout), Relu())


class DoubleConv(nn.Module):
    """The family's spelling of the two-convolution block: `conv.*`."""

    def __init__(self, cin, cout, mid=None, prec=None):
        super().__init__()
        self.conv = _double_conv(cin, cout, mid or cout, prec)

    def forward(self, x):
        return self.conv(x)


class Down(nn.Module):
    def __init__(self, cin, cout, prec=None):
        super().__init__()
        self.pool_conv = nn.Sequential(nn.MaxPool2d(2), DoubleConv(cin, cout, prec=prec))

    def forward(self, x):
        return self.pool_conv(x)


class Up(nn.Module):
    def __init__(self, cin, cout, prec=None):
        super().__init__()
        self.conv = DoubleConv(cin, cout, cin // 2, prec)

    def forward(self, x, skip):
        x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
        return self.conv(torch.cat([skip, x], dim=1))


def _soft_bins(logits, centres):
    return (torch.softmax(logits, dim=1) * centres[None, :, None, None]).sum(1, keepdim=True)


def _ce_sum(logits, bins):
    """Σ over the pixels of the label-smoothed cross entropy, float32."""
    logp = torch.log_softmax(logits, dim=1)
    nll = -logp.gather(1, bins[:, None]).squeeze(1)
    return ((1.0 - LABEL_SMOOTHING) * nll - LABEL_SMOOTHING * logp.mean(1)).sum()


class HybridNet(nn.Module):
    def __init__(self, c, n_bins, centres, checkpointed=False, prec=None):
        super().__init__()
        self.checkpointed = checkpointed
        self.inc = DoubleConv(2, c, prec=prec)
        self.down1 = Down(c, 2 * c, prec)
        self.down2 = Down(2 * c, 4 * c, prec)
        self.down3 = Down(4 * c, 8 * c, prec)
        self.down4 = Down(8 * c, 8 * c, prec)
        widths = ((16 * c, 4 * c), (8 * c, 2 * c), (4 * c, c), (2 * c, c))
        for i, (w_in, w_out) in enumerate(widths, start=1):
            setattr(self, f"coarse_up{i}", Up(w_in, w_out, prec))
        self.coarse_head = Conv(c, n_bins, 1, prec=prec)
        for i, (w_in, w_out) in enumerate(widths, start=1):
            setattr(self, f"offset_up{i}", Up(w_in, w_out, prec))
        self.offset_fusion = nn.Sequential(
            Conv(c + 1, c, 3, padding=1, prec=prec), BatchNorm(c), Relu(),
            Conv(c, c // 2, 3, padding=1, prec=prec), BatchNorm(c // 2), Relu())
        self.offset_head = Conv(c // 2, 1, 1, prec=prec)
        self.register_buffer("bin_centers", torch.zeros(n_bins))
        self._centres = torch.from_numpy(centres)
        self.register_load_state_dict_post_hook(lambda module, keys: module.write_centres())

    @torch.no_grad()
    def write_centres(self):
        self.bin_centers.copy_(self._centres)

    def _run(self, fn, *args):
        if self.checkpointed and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def _decode(self, prefix, f):
        d = self._run(getattr(self, f"{prefix}1"), f[4], f[3])
        d = self._run(getattr(self, f"{prefix}2"), d, f[2])
        d = self._run(getattr(self, f"{prefix}3"), d, f[1])
        return self._run(getattr(self, f"{prefix}4"), d, f[0])

    def _offset(self, o, coarse):
        return self.offset_head(self.offset_fusion(torch.cat([o, coarse], dim=1)))

    def outputs(self, x) -> Dict[str, torch.Tensor]:
        """logits, coarse, offset and final (NCHW) of an NCHW mel image."""
        f, h = [], x
        for block in (self.inc, self.down1, self.down2, self.down3, self.down4):
            h = self._run(block, h)
            f.append(h)
        logits = self.coarse_head(self._decode("coarse_up", f))
        if logits.shape[-2:] != x.shape[-2:]:
            raise ValueError("the logits' size differs from the input's: the published "
                             "model's resize is not part of this reference")
        coarse = self._run(_soft_bins, logits, self.bin_centers)
        o = self._decode("offset_up", f)
        offset = self._run(self._offset, o, coarse.detach())
        return {"logits": logits, "coarse": coarse, "offset": offset, "final": coarse + offset}

    def forward(self, x):
        """The final depth: NHWC [B, S, S, 2] in, NHWC out."""
        return self.outputs(x.permute(0, 3, 1, 2))["final"].permute(0, 2, 3, 1)


def build_net(cfg: Dict, prec=None, checkpointed: bool = False) -> nn.Module:
    if cfg.get("model_type", "hybrid") != "hybrid":
        raise ValueError(f"no reference of the coarse model_type {cfg['model_type']!r}")
    return HybridNet(int(cfg["base_channels"]), int(cfg["n_bins"]), sid_centres(cfg),
                     checkpointed, prec)


def param_specs(cfg: Dict):
    with torch.device("meta"):
        net = build_net(cfg)
    return state_specs(net, lambda shape: math.sqrt(2.0 / (shape[0] * shape[2] * shape[3])))


def extra_inputs(depth, gen, cfg: Dict) -> Dict[str, torch.Tensor]:
    """The bin targets [n, S, S] int32 of the rows' depth [n, S, S, 1] in
    meters (SID edges; the invalid pixels at 0 m fall in bin 0), bucketised
    where the depth lies against the float32 inner edges (`side="left"`)."""
    edges = sid_edges(cfg)
    inner = torch.from_numpy(edges[1:-1]).to(depth.device)
    idx = torch.searchsorted(inner, depth[..., 0].contiguous(), right=False)
    return {"bins": idx.clamp_(0, len(edges) - 2).to(torch.int32)}


def loss_terms(out: Dict, gt, bins, shards) -> Dict[str, torch.Tensor]:
    """The loss's terms from the net's outputs (`HybridNet.outputs`), the
    NCHW depth and the [B, S, S] bins: `ce`, `regression`, `offset_reg`."""
    ce = checkpoint(_ce_sum, out["logits"], bins.long(), use_reentrant=False)
    sums = shards.total(torch.stack([ce, (out["final"] - gt).abs().sum(),
                                     out["offset"].abs().sum()]))
    pixels = gt.numel() * shards.ranks
    return {"ce": sums[0] / pixels, "regression": sums[1] / pixels,
            "offset_reg": sums[2] / pixels}


def train_loss(net, batch: Dict[str, torch.Tensor], cfg: Dict, shards) -> torch.Tensor:
    x = mel_frontend(batch["waveform"], int(cfg["images_size"]), float(cfg["max_depth"]),
                     int(cfg["sample_rate"])).permute(0, 3, 1, 2)
    t = loss_terms(net.outputs(x), batch["depth"].permute(0, 3, 1, 2), batch["bins"], shards)
    return (_extra(cfg, "ce_weight", 1.0) * t["ce"]
            + _extra(cfg, "regression_weight", 0.5) * t["regression"]
            + _extra(cfg, "offset_reg_weight", 0.01) * t["offset_reg"])


def predict(net, batch: Dict[str, torch.Tensor], cfg: Dict) -> torch.Tensor:
    x = mel_frontend(batch["waveform"], int(cfg["images_size"]), float(cfg["max_depth"]),
                     int(cfg["sample_rate"]))
    return net(x)[..., 0]
