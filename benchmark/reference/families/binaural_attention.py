"""binaural_attention: two five-scale residual encoders (one an ear),
widths c·{1, 2, 4, 8, 8}; at the attention levels, bidirectional cross
attention with shared 1×1 projections (q, k to C/8, v and out to C), scale
1/√C, and a γ gate; per-level fusion (concat, 1×1 conv, BatchNorm, ReLU);
four bilinear (align_corners) up blocks; a sigmoid·max_depth head, clipped
to [0, max_depth]. On the mel front end's image of the two channels,
trained on the Combined loss, its encoders, attentions, fusions and up
blocks recomputed in the backward where `checkpointed`.
Initialisation: kaiming fan_out N(0, 2 / (out channels · receptive
field)) kernels, BatchNorm 1/0, each γ a "gamma" (drawn non-zero)."""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..frontend import resize_matrix
from ..nets import Attention, BatchNorm, Conv, DoubleConv, Down, Relu, UpBilinear, state_specs
from ..precision import Precision
from ..train import mel_combined_loss as train_loss  # noqa: F401
from ..train import mel_predict as predict  # noqa: F401


class Encoder(nn.Module):
    def __init__(self, c, prec=None):
        super().__init__()
        self.inc = DoubleConv(1, c, prec=prec)
        self.down1 = Down(c, 2 * c, prec)
        self.down2 = Down(2 * c, 4 * c, prec)
        self.down3 = Down(4 * c, 8 * c, prec)
        self.down4 = Down(8 * c, 8 * c, prec)

    def forward(self, x):
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        return x1, x2, x3, x4, self.down4(x4)


class CrossAttention(nn.Module):
    def __init__(self, channels, prec=None):
        super().__init__()
        self.prec = prec or Precision()
        inner = channels // 8
        self.query = nn.Conv2d(channels, inner, 1)
        self.key = nn.Conv2d(channels, inner, 1)
        self.value = nn.Conv2d(channels, channels, 1)
        self.out = nn.Conv2d(channels, channels, 1)
        self.gamma = nn.Parameter(torch.zeros(1))
        self.scale = 1.0 / math.sqrt(channels)

    def _proj(self, conv, t):
        p = self.prec
        return p.result(F.linear(p.operand(t), p.operand(conv.weight.flatten(1)), conv.bias))

    def forward(self, left, right):
        b, c, h, w = left.shape
        lt = left.permute(0, 2, 3, 1).reshape(b, h * w, c)
        rt = right.permute(0, 2, 3, 1).reshape(b, h * w, c)
        both, swapped = torch.cat([lt, rt]), torch.cat([rt, lt])
        p = self.prec
        q, k, v = (self._proj(self.query, both), self._proj(self.key, swapped),
                   self._proj(self.value, swapped))
        att = p.result(Attention.apply(p.operand(q), p.operand(k), p.operand(v), self.scale))
        out = self._proj(self.out, att)

        def image(t):
            return t.reshape(b, h, w, c).permute(0, 3, 1, 2)

        return image(lt + self.gamma * out[:b]), image(rt + self.gamma * out[b:])


class BinauralNet(nn.Module):
    def __init__(self, c=64, max_depth=30.0, levels=(2, 3, 4, 5), output_size=256,
                 checkpointed=False, prec=None):
        super().__init__()
        ch = {1: c, 2: 2 * c, 3: 4 * c, 4: 8 * c, 5: 8 * c}
        self.max_depth, self.levels, self.output_size = float(max_depth), tuple(levels), output_size
        self.checkpointed = checkpointed
        self.left_encoder = Encoder(c, prec)
        self.right_encoder = Encoder(c, prec)
        self.attention_modules = nn.ModuleDict(
            {f"attn_{lv}": CrossAttention(ch[lv], prec) for lv in self.levels})
        self.fusion_layers = nn.ModuleDict({
            f"fusion_{lv}": nn.Sequential(Conv(2 * ch[lv], ch[lv], 1, prec=prec),
                                          BatchNorm(ch[lv]), Relu()) for lv in range(1, 6)})
        self.up1 = UpBilinear(ch[5] + ch[4], 4 * c, prec)
        self.up2 = UpBilinear(4 * c + ch[3], 2 * c, prec)
        self.up3 = UpBilinear(2 * c + ch[2], c, prec)
        self.up4 = UpBilinear(c + ch[1], c, prec)
        self.outc = nn.Sequential(Conv(c, 1, 1, prec=prec))

    def _run(self, fn, *args):
        if self.checkpointed and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def forward(self, x):
        """NHWC [B, S, S, 2] in, NHWC depth in meters out."""
        x = x.permute(0, 3, 1, 2)
        lf = self._run(self.left_encoder, x[:, 0:1])
        rf = self._run(self.right_encoder, x[:, 1:2])
        fused = {}
        for lv in range(1, 6):
            a, b = lf[lv - 1], rf[lv - 1]
            if lv in self.levels:
                a, b = self._run(self.attention_modules[f"attn_{lv}"], a, b)
            fused[lv] = self._run(self.fusion_layers[f"fusion_{lv}"], torch.cat([a, b], 1))
        h = self._run(self.up1, fused[5], fused[4])
        h = self._run(self.up2, h, fused[3])
        h = self._run(self.up3, h, fused[2])
        h = self._run(self.up4, h, fused[1])
        depth = torch.sigmoid(self.outc(h)) * self.max_depth
        if depth.shape[-1] != self.output_size:
            wh = torch.from_numpy(resize_matrix(depth.shape[-2], self.output_size))
            ww = torch.from_numpy(resize_matrix(depth.shape[-1], self.output_size))
            depth = wh.to(depth) @ depth @ ww.to(depth).T
        return torch.clamp(depth, 0.0, self.max_depth).permute(0, 2, 3, 1)


def build_net(cfg: Dict, prec=None, checkpointed: bool = False) -> nn.Module:
    return BinauralNet(int(cfg["base_channels"]), float(cfg["max_depth"]),
                       tuple(cfg["attention_levels"]), int(cfg["images_size"]),
                       checkpointed, prec)


def param_specs(cfg: Dict):
    with torch.device("meta"):
        net = build_net(cfg)
    return state_specs(net, lambda shape: math.sqrt(2.0 / (shape[0] * shape[2] * shape[3])))
