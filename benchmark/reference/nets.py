"""Plain float32 copies of the two nets the cells run, under the parameter
names of their published checkpoints (so one weight dict loads into the
reference and into the program alike).

`unet_baseline`: the pix2pix UNet generator (`unet_256`: 8 downsamplings,
k4 s2 p1 convs, BatchNorm, LeakyReLU 0.2 down, ReLU up, skip concat, ReLU
head in meters when the depth is not normalised).

`binaural_attention`: two five-scale residual encoders (one an ear), widths
c·{1, 2, 4, 8, 8}; at the attention levels, bidirectional cross attention
with shared 1×1 projections (q, k to C/8, v and out to C), scale 1/√C, and a
γ gate; per-level fusion (concat, 1×1 conv, BatchNorm, ReLU); four bilinear
(align_corners) up blocks; a sigmoid·max_depth head, clipped to
[0, max_depth].

BatchNorm normalises with the batch statistics (biased variance, eps 1e-5)
in training and with the running buffers in evaluation; it never updates
the buffers, and keeps its last training batch's mean and unbiased
variance (`batch_stats`), which the comparison reads.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .frontend import resize_matrix
from .precision import Precision

# the attention's rows and columns per block: the scores of a block stay
# under this many float32 elements (1 GiB)
ATTENTION_BLOCK_ELEMS = 2 ** 28


class BatchNorm(nn.BatchNorm2d):
    """`shards` (a `RowShards`, set by `reference_steps`): the statistics of
    the global batch, whose rows other processes hold."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.1)
        self.shards = None

    def forward(self, x):
        if self.training and self.shards is not None and self.shards.group is not None:
            dims, shape = (0, 2, 3), (1, -1, 1, 1)
            total = self.shards.total(torch.cat([x.sum(dims), x.new_tensor([x.numel() / x.shape[1]])]))
            count = total[-1]
            centred = x - (total[:-1] / count).reshape(shape)
            var = self.shards.total((centred * centred).sum(dims)) / count
            self.batch_stats = ((total[:-1] / count).detach(),
                                (var * count / (count - 1)).detach())
            return centred * torch.rsqrt(var + self.eps).reshape(shape) * self.weight.reshape(shape) \
                + self.bias.reshape(shape)
        if self.training:
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=1)
                self.batch_stats = (mean.detach(), var.detach())
            return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


class Conv(nn.Conv2d):
    """A convolution whose operands and result pass through `prec`."""

    def __init__(self, cin, cout, k, stride=1, padding=0, bias=True, prec=None):
        super().__init__(cin, cout, k, stride=stride, padding=padding, bias=bias)
        self.prec = prec or Precision()

    def forward(self, x):
        p = self.prec
        y = F.conv2d(p.operand(x), p.operand(self.weight), self.bias, self.stride, self.padding)
        return p.result(y)


class ConvTranspose(nn.ConvTranspose2d):
    def __init__(self, cin, cout, bias=True, prec=None):
        super().__init__(cin, cout, 4, stride=2, padding=1, bias=bias)
        self.prec = prec or Precision()

    def forward(self, x):
        p = self.prec
        y = F.conv_transpose2d(p.operand(x), p.operand(self.weight), self.bias, stride=2,
                               padding=1)
        return p.result(y)


# ---- UNet-256 -------------------------------------------------------------------


class _Relu(nn.Module):
    def forward(self, x):
        return torch.relu(x)


class _Leaky(nn.Module):
    def forward(self, x):
        return F.leaky_relu(x, 0.2)


class UnetBlock(nn.Module):
    def __init__(self, outer, inner, input_nc=None, sub=None, outermost=False,
                 innermost=False, prec=None):
        super().__init__()
        self.outermost = outermost
        input_nc = outer if input_nc is None else input_nc
        down = Conv(input_nc, inner, 4, 2, 1, bias=False, prec=prec)
        if outermost:
            layers = [down, sub, _Relu(), ConvTranspose(inner * 2, outer, True, prec), _Relu()]
        elif innermost:
            layers = [_Leaky(), down, _Relu(), ConvTranspose(inner, outer, False, prec),
                      BatchNorm(outer)]
        else:
            layers = [_Leaky(), down, BatchNorm(inner), sub, _Relu(),
                      ConvTranspose(inner * 2, outer, False, prec), BatchNorm(outer)]
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        if self.outermost:
            return self.model(x)
        return torch.cat([x, self.model(x)], 1)


class UNet(nn.Module):
    def __init__(self, input_nc=2, output_nc=1, num_downs=8, ngf=64, prec=None):
        super().__init__()
        block = UnetBlock(ngf * 8, ngf * 8, innermost=True, prec=prec)
        for _ in range(num_downs - 5):
            block = UnetBlock(ngf * 8, ngf * 8, sub=block, prec=prec)
        block = UnetBlock(ngf * 4, ngf * 8, sub=block, prec=prec)
        block = UnetBlock(ngf * 2, ngf * 4, sub=block, prec=prec)
        block = UnetBlock(ngf, ngf * 2, sub=block, prec=prec)
        self.model = UnetBlock(output_nc, ngf, input_nc=input_nc, sub=block, outermost=True,
                               prec=prec)

    def forward(self, x):
        """NHWC in, NHWC depth in meters out."""
        return self.model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


# ---- the binaural attention net ------------------------------------------------------


class DoubleConv(nn.Module):
    def __init__(self, cin, cout, mid=None, prec=None):
        super().__init__()
        mid = mid or cout
        self.double_conv = nn.Sequential(
            Conv(cin, mid, 3, padding=1, bias=False, prec=prec), BatchNorm(mid), _Relu(),
            Conv(mid, cout, 3, padding=1, bias=False, prec=prec), BatchNorm(cout), _Relu())

    def forward(self, x):
        return self.double_conv(x)


class Down(nn.Module):
    def __init__(self, cin, cout, prec=None):
        super().__init__()
        self.maxpool_conv = nn.Sequential(nn.MaxPool2d(2), DoubleConv(cin, cout, prec=prec))

    def forward(self, x):
        return self.maxpool_conv(x)


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


class _Attention(torch.autograd.Function):
    """softmax(q·kᵀ·scale)·v in blocks of query rows, the backward
    recomputing each block's probabilities from the saved log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        b, n, _ = q.shape
        m = k.shape[1]
        rows = max(1, min(n, ATTENTION_BLOCK_ELEMS // max(1, b * m)))
        out = torch.empty(b, n, v.shape[2], dtype=q.dtype, device=q.device)
        lse = torch.empty(b, n, 1, dtype=q.dtype, device=q.device)
        kt = k.transpose(1, 2)
        for s in range(0, n, rows):
            sc = torch.matmul(q[:, s:s + rows], kt) * scale
            lse[:, s:s + rows] = torch.logsumexp(sc, dim=-1, keepdim=True)
            out[:, s:s + rows] = torch.matmul(torch.exp(sc - lse[:, s:s + rows]), v)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.rows = scale, rows
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        scale, rows = ctx.scale, ctx.rows
        dq, dk, dv = torch.empty_like(q), torch.zeros_like(k), torch.zeros_like(v)
        kt = k.transpose(1, 2)
        delta = (do * out).sum(-1, keepdim=True)
        for s in range(0, q.shape[1], rows):
            blk = slice(s, s + rows)
            p = torch.exp(torch.matmul(q[:, blk], kt) * scale - lse[:, blk])
            dv += torch.matmul(p.transpose(1, 2), do[:, blk])
            ds = p * (torch.matmul(do[:, blk], v.transpose(1, 2)) - delta[:, blk]) * scale
            dq[:, blk] = torch.matmul(ds, k)
            dk += torch.matmul(ds.transpose(1, 2), q[:, blk])
        return dq, dk, dv, None


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
        att = p.result(_Attention.apply(p.operand(q), p.operand(k), p.operand(v), self.scale))
        out = self._proj(self.out, att)

        def image(t):
            return t.reshape(b, h, w, c).permute(0, 3, 1, 2)

        return image(lt + self.gamma * out[:b]), image(rt + self.gamma * out[b:])


class UpBilinear(nn.Module):
    def __init__(self, cin, cout, prec=None):
        super().__init__()
        self.conv = DoubleConv(cin, cout, cin // 2, prec=prec)

    def forward(self, x, skip):
        x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
        return self.conv(torch.cat([skip, x], dim=1))


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
                                          BatchNorm(ch[lv]), _Relu()) for lv in range(1, 6)})
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


# ---- factory and the weights' layout ----------------------------------------------


def build_net(cfg: Dict, prec: Precision = None, checkpointed: bool = False) -> nn.Module:
    """The reference net of a configuration file's dict."""
    fam = cfg["family"]
    if fam == "unet_baseline":
        downs = {"unet_256": 8, "unet_128": 7}[cfg.get("generator", "unet_256")]
        return UNet(num_downs=downs, ngf=int(cfg["ngf"]), prec=prec)
    if fam == "binaural_attention":
        return BinauralNet(int(cfg["base_channels"]), float(cfg["max_depth"]),
                           tuple(cfg["attention_levels"]), int(cfg["images_size"]),
                           checkpointed, prec)
    raise ValueError(f"no reference for the family {fam!r}")


def param_specs(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, rule, std) of every entry of the net's state dict, in
    order: rule "normal" (std given), "zeros", "ones", "gamma" (the
    attention gate) or "count" (BatchNorm's step counter). The family's
    initialisation: N(0, 0.02) kernels for the UNet, kaiming fan_out
    N(0, 2 / (out channels · receptive field)) for the binaural net."""
    with torch.device("meta"):
        net = build_net(cfg)
    kaiming = cfg["family"] == "binaural_attention"
    specs = []
    for name, t in net.state_dict(keep_vars=True).items():
        shape, leaf = tuple(t.shape), name.rsplit(".", 1)[-1]
        if name.endswith("num_batches_tracked"):
            specs.append((name, shape, "count", 0.0))
        elif leaf == "gamma":
            specs.append((name, shape, "gamma", 0.0))
        elif leaf == "weight" and len(shape) == 4:
            fan_out = shape[0] * shape[2] * shape[3]
            specs.append((name, shape, "normal",
                          math.sqrt(2.0 / fan_out) if kaiming else 0.02))
        elif leaf in ("weight", "running_var"):
            specs.append((name, shape, "ones", 0.0))
        else:
            specs.append((name, shape, "zeros", 0.0))
    return specs
