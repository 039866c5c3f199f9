"""The layers the families' plain float32 nets share (each family's own net
is in `families/<family>.py`), and the walk over a state dict that their
initialisation rules share.

BatchNorm normalises with the batch statistics (biased variance, eps 1e-5)
in training and with the running buffers in evaluation; it never updates
the buffers, and keeps its last training batch's mean and unbiased
variance (`batch_stats`), which the comparison reads.

The convolutions and the attention pass their operands and results through
a `Precision`; the attention is softmax(q·kᵀ·scale)·v in blocks of query
rows. `DoubleConv`, `Down` and `UpBilinear` are the two-convolution
blocks of the port's encoder-decoder families (3×3 conv, BatchNorm, ReLU,
twice; a max-pool before; an align_corners bilinear ×2 and a skip concat
before).
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .families import build_net  # noqa: F401  (tests outside the benchmark import it here)
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


class Relu(nn.Module):
    def forward(self, x):
        return torch.relu(x)


class LeakyRelu(nn.Module):
    def forward(self, x):
        return F.leaky_relu(x, 0.2)


class DoubleConv(nn.Module):
    def __init__(self, cin, cout, mid=None, prec=None):
        super().__init__()
        mid = mid or cout
        self.double_conv = nn.Sequential(
            Conv(cin, mid, 3, padding=1, bias=False, prec=prec), BatchNorm(mid), Relu(),
            Conv(mid, cout, 3, padding=1, bias=False, prec=prec), BatchNorm(cout), Relu())

    def forward(self, x):
        return self.double_conv(x)


class Down(nn.Module):
    def __init__(self, cin, cout, prec=None):
        super().__init__()
        self.maxpool_conv = nn.Sequential(nn.MaxPool2d(2), DoubleConv(cin, cout, prec=prec))

    def forward(self, x):
        return self.maxpool_conv(x)


class UpBilinear(nn.Module):
    def __init__(self, cin, cout, prec=None):
        super().__init__()
        self.conv = DoubleConv(cin, cout, cin // 2, prec=prec)

    def forward(self, x, skip):
        x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
        return self.conv(torch.cat([skip, x], dim=1))


class Attention(torch.autograd.Function):
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


def state_specs(net: nn.Module, kernel_std: Callable[[Tuple[int, ...]], float]
                ) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, rule, std) of every entry of `net`'s state dict, in
    order: BatchNorm's step counter "count", a gate `gamma` "gamma", a 4-D
    `weight` (a convolution's kernel) "normal" with the std that
    `kernel_std(shape)` gives, any other `weight` and `running_var` "ones",
    the rest "zeros"."""
    specs = []
    for name, t in net.state_dict(keep_vars=True).items():
        shape, leaf = tuple(t.shape), name.rsplit(".", 1)[-1]
        if name.endswith("num_batches_tracked"):
            specs.append((name, shape, "count", 0.0))
        elif leaf == "gamma":
            specs.append((name, shape, "gamma", 0.0))
        elif leaf == "weight" and len(shape) == 4:
            specs.append((name, shape, "normal", kernel_std(shape)))
        elif leaf in ("weight", "running_var"):
            specs.append((name, shape, "ones", 0.0))
        else:
            specs.append((name, shape, "zeros", 0.0))
    return specs
