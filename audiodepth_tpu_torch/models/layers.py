"""Building blocks of the model zoo (port of `models/layers.py`).

The port runs NCHW inside the model. Cast points follow the JAX package
exactly, with no autocast:
  * params are fp32; a conv casts its input, kernel and bias to the model's
    compute dtype (flax `nn.Conv(dtype=...)`), so its output is in that
    dtype;
  * BatchNorm computes in at least fp32 and casts back to the compute dtype;
    in train mode it folds the batch statistics into its running buffers in
    their stored dtype, except while `remat` recomputes a forward;
  * the head is promoted with `at_least_f32`.

Initializers: `normal_init` (the pix2pix UNet), `kaiming_init` (the
residual, attention and AdaBins families) and `lecun_normal_init` (flax's
default, which the JAX package's base_residual heads and cVAE bottleneck
keep). The residual blocks (`DoubleConv`,
`Down`, `UpBilinear`) keep the reference's module names, so their
state_dict keys are the reference's (`double_conv.0`, `maxpool_conv.1`,
`conv.double_conv.3`, ...); the coarse-depth family's copies of the same
blocks name them `conv` and `pool_conv` (the `inner` / `pool` arguments).
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.cuda.batch_norm import batch_norm_train, kernel_takes
from ..parallel.mesh import active_group, global_sum


def normal_init(std: float = 0.02) -> Callable[[torch.Tensor, Optional[torch.Generator]], None]:
    """Initializer filling a tensor with N(0, std) drawn in float32 on the
    CPU from an explicit generator, so a seed gives the same weights on
    every device."""

    def init(t: torch.Tensor, generator: Optional[torch.Generator] = None) -> None:
        draw = torch.empty(t.shape, dtype=torch.float32).normal_(0.0, std, generator=generator)
        with torch.no_grad():
            t.copy_(draw)

    return init


def kaiming_init(transposed: bool = False
                 ) -> Callable[[torch.Tensor, Optional[torch.Generator]], None]:
    """torch `kaiming_normal_(mode="fan_out", nonlinearity="relu")`, which is
    flax `variance_scaling(2.0, "fan_out", "normal")`: N(0, 2 / fan_out) with
    fan_out = out_channels x receptive field, drawn like `normal_init`.
    `transposed`: a ConvTranspose2d weight [I, O, kh, kw], whose output
    channels are its second axis (flax's fan_out of a ConvTranspose)."""

    def init(t: torch.Tensor, generator: Optional[torch.Generator] = None) -> None:
        fan_out = t.shape[1 if transposed else 0] * math.prod(t.shape[2:])
        normal_init(math.sqrt(2.0 / fan_out))(t, generator)

    return init


def lecun_normal_init() -> Callable[[torch.Tensor, Optional[torch.Generator]], None]:
    """flax's default kernel init, `variance_scaling(1.0, "fan_in",
    "truncated_normal")`: N(0, 1 / fan_in) truncated to ±2 standard
    deviations (the std corrected for the truncation), fan_in = in_channels
    x receptive field, drawn like `normal_init`."""

    def init(t: torch.Tensor, generator: Optional[torch.Generator] = None) -> None:
        fan_in = t.shape[1] * math.prod(t.shape[2:])
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        draw = torch.empty(t.shape, dtype=torch.float32)
        torch.nn.init.trunc_normal_(draw, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        with torch.no_grad():
            t.copy_(draw)

    return init


def init_modules(model: nn.Module, generator: torch.Generator, kernel_init,
                 special=None) -> None:
    """A family's seeded init, in module order from `generator`: every conv,
    transposed conv and linear kernel by `kernel_init` (or by
    `special[module]`), zero biases, BatchNorm scale 1 / bias 0 and running
    statistics 0 / 1."""
    special = special or {}
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                special.get(m, kernel_init)(m.weight, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """Cast to fp32 for numerics-critical math without ever DOWNcasting
    (the float64 mode stays float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


# set while `remat` recomputes a forward inside the backward: BatchNorm then
# normalizes as before but does not fold its statistics a second time
_remat_state = threading.local()


def _recomputing() -> bool:
    return getattr(_remat_state, "recomputing", False)


@contextlib.contextmanager
def _recompute_context():
    prev = _recomputing()
    _remat_state.recomputing = True
    try:
        yield
    finally:
        _remat_state.recomputing = prev


def remat(fn: Callable, *args):
    """`fn(*args)` with its activations recomputed in the backward instead of
    kept (the JAX package's `nn.remat`), without a second BatchNorm fold."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(), _recompute_context()))


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d (momentum 0.1, eps 1e-5, affine) that normalizes in at
    least fp32 and casts the result back to the compute dtype. It also takes
    [B, C] (BatchNorm1d's form, the legacy FCBlock's), with the same rules.

    In train mode it normalizes with the batch statistics and folds them,
    with torch's unbiased variance, into the running buffers in place and in
    their stored dtype, whatever the compute dtype (the JAX package's
    `models/layers.py:86-95`). Eval mode normalizes with the buffers.

    Inside a data-parallel step (`parallel.use_group`) the statistics are
    the global batch's, as under a JAX mesh: the count and the per-channel
    sums are reduced first, then Σ(x − mean)² (two passes: one pass of Σx²
    loses fp32 precision on bf16 activations), both through the
    differentiable `parallel.global_sum`. The buffers fold the unbiased
    variance over the global count. torch's `SyncBatchNorm` would drop the
    dtype rules and the fold-once of `remat`, so it is not used.

    `relu`: the ReLU that follows the norm is applied here (its slot in the
    owner's Sequential holds an `nn.Identity`, so indices and state_dict
    keys stay the reference's).

    A bf16 train-mode forward outside a data-parallel group goes through
    the hand-written kernels where `ops/cuda/batch_norm.py::kernel_takes`
    its input: bf16 in and out, fp32 statistics, the fold and the ReLU
    inside, no fp32 copy of the activation. Every other input takes the
    code below."""

    def __init__(self, num_features: int, dtype: torch.dtype = torch.float32,
                 relu: bool = False):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.compute_dtype = dtype
        self.relu = relu

    def extra_repr(self) -> str:
        return super().extra_repr() + (", relu=True" if self.relu else "")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if (self.training and self.compute_dtype == torch.bfloat16 and active_group() is None
                and kernel_takes(x, self.weight, self.bias, self.running_mean,
                                 self.running_var)):
            return batch_norm_train(x, self.weight, self.bias, self.running_mean,
                                    self.running_var, self.momentum, self.eps, self.relu,
                                    fold=not _recomputing())
        y = self._forward(x).to(self.compute_dtype)
        return F.relu(y) if self.relu else y

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        sdt = torch.promote_types(x.dtype, torch.float32)
        xs, w, b = x.to(sdt), self.weight.to(sdt), self.bias.to(sdt)
        if not self.training:
            y = F.batch_norm(xs, self.running_mean.to(sdt), self.running_var.to(sdt), w, b,
                             training=False, momentum=0.0, eps=self.eps)
        elif active_group() is not None:
            y = self._global_batch_norm(xs, w, b)
        elif self.running_mean.dtype == sdt:
            # the buffers themselves: the fused kernel folds them in place. A
            # recompute folds into copies, so that it saves the same tensors
            # for the backward as the forward did
            rm, rv = self.running_mean, self.running_var
            if _recomputing():
                rm, rv = rm.clone(), rv.clone()
            y = F.batch_norm(xs, rm, rv, w, b, training=True, momentum=self.momentum,
                             eps=self.eps)
        else:
            y = F.batch_norm(xs, None, None, w, b, training=True, momentum=0.0, eps=self.eps)
            if not _recomputing():
                self._fold(xs)
        return y

    def _global_batch_norm(self, xs: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor) -> torch.Tensor:
        """Train-mode normalization with the global batch's statistics; the
        fold runs once a forward, not in a `remat` recompute (which runs the
        same collectives in the same order on every rank)."""
        dims = (0,) + tuple(range(2, xs.dim()))
        shape = (1, -1) + (1,) * (xs.dim() - 2)
        sums = global_sum(torch.cat([xs.sum(dim=dims),
                                     xs.new_tensor([xs.numel() // xs.shape[1]])]))
        count = sums[-1]
        mean = sums[:-1] / count
        centred = xs - mean.reshape(shape)
        sq = global_sum((centred * centred).sum(dim=dims))
        inv_std = torch.rsqrt(sq / count + self.eps)
        y = centred * (inv_std * w).reshape(shape) + b.reshape(shape)
        if not _recomputing():
            with torch.no_grad():
                self._fold_stats(mean, sq / (count - 1))
        return y

    @torch.no_grad()
    def _fold(self, xs: torch.Tensor) -> None:
        """running ← (1 − momentum)·running + momentum·batch, in the
        buffers' dtype (a compute dtype other than the buffers')."""
        dims = (0,) + tuple(range(2, xs.dim()))
        var, mean = torch.var_mean(xs, dim=dims, correction=1)
        self._fold_stats(mean, var)

    @torch.no_grad()
    def _fold_stats(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        for buf, stat in ((self.running_mean, mean), (self.running_var, var)):
            buf.mul_(1.0 - self.momentum).add_(self.momentum * stat.detach().to(buf.dtype))


class _InstanceNorm(nn.Module):
    """Per-sample, per-channel spatial normalization; no params, no stats."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
        return (x - mean) * torch.rsqrt(var + 1e-5)


def make_norm(norm: str, num_features: int, dtype: torch.dtype) -> nn.Module:
    """norm in {batch, instance, none} (unetbaseline_model.py:59-77)."""
    if norm == "batch":
        return BatchNorm(num_features, dtype=dtype)
    if norm == "instance":
        return _InstanceNorm()
    if norm == "none":
        return nn.Identity()
    raise ValueError(f"unknown norm {norm!r}")


class ConvDown(nn.Conv2d):
    """k4 s2 p1 strided conv (the pix2pix down-sampling conv)."""

    def __init__(self, in_ch: int, out_ch: int, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, out_ch, kernel_size=4, stride=2, padding=1, bias=use_bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class ConvUp(nn.ConvTranspose2d):
    """k4 s2 p1 transposed conv producing exactly 2x spatial (pix2pix up conv).

    flax's `ConvTranspose(padding="SAME")` holds the spatially flipped kernel
    of this one (tools/import_jax.py flips it on transfer)."""

    def __init__(self, in_ch: int, out_ch: int, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, out_ch, kernel_size=4, stride=2, padding=1, bias=use_bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), bias,
                                  stride=2, padding=1)


class Conv2d(nn.Conv2d):
    """Stride-1 'SAME' conv that computes in the model's compute dtype
    (flax `nn.Conv(dtype=...)`): input, kernel and bias are cast to it."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, out_ch, kernel_size, padding=kernel_size // 2, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class DoubleConv(nn.Module):
    """(conv3x3 → BN → ReLU) × 2, no conv bias (base_residual_model.py:23-40),
    its Sequential named `inner`; each ReLU runs inside its BatchNorm (its
    slot an `nn.Identity`)."""

    def __init__(self, in_ch: int, out_ch: int, mid_ch: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, inner: str = "double_conv"):
        super().__init__()
        mid = mid_ch or out_ch
        self.inner = inner
        setattr(self, inner, nn.Sequential(
            Conv2d(in_ch, mid, 3, bias=False, dtype=dtype), BatchNorm(mid, dtype, relu=True),
            nn.Identity(), Conv2d(mid, out_ch, 3, bias=False, dtype=dtype),
            BatchNorm(out_ch, dtype, relu=True), nn.Identity()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, self.inner)(x)


class Down(nn.Module):
    """2×2 max-pool, then DoubleConv, in a Sequential named `pool`."""

    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype = torch.float32,
                 inner: str = "double_conv", pool: str = "maxpool_conv"):
        super().__init__()
        self.pool = pool
        setattr(self, pool, nn.Sequential(
            nn.MaxPool2d(2), DoubleConv(in_ch, out_ch, dtype=dtype, inner=inner)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, self.pool)(x)


def upsample2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """2× bilinear upsample with torch's align_corners=True phase (the JAX
    package reproduces it with `scale_and_translate`). On a card in torch's
    deterministic mode (`torch.use_deterministic_algorithms`, which a
    sequence-parallel engine turns on around its steps) its backward is two
    products with the interpolation matrices: torch's own adds with atomics,
    in an order that differs from run to run, and refuses to run in that
    mode."""
    if x.is_cuda and torch.are_deterministic_algorithms_enabled():
        return _Upsample2xDeterministic.apply(x)
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


@functools.lru_cache(maxsize=None)
def _align_corners_matrix(n: int, device: torch.device,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[2n, n] weights of the 2× align_corners=True interpolation in `dtype`
    (float32 or float64), computed as torch's kernel computes them in its
    accumulation type (the scale and source index in that type); made once
    for each (n, device, dtype)."""
    ft = np.float64 if dtype == torch.float64 else np.float32
    out = 2 * n
    scale = ft((n - 1) / (out - 1)) if out > 1 else ft(0.0)
    src = scale * np.arange(out, dtype=ft)
    i0 = src.astype(np.int64)
    i1 = np.minimum(i0 + 1, n - 1)
    lam1 = src - i0.astype(ft)
    m = np.zeros((out, n), ft)
    np.add.at(m, (np.arange(out), i0), ft(1.0) - lam1)
    np.add.at(m, (np.arange(out), i1), lam1)
    return torch.from_numpy(m).to(device)


class _Upsample2xDeterministic(torch.autograd.Function):
    """torch's 2× align_corners upsample forward; backward Aₕᵀ·g·A_w in at
    least float32 (`_align_corners_matrix`)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        ctx.hw = x.shape[-2:]
        return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        acc = torch.promote_types(g.dtype, torch.float32)
        ah, aw = (_align_corners_matrix(n, g.device, acc) for n in ctx.hw)
        return torch.matmul(torch.matmul(ah.t(), g.to(acc)), aw).to(g.dtype)


class UpBilinear(nn.Module):
    """2× bilinear upsample → concat [skip, x] → DoubleConv(out, mid=in//2)
    (the bilinear branch of Up, base_residual_model.py:57-80). `in_ch` is
    the channel count after the concat."""

    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype = torch.float32,
                 inner: str = "double_conv"):
        super().__init__()
        self.conv = DoubleConv(in_ch, out_ch, in_ch // 2, dtype=dtype, inner=inner)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = upsample2x_align_corners(x)
        return self.conv(torch.cat([skip, x.to(skip.dtype)], dim=1))
