"""Train-mode BatchNorm over a bf16 channels-last activation: wrappers of
the CUDA kernels in `csrc/batch_norm.cu`, the forward and the backward,
their plain PyTorch versions, their launch plan, and the autograd Function
that joins them.

    forward   y = BN(x) with the batch's statistics [then ReLU], x and y
              bf16 [N, C, H, W] channels-last, statistics in fp32; the
              running buffers folded in place (momentum, unbiased
              variance) unless `fold` is False (a `remat` recompute)
    backward  (dx, dγ, dβ) from dy and the saved x, mean and invstd; the
              ReLU's mask recomputed from x

It replaces no TPU kernel: on the TPU, XLA fused the casts around the fp32
BatchNorm, and the normalisation, into their neighbours; eager PyTorch ran
them as three passes each way (bf16 → fp32 copy, cuDNN's fp32 BatchNorm,
fp32 → bf16 copy). `models/layers.py::BatchNorm` takes this path in a
bf16 train-mode forward outside a data-parallel group where `kernel_takes`
the input (a CUDA bf16 channels-last activation, C a multiple of 8, fp32
parameters and buffers), and keeps its own code for everything else.

`audiodepth::batch_norm_train_fwd` (which folds the running buffers, so
its schema marks them mutated) and `audiodepth::batch_norm_train_bwd` are
the registered ops: their CUDA implementations are the wrappers (the
kernels, counted), their CPU implementations the plain versions (the
module's own cast → F.batch_norm → cast, then the ReLU; the backward is that chain's
autograd), and their fakes give the shapes without the library. torch's
`register_autograd` refuses an op that mutates its arguments, so the
autograd Function `BatchNormTrain` joins the two ops; it saves x (bf16),
the weight, the bias, mean and invstd.

`bn_plan` (pure Python, tested on the CPU) decides how a call runs: the
groups of 8 channels a block takes (a thread loads a row's 8 channels with
one 16-byte load, so C must be a multiple of 8), the rows it takes at a
time, and the row chunks (one block each, every block of a pass resident
at once); the partials buffer is sized from it.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ._build import Launcher, cdiv, device_args, sm_count

SOURCE = "audiodepth_tpu_torch/csrc/batch_norm.cu"
# no TPU kernel: XLA fused the casts and the normalisation into their neighbours
REPLACES = "none (XLA fused BatchNorm and its casts on the TPU)"

THREADS = 256          # csrc/batch_norm.cu kThreads
VEC = 8                # kVec: the channels of one 16-byte load
BLOCKS_PER_SM = 2      # kMinBlocksPerSm: the blocks of a pass all resident at once
MIN_ROWS_PER_SLOT = 16  # rows a block's thread row slot takes at the least


@dataclass(frozen=True)
class BnPlan:
    """How one call runs: `group_tile` groups of VEC channels a block
    (`channel_tiles` blocks across C), `rows_per_iter` rows a block takes
    at a time, `row_blocks` chunks of `rows_per_block` rows."""

    rows: int
    channels: int
    group_tile: int
    channel_tiles: int
    rows_per_iter: int
    rows_per_block: int
    row_blocks: int

    @property
    def fwd_scratch_floats(self) -> int:
        """Each chunk's (mean, M2) per channel."""
        return 2 * self.row_blocks * self.channels

    @property
    def bwd_scratch_floats(self) -> int:
        """Each chunk's two sums per channel, then dx's three coefficients."""
        return 2 * self.row_blocks * self.channels + 3 * self.channels


def bn_plan(rows: int, channels: int, n_sm: int) -> BnPlan:
    """The plan of a call over `rows` rows of `channels` channels on a card
    of `n_sm` SMs."""
    if rows < 2 or channels < 1 or channels % VEC:
        raise ValueError(f"the kernels take more than one value a channel and a multiple of "
                         f"{VEC} channels; got {rows} rows of {channels} channels")
    groups = channels // VEC
    channel_tiles = cdiv(groups, THREADS)
    group_tile = cdiv(groups, channel_tiles)
    rows_per_iter = THREADS // group_tile
    max_blocks = max(1, n_sm * BLOCKS_PER_SM // channel_tiles)
    blocks = min(max_blocks, max(1, cdiv(rows, rows_per_iter * MIN_ROWS_PER_SLOT)))
    rows_per_block = cdiv(cdiv(rows, blocks), rows_per_iter) * rows_per_iter
    return BnPlan(rows, channels, group_tile, channel_tiles, rows_per_iter, rows_per_block,
                  cdiv(rows, rows_per_block))


# ---- the plain versions -----------------------------------------------------------


def _stats_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def batch_norm_train_fwd_plain(x, weight, bias, running_mean, running_var, momentum: float,
                               eps: float, relu: bool, fold: bool):
    """The module's own chain: cast to at least fp32, torch's train-mode BatchNorm
    (the running buffers folded in place where `fold`), cast back, ReLU;
    with the batch's mean and invstd."""
    sdt = _stats_dtype(x)
    xs = x.to(sdt)
    rm, rv = (running_mean, running_var) if fold else (None, None)
    y, mean, invstd = torch.native_batch_norm(xs, weight.to(sdt), bias.to(sdt), rm, rv, True,
                                              momentum, eps)
    y = y.to(x.dtype)
    return (F.relu(y) if relu else y), mean, invstd


def batch_norm_train_bwd_plain(dy, x, weight, bias, mean, invstd, eps: float, relu: bool):
    """The gradients of the module's own chain: the ReLU's mask from its forward
    recomputed, then torch's BatchNorm backward on the saved statistics in
    at least fp32."""
    sdt = _stats_dtype(x)
    xs, w = x.to(sdt), weight.to(sdt)
    g = dy
    if relu:
        y = torch.native_batch_norm(xs, w, bias.to(sdt), None, None, True, 0.0, eps)[0]
        g = torch.where(y.to(x.dtype) > 0, dy, torch.zeros_like(dy))
    dx, dw, db = torch.ops.aten.native_batch_norm_backward(
        g.to(sdt), xs, w, None, None, mean, invstd, True, eps, [True, True, True])
    return dx.to(x.dtype), dw.to(weight.dtype), db.to(bias.dtype)


# ---- the wrappers ---------------------------------------------------------------------


def check_activation(x: torch.Tensor) -> Tuple[int, int]:
    """(rows, C) of a 4-D activation [N, C, H, W]."""
    if x.dim() != 4:
        raise ValueError(f"x must be [N, C, H, W], got {tuple(x.shape)}")
    n, c, h, w = x.shape
    return n * h * w, c


def row_stride(t: torch.Tensor) -> Optional[int]:
    """The distance in elements between the rows (n, h, w) of a 4-D tensor
    whose channels are contiguous, rows in (n, h, w) order a common stride
    apart (channels-last, or a channel slice of it); None otherwise."""
    n, c, h, w = t.shape
    if c > 1 and t.stride(1) != 1:
        return None
    ld, seen = None, 1
    for size, stride in ((w, t.stride(3)), (h, t.stride(2)), (n, t.stride(0))):
        if size > 1:
            if ld is None:
                if stride % seen:
                    return None
                ld = stride // seen
            if stride != ld * seen:
                return None
        seen *= size
    ld = c if ld is None else ld
    return ld if ld >= c else None


def kernel_takes(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 running_mean: torch.Tensor, running_var: torch.Tensor) -> bool:
    """Whether the kernels take a train-mode BatchNorm of `x` with these
    parameters and running buffers."""
    return (x.is_cuda and x.dtype == torch.bfloat16 and x.dim() == 4 and x.shape[1] % VEC == 0
            and x.is_contiguous(memory_format=torch.channels_last)
            and all(t.dtype == torch.float32 for t in (weight, bias, running_mean, running_var)))


def _kernel_tensor(t: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(t, row stride) as the kernels read it: t itself where its rows are
    evenly strided and aligned for 16-byte loads, else a channels-last
    copy."""
    ld = row_stride(t)
    if ld is None or ld % VEC or t.data_ptr() % 16:
        t = t.contiguous(memory_format=torch.channels_last)
        ld = t.shape[1]
    return t, ld


def _check_params(x: torch.Tensor, *params: torch.Tensor) -> None:
    c = x.shape[1]
    for p in params:
        if p.shape != (c,) or p.dtype != torch.float32 or p.device != x.device:
            raise ValueError(f"the kernels take fp32 [{c}] parameters and statistics on "
                             f"{x.device}; got {p.dtype} {tuple(p.shape)} on {p.device}")
        if not p.is_contiguous():
            raise ValueError("the kernels' parameters and statistics must be contiguous")


def _kernel_input(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the kernels take bfloat16 activations, got {x.dtype}")


@functools.lru_cache(maxsize=256)
def _device_plan(index: int, rows: int, channels: int) -> BnPlan:
    """`bn_plan` for card `index`, worked out once per shape."""
    return bn_plan(rows, channels, sm_count(index))


class BatchNormTrainFwd(Launcher):
    """Callable wrapper of the forward kernels (statistics, finalize with
    the fold, normalise): (x, weight, bias, running_mean, running_var,
    momentum, eps, relu, fold) → (y, mean, invstd). `launches` counts calls
    (three kernels each), `variant_launches` the same by epilogue ("relu",
    "plain")."""

    name = "batch_norm_train_fwd"

    def __call__(self, x, weight, bias, running_mean, running_var, momentum: float,
                 eps: float, relu: bool, fold: bool):
        rows, c = check_activation(x)
        if x.device.type == "cpu":
            return batch_norm_train_fwd_plain(x, weight, bias, running_mean, running_var,
                                              momentum, eps, relu, fold)
        _kernel_input(x)
        _check_params(x, weight, bias, running_mean, running_var)
        index, stream = device_args(x.device)
        plan = _device_plan(index, rows, c)
        x, ld = _kernel_tensor(x)
        y = torch.empty_like(x, memory_format=torch.channels_last)
        mean = torch.empty(c, dtype=torch.float32, device=x.device)
        invstd = torch.empty_like(mean)
        part = torch.empty(plan.fwd_scratch_floats, dtype=torch.float32, device=x.device)
        err = self.library().adepth_bn_fwd(
            x.data_ptr(), ld, y.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            running_mean.data_ptr(), running_var.data_ptr(), mean.data_ptr(), invstd.data_ptr(),
            part.data_ptr(), rows, c, *_plan_args(plan), float(momentum), float(eps), int(relu),
            int(fold), index, stream)
        self._check(err, "relu" if relu else "plain")
        return y, mean, invstd


class BatchNormTrainBwd(Launcher):
    """Callable wrapper of the backward kernels (sums, finalize, dx):
    (dy, x, weight, bias, mean, invstd, eps, relu) → (dx, dweight, dbias).
    dy may be a channel slice of a channels-last tensor (the gradient of a
    concatenation); other layouts are copied to channels-last first.
    `launches` counts calls (three kernels each), `variant_launches` the
    same by epilogue."""

    name = "batch_norm_train_bwd"

    def __call__(self, dy, x, weight, bias, mean, invstd, eps: float, relu: bool):
        rows, c = check_activation(x)
        if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
            raise ValueError(f"dy must be like x {tuple(x.shape)} {x.dtype} on {x.device}; got "
                             f"{tuple(dy.shape)} {dy.dtype} on {dy.device}")
        if x.device.type == "cpu":
            return batch_norm_train_bwd_plain(dy, x, weight, bias, mean, invstd, eps, relu)
        _kernel_input(x)
        _check_params(x, weight, bias, mean, invstd)
        index, stream = device_args(x.device)
        plan = _device_plan(index, rows, c)
        x, ld_x = _kernel_tensor(x)
        dy, ld_dy = _kernel_tensor(dy)
        dx = torch.empty_like(x, memory_format=torch.channels_last)
        dweight = torch.empty(c, dtype=torch.float32, device=x.device)
        dbias = torch.empty_like(dweight)
        part = torch.empty(plan.bwd_scratch_floats, dtype=torch.float32, device=x.device)
        err = self.library().adepth_bn_bwd(
            dy.data_ptr(), ld_dy, x.data_ptr(), ld_x, weight.data_ptr(), bias.data_ptr(),
            mean.data_ptr(), invstd.data_ptr(), dx.data_ptr(), dweight.data_ptr(),
            dbias.data_ptr(), part.data_ptr(), rows, c, *_plan_args(plan), int(relu), index,
            stream)
        self._check(err, "relu" if relu else "plain")
        return dx, dweight, dbias


def _plan_args(plan: BnPlan):
    return plan.group_tile, plan.channel_tiles, plan.rows_per_block, plan.row_blocks


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a library built from
    `csrc/batch_norm.cu` on it."""
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    plan = [i, i, ll, i]  # _plan_args
    lib.adepth_bn_fwd.argtypes = [p, ll, p, p, p, p, p, p, p, p, ll, i, *plan, f, f, i, i, i, p]
    lib.adepth_bn_fwd.restype = i
    lib.adepth_bn_bwd.argtypes = [p, ll, p, ll, p, p, p, p, p, p, p, p, ll, i, *plan, i, i, p]
    lib.adepth_bn_bwd.restype = i
    lib.adepth_cuda_error_string.argtypes = [i]
    lib.adepth_cuda_error_string.restype = ctypes.c_char_p
    return lib


batch_norm_train_fwd = BatchNormTrainFwd()
batch_norm_train_bwd = BatchNormTrainBwd()


# ---- the registered ops -----------------------------------------------------------------


@torch.library.custom_op("audiodepth::batch_norm_train_fwd",
                         mutates_args=("running_mean", "running_var"), device_types="cuda")
def batch_norm_train_fwd_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                            running_mean: torch.Tensor, running_var: torch.Tensor,
                            momentum: float, eps: float, relu: bool, fold: bool
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward kernels as a PyTorch op: (y, mean, invstd); on a CUDA
    tensor, through `batch_norm_train_fwd`."""
    return batch_norm_train_fwd(x, weight, bias, running_mean, running_var, momentum, eps,
                                relu, fold)


@batch_norm_train_fwd_op.register_kernel("cpu")
def _fwd_cpu(x, weight, bias, running_mean, running_var, momentum, eps, relu, fold):
    return batch_norm_train_fwd(x, weight, bias, running_mean, running_var, momentum, eps,
                                relu, fold)  # checks, then plain


@batch_norm_train_fwd_op.register_fake
def _fwd_fake(x, weight, bias, running_mean, running_var, momentum, eps, relu, fold):
    _, c = check_activation(x)
    stat = x.new_empty((c,), dtype=_stats_dtype(x))
    return torch.empty_like(x), stat, torch.empty_like(stat)


@torch.library.custom_op("audiodepth::batch_norm_train_bwd", mutates_args=(),
                         device_types="cuda")
def batch_norm_train_bwd_op(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                            bias: torch.Tensor, mean: torch.Tensor, invstd: torch.Tensor,
                            eps: float, relu: bool
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels as a PyTorch op: (dx, dweight, dbias); on CUDA
    tensors, through `batch_norm_train_bwd`."""
    return batch_norm_train_bwd(dy, x, weight, bias, mean, invstd, eps, relu)


@batch_norm_train_bwd_op.register_kernel("cpu")
def _bwd_cpu(dy, x, weight, bias, mean, invstd, eps, relu):
    return batch_norm_train_bwd(dy, x, weight, bias, mean, invstd, eps, relu)


@batch_norm_train_bwd_op.register_fake
def _bwd_fake(dy, x, weight, bias, mean, invstd, eps, relu):
    check_activation(x)
    return torch.empty_like(x), torch.empty_like(weight), torch.empty_like(bias)


class BatchNormTrain(torch.autograd.Function):
    """y = BatchNorm(x) [ReLU] through the registered ops; the backward op
    gives the gradients of x, the weight and the bias."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum, eps, relu, fold):
        y, mean, invstd = batch_norm_train_fwd_op(x, weight, bias, running_mean, running_var,
                                                  momentum, eps, relu, fold)
        ctx.save_for_backward(x, weight, bias, mean, invstd)
        ctx.eps, ctx.relu = eps, relu
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, mean, invstd = ctx.saved_tensors
        dx, dweight, dbias = batch_norm_train_bwd_op(dy, x, weight, bias, mean, invstd, ctx.eps,
                                                     ctx.relu)
        return dx, dweight, dbias, None, None, None, None, None, None


def batch_norm_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     running_mean: torch.Tensor, running_var: torch.Tensor, momentum: float,
                     eps: float, relu: bool, fold: bool) -> torch.Tensor:
    """Train-mode BatchNorm [ReLU] of a bf16 channels-last activation: the
    kernels on the card, the plain versions on the CPU."""
    return BatchNormTrain.apply(x, weight, bias, running_mean, running_var, float(momentum),
                                float(eps), bool(relu), bool(fold))
