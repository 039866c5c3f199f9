"""AdaBins' soft binning over the class head's bf16 channels-last logits:
wrappers of the CUDA kernels in `csrc/soft_binning.cu`, the forward and
the backward, their plain PyTorch versions, their launch plan, and the
registered ops with their autograd formula.

    forward   (base, logit_mean) from logits [B, K, H, W] and centers
              [B, K]: base = Σ_k softmax(logits)_k · centers_k, fp32
              [B, 1, H, W], and the logits' spatial mean, fp32 [B, K]
    backward  (grad_logits, grad_centers) from g_base, g_mean and the
              saved logits, centers and base; the softmax recomputed,
              grad_logits rounded to the logits' dtype once

It replaces no TPU kernel: on the TPU, XLA fused the float32 cast, the
softmax, the product with the centres, the sum and the KL term's spatial
mean into a few passes; eager PyTorch runs each as its own float32 pass
over [B, K, H, W] and keeps the probabilities for the backward.

`soft_binning` is the entry the model calls: the registered op where
`kernel_takes` the input (CUDA bf16 channels-last logits with K a multiple
of 8 up to 256 and fp32 centers [B, K], with or without grad), the plain
forward (the model's own chain) for everything else.

`audiodepth::soft_binning_fwd` and `audiodepth::soft_binning_bwd` are the
registered ops: their CUDA implementations are the wrappers (the kernels,
counted), their CPU implementations the plain versions (the model's own
chain: cast to at least fp32, softmax, product, sum, mean; the backward
is that chain's gradient, written out as autograd computes it), and their
fakes give the shapes without the library. The forward op mutates
nothing, so `register_autograd` joins it to the backward op; it saves the
logits (bf16), the centers and base.

`sb_plan` (pure Python, tested on the CPU) decides how a call runs: the
lanes a pixel takes (8 bins a lane, one 16-byte load: the power of two at
or above K / 8), the pixels a block takes, and the blocks an image; the
partials buffer is sized from it.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Tuple

import torch

from ._build import Launcher, cdiv, device_args, sm_count

SOURCE = "audiodepth_tpu_torch/csrc/soft_binning.cu"
# no TPU kernel: XLA fused the cast, the softmax expectation and the mean
REPLACES = "none (XLA fused the soft binning's float32 passes on the TPU)"

THREADS = 256            # csrc/soft_binning.cu kThreads
VEC = 8                  # kVec: the bins of one 16-byte load
MAX_LANES = 32           # kMaxLanes: a pixel's bins in one warp
MAX_BINS = VEC * MAX_LANES
PIXELS_PER_BLOCK = 1024  # a block's pixels where the image has enough
MIN_BLOCKS_PER_SM = 2    # at least this many blocks a card's SM, where the pixels allow


@dataclass(frozen=True)
class SbPlan:
    """How one call runs: `lanes` lanes a pixel (`slots` pixels a block
    at a time), `blocks` blocks an image of `pixels_per_block` pixels."""

    batch: int
    bins: int
    hw: int
    lanes: int
    slots: int
    pixels_per_block: int
    blocks: int

    @property
    def scratch_floats(self) -> int:
        """Each block's partial sum a bin."""
        return self.batch * self.blocks * self.bins


def sb_plan(batch: int, bins: int, hw: int, n_sm: int) -> SbPlan:
    """The plan of a call over `batch` images of `hw` pixels and `bins`
    bins on a card of `n_sm` SMs."""
    if batch < 1 or hw < 1 or bins < VEC or bins % VEC or bins > MAX_BINS:
        raise ValueError(f"the kernels take a multiple of {VEC} bins up to {MAX_BINS} and at "
                         f"least one pixel; got {batch} images of {hw} pixels, {bins} bins")
    if batch > 65535:
        raise ValueError(f"the kernels take at most 65535 images a call; got {batch}")
    lanes = 1
    while lanes < bins // VEC:
        lanes *= 2
    slots = THREADS // lanes
    blocks = cdiv(hw, PIXELS_PER_BLOCK)
    # small images: more, smaller blocks, down to one iteration's pixels each
    blocks = min(cdiv(hw, slots), max(blocks, cdiv(MIN_BLOCKS_PER_SM * n_sm, batch)))
    pixels_per_block = cdiv(cdiv(hw, blocks), slots) * slots
    return SbPlan(batch, bins, hw, lanes, slots, pixels_per_block, cdiv(hw, pixels_per_block))


# ---- the plain versions -----------------------------------------------------------


def _stats_dtype(logits: torch.Tensor) -> torch.dtype:
    return torch.promote_types(logits.dtype, torch.float32)


def _like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """`t` laid out as `torch.empty_like(ref)` would be (channels-last where
    `ref` is)."""
    if ref.dim() == 4 and ref.is_contiguous(memory_format=torch.channels_last):
        return t.contiguous(memory_format=torch.channels_last)
    return t.contiguous()


def soft_binning_fwd_plain(logits: torch.Tensor, centers: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The model's own chain: cast to at least fp32, softmax over the bins,
    product with the centers, sum; and the cast logits' spatial mean."""
    z = logits.to(_stats_dtype(logits))
    probs = torch.softmax(z, dim=1)
    base = torch.sum(probs * centers[:, :, None, None], dim=1, keepdim=True)
    return base.contiguous(), z.mean(dim=(2, 3))


def soft_binning_bwd_plain(g_base: torch.Tensor, g_mean: torch.Tensor, logits: torch.Tensor,
                           centers: torch.Tensor, base: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradients of the model's own chain, as autograd computes them:
    the sum's gradient expanded over the bins, the product's two
    gradients, the softmax's backward, the mean's gradient expanded over
    the pixels and divided by their count, one rounding to the logits'
    dtype. `base` (the forward's) is recomputed inside the softmax's
    backward, as autograd does."""
    del base
    sdt = _stats_dtype(logits)
    z = logits.to(sdt)
    probs = torch.softmax(z, dim=1)
    g = g_base.to(sdt).expand_as(probs)
    grad_probs = g * centers[:, :, None, None]
    grad_centers = (g * probs).sum(dim=(2, 3))
    grad_z = torch._softmax_backward_data(grad_probs, probs, 1, sdt)
    hw = logits.shape[2] * logits.shape[3]
    grad_z = grad_z + g_mean.to(sdt)[:, :, None, None].expand_as(grad_z) / hw
    return _like(grad_z.to(logits.dtype), logits), grad_centers.to(centers.dtype)


# ---- the wrappers ---------------------------------------------------------------------


def check_logits(logits: torch.Tensor, centers: torch.Tensor) -> Tuple[int, int, int]:
    """(B, K, HW) of logits [B, K, H, W] and centers [B, K]."""
    if logits.dim() != 4:
        raise ValueError(f"logits must be [B, K, H, W], got {tuple(logits.shape)}")
    b, k, h, w = logits.shape
    if centers.shape != (b, k):
        raise ValueError(f"centers must be [{b}, {k}], got {tuple(centers.shape)}")
    return b, k, h * w


def _kernel_inputs(logits: torch.Tensor, *fp32: torch.Tensor) -> torch.Tensor:
    """The logits as the kernels read them (channels-last, 16-byte
    aligned: a copy where they are not), after the checks."""
    if logits.device.type != "cuda":
        raise ValueError(f"unsupported device {logits.device}")
    if logits.dtype != torch.bfloat16:
        raise TypeError(f"the kernels take bfloat16 logits, got {logits.dtype}")
    for t in fp32:
        if t.dtype != torch.float32 or t.device != logits.device:
            raise ValueError(f"the kernels take fp32 tensors beside the logits on "
                             f"{logits.device}; got {t.dtype} on {t.device}")
    if not logits.is_contiguous(memory_format=torch.channels_last) or logits.data_ptr() % 16:
        logits = logits.contiguous(memory_format=torch.channels_last)
    return logits


@functools.lru_cache(maxsize=256)
def _device_plan(index: int, batch: int, bins: int, hw: int) -> SbPlan:
    """`sb_plan` for card `index`, worked out once per shape."""
    return sb_plan(batch, bins, hw, sm_count(index))


def _plan_args(plan: SbPlan):
    return plan.batch, plan.hw, plan.bins, plan.lanes, plan.pixels_per_block, plan.blocks


class SoftBinningFwd(Launcher):
    """Callable wrapper of the forward kernels (the pass, the finalize):
    (logits, centers) → (base, logit_mean). `launches` counts calls (two
    kernels each), `variant_launches` the same by whether the call records
    for autograd ("grad": an input requires grad, as the student's and a
    remat recompute's do) or not ("no_grad": the teacher's, eval's,
    serving's)."""

    name = "soft_binning_fwd"

    def __call__(self, logits, centers):
        batch, bins, hw = check_logits(logits, centers)
        if logits.device.type == "cpu":
            return soft_binning_fwd_plain(logits, centers)
        grad = logits.requires_grad or centers.requires_grad
        logits = _kernel_inputs(logits, centers)
        centers = centers.contiguous()
        index, stream = device_args(logits.device)
        plan = _device_plan(index, batch, bins, hw)
        h, w = logits.shape[2:]
        base = torch.empty((batch, 1, h, w), dtype=torch.float32, device=logits.device)
        logit_mean = torch.empty((batch, bins), dtype=torch.float32, device=logits.device)
        part = torch.empty(plan.scratch_floats, dtype=torch.float32, device=logits.device)
        err = self.library().adepth_sb_fwd(logits.data_ptr(), centers.data_ptr(),
                                           base.data_ptr(), logit_mean.data_ptr(),
                                           part.data_ptr(), *_plan_args(plan), index, stream)
        self._check(err, "grad" if grad else "no_grad")
        return base, logit_mean


class SoftBinningBwd(Launcher):
    """Callable wrapper of the backward kernels (the pass, the finalize):
    (g_base, g_mean, logits, centers, base) → (grad_logits, grad_centers),
    grad_logits bf16 channels-last. `launches` counts calls (two kernels
    each), `variant_launches` the same under "backward"."""

    name = "soft_binning_bwd"

    def __call__(self, g_base, g_mean, logits, centers, base):
        batch, bins, hw = check_logits(logits, centers)
        h, w = logits.shape[2:]
        for name, t, shape in (("g_base", g_base, (batch, 1, h, w)), ("base", base, (batch, 1, h, w)),
                               ("g_mean", g_mean, (batch, bins))):
            if t.shape != shape:
                raise ValueError(f"{name} must be {list(shape)}, got {tuple(t.shape)}")
        if logits.device.type == "cpu":
            return soft_binning_bwd_plain(g_base, g_mean, logits, centers, base)
        logits = _kernel_inputs(logits, centers, g_base, g_mean, base)
        g_base, g_mean = g_base.contiguous(), g_mean.contiguous()
        centers, base = centers.contiguous(), base.contiguous()
        index, stream = device_args(logits.device)
        plan = _device_plan(index, batch, bins, hw)
        grad_logits = torch.empty_like(logits, memory_format=torch.channels_last)
        grad_centers = torch.empty((batch, bins), dtype=torch.float32, device=logits.device)
        part = torch.empty(plan.scratch_floats, dtype=torch.float32, device=logits.device)
        err = self.library().adepth_sb_bwd(g_base.data_ptr(), g_mean.data_ptr(),
                                           logits.data_ptr(), centers.data_ptr(),
                                           base.data_ptr(), grad_logits.data_ptr(),
                                           grad_centers.data_ptr(), part.data_ptr(),
                                           *_plan_args(plan), index, stream)
        self._check(err, "backward")
        return grad_logits, grad_centers


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a library built from
    `csrc/soft_binning.cu` on it."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    plan = [i, ll, i, i, ll, i]  # _plan_args
    lib.adepth_sb_fwd.argtypes = [p, p, p, p, p, *plan, i, p]
    lib.adepth_sb_fwd.restype = i
    lib.adepth_sb_bwd.argtypes = [p, p, p, p, p, p, p, p, *plan, i, p]
    lib.adepth_sb_bwd.restype = i
    lib.adepth_cuda_error_string.argtypes = [i]
    lib.adepth_cuda_error_string.restype = ctypes.c_char_p
    return lib


soft_binning_fwd = SoftBinningFwd()
soft_binning_bwd = SoftBinningBwd()


# ---- the registered ops -----------------------------------------------------------------


@torch.library.custom_op("audiodepth::soft_binning_fwd", mutates_args=(), device_types="cuda")
def soft_binning_fwd_op(logits: torch.Tensor, centers: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernels as a PyTorch op: (base [B, 1, H, W], logit_mean
    [B, K]) of the class head's logits, differentiable (the backward op);
    on a CUDA tensor through `soft_binning_fwd`, on the CPU the plain
    version."""
    return soft_binning_fwd(logits, centers)


@soft_binning_fwd_op.register_kernel("cpu")
def _fwd_cpu(logits, centers):
    return soft_binning_fwd(logits, centers)  # checks, then plain


@soft_binning_fwd_op.register_fake
def _fwd_fake(logits, centers):
    batch, bins, _ = check_logits(logits, centers)
    sdt = _stats_dtype(logits)
    return (logits.new_empty((batch, 1) + tuple(logits.shape[2:]), dtype=sdt),
            logits.new_empty((batch, bins), dtype=sdt))


@torch.library.custom_op("audiodepth::soft_binning_bwd", mutates_args=(), device_types="cuda")
def soft_binning_bwd_op(g_base: torch.Tensor, g_mean: torch.Tensor, logits: torch.Tensor,
                        centers: torch.Tensor, base: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernels as a PyTorch op: (grad_logits, grad_centers);
    on CUDA tensors, through `soft_binning_bwd`."""
    return soft_binning_bwd(g_base, g_mean, logits, centers, base)


@soft_binning_bwd_op.register_kernel("cpu")
def _bwd_cpu(g_base, g_mean, logits, centers, base):
    return soft_binning_bwd(g_base, g_mean, logits, centers, base)


@soft_binning_bwd_op.register_fake
def _bwd_fake(g_base, g_mean, logits, centers, base):
    check_logits(logits, centers)
    return torch.empty_like(logits), torch.empty_like(centers)


def _setup_context(ctx, inputs, output):
    logits, centers = inputs
    ctx.save_for_backward(logits, centers, output[0])


def _backward(ctx, g_base, g_mean):
    logits, centers, base = ctx.saved_tensors
    grad_logits, grad_centers = soft_binning_bwd_op(g_base, g_mean, logits, centers, base)
    return (grad_logits if ctx.needs_input_grad[0] else None,
            grad_centers if ctx.needs_input_grad[1] else None)


soft_binning_fwd_op.register_autograd(_backward, setup_context=_setup_context)


def kernel_takes(logits: torch.Tensor, centers: torch.Tensor) -> bool:
    """Whether the kernels take the soft binning of `logits` and `centers`."""
    return (logits.is_cuda and logits.dtype == torch.bfloat16 and logits.dim() == 4
            and logits.shape[1] % VEC == 0 and logits.shape[1] <= MAX_BINS
            and logits.is_contiguous(memory_format=torch.channels_last)
            and centers.dtype == torch.float32 and centers.device == logits.device
            and centers.shape == logits.shape[:2])


def soft_binning(logits: torch.Tensor, centers: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(base, logit_mean) of the class head's logits and the bin centers:
    the kernels where they take the input, else the model's own chain."""
    if kernel_takes(logits, centers):
        return soft_binning_fwd_op(logits, centers)
    return soft_binning_fwd_plain(logits, centers)
