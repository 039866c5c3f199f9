"""How the reference nets compute their products.

`Precision()` is plain float32: the reference. `Precision.fp8()` is the
control, float8 wherever the configuration's bfloat16 holds a tensor:
each convolution, transposed convolution, linear layer and attention
product takes its operands rounded to float8 e4m3 (scaled per tensor so
that the largest magnitude lands on 448, the format's largest) and hands
on its result rounded to e4m3 as well, and the gradient arriving at each
of them is rounded to float8 e5m2 (largest 57344) in the backward; the
products themselves accumulate in float32, as an fp8 tensor-core product
does. The forward rounding passes the gradient straight through.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def set_float32_exact() -> None:
    """TF32 off for cuBLAS and cuDNN: float32 products stay float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = top / amax
    return (x * scale).to(dtype).to(x.dtype) / scale


class _RoundForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


class Precision:
    """`operand(x)` before a product, `result(y)` after it."""

    def __init__(self, fp8: bool = False):
        self.is_fp8 = fp8

    @classmethod
    def fp8(cls) -> "Precision":
        return cls(fp8=True)

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        return _RoundForward.apply(x) if self.is_fp8 else x

    def result(self, y: torch.Tensor) -> torch.Tensor:
        return _RoundBoth.apply(y) if self.is_fp8 else y

    def __repr__(self) -> str:
        return "fp8" if self.is_fp8 else "float32"
