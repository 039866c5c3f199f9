"""Least time of one call of each hand-written op, from its input shapes:
the larger of its operations at the peak rate for them and its bytes (each
input read once, each output written once) at the memory's rate.

Each op's arithmetic is a file of its own, `bounds/<op name after "::">.py`,
holding `OP`, the registered op's name, and `bound_s(shapes, dtype, peak,
cfg)`: the seconds of one call with input shapes `shapes` (as the profiler
records them) and input dtype `dtype`, on a card of the `peak` rates,
for a configuration file's dict `cfg`. A kernel's bound joins as a new
file there, beside its roofline reader; no file outside `bounds/` names an
op.
"""

from __future__ import annotations

from typing import Dict, Sequence

from .bounds import bound_file


def dtype_bytes(dtype: str) -> int:
    """2 for a 16-bit float ("c10::BFloat16", "c10::Half", "bfloat16"), else 4."""
    name = dtype.lower()
    return 2 if "bfloat16" in name or "half" in name or "float16" in name else 4


def tensor_core_bound_s(flops: float, exps: float, nbytes: float, dtype: str,
                        peak: Dict[str, float]) -> float:
    """A tensor-core kernel's bound: `flops` at the bf16 tensor rate (six
    bf16 passes of three-piece products for a float32 input), `exps` exp2
    at the special-function unit's rate, `nbytes` at the memory's rate."""
    passes = 6 if dtype_bytes(dtype) == 4 else 1
    ex2 = exps / (peak["sms"] * peak["clock"] * peak["ex2_per_clock_sm"])
    return max(passes * flops / peak["bf16"], ex2, nbytes / peak["hbm"])


def kernel_bound_s(op: str, shapes: Sequence[Sequence[int]], dtype: str,
                   peak: Dict[str, float], cfg: Dict = None) -> float:
    """Seconds of the bound of one call of `op` (its bound file's
    `bound_s`)."""
    return bound_file(op).bound_s(shapes, dtype, peak, cfg or {})
