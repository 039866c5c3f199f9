"""The numbers that decide `correct`, and their limits.

Training (the first steps, program against the float32 reference on the
same weights and rows):
- `loss_gap`: the first step's |L_prog − L_ref| / |L_ref|;
- `grad_gap`: the first gradient, as AdamW received it, by the worst leaf:
  |‖g_prog‖ − ‖g_ref‖| over the larger of the leaf's ‖g_ref‖ and the median
  leaf's; `grad_median_gap` the median leaf's;
- `change_gap`: the parameters' change over the steps, by the worst leaf,
  likewise, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (the others, such as a bias before a
  BatchNorm or under a softmax, move under AdamW by rounding alone);
- the first step's BatchNorm batch statistics (the program's read back from
  its running buffers' fold), by the worst layer and channel:
  `bn_mean_gap`, the mean's shift over the channel's root mean square
  √(μ² + σ²); `bn_var_gap`, the variance's relative gap.

Serving (a sample of the window's answers against the reference's depth
of the same recordings): `depth_max_gap_m`, the widest gap in meters over
every pixel of the sample; `depth_mean_gap_m`, the largest of the answers'
mean absolute gaps; `logit_gap`, the largest of the answers' mean absolute
gap over their mean sigmoid slope d·(max − d)/max (the reference's), an
estimate of the mean error of the head's logit, which does not shrink where
the sigmoid saturates.

Each number that a cell's limits file names is compared; a number over its
limit, or not finite, makes the run not correct.
"""

from __future__ import annotations

import math
from statistics import median
from typing import Dict, Tuple

GRAD_FLOOR = 1e-3
BN_EPS = 1e-5   # BatchNorm's own: a variance below it is noise to the layer


def train_numbers(prog: Dict, ref: Dict) -> Tuple[Dict[str, float], Dict[str, str]]:
    """(numbers, where each was worst)."""
    if len(prog["loss"]) != len(ref["loss"]):
        return {}, {"steps": f"{len(prog['loss'])} against {len(ref['loss'])}"}
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])]
    g_med = median(ref["grad"].values())
    grad = {n: abs(prog["grad"][n] - g) / max(g, g_med) for n, g in ref["grad"].items()}
    moving = [n for n, g in ref["grad"].items() if g >= GRAD_FLOOR * g_med]
    c_med = median(ref["change"][n] for n in moving)
    change = {n: abs(prog["change"][n] - ref["change"][n]) / max(ref["change"][n], c_med)
              for n in moving}
    worst_g = max(grad, key=grad.get)
    worst_c = max(change, key=change.get)
    numbers = {"loss_gap": losses[0], "grad_gap": grad[worst_g],
               "grad_median_gap": median(grad.values()), "change_gap": change[worst_c]}
    where = {"grad_gap": worst_g, "change_gap": worst_c}
    for kind in ("bn_mean_gap", "bn_var_gap"):
        gaps = {n: _stat_gap(kind, prog["bn"][n], ref["bn"][n]) for n in ref.get("bn", {})}
        if gaps:
            where[kind] = max(gaps, key=gaps.get)
            numbers[kind] = gaps[where[kind]]
    return numbers, where


def _stat_gap(kind: str, prog, ref) -> float:
    (pm, pv), (rm, rv) = prog, ref
    var = rv.clamp_min(0) + BN_EPS
    mean = (pm - rm).abs()
    if kind == "bn_mean_gap":
        return float((mean / (rm * rm + var).sqrt()).max())
    return float(((pv - rv).abs() / var).max())


def serve_numbers(served, reference, max_depth: float
                  ) -> Tuple[Dict[str, float], Dict[str, str]]:
    """served, reference: [K, S, S] float tensors of the same requests."""
    ref = reference.double()
    gap = (served.double() - ref).abs().flatten(1)
    slope = (ref * (max_depth - ref) / max_depth).flatten(1).mean(1)
    per = {"depth_max_gap_m": gap.amax(1), "depth_mean_gap_m": gap.mean(1),
           "logit_gap": gap.mean(1) / slope.clamp_min(1e-12)}
    worst = {k: int(v.argmax()) for k, v in per.items()}
    return ({k: float(per[k][i]) for k, i in worst.items()},
            {k: f"sample {i}" for k, i in worst.items()})


def judge(numbers: Dict[str, float], limits: Dict) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(correct, {number: {"value", "limit"}}) over the limits file's numbers."""
    out, ok = {}, True
    for name, spec in limits["numbers"].items():
        value = numbers.get(name, math.nan)
        out[name] = {"value": value, "limit": float(spec["limit"])}
        ok = ok and math.isfinite(value) and value <= float(spec["limit"])
    return ok, out
