"""Arithmetic the per-layer readers share, over a run's readings `ctx`:
`window` (what the measured window counted), `trace` (the traced stretch:
its parsed `summary`, `steps`, and the kernels' launch `counters` over it,
or None), `rank_traces` (each rank's busy, window and collective seconds),
`cfg`, `traffic` and `peak` (the card's published peaks, None off a card).
"""

from __future__ import annotations

from statistics import fmean
from typing import Dict, Optional

from flops import kernel_bound_s


def roofline(ctx: Dict, op: str) -> Optional[float]:
    """% of the traced calls of `op` that their bound takes: the sum of the
    calls' bounds over the sum of the device time their launches took. None
    where nothing was traced, the op did not run, or the trace lost records
    (as many calls as the op's launch counter, each with a kernel, or the op
    is left out)."""
    traced, peak = ctx.get("trace"), ctx.get("peak")
    if not traced or not peak:
        return None
    calls = traced["summary"].calls(op)
    launched = traced["counters"].get(op, 0)
    if not calls or launched == 0:
        return None
    if len(calls) != launched or any(not any(e.cat == "kernel" for e in c.events)
                                     for c in calls):
        return None
    bound = sum(kernel_bound_s(op, c.shapes, (c.dtypes or ["float"])[0], peak, ctx["cfg"])
                for c in calls)
    busy = sum(e.dur for c in calls for e in c.events) / 1e6
    return 100.0 * bound / busy


def idle_share(ctx: Dict) -> Optional[float]:
    """% of the traced window with no GPU event running, averaged over the
    ranks."""
    ranks = [d for d in ctx.get("rank_traces") or [] if d]
    if not ranks:
        return None
    return fmean(100.0 * (1.0 - d["busy_s"] / d["window_s"]) for d in ranks)
