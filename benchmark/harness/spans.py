"""Arithmetic the span readers share: the program's own spans
(`audiodepth_tpu_torch.obs.spans`), read in the traced process after the
traced stretch, and the device's idle time split by the `engine.train_step`
annotations the spans leave in the trace.

The program times its spans on the card (a pair of CUDA events each) only
while a profiler traces, so its store holds the traced stretch's spans
alone. The device ms come from those events, not from the trace: the
trace's launch records, which would tie each GPU event to the annotation
that launched it, are not kept past `harness.trace.parse_trace`. A program
without the spans (an older commit) gives every reader None.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

TRAIN_STEP = "engine.train_step"


def _on_card(ctx: Dict) -> bool:
    traced = ctx.get("trace")
    return bool(traced) and bool(traced["summary"].gpu)


def program_spans() -> Optional[Dict]:
    """The program's `obs.spans.summary()`, or None where it has none."""
    try:
        from audiodepth_tpu_torch.obs import summary
    except ImportError:
        return None
    return summary()


def device_ms_per(ctx: Dict, names: Iterable[str], per: str) -> Optional[float]:
    """The device ms of the profiled spans `names`, summed, over the
    profiled spans named `per` (a mean a step or a batch). None off a card,
    untraced, or where the store holds no span of them."""
    spans = program_spans() if _on_card(ctx) else None
    if spans is None:
        return None
    names = set(names)
    timed = [(name, ms) for name, ms in spans["device_ms"] if ms is not None]
    mine = [ms for name, ms in timed if name in names]
    count = sum(1 for name, _ in timed if name == per)
    return sum(mine) / count if mine and count else None


def accumulated(ctx: Dict, name: str) -> Optional[Tuple[int, float]]:
    """(calls, host seconds) of the span `name` since the process started,
    from the accumulator; None off a card, untraced, or never entered."""
    spans = program_spans() if _on_card(ctx) else None
    total = None if spans is None else spans["totals"].get(name)
    return None if not total else (total["count"], total["host_s"])


def idle_intervals(summary) -> List[Tuple[float, float]]:
    """The stretches of the traced window with no GPU event running (µs),
    as `TraceSummary.idle_gaps` finds them; they add up to the window less
    the busy union."""
    gaps, end = [], summary.start_us
    for s, e in sorted((g.ts, g.ts + g.dur) for g in summary.gpu):
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if summary.start_us + summary.window_us > end:
        gaps.append((end, summary.start_us + summary.window_us))
    return gaps


def idle_split(ctx: Dict) -> Optional[Tuple[float, float, int]]:
    """(idle ms inside the `engine.train_step` annotations, idle ms outside
    them, the annotations) over the traced window: a gap that crosses an
    annotation's edge is cut there. None off a card or where the trace
    holds no annotation of the step."""
    if not _on_card(ctx):
        return None
    s = ctx["trace"]["summary"]
    w0, w1 = s.start_us, s.start_us + s.window_us
    steps = sorted((max(ts, w0), min(ts + dur, w1)) for ts, dur, name in s.host
                   if name == TRAIN_STEP)
    if not steps:
        return None
    gaps = idle_intervals(s)
    inside = sum(max(0.0, min(ge, te) - max(gs, ts)) for gs, ge in gaps for ts, te in steps)
    total = sum(ge - gs for gs, ge in gaps)
    return inside / 1e3, (total - inside) / 1e3, len(steps)
