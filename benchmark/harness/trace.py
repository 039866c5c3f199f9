"""Reading a `torch.profiler` chrome trace: the benchmark's frozen copy of
the port's trace arithmetic (`tools/profile_step.py`: `busy_union_us`,
`categorize` and its categories; `obs/logging.py`: `prime_trace`), and the
attribution of device time to the registered ops.

An op's device time is every GPU event (kernel, copy, memset) that a
launch inside the op's CPU-side event started: the launch (a CUDA runtime
or driver event on the op's thread, within its span) and the GPU event
share a correlation id. A later kernel behind the same op keeps the op's
metric. Where the trace holds fewer of an op's launches than its wrapper's
`launches` counter says ran, its records were lost and the op is left out.
"""

from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW_SPAN = "bench.traced_window"
PRIMER_KERNELS = 16

# (regex searched in the GPU event's name) -> category; order matters
CATEGORIES = (
    (r"fused_mel_frontend_kernel|frontend_normalize_kernel", "B1 mel front end (hand-written)"),
    (r"flash_fwd_\w*kernel", "B2 flash attention forward (hand-written)"),
    (r"flash_bwd_\w*kernel", "B3 flash attention backward (hand-written)"),
    (r"nccl", "NCCL collectives"),
    (r"^Memcpy|^Memset", "copies and memsets"),
    (r"batch_norm|bn_fw|bn_bw|welford", "BatchNorm"),
    (r"fprop", "convolution forward (cuDNN fprop)"),
    (r"dgrad", "convolution data gradient (cuDNN dgrad)"),
    (r"wgrad", "convolution weight gradient (cuDNN wgrad)"),
    (r"cudnn|convolve|implicit_gemm|nchwToNhwc|nhwcToNchw", "other cuDNN"),
    (r"multi_tensor_apply|fused_adam|adam", "optimizer (multi_tensor_apply)"),
    (r"softmax", "softmax"),
    (r"upsample|interpolate", "upsample"),
    (r"gemm|gemv|cutlass|cublas|nvjet", "matrix products (cuBLAS)"),
    (r"reduce_kernel|reduction", "reductions"),
    (r"elementwise", "elementwise"),
    (r"CatArrayBatchedCopy|copy_kernel|transpose|index", "copies/transposes/gathers"),
)


def categorize(name: str) -> str:
    for pat, cat in CATEGORIES:
        if re.search(pat, name, re.IGNORECASE):
            return cat
    return "misc"


def busy_union_us(intervals) -> float:
    """Time covered by any of the (start, duration) intervals, merged."""
    total, end = 0.0, None
    for ts, dur in sorted(intervals):
        if end is None or ts > end:
            total += dur
            end = ts + dur
        elif ts + dur > end:
            total += ts + dur - end
            end = ts + dur
    return total


def prime_trace(device) -> None:
    """PRIMER_KERNELS tiny kernels, waited for: a trace may lose the records
    of the kernels launched right after the profiler starts, so what is
    traced starts after these."""
    import torch

    x = torch.zeros(1, device=device)
    for _ in range(PRIMER_KERNELS):
        x.add_(1)
    torch.cuda.synchronize(device)


def all_threads():
    """The profiler's setting that records the CPU-side ops of every
    thread (the serving runner's device thread among them), where this
    torch has it; else None (then only the starting thread's ops)."""
    import torch

    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


@dataclass
class GpuEvent:
    name: str
    ts: float
    dur: float
    correlation: Optional[int]
    cat: str = "kernel"


@dataclass
class OpCall:
    name: str
    shapes: list
    dtypes: list
    events: List[GpuEvent] = field(default_factory=list)


@dataclass
class TraceSummary:
    """What one traced window shows (times in µs)."""

    window_us: float
    gpu: List[GpuEvent]
    ops: List[OpCall]
    host: List[Tuple[float, float, str]]   # (ts, dur, name) of CPU-side events
    start_us: float = 0.0

    @property
    def busy_us(self) -> float:
        return busy_union_us((e.ts, e.dur) for e in self.gpu)

    def per_category(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for e in self.gpu:
            out[categorize(e.name)] += e.dur
        return dict(out)

    def calls(self, op: str) -> List[OpCall]:
        return [c for c in self.ops if c.name == op]

    def idle_gaps(self, top: int = 10) -> List[Tuple[str, float]]:
        """The longest stretches of the window with no GPU event running,
        each named by the innermost host-side event covering its middle
        ("host: no traced op" where only the window's own span covers it)."""
        ivs = sorted((e.ts, e.ts + e.dur) for e in self.gpu)
        gaps, end = [], self.start_us
        for s, e in ivs:
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if self.start_us + self.window_us > end:
            gaps.append((end, self.start_us + self.window_us))
        named = []
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
            mid = 0.5 * (s + e)
            cover = [h for h in self.host if h[0] <= mid <= h[0] + h[1]
                     and h[2] != WINDOW_SPAN]
            name = min(cover, key=lambda h: h[1])[2] if cover else "host: no traced op"
            named.append((name, (e - s) / 1e6))
        return named


def parse_trace(path: str) -> TraceSummary:
    """Read the GPU events, the registered ops' calls with their launches'
    GPU events, and the host-side events inside the `WINDOW_SPAN`
    annotation (the whole trace where there is none)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    window = [e for e in events if e.get("name") == WINDOW_SPAN]
    if window:
        w0 = float(window[0]["ts"])
        w1 = w0 + float(window[0]["dur"])
    else:
        w0 = min(float(e["ts"]) for e in events)
        w1 = max(float(e["ts"]) + float(e.get("dur", 0)) for e in events)
    gpu, by_corr = [], {}
    launches = defaultdict(list)   # tid -> sorted [(ts, correlation)]
    ops, host = [], []
    for e in events:
        cat = str(e.get("cat", "")).lower()
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        args = e.get("args", {}) or {}
        if cat in GPU_CATS:
            if ts + dur <= w0 or ts >= w1:
                continue
            s, t = max(ts, w0), min(ts + dur, w1)
            ev = GpuEvent(str(e.get("name", "")), s, t - s, args.get("correlation"), cat)
            gpu.append(ev)
            if ev.correlation is not None:
                by_corr[ev.correlation] = by_corr.get(ev.correlation, []) + [ev]
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[e.get("tid")].append((ts, args["correlation"]))
        elif cat in ("cpu_op", "user_annotation", "python_function"):
            if ts + dur >= w0 and ts <= w1:
                host.append((ts, dur, str(e.get("name", ""))))
            if cat == "cpu_op" and str(e.get("name", "")).startswith("audiodepth::") \
                    and w0 <= ts <= w1:
                ops.append((e.get("tid"), ts, dur, OpCall(
                    str(e["name"]), args.get("Input Dims", []), args.get("Input type", []))))
    for tid in launches:
        launches[tid].sort()
    # an op's dispatch may record its name twice, one event inside the other
    kept, outer = [], {}
    for tid, ts, dur, call in sorted(ops, key=lambda o: (o[1], -o[2])):
        o = outer.get((tid, call.name))
        if o is not None and o[0] <= ts and ts + dur <= o[0] + o[1]:
            continue
        outer[(tid, call.name)] = (ts, dur)
        kept.append((tid, ts, dur, call))
    ops = kept
    for tid, ts, dur, call in ops:
        seq = launches.get(tid, [])
        i = bisect.bisect_left(seq, (ts, -1))
        while i < len(seq) and seq[i][0] <= ts + dur:
            call.events.extend(by_corr.get(seq[i][1], []))
            i += 1
    return TraceSummary(window_us=w1 - w0, gpu=gpu, ops=[c for *_, c in ops], host=host,
                        start_us=w0)
