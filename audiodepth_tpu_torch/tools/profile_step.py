"""On-card train-step profiler: capture a `torch.profiler` trace of the
port's train step and print a per-category breakdown of its GPU time (port
of `tools/profile_step.py`).

The capture half drives `Engine.train_step` on device-cached batches (a
fixed device batch with its bins for coarse_depth, attached on the host as
`cli/train.py` attaches them): 3 steps untraced, then `--steps` steps traced
(after `obs.logging.prime_trace`: a trace may lose the records of the
kernels launched right after it starts), each inside a `record_function` span
named `adepth_step_<i>`, written as a chrome trace. The analysis half
(`parse_trace`) reads any chrome trace of `torch.profiler` (this tool's,
`--profile_dir`'s, `chip_smoke.py`'s): the
GPU events (kernels, copies, memsets) with their stream and bytes, their
time per category (`categorize`, on CUDA kernel names), per kernel name
and per step (a GPU event belongs to the step whose span holds its launch,
found through its correlation id, else its own start), and the busy union
of the window (the time any of them ran, merged over streams).

The report adds one line per hand-written kernel of the port: its launches
in the trace beside its wrapper's launch counter over the same steps, and
DROPPED where the two differ. A profiler that loses a kernel's records
would otherwise report a breakdown without it and say nothing. Where the
trace holds the program's spans (`obs.spans`: the `engine.*`, `cache.*`,
`runner.*`, `serve.*`, `adabins.*` and `loss.*` annotations), it adds one
line per span name: its calls, its host ms a call (the annotation's
length) and its device ms a call (the GPU events whose launch, found
through its correlation id, falls inside the annotation, on any thread:
autograd launches the backward's kernels from its own thread while the
span's thread waits).

Usage:
    python -m audiodepth_tpu_torch.tools.profile_step --model unet_baseline \
        --batch_size 256 [--steps 8] [--trace_dir DIR] [--keep_trace]
    python -m audiodepth_tpu_torch.tools.profile_step --parse_only DIR/trace.json
The entry point runs on `cuda` (`--device cpu` profiles the CPU: no GPU
events) and raises without a card.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import re
import shutil
import tempfile
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Tuple

STEP_PREFIX = "adepth_step_"
WARMUP_STEPS = 3
GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_NAME = re.compile(r"^(engine|cache|runner|serve|adabins|loss)\.")   # the program's spans

# (regex searched in the GPU event's name) -> category. Order matters: the
# hand-written kernels first, cuDNN's convolutions before the GEMMs (their
# names say implicit_gemm).
_CATEGORIES = (
    (r"fused_mel_frontend_kernel|frontend_normalize_kernel", "B1 mel front end (hand-written)"),
    (r"flash_fwd_\w*kernel", "B2 flash attention forward (hand-written)"),
    (r"flash_bwd_\w*kernel", "B3 flash attention backward (hand-written)"),
    (r"soft_bin_\w*kernel", "AdaBins soft binning (hand-written)"),
    (r"^Memcpy|^Memset", "copies and memsets"),
    (r"batch_?norm|bn_fw|bn_bw|welford", "BatchNorm"),  # cuDNN's batchnorm_*, ours bn_*
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

# each hand-written kernel: its wrapper's name and the GPU launches its
# `launches` counter counts (B1's two-pass form counts both of its kernels;
# B3's bf16 call also launches `flash_bwd_prep_kernel`, which it does not;
# a BatchNorm call launches three kernels and counts one, its first; a
# soft-binning call two, its pass and its finalize, and counts the pass)
HAND_WRITTEN = (
    ("fused_mel_frontend", r"fused_mel_frontend_kernel|frontend_normalize_kernel"),
    ("flash_cross_attention_fwd", r"flash_fwd_(wgmma|f32)_kernel"),
    ("flash_cross_attention_bwd", r"flash_bwd_(wgmma|split|f32)_kernel"),
    ("batch_norm_train_fwd", r"bn_fwd_stats_kernel"),
    ("batch_norm_train_bwd", r"bn_bwd_reduce_kernel"),
    ("soft_binning_fwd", r"soft_bin_fwd_kernel"),
    ("soft_binning_bwd", r"soft_bin_bwd_kernel"),
)


def categorize(name: str) -> str:
    for pat, cat in _CATEGORIES:
        if re.search(pat, name, re.IGNORECASE):
            return cat
    return "misc"


@dataclass
class Activity:
    """One GPU event of a trace."""

    cat: str        # kernel, gpu_memcpy or gpu_memset
    name: str
    stream: object
    ts: float       # µs
    dur: float      # µs
    bytes: Optional[int] = None
    step: Optional[int] = None


@dataclass
class TraceProfile:
    """What `parse_trace` reads from one trace (times in µs)."""

    steps: int
    activity: List[Activity]
    per_category: Dict[str, float] = field(default_factory=dict)
    per_kernel: Dict[str, float] = field(default_factory=dict)
    kernel_counts: Dict[str, int] = field(default_factory=dict)
    per_step: List[float] = field(default_factory=list)
    outside_steps_us: float = 0.0
    busy_us: float = 0.0
    window_us: float = 0.0
    # span name -> (calls, host µs, device µs), in the order they first start
    phases: Dict[str, Tuple[int, float, float]] = field(default_factory=dict)

    @property
    def total_us(self) -> float:
        return sum(self.per_category.values())

    def launches(self, pattern: str) -> int:
        """GPU events whose name matches `pattern`."""
        return sum(n for name, n in self.kernel_counts.items() if re.search(pattern, name))


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


def _step_of(t: float, spans) -> Optional[int]:
    for i, (start, end) in spans:
        if start <= t <= end:
            return i
    return None


def parse_trace(path: str, steps: int) -> TraceProfile:
    """Aggregate the GPU events of a torch.profiler chrome trace: GPU time
    per category, per kernel name and per `adepth_step_<i>` span (empty
    without spans), the busy union and the window from the first GPU event's
    start (or the first span's) to the last one's end. Where the trace has
    spans, only the events of the steps are aggregated; `activity` keeps
    every GPU event."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans, launch, named = [], {}, defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        name, cat = str(e.get("name", "")), str(e.get("cat", "")).lower()
        if name.startswith(STEP_PREFIX) and cat == "user_annotation":
            spans.append((int(name[len(STEP_PREFIX):]),
                          (float(e["ts"]), float(e["ts"]) + float(e["dur"]))))
        elif cat == "user_annotation" and SPAN_NAME.match(name):
            named[name].append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = float(e["ts"])
    spans = sorted((i, span) for i, span in spans)
    for ivs in named.values():
        ivs.sort()
    device = defaultdict(float)
    out = TraceProfile(steps=steps, activity=[])
    for e in events:
        cat = str(e.get("cat", "")).lower()
        if e.get("ph") != "X" or cat not in GPU_CATS:
            continue
        args = e.get("args", {})
        act = Activity(cat, str(e.get("name", "")), args.get("stream"), float(e["ts"]),
                       float(e["dur"]), args.get("bytes"))
        launched = launch.get(args.get("correlation"))
        if spans:
            act.step = _step_of(act.ts if launched is None else launched, spans)
        if launched is not None:   # every span that holds the launch
            for name, ivs in named.items():
                i = bisect.bisect_right(ivs, (launched, float("inf"))) - 1
                if i >= 0 and launched <= ivs[i][1]:
                    device[name] += act.dur
        out.activity.append(act)
    # with spans, the steps' events alone (a primer's or another thread's
    # work is `outside_steps_us`)
    mine = [a for a in out.activity if a.step is not None] if spans else out.activity
    out.outside_steps_us = sum(a.dur for a in out.activity) - sum(a.dur for a in mine)
    per_step = defaultdict(float)
    cats, kernels, counts = defaultdict(float), defaultdict(float), Counter()
    for a in mine:
        if a.step is not None:
            per_step[a.step] += a.dur
        cats[categorize(a.name)] += a.dur
        kernels[a.name] += a.dur
        counts[a.name] += 1
    out.per_category, out.per_kernel, out.kernel_counts = dict(cats), dict(kernels), dict(counts)
    out.per_step = [per_step.get(i, 0.0) for i, _ in spans]
    out.busy_us = busy_union_us((a.ts, a.dur) for a in mine)
    starts = [a.ts for a in mine] + [s for _, (s, _) in spans]
    ends = [a.ts + a.dur for a in mine] + [e for _, (_, e) in spans]
    out.window_us = max(ends) - min(starts) if starts else 0.0
    for name, ivs in sorted(named.items(), key=lambda kv: kv[1][0]):
        out.phases[name] = (len(ivs), sum(e - s for s, e in ivs), device.get(name, 0.0))
    return out


def hand_written_rows(prof: TraceProfile, counters: Optional[Mapping[str, int]] = None):
    """[(wrapper name, launches in the trace, its counter or None, dropped)]."""
    rows = []
    for name, pattern in HAND_WRITTEN:
        seen = prof.launches(pattern)
        counted = None if counters is None else int(counters.get(name, 0))
        rows.append((name, seen, counted, counted is not None and seen != counted))
    return rows


def report(prof: TraceProfile, steps: int, top: int = 12,
           counters: Optional[Mapping[str, int]] = None) -> str:
    """The JAX tool's table (category, ms/step, share; the top items) on
    CUDA kernel names, with the steps, one line per hand-written kernel and
    one per span of the program (device n/a in a trace without GPU events)."""
    total = prof.total_us
    steps = max(steps, 1)
    lines = [f"GPU time {total / 1e3 / steps:.3f} ms/step over {steps} steps; busy union "
             f"{prof.busy_us / 1e3:.3f} ms of a {prof.window_us / 1e3:.3f} ms window "
             f"({100 * prof.busy_us / prof.window_us if prof.window_us else 0.0:.1f}% busy)"]
    if prof.per_step:
        lines.append("per step (ms): " + ", ".join(f"{t / 1e3:.3f}" for t in prof.per_step)
                     + (f"; outside the steps {prof.outside_steps_us / 1e3:.3f}"
                        if prof.outside_steps_us else ""))
    lines.append("")
    lines.append(f"{'category':42s} {'ms/step':>8s}  share")
    for c, t in sorted(prof.per_category.items(), key=lambda kv: -kv[1]):
        lines.append(f"{c:42s} {t / 1e3 / steps:8.3f}  {100 * t / total:4.1f}%")
    lines.append(f"{'TOTAL (GPU-event sum)':42s} {total / 1e3 / steps:8.3f}")
    lines.append("")
    lines.append(f"top {top} kernels:")
    for name, t in sorted(prof.per_kernel.items(), key=lambda kv: -kv[1])[:top]:
        lines.append(f"  {t / 1e3 / steps:7.3f} ms/step  {name[:130]}")
    lines.append("")
    lines.append("hand-written kernels: launches in the trace vs the wrapper's counter")
    for name, seen, counted, dropped in hand_written_rows(prof, counters):
        lines.append(f"  {name:28s} trace {seen:5d}  counter "
                     + ("  n/a" if counted is None else f"{counted:5d}")
                     + ("  DROPPED" if dropped else ""))
    if prof.phases:
        lines.append("")
        lines.append("the program's spans (obs.spans): calls, host and device ms a call")
        for name, (n, host, dev) in prof.phases.items():
            lines.append(f"  {name:20s} {n:5d}  host {host / 1e3 / n:8.3f}  device "
                         + (f"{dev / 1e3 / n:8.3f}" if prof.activity else "     n/a"))
    return "\n".join(lines)


def _batches(args, cfg, eng, task, ds) -> List[dict]:
    """max(steps, WARMUP_STEPS) train batches on the device."""
    n = max(args.steps, WARMUP_STEPS)
    if cfg.model.name == "coarse_depth":
        # bin targets are attached on the host (cli/train.py does the same);
        # one fixed device batch
        from ..data.bins import add_bins_to_batch

        batch = add_bins_to_batch(next(ds.batches(args.batch_size, shuffle=False)),
                                  task.bin_edges, cfg.dataset.max_depth, cfg.dataset.depth_norm)
        return [eng.put_batch(eng.encode(batch))] * n
    from ..data.device_cache import DeviceDatasetCache

    cache = DeviceDatasetCache(ds, eng._depth_units, task.device)
    return (list(cache.batches(args.batch_size, shuffle=True, seed=2)) * n)[:n]


def capture(args) -> Tuple[str, Dict[str, int]]:
    """Trace `args.steps` train steps after WARMUP_STEPS untraced ones;
    returns (chrome trace path, each hand-written kernel's counter over the
    traced steps)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from .._device import synchronize
    from ..cli.train import _parse_override
    from ..configs import load_config
    from ..data.synthetic import SyntheticEchoDataset
    from ..models import init_weights, make_task
    from ..obs.logging import prime_trace
    from ..ops.cuda import KERNELS
    from ..train.engine import Engine

    overrides = {"mode.batch_size": args.batch_size}
    for kv in args.override or []:
        k, v = _parse_override(kv)
        overrides[k] = v
    cfg = load_config(args.dataset, "train", "profile", args.model, overrides=overrides)
    task = make_task(cfg, device=args.device)
    init_weights(task.model, torch.Generator().manual_seed(0))
    eng = Engine(cfg, task)
    state = eng.init_state()
    ds = SyntheticEchoDataset(cfg, num_samples=args.batch_size * 2, seed=0,
                              with_image=args.model in ("rgb_depth", "adabins_distillation"))
    bts = _batches(args, cfg, eng, task, ds)
    on_card = task.device.type == "cuda"

    for b in bts[:WARMUP_STEPS]:  # the kernels' build and cuDNN's search, untraced
        state, m = eng.train_step(state, b)
    float(m["loss"])
    synchronize(task.device)
    before = {w.name: w.launches for w, _, _ in KERNELS}
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        if on_card:
            prime_trace(task.device)
        for i, b in enumerate(bts[:args.steps]):
            with record_function(f"{STEP_PREFIX}{i}"):
                state, m = eng.train_step(state, b)
        float(m["loss"])
        synchronize(task.device)
    counters = {w.name: w.launches - before[w.name] for w, _, _ in KERNELS}
    os.makedirs(args.trace_dir, exist_ok=True)
    path = os.path.join(args.trace_dir, f"{args.model}_bs{args.batch_size}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path, counters


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="unet_baseline")
    p.add_argument("--dataset", default="batvisionv2")
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--override", action="append",
                   help="config override, e.g. model.base_channels=64")
    p.add_argument("--trace_dir", default=None)
    p.add_argument("--keep_trace", action="store_true")
    p.add_argument("--parse_only", default=None,
                   help="skip capture; parse this chrome trace")
    p.add_argument("--top", type=int, default=12)
    p.add_argument("--device", default="cuda",
                   help="torch device to profile on (cuda, cuda:1, cpu)")
    return p


def main(argv=None):
    """Capture (or read) a trace and print the report; returns
    (TraceProfile, counters or None)."""
    args = build_parser().parse_args(argv)
    counters = None
    if args.parse_only:
        path = args.parse_only
    else:
        made_dir = args.trace_dir is None
        if made_dir:
            args.trace_dir = tempfile.mkdtemp(prefix="adepth_prof_")
        path, counters = capture(args)
    prof = parse_trace(path, args.steps)
    print(report(prof, args.steps, args.top, counters))
    if args.parse_only is None and not args.keep_trace:
        if made_dir:
            shutil.rmtree(args.trace_dir, ignore_errors=True)
        else:
            os.remove(path)
    else:
        print(f"\ntrace: {path}")
    return prof, counters


if __name__ == "__main__":
    main()
