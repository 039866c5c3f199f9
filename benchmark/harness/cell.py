"""One run of one cell: set-up, the measured window, the traced stretch,
the correctness check, and the result line's fields.

`run_cell` takes the device itself, so the tests drive a whole run on the
CPU at a small size; `run.py` is what looks for the cards first.
"""

from __future__ import annotations

import math
import multiprocessing as mp
import socket
import statistics
import time
from typing import Dict, Optional

import torch

from . import check
from .guard import forbidden_modules
from .spec import Cell


def _device_info(device, count: int, peak_bytes: int) -> Dict[str, object]:
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": count,
                "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": int(peak_bytes)}


def _peaks(device) -> Optional[Dict[str, float]]:
    from flops import peak_for

    dev = torch.device(device)
    return peak_for(torch.cuda.get_device_name(dev)) if dev.type == "cuda" else None


def _p95(values) -> float:
    vals = sorted(values)
    if not vals:
        return math.nan
    return statistics.quantiles(vals, n=20, method="inclusive")[-1] if len(vals) > 1 else vals[0]


def _read_layers(cell: Cell, ctx: Dict) -> Dict[str, Dict[str, object]]:
    out = {}
    for m in cell.per_layer:
        value = m.read(ctx)
        if value is not None:
            out[m.name] = {"value": float(value), "unit": m.unit}
    return out


def _op_records(traced) -> Dict[str, list]:
    """{op: [CPU-side calls in the trace, the wrapper's launches, calls with
    device events]}: what the roofline readers had to read."""
    from flops import bounded_ops

    s = traced["summary"]
    return {op: [len(s.calls(op)), traced["counters"].get(op, 0),
                 sum(1 for c in s.calls(op) if c.events)] for op in bounded_ops()}


def _breakdown(summary) -> Dict[str, list]:
    cats = sorted(summary.per_category().items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[name, us / 1e6] for name, us in cats],
            "idle_gaps": [[name, s] for name, s in summary.idle_gaps(10)]}


# ---- training -------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _references(cell: Cell, run, shards, also=()) -> Dict[str, object]:
    """Free the program's state, then follow its checked steps with the
    float32 reference (and the `also` precisions, for the tools) on this
    process's rows; with the time and device peak the reference took."""
    from reference import Precision
    from reference.train import reference_steps

    readings = run.readings
    run.free()
    on_card = run.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(run.device)
    t = time.perf_counter()
    batches = run.reference_batches(run.device, shards.ranks, _rank(shards))
    out = {"readings": readings,
           "ref": reference_steps(cell.config, run.weights, batches, Precision(), run.device,
                                  shards),
           "also": [reference_steps(cell.config, run.weights, batches, p, run.device, shards)
                    for p in also]}
    out["seconds"] = time.perf_counter() - t
    out["peak_bytes"] = torch.cuda.max_memory_allocated(run.device) if on_card else 0
    return out


def _rank(shards) -> int:
    import torch.distributed as dist

    return 0 if shards.group is None else dist.get_rank(shards.group)


def _train_rank(cell: Cell, seed: int, seconds: float, trace: bool, rank: int, n: int,
                init: str, t_start: float, on_card: bool, also=()):
    """A rank of a data-parallel cell (rank 0 is the caller's process):
    NCCL on card `rank`, or gloo on the CPU (the tests). The reference runs
    on every rank, over its rows of the global batches."""
    import torch.distributed as dist
    from audiodepth_tpu_torch.parallel import initialize_multihost, shutdown
    from reference.ranks import RowShards

    from .train import TrainRun, rank_digest

    device = torch.device("cuda", rank) if on_card else torch.device("cpu")
    group = initialize_multihost(init, n, rank, backend="nccl" if on_card else "gloo",
                                 device=device)
    try:
        run = TrainRun(cell, seed, device, group, t_start)
        win = run.window(seconds)
        traced = run.traced(win["step_s"]) if trace else None
        refs = _references(cell, run, RowShards(dist.group.WORLD), also)
        mine = {"setup_s": run.setup_s, "memory_peak_bytes": win["memory_peak_bytes"],
                "trace": rank_digest(traced), "forbidden": forbidden_modules(),
                "reference_peak_bytes": refs["peak_bytes"]}
        gathered = [None] * n
        dist.all_gather_object(gathered, mine)
        return run, win, traced, refs, gathered
    finally:
        shutdown()


def _train_child(name, config, traffic, plant, *args):
    if plant is not None:
        plant()
    _train_rank(Cell(name, 0, config, traffic, {}, [], [], 0), *args)


def run_train_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
                   t_start: float, plant=None, also=()) -> Dict[str, object]:
    """`also`: further precisions the reference is followed in (the tools'
    control), returned under "also"."""
    from reference.ranks import RowShards

    from .train import TrainRun, rank_digest

    ranks = int(cell.traffic.get("ranks", 1))
    on_card = torch.device(device).type == "cuda"
    if ranks > 1:
        init = f"tcp://127.0.0.1:{_free_port()}"
        ctx = mp.get_context("spawn")
        children = [ctx.Process(target=_train_child,
                                args=(cell.name, cell.config, cell.traffic, plant, seed, seconds,
                                      trace, r, ranks, init, t_start, on_card, also))
                    for r in range(1, ranks)]
        for c in children:
            c.start()
        try:
            run, win, traced, refs, gathered = _train_rank(cell, seed, seconds, trace, 0, ranks,
                                                           init, t_start, on_card, also)
        finally:
            for c in children:
                c.join(timeout=300)
                if c.is_alive():
                    c.terminate()
                    c.join(timeout=10)
        setup_s = max(g["setup_s"] for g in gathered)
        peak_bytes = max(g["memory_peak_bytes"] for g in gathered)
        ref_peak = max(g["reference_peak_bytes"] for g in gathered)
        digests = [g["trace"] for g in gathered]
        foreign = sorted({m for g in gathered for m in g["forbidden"]})
    else:
        run = TrainRun(cell, seed, device, None, t_start)
        win = run.window(seconds)
        traced = run.traced(win["step_s"]) if trace else None
        setup_s, peak_bytes = run.setup_s, win["memory_peak_bytes"]
        digests, foreign = [rank_digest(traced)], []
        refs = _references(cell, run, RowShards(), also)
        ref_peak = refs["peak_bytes"]
    readings, ref, ref_s = refs["readings"], refs["ref"], refs["seconds"]
    numbers, where = check.train_numbers(readings, ref)
    correct, checks = check.judge(numbers, cell.limits)
    failed = 0 if math.isfinite(win["last_loss"]) else 1
    correct = correct and failed == 0
    ctx = {"cell": cell, "cfg": cell.config, "traffic": cell.traffic, "peak": _peaks(device),
           "window": win, "trace": traced, "rank_traces": digests}
    result = {"correct": correct, "attempted": win["steps"], "failed": failed,
              "device": _device_info(device, ranks, peak_bytes)}
    if trace:
        result["metrics"] = _read_layers(cell, ctx)
        s = traced["summary"]
        result["device"]["busy_s"] = statistics.fmean(d["busy_s"] for d in digests)
        result["device"]["window_s"] = statistics.fmean(d["window_s"] for d in digests)
        result["breakdown"] = _breakdown(s)
    else:
        result["metrics"] = {
            "train_pairs_per_s": {"value": win["pairs"] / win["seconds"], "unit": "pairs/s"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    notes = {"steps": win["steps"], "window_s": win["seconds"], "loss_first": readings["loss"],
             "loss_ref": ref["loss"], "worst": where, "foreign_in_ranks": foreign,
             "numbers": numbers, "op_records": _op_records(traced) if trace else None,
             "reference_s": ref_s, "reference_peak_bytes": ref_peak, "setup_phases": run.phases}
    return {"result": result, "checks": checks, "notes": notes, "foreign": foreign,
            "readings": readings, "reference": ref, "also": refs["also"]}


# ---- serving -----------------------------------------------------------------------------


def run_serve_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
                   t_start: float) -> Dict[str, object]:
    import numpy as np
    from reference import Precision
    from reference.train import reference_predict

    from .serve import ServeRun
    from .train import rank_digest

    run = ServeRun(cell, seed, seconds, device, t_start)
    try:
        win = run.window(seconds)
        traced = run.traced() if trace else None
    finally:
        run.close()
    missing = [i for i in run.checked if i not in win["answers"]]
    if missing:
        numbers, where = {}, {"missing answers": str(missing[:10])}
    else:
        served = run.served_answers(win["answers"])
        waves = torch.from_numpy(run.waves[run.checked]).to(run.device)
        ref = reference_predict(cell.config, run.weights, {"waveform": waves}, Precision()).cpu()
        numbers, where = check.serve_numbers(served, ref, float(cell.config["max_depth"]))
    correct, checks = check.judge(numbers, cell.limits)
    correct = correct and win["failed"] == 0 and not missing
    lat_ms = [x * 1e3 for x in win["latency_s"]]
    late = np.asarray(win["late_s"])
    ctx = {"cell": cell, "cfg": cell.config, "traffic": cell.traffic, "peak": _peaks(device),
           "window": win, "trace": traced, "rank_traces": [rank_digest(traced)]}
    result = {"correct": correct, "attempted": win["attempted"], "failed": win["failed"],
              "device": _device_info(device, 1, win["memory_peak_bytes"])}
    if trace:
        result["metrics"] = _read_layers(cell, ctx)
        s = traced["summary"]
        result["device"]["busy_s"] = s.busy_us / 1e6
        result["device"]["window_s"] = s.window_us / 1e6
        result["breakdown"] = _breakdown(s)
    else:
        result["metrics"] = {"serve_p95_ms": {"value": _p95(lat_ms), "unit": "ms"},
                             "setup_s": {"value": run.setup_s, "unit": "s"}}
    finite = late[np.isfinite(late)]
    due = np.asarray(win["due_s"])
    halves = [np.asarray(win["latency_s"])[m] * 1e3 for m in (due < due.max() / 2,
                                                               due >= due.max() / 2)]
    notes = {"requests": win["attempted"], "completed": win["completed"],
             "p50_ms": statistics.median(lat_ms) if lat_ms else None,
             "max_ms": max(lat_ms) if lat_ms else None,
             "generator_late_ms": {"p50": float(np.median(finite) * 1e3) if finite.size else None,
                                   "p99": float(np.quantile(finite, 0.99) * 1e3)
                                   if finite.size else None,
                                   "max": float(finite.max() * 1e3) if finite.size else None},
             "batches": win["batches"], "served_rows": win["served_rows"], "worst": where,
             "setup_phases": run.phases,
             "p95_ms_by_half": [float(np.quantile(h, 0.95)) if h.size else None for h in halves],
             "numbers": numbers, "op_records": _op_records(traced) if trace else None}
    return {"result": result, "checks": checks, "notes": notes, "foreign": []}


KINDS = {"train_cached": run_train_cell, "serve_open_loop": run_serve_cell}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float = None, **tools) -> Dict[str, object]:
    """`tools` are for the tests and the calibration only: `plant`, a
    picklable function each further rank's process calls first (a fault
    planted in every rank); `also`, further precisions of the reference."""
    t_start = time.perf_counter() if t_start is None else t_start
    tools = {k: v for k, v in tools.items() if v}
    kind = cell.traffic["kind"]
    if kind not in KINDS:
        raise SystemExit(f"no generator for the traffic kind {kind!r}")
    return KINDS[kind](cell, seed, seconds, trace, device, t_start, **tools)
