"""Named spans inside the port's steps, on the profiler's clock.

`span(name, device)` marks a stretch of host code (a phase of the train
step, the device cache's gather, the serving runner's copies):

  * always, it adds its call and its host seconds (`time.perf_counter_ns`)
    to a per-name accumulator in process memory: two clock reads and one
    update of the calling thread's own dict (no lock: `summary` adds the
    threads' dicts up);
  * only while a `torch.profiler` trace records, it also opens a
    `record_function(name)` annotation, so the span lands in the trace
    beside the kernels it launched, on their clock (`tools/profile_step.py`
    reads a span's device time there, from the GPU events its launches
    started); and on a CUDA `device` it records a pair of timing events on
    the current stream at its edges, for a reader that has no trace to
    read (the benchmark's readers run after its trace is gone). The last
    `STORE_CAP` profiled spans are kept.

`add(name, seconds)` adds to the accumulator alone, for a stretch measured
elsewhere (a request's wait, which crosses threads). `summary()` returns
the accumulator and each kept span's device milliseconds: the events'
`elapsed_time`, from when the card reached the first to when it reached
the second, so it includes any stretch in which the card waited for the
host inside the span. A span's events are waited for and dropped the
first time `summary` reads them.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List

import torch
import torch.autograd.profiler as _autograd_profiler

STORE_CAP = 4096


class _Open:
    """One entry into a span; the context manager `Spans.span` returns."""

    __slots__ = ("spans", "name", "device", "t0", "profiled")

    def __init__(self, spans: "Spans", name: str, device):
        self.spans, self.name, self.device = spans, name, device

    def __enter__(self):
        # the profiler's own process-wide flag (the C one is per thread)
        self.profiled = (self.spans._open_profiled(self.name, self.device)
                         if _autograd_profiler._is_profiler_enabled else None)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t0
        spans = self.spans
        if self.profiled is not None:
            spans._close_profiled(self.name, self.device, self.profiled)
        try:
            totals = spans._local.totals
        except AttributeError:
            totals = spans._thread_totals()
        t = totals.get(self.name)
        if t is None:
            totals[self.name] = [1, ns]
        else:
            t[0] += 1
            t[1] += ns
        return False


class Spans:
    """The accumulator and the profiled store of one process (`SPANS`);
    a test makes its own."""

    def __init__(self, cap: int = STORE_CAP):
        self._lock = threading.Lock()
        self._per_thread: List[Dict[str, List[int]]] = []   # name -> [calls, host ns]
        self._records: deque = deque(maxlen=cap)             # [name, start, end or None]
        self._local = threading.local()

    def span(self, name: str, device=None) -> _Open:
        return _Open(self, name, device)

    def add(self, name: str, seconds: float) -> None:
        try:
            totals = self._local.totals
        except AttributeError:
            totals = self._thread_totals()
        t = totals.setdefault(name, [0, 0])
        t[0] += 1
        t[1] += int(seconds * 1e9)

    def _thread_totals(self) -> Dict[str, List[int]]:
        """The calling thread's accumulator, made at its first span."""
        totals = self._local.totals = {}
        with self._lock:
            self._per_thread.append(totals)
        return totals

    @staticmethod
    def _open_profiled(name: str, device) -> tuple:
        annotation = torch.profiler.record_function(name)
        annotation.__enter__()
        start = None
        if device is not None and device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(device))
        return annotation, start

    def _close_profiled(self, name: str, device, opened: tuple) -> None:
        annotation, start = opened
        end = None
        if start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(device))
        annotation.__exit__(None, None, None)
        self._records.append([name, start, end])   # a deque's append is atomic

    def summary(self) -> Dict[str, object]:
        """{"totals": {name: {"count", "host_s"}}, "device_ms": [(name, ms
        or None off a card)]}: the accumulator, and the kept profiled spans
        in the order they closed."""
        totals: Dict[str, Dict[str, float]] = {}
        with self._lock:
            per_thread = list(self._per_thread)
        for per in per_thread:
            for k, (c, ns) in per.copy().items():
                t = totals.setdefault(k, {"count": 0, "host_s": 0.0})
                t["count"] += c
                t["host_s"] += ns / 1e9
        device_ms = []
        for rec in list(self._records):
            if rec[2] is not None:
                rec[2].synchronize()
                rec[1:] = [rec[1].elapsed_time(rec[2]), None]
            device_ms.append((rec[0], rec[1]))
        return {"totals": totals, "device_ms": device_ms}


SPANS = Spans()
span = SPANS.span
add = SPANS.add
summary = SPANS.summary
