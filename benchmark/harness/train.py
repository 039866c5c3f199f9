"""The `train_cached` generator: training from the device cache.

The mix's file gives the global batch (`batch_size`, the configuration's
unless set), the rows of the cache (`cache_rows`), the data-parallel ranks
(`ranks`, a card each), the first steps the reference follows
(`checked_steps`, 3 unless set: fewer keep the reference's time under the
window's) and the untimed steps after them (`warmup_steps`). Set-up makes the weights and `cache_rows` synthetic pairs
from the seed, builds the port's task, `Engine` and `DeviceDatasetCache`
(row-sharded over the ranks) as `cli/train.py --device_cache` does, and
drives the engine through its first steps: the ones the reference follows,
read as they happen, then the warm-up. The window then runs
`Engine.train_step` epoch after epoch, each epoch's batches reshuffled as
`fit` reshuffles them, until `--seconds` have passed; on several ranks the
ranks agree at each step whether to stop, by the one-number all-reduce
`fit` makes there (`DataGroup.any`). It is timed from a synchronised start
to a synchronised end.

A traced run then traces a few more steps (after `prime_trace`), each in a
`bench.step` span, inside the `bench.traced_window` span.
"""

from __future__ import annotations

import gc
import math
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import trace as tracing
from .inputs import make_pairs, make_weights
from .port import kernel_counters, make_port_task

CHECKED_STEPS = 3   # the first steps the reference follows, unless the mix says fewer
TRACE_SECONDS = 2.0


class _Pairs:
    """The generated pairs as the dataset the device cache loads."""

    def __init__(self, pairs: Dict[str, np.ndarray]):
        self.pairs = pairs

    def __len__(self) -> int:
        return len(self.pairs["waveform"])

    def sample(self, i: int) -> Dict[str, np.ndarray]:
        return {k: v[i] for k, v in self.pairs.items()}


def epoch_seed(seed: int, epoch: int) -> int:
    """The reshuffle seed of epoch `epoch` (1-based), as `cli/train.py`
    draws it from mode.seed."""
    return int(seed) * 100_003 + epoch


def batch_rows(n: int, batch: int, seed: int) -> List[np.ndarray]:
    """An epoch's batches as global rows: a permutation of range(n) from
    the epoch's seed cut into whole batches, as the port's loaders cut it
    (the reference's copy of the order, not the program's)."""
    order = np.arange(n)
    np.random.default_rng(seed).shuffle(order)
    return [order[i:i + batch] for i in range(0, n - batch + 1, batch)]


def _leaf_norms(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.stack([torch.linalg.vector_norm(t.double()) for t in tensors])


class TrainRun:
    """One rank of a training cell: set-up, window, traced stretch."""

    def __init__(self, cell, seed: int, device, group=None, t_start: float = None):
        from audiodepth_tpu_torch.data.codec import depth_storage_units
        from audiodepth_tpu_torch.data.device_cache import DeviceDatasetCache
        from audiodepth_tpu_torch.train.engine import Engine

        self.cell, self.seed, self.device, self.group = cell, int(seed), torch.device(device), group
        self.t_start = time.perf_counter() if t_start is None else t_start
        cfg, tr = cell.config, cell.traffic
        self.batch = int(tr.get("batch_size", cfg["batch_size"]))
        ranks = 1 if group is None else group.size
        if self.batch % ranks:
            raise ValueError(f"batch {self.batch} over {ranks} ranks")
        self.phases: Dict[str, float] = {}
        weights = make_weights(cfg, self.seed, self.device)
        self.weights = {k: v.cpu() for k, v in weights.items()}  # the reference's copy
        self._phase("weights")
        pcfg, self.task = make_port_task(cfg, weights, self.device)
        del weights
        self._phase("task")
        rows = int(tr["cache_rows"])
        self.pairs = {k: v.cpu().numpy() for k, v in
                      make_pairs(rows, self.seed, cfg, self.device).items()}
        self._phase("pairs")
        self.steps_per_epoch = rows // self.batch
        self.engine = Engine(pcfg, self.task, steps_per_epoch=self.steps_per_epoch, group=group)
        self.state = self.engine.init_state()
        self.cache = DeviceDatasetCache(_Pairs(self.pairs), depth_storage_units(pcfg),
                                        self.device, group=group)
        self._phase("cache")
        self.shard = None if group is None else (group.rank, group.size)
        self.epoch = 0
        self.order: List[np.ndarray] = []   # global rows of each step, in order
        self._batches = self._feed()
        self.readings = self._checked_steps()
        self._phase("checked_steps")
        for _ in range(int(tr.get("warmup_steps", 2))):
            self.step()
        self.sync()
        self._phase("warmup")
        self.setup_s = time.perf_counter() - self.t_start

    def _phase(self, name: str) -> None:
        """Seconds since the process started, at the end of each set-up phase."""
        self.phases[name] = time.perf_counter() - self.t_start

    # -- the feed and one step --------------------------------------------------
    def _feed(self):
        while True:
            self.epoch += 1
            seed = epoch_seed(self.seed, self.epoch)
            # the rows each step trains on, globally (the reference's batches)
            self.order.extend(batch_rows(len(self.pairs["waveform"]), self.batch, seed))
            yield from self.cache.batches(self.batch, shuffle=True, seed=seed, shard=self.shard)

    def step(self):
        self.state, metrics = self.engine.train_step(self.state, next(self._batches),
                                                     epoch=float(self.epoch - 1))
        return metrics

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _checked_steps(self) -> Dict[str, object]:
        """The first steps, read for the comparison: each loss, each leaf's
        first gradient as AdamW got it (its first moment after one step is
        (1 − β1)·g), each leaf's change over the steps."""
        model, opt = self.state.model, self.state.optimizer
        names = [n for n, _ in model.named_parameters()]
        params = [p for _, p in model.named_parameters()]
        start = [p.detach().clone() for p in params]
        norms = {n: m for n, m in model.named_modules() if isinstance(m, torch.nn.BatchNorm2d)}
        before = {n: (m.running_mean.clone(), m.running_var.clone()) for n, m in norms.items()}
        beta1 = opt.param_groups[0]["betas"][0]
        losses = []
        checked = int(self.cell.traffic.get("checked_steps", CHECKED_STEPS))
        for t in range(checked):
            losses.append(self.step()["loss"].detach().clone())
            if t == 0:
                # a leaf the optimizer got no gradient for reads 0
                grad = _leaf_norms([opt.state[p].get("exp_avg", torch.zeros_like(p))
                                    for p in params]) / (1.0 - beta1)
                # the batch's statistics, from the buffers' fold at the momentum
                bn = {n: tuple(((buf.detach() - (1 - m.momentum) * b0) / m.momentum).double().cpu()
                               for buf, b0 in zip((m.running_mean, m.running_var), before[n]))
                      for n, m in norms.items()}
        change = _leaf_norms([p.detach() - s for p, s in zip(params, start)])
        del start
        return {"loss": [float(x) for x in losses],
                "grad": dict(zip(names, grad.tolist())),
                "change": dict(zip(names, change.tolist())), "bn": bn,
                "rows": [np.asarray(r) for r in self.order[:checked]]}

    # -- the window -----------------------------------------------------------------
    def window(self, seconds: float) -> Dict[str, object]:
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        issue: List[float] = []
        self.sync()
        if self.group is not None:
            self.group.barrier()
        t0 = time.perf_counter()
        steps = 0
        while True:
            ti = time.perf_counter()
            metrics = self.step()
            issue.append(time.perf_counter() - ti)
            steps += 1
            done = time.perf_counter() - t0 >= seconds
            if self.group is not None:
                done = self.group.any(done)
            if done:
                break
        loss = float(metrics["loss"])
        self.sync()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0
        ranks = 1 if self.group is None else self.group.size
        return {"seconds": wall, "steps": steps, "pairs": steps * self.batch, "ranks": ranks,
                "issue_s": issue, "last_loss": loss, "memory_peak_bytes": int(peak),
                "step_s": wall / steps}

    def traced(self, step_s: float) -> Dict[str, object]:
        """Trace max(3, TRACE_SECONDS / step) steps; the parsed summary, the
        kernels' launch counters over them, and the step count."""
        from torch.profiler import ProfilerActivity, profile, record_function

        steps = max(3, math.ceil(TRACE_SECONDS / max(step_s, 1e-3)))
        on_card = self.device.type == "cuda"
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        tmp = tempfile.mkdtemp(prefix="bench_trace_")
        path = os.path.join(tmp, "trace.json")
        try:
            with profile(activities=activities, record_shapes=True) as prof:
                if on_card:
                    tracing.prime_trace(self.device)
                before = kernel_counters()
                with record_function(tracing.WINDOW_SPAN):
                    for i in range(steps):
                        with record_function("bench.step"):
                            self.step()
                    self.sync()
                after = kernel_counters()
            prof.export_chrome_trace(path)
            summary = tracing.parse_trace(path)
        finally:
            for name in os.listdir(tmp):
                os.remove(os.path.join(tmp, name))
            os.rmdir(tmp)
        return {"summary": summary, "steps": steps,
                "counters": {k: after[k] - before[k] for k in after}}

    def free(self) -> None:
        """Drop the program's state before the reference runs."""
        self.state = self.engine = self.task = self.cache = self._batches = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_batches(self, device, ranks: int = 1, rank: int = 0) -> List:
        """Callables giving the checked steps' global batches as float32
        tensors on `device`; with `ranks`, this rank's contiguous share of
        each one's rows."""
        def make(rows):
            share = len(rows) // ranks
            rows = rows[rank * share:(rank + 1) * share]
            return lambda: {k: torch.from_numpy(v[rows]).to(device)
                            for k, v in self.pairs.items()}

        return [make(r) for r in self.readings["rows"]]


def rank_digest(traced: Optional[Dict]) -> Optional[Dict[str, float]]:
    """What each rank's trace adds to the result: its busy and window
    seconds (the result's are their means over the cards)."""
    if traced is None:
        return None
    s = traced["summary"]
    return {"busy_s": s.busy_us / 1e6, "window_s": s.window_us / 1e6}
