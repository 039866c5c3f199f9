"""The `serve_open_loop` generator: the port's HTTP server under open-loop
arrivals.

The mix's file gives the arrival rate (`rate_rps`), the server's batch
ladder (`ladder`) and collection wait (`batch_wait_ms`), the warm-up
stretch (`warmup_s`) and the sample of answers checked (`checked`). Set-up
makes the weights and one distinct recording a request from the seed
(`inputs.make_pairs`, the generator's length: the server cuts it to the
time-of-flight window), builds the port's task, `InferenceRunner` (its
ladder warmed), `MicroBatcher` and HTTP server on a free local port, starts
the client process and sends one warm-up stretch through HTTP. The window's
requests arrive at `rate_rps` (`client.stratified_gaps`) for `--seconds`;
each is timed from when it was due to when its answer was read. A span
around every `InferenceRunner.run` and the batcher's counters are read
over the window. A traced run then traces a stretch of `TRACE_SECONDS` at
the same rate.
"""

from __future__ import annotations

import gc
import multiprocessing as mp
import os
import tempfile
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from . import trace as tracing
from .client import client_main, stratified_gaps
from .inputs import make_pairs, make_weights
from .port import kernel_counters, make_port_task

TRACE_SECONDS = 2.0
START_DELAY_S = 0.5   # from sending a phase to its first due time


class ServeRun:
    def __init__(self, cell, seed: int, seconds: float, device, t_start: float = None):
        from audiodepth_tpu_torch.cli.serve import InferenceRunner, MicroBatcher, make_server

        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.t_start = time.perf_counter() if t_start is None else t_start
        cfg, tr = cell.config, cell.traffic
        self.rate = float(tr["rate_rps"])
        self.n = max(1, round(self.rate * seconds))
        self.phases: Dict[str, float] = {}
        # the client process starts first: its interpreter comes up meanwhile
        ctx = mp.get_context("spawn")
        self.conn, child = ctx.Pipe()
        self.client = ctx.Process(target=client_main, args=(child,), daemon=True)
        self.client.start()
        child.close()
        weights = make_weights(cfg, self.seed, self.device)
        self.weights = {k: v.cpu() for k, v in weights.items()}
        _, self.task = make_port_task(cfg, weights, self.device, mode="test")
        del weights
        self._mark("task")
        pcfg = self.task.cfg
        self.waves = make_pairs(self.n, self.seed, cfg, self.device)["waveform"].cpu().numpy()
        self._mark("recordings")
        self.runner = InferenceRunner(pcfg, self.task, ladder=tuple(tr["ladder"]))
        self.runner.warmup()
        self._mark("ladder_warmed")
        self.spans: List[tuple] = []
        run = self.runner.run

        def spanned(waves):
            t = time.perf_counter()
            out = run(waves)
            self.spans.append((t, time.perf_counter(), waves.shape[0]))
            return out

        self.runner.run = spanned
        self.batcher = MicroBatcher(self.runner, wait_ms=float(tr["batch_wait_ms"]))
        self.server = make_server(self.batcher, "127.0.0.1", 0)
        self._serving = threading.Thread(target=self.server.serve_forever, daemon=True)
        self._serving.start()
        # the recordings go to the client through a file (a pipe is slow on
        # some hosts), 16-bit PCM as recorded; removed once it has read them
        tmp = tempfile.mkdtemp(prefix="bench_bodies_")
        path = os.path.join(tmp, "bodies.npy")
        try:
            np.save(path, np.round(self.waves * 32768.0).astype(np.int16))
            self.conn.send((self.server.server_address[1], path))
            if self.conn.recv() != "ready":
                raise RuntimeError("the client process did not start")
        finally:
            os.remove(path)
            os.rmdir(tmp)
        self._mark("client_ready")
        rng = np.random.default_rng(self.seed)
        self.checked = sorted(rng.choice(self.n, size=min(self.n, int(tr["checked"])),
                                         replace=False).tolist())
        warm = max(1, round(self.rate * float(tr["warmup_s"])))
        self._phase(stratified_gaps(warm, self.rate, self.seed + 1), keep=())
        self._await()
        self._mark("http_warmed")
        self.setup_s = time.perf_counter() - self.t_start

    def _mark(self, name: str) -> None:
        """Seconds since the process started, at the end of each set-up phase."""
        self.phases[name] = time.perf_counter() - self.t_start

    def _phase(self, gaps: np.ndarray, keep) -> float:
        """Send the client a stretch of requests; returns its start."""
        t0 = time.perf_counter() + START_DELAY_S
        self.conn.send({"t0": t0, "due": np.cumsum(gaps) - gaps[0], "keep": list(keep)})
        return t0

    def _await(self) -> Dict[str, object]:
        return self.conn.recv()

    def window(self, seconds: float) -> Dict[str, object]:
        gaps = stratified_gaps(self.n, self.rate, self.seed)
        served0, batches0 = self.batcher.served, self.batcher.batches
        t0 = self._phase(gaps, keep=self.checked)
        end = t0 + float(np.sum(gaps) - gaps[0])
        time.sleep(max(0.0, end - time.perf_counter()))
        served1, batches1 = self.batcher.served, self.batcher.batches
        rec = self._await()
        if self.device.type == "cuda":
            peak = torch.cuda.max_memory_allocated(self.device)
        else:
            peak = 0
        self.record = rec
        ok = (rec["status"] == 200) & np.isfinite(rec["done"])
        lat = np.where(ok, rec["done"] - rec["due"], np.inf)
        late = rec["sent"] - rec["due"]
        spans = [s for s in self.spans if t0 <= s[0] <= end]
        last = float(np.nanmax(rec["done"])) if ok.any() else float(end - t0)
        return {"seconds": end - t0, "attempted": self.n, "failed": int((~ok).sum()),
                "latency_s": lat, "late_s": late, "due_s": rec["due"], "completed": int(ok.sum()),
                "busy_until_s": last, "answers": rec["answers"],
                "served_rows": served1 - served0, "batches": batches1 - batches0,
                "runner_s": [s[1] - s[0] for s in spans], "memory_peak_bytes": int(peak)}

    def traced(self) -> Dict[str, object]:
        from torch.profiler import ProfilerActivity, profile, record_function

        n = max(1, round(self.rate * TRACE_SECONDS))
        gaps = stratified_gaps(n, self.rate, self.seed + 2)
        tmp = tempfile.mkdtemp(prefix="bench_trace_")
        path = os.path.join(tmp, "trace.json")
        on_card = self.device.type == "cuda"
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        try:
            # the forwards run on the runner's own thread
            with profile(activities=activities, record_shapes=True,
                         experimental_config=tracing.all_threads()) as prof:
                if on_card:
                    tracing.prime_trace(self.device)
                before = kernel_counters()
                t0 = self._phase(gaps, keep=())
                time.sleep(max(0.0, t0 - time.perf_counter()))
                with record_function(tracing.WINDOW_SPAN):   # from the first due time
                    end = t0 + float(np.sum(gaps) - gaps[0])
                    time.sleep(max(0.0, end - time.perf_counter()))
                    self._await()   # every answer of the stretch, inside the span
                    if on_card:
                        torch.cuda.synchronize(self.device)
                after = kernel_counters()
            prof.export_chrome_trace(path)
            summary = tracing.parse_trace(path)
        finally:
            for name in os.listdir(tmp):
                os.remove(os.path.join(tmp, name))
            os.rmdir(tmp)
        return {"summary": summary, "steps": n,
                "counters": {k: after[k] - before[k] for k in after}}

    def close(self) -> None:
        """Stop the client, the server, the batcher and the runner, and
        wait for each; then drop the program's state."""
        try:
            self.conn.send(None)
        except OSError:
            pass
        self.client.join(timeout=30)
        if self.client.is_alive():
            self.client.terminate()
            self.client.join(timeout=10)
        self.server.shutdown()
        self.server.server_close()
        self._serving.join(timeout=10)
        self.batcher.stop()
        self.runner.close()
        self.task = self.runner = self.batcher = self.server = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def served_answers(self, answers: Dict[int, bytes]) -> torch.Tensor:
        size = int(self.cell.config["images_size"])
        return torch.stack([torch.from_numpy(np.frombuffer(answers[i], np.float32)
                                             .reshape(size, size).copy())
                            for i in self.checked])
