"""Inference serving CLI: waveform in, depth map out, over HTTP (port of
`cli/serve.py`).

  * One forward per batch — TOF-fix → mel front end (kernel B1 on the card)
    → model (UNet, the binaural attention net with kernel B2 on the card,
    base_residual, the cVAE with its fixed eval draw, or the AdaBins
    student alone) → meters + clip to [0, max_depth] — run once per size of
    a batch ladder at startup (`warmup`), so no size is first seen
    mid-serving. Models that read camera images (rgb_depth, --eval_img
    baselines) are refused.
  * Micro-batching: concurrent requests are collected for up to
    --batch_wait_ms, padded to the smallest ladder size, and run as one
    device batch.
  * Weights: a checkpoint that `cli.train` saved (`ckpt/`: --checkpoint_path
    DIR[/EPOCH], or --ckpt_dir ROOT with the experiment's name; --use_best,
    --checkpoints EPOCH, else the latest), a reference torch .pth
    (--torch_checkpoint; a port checkpoint is one too), or --random_init
    (seeded torch.Generator). The JAX package's orbax checkpoints are not
    read: convert them with `tools/import_jax.py`.

Protocol (the JAX server's):
  POST /predict   body = raw little-endian float32 waveform, C-order
                  [2, L] (any L: the server pads/cuts to the TOF window).
                  → 200, body = raw float32 depth meters [S, S],
                  header X-Shape: "S,S".
  GET  /healthz   → 200 "ok".
  GET  /stats     → JSON: served count, latency percentiles, queue depth.

`--loadtest N` starts the server in-process, drives N concurrent requests
through real HTTP, checks every answer, and prints a latency/throughput
JSON line.
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Inference runner: task (model on its device) → one forward per batch
# ---------------------------------------------------------------------------
class InferenceRunner:
    """Owns the task (model and device) and runs ladder-sized batches.

    Every forward runs on one device thread that the runner owns, whoever
    calls: cuDNN and cuBLAS keep their handles and workspaces per thread,
    so the warm-up must happen on the thread that serves. `close()` stops
    the thread.
    """

    def __init__(self, cfg, task, ladder: Sequence[int] = (1, 4, 16)):
        from ..data.frontend import tof_cut_samples

        self.cfg = cfg
        self.task = task
        self.device = task.device
        self.ladder = sorted(set(int(b) for b in ladder))
        self.wave_len = tof_cut_samples(cfg.dataset.max_depth,
                                        cfg.dataset.sample_rate)
        self.out_size = int(cfg.dataset.images_size)
        self._device_thread = ThreadPoolExecutor(max_workers=1,
                                                 thread_name_prefix="device")

    def close(self) -> None:
        self._device_thread.shutdown(wait=True)

    def _forward(self, waves: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(waves, np.float32)).to(self.device)
        pred = self.task.predict_meters({"waveform": x})
        pred = torch.clamp(pred, 0.0, self.cfg.dataset.max_depth)
        return pred.float().cpu().numpy()  # the copy to the host synchronizes

    def _infer(self, waves: np.ndarray) -> np.ndarray:
        return self._device_thread.submit(self._forward, waves).result()

    def warmup(self) -> Dict[int, float]:
        """Run every ladder size once; returns per-size seconds."""
        times = {}
        for b in self.ladder:
            z = np.zeros((b, 2, self.wave_len), np.float32)
            t0 = time.perf_counter()
            self._infer(z)
            times[b] = time.perf_counter() - t0
        return times

    def fix_length(self, wave: np.ndarray) -> np.ndarray:
        """[2, L] any L → [2, wave_len] (cut / zero-pad, dataset semantics)."""
        c, l = wave.shape
        if l >= self.wave_len:
            return wave[:, : self.wave_len]
        out = np.zeros((c, self.wave_len), np.float32)
        out[:, :l] = wave
        return out

    def run(self, waves: np.ndarray) -> np.ndarray:
        """[B, 2, wave_len] float32 → [B, S, S, 1] float32 meters.

        B must be a ladder size (the batcher pads to one).
        """
        if waves.shape[0] not in self.ladder:
            raise ValueError(
                f"batch {waves.shape[0]} not in the ladder {self.ladder}")
        return self._infer(waves)


# ---------------------------------------------------------------------------
# Micro-batcher: request queue → padded ladder batches → per-request futures
# ---------------------------------------------------------------------------
class _Request:
    __slots__ = ("wave", "event", "result", "error", "t_enqueue")

    def __init__(self, wave: np.ndarray):
        self.wave = wave
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[Exception] = None
        self.t_enqueue = time.perf_counter()


class MicroBatcher:
    """Collects concurrent requests into one padded device batch.

    The collector blocks on the first request, then drains whatever else
    arrives within wait_ms (bounded by the largest ladder size), pads to
    the smallest ladder size ≥ n, runs ONE batch, and fans results back
    out. Pad rows are zeros; their outputs are dropped.
    """

    def __init__(self, runner: InferenceRunner, wait_ms: float = 2.0):
        self.runner = runner
        self.wait_s = wait_ms / 1e3
        self.q: "queue.Queue[_Request]" = queue.Queue()
        self.latencies: List[float] = []
        self.batch_fill: List[int] = []
        self.served = 0
        self.batches = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, wave: np.ndarray) -> _Request:
        req = _Request(wave)
        self.q.put(req)
        return req

    def stop(self):
        self._stop.set()
        self.q.put(None)  # type: ignore[arg-type]  # unblock the collector
        self._thread.join(timeout=5)

    def _loop(self):
        max_b = max(self.runner.ladder)
        while not self._stop.is_set():
            first = self.q.get()
            if first is None:
                continue
            batch = [first]
            deadline = time.perf_counter() + self.wait_s
            while len(batch) < max_b:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self.q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    break
                batch.append(nxt)
            self._run_batch(batch)

    def _run_batch(self, batch: List[_Request]):
        n = len(batch)
        padded = min(b for b in self.runner.ladder if b >= n) \
            if n <= max(self.runner.ladder) else max(self.runner.ladder)
        try:
            waves = np.zeros((padded, 2, self.runner.wave_len), np.float32)
            for i, req in enumerate(batch[:padded]):
                waves[i] = req.wave
            out = self.runner.run(waves)
            now = time.perf_counter()
            with self._lock:
                self.served += n
                self.batches += 1
                self.batch_fill.append(n)
                for i, req in enumerate(batch[:padded]):
                    req.result = out[i]
                    self.latencies.append(now - req.t_enqueue)
                if len(self.latencies) > 65536:  # bounded stats windows
                    del self.latencies[:32768]
                    del self.batch_fill[:16384]
            for req in batch[:padded]:
                req.event.set()
            # overflow beyond the largest ladder size: requeue the tail
            for req in batch[padded:]:
                self.q.put(req)
        except Exception as e:  # the collector must keep running: fail every waiter
            for req in batch:
                req.error = e
                req.event.set()

    def stats(self) -> Dict[str, object]:
        with self._lock:
            lats = np.asarray(self.latencies[-4096:], np.float64)
            fills = self.batch_fill[-4096:]
            served = self.served
            batches = self.batches
        out: Dict[str, object] = {
            "served": served,
            "batches": batches,
            "queue_depth": self.q.qsize(),
            "ladder": self.runner.ladder,
        }
        if lats.size:
            out.update(
                p50_ms=round(float(np.percentile(lats, 50)) * 1e3, 3),
                p95_ms=round(float(np.percentile(lats, 95)) * 1e3, 3),
                p99_ms=round(float(np.percentile(lats, 99)) * 1e3, 3),
                mean_batch_fill=round(float(np.mean(fills)), 2),
            )
        return out


# ---------------------------------------------------------------------------
# HTTP server (stdlib; one collector thread owns the device)
# ---------------------------------------------------------------------------
def make_server(batcher: MicroBatcher, host: str, port: int):
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    runner = batcher.runner

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet; /stats is the observability
            pass

        def _send(self, code: int, body: bytes,
                  ctype: str = "application/octet-stream",
                  extra: Optional[Dict[str, str]] = None):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, b"ok", "text/plain")
            elif self.path == "/stats":
                self._send(200, json.dumps(batcher.stats()).encode(),
                           "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, b"not found", "text/plain")
                return
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n)
            if n == 0 or n % 8 != 0:  # 2 channels x float32
                self._send(400, b"body must be float32 [2, L] bytes",
                           "text/plain")
                return
            wave = np.frombuffer(body, np.float32).reshape(2, -1)
            req = batcher.submit(runner.fix_length(wave.astype(np.float32)))
            req.event.wait()
            if req.error is not None:
                self._send(500, str(req.error).encode(), "text/plain")
                return
            depth = np.ascontiguousarray(req.result[..., 0], np.float32)
            self._send(200, depth.tobytes(),
                       extra={"X-Shape": f"{depth.shape[0]},{depth.shape[1]}"})

    class Server(ThreadingHTTPServer):
        # the stdlib's listen backlog of 5 overflows under a few concurrent
        # clients, and a dropped connection costs a 1 s SYN retransmit
        request_queue_size = 128

    return Server((host, port), Handler)


# ---------------------------------------------------------------------------
# flags → (cfg, task, source)
# ---------------------------------------------------------------------------
def load_serving_state(args):
    """Build (cfg, task, source) from parsed flags: a task on args.device
    with the weights of a reference .pth, of random init, or of a
    checkpoint `cli.train` saved (the JAX server's resolution of
    --checkpoint_path, --ckpt_dir, --checkpoints and --use_best)."""
    import os

    from ..ckpt import CheckpointManager
    from ..configs import experiment_name, load_config
    from ..models import init_weights, make_task
    from ..tools.import_jax import load_torch_state_dict
    from .common import model_shape_overrides

    overrides = model_shape_overrides(args)
    if args.compute_dtype:
        overrides["mode.compute_dtype"] = args.compute_dtype
    cfg = load_config(args.dataset, "test", args.experiment_name, args.model,
                      overrides=overrides)
    if cfg.model.input_nc != 2:
        raise SystemExit("serving is waveform→depth; image-input models "
                         "(rgb_depth / --eval_img baselines) are not servable")
    task = make_task(cfg, device=args.device)

    if args.torch_checkpoint:
        sd = load_torch_state_dict(args.torch_checkpoint)
        task.model.load_state_dict(sd, strict=True)
        return cfg, task, f"torch:{args.torch_checkpoint}"

    if args.random_init:
        gen = torch.Generator().manual_seed(int(args.seed))
        init_weights(task.model, gen)
        return cfg, task, "random-init"

    epoch_req = args.checkpoints
    ckpt_dir = args.ckpt_dir
    if args.checkpoint_path:
        path = os.path.abspath(args.checkpoint_path).rstrip("/")
        if os.path.basename(path).isdigit():
            epoch_req = int(os.path.basename(path))
            path = os.path.dirname(path)
        ckpt_dir, exp = os.path.dirname(path), os.path.basename(path)
    else:
        exp = (experiment_name(cfg) if args.experiment_name == "default"
               else args.experiment_name)
    if args.use_best and epoch_req is None:
        epoch_req = "best"
    mgr = CheckpointManager(ckpt_dir, exp, create=False)
    try:
        sd, _, epoch = mgr.restore_eval(epoch=epoch_req)
    except FileNotFoundError:
        raise SystemExit(f"checkpoint not found under {mgr.directory}; "
                         f"available epochs: {mgr.all_epochs()}")
    task.model.load_state_dict(sd, strict=True)
    return cfg, task, f"{exp}@{epoch}"


# ---------------------------------------------------------------------------
# load test: real HTTP round trips against the in-process server
# ---------------------------------------------------------------------------
def run_loadtest(port: int, runner: InferenceRunner, n_requests: int,
                 concurrency: int) -> Dict[str, object]:
    """Drive n_requests POSTs; every answer must be a finite [S, S] depth
    within [0, max_depth] (counted in "bad_responses" otherwise)."""
    import urllib.request

    rng = np.random.default_rng(0)
    wave = (rng.standard_normal((2, runner.wave_len)) * 0.05).astype(np.float32)
    body = wave.tobytes()
    url = f"http://127.0.0.1:{port}/predict"
    s, max_depth = runner.out_size, runner.cfg.dataset.max_depth
    lats: List[float] = []
    bad = [0]
    lock = threading.Lock()
    it = iter(range(n_requests))

    def worker():
        while True:
            with lock:
                try:
                    next(it)
                except StopIteration:
                    return
            t0 = time.perf_counter()
            req = urllib.request.Request(url, data=body, method="POST")
            with urllib.request.urlopen(req) as resp:
                shape = resp.headers.get("X-Shape")
                depth = np.frombuffer(resp.read(), np.float32)
            dt = time.perf_counter() - t0
            ok = (shape == f"{s},{s}" and depth.size == s * s
                  and bool(np.all(np.isfinite(depth)))
                  and bool(np.all((depth >= 0) & (depth <= max_depth))))
            with lock:
                lats.append(dt)
                bad[0] += not ok

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    arr = np.asarray(lats) * 1e3
    return {
        "requests": n_requests,
        "answered": len(lats),
        "bad_responses": bad[0],
        "concurrency": concurrency,
        "throughput_rps": n_requests / wall,
        "p50_ms": float(np.percentile(arr, 50)),
        "p95_ms": float(np.percentile(arr, 95)),
        "p99_ms": float(np.percentile(arr, 99)),
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="audio-depth serving (PyTorch/CUDA)")
    p.add_argument("--dataset", default="batvisionv2",
                   choices=["batvisionv1", "batvisionv2", "synthetic"])
    p.add_argument("--model", default="unet_baseline")
    p.add_argument("--experiment_name", default="default")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (cuda, cuda:1, cpu)")
    p.add_argument("--ckpt_dir", default="./checkpoints",
                   help="root of the checkpoints cli.train saved (with the experiment name)")
    p.add_argument("--checkpoint_path", default=None,
                   help="one experiment's checkpoint directory, or DIR/EPOCH")
    p.add_argument("--checkpoints", type=int, default=None, help="epoch")
    p.add_argument("--use_best", action="store_true",
                   help="the epoch best.json names")
    p.add_argument("--torch_checkpoint", default=None,
                   help="serve a reference .pth directly (no retraining)")
    p.add_argument("--random_init", action="store_true",
                   help="serve an untrained model (smoke tests / latency "
                        "benchmarks without a checkpoint)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute_dtype", default=None,
                   choices=[None, "bfloat16", "float32"])
    from .common import add_model_shape_args

    add_model_shape_args(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8474)
    p.add_argument("--batch_ladder", default="1,4,16",
                   help="comma-separated batch sizes run at startup; "
                        "requests are micro-batched and padded to the "
                        "smallest fitting size")
    p.add_argument("--batch_wait_ms", type=float, default=2.0,
                   help="max time the collector waits to fill a batch")
    p.add_argument("--loadtest", type=int, default=0, metavar="N",
                   help="serve in-process, drive N HTTP requests, print a "
                        "latency/throughput JSON line, and exit")
    p.add_argument("--loadtest_concurrency", type=int, default=16)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg, task, source = load_serving_state(args)
    ladder = [int(b) for b in str(args.batch_ladder).split(",") if b]
    runner = InferenceRunner(cfg, task, ladder=ladder)
    print(f"serving {cfg.model.name} ({source}) on {runner.device}; "
          f"wave_len={runner.wave_len}, out={runner.out_size}²; "
          f"warming ladder {runner.ladder} ...")
    times = runner.warmup()
    print("warm: " + ", ".join(f"bs={b} {t:.2f}s" for b, t in times.items()))

    batcher = MicroBatcher(runner, wait_ms=args.batch_wait_ms)
    server = make_server(batcher, args.host, args.port)
    port = server.server_address[1]

    if args.loadtest:
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            result = run_loadtest(port, runner, args.loadtest,
                                  args.loadtest_concurrency)
            result["server_stats"] = batcher.stats()
        finally:
            server.shutdown()
            server.server_close()
            batcher.stop()
            runner.close()
        print(json.dumps(result))
        return result

    print(f"listening on http://{args.host}:{port}  "
          f"(POST /predict, GET /healthz, GET /stats)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()
        batcher.stop()
        runner.close()


if __name__ == "__main__":
    main()
