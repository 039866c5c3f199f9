#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`audiodepth_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero:
  env        torch / CUDA versions, the card's name and power limit;
  build      compile every CUDA kernel of the port from `csrc/` (nvcc, one
             process per source, all started together);
  kernel     each kernel against its plain PyTorch version on the card at
             the serving shapes, max |Δ| asserted, and its time, the plain
             version's time and the card's bound for the same work;
  serve      the main path: unet_256 / ngf 64 / 256² / bf16, random init
             from seed 0, batch ladder 1,4,16, the port's HTTP server
             in-process, 16 warm-up requests, then a 48-request loadtest
             at concurrency 8; every
             answer checked, one served answer compared with a direct run,
             and each kernel's launch count compared with the device
             batches the server ran;
  profile    host wall and device time of one served batch (sizes 1, 16);
  f32_vs_cpu the same seeded unet_256 in float32 (TF32 off) through
             `predict_meters` on the card and on the CPU;
  kernels    one line listing every kernel with its numbers.
The last line is {"ok": true, "device": {...}}. Without a CUDA device, or
without the repository beside it, the script exits non-zero before printing
any result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

# (fp32 TFLOP/s on the CUDA cores, HBM TB/s), NVIDIA data sheets, dense
PEAKS = {"H100 SXM": (67.0, 3.35), "H100 PCIe": (51.0, 2.0), "H100 NVL": (60.0, 3.9)}
KERNEL_TOL = 1e-5          # B1 vs its plain version (see the kernel phase)
F32_VS_CPU_TOL = 1e-3      # relative to max |cpu|
SERVED_TOL = 2 ** -5       # served vs direct bf16 answer, relative to max |direct|


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def peak_for(name: str):
    key = ("H100 PCIe" if "PCIe" in name else "H100 NVL" if "NVL" in name
           else "H100 SXM")
    return key, PEAKS[key]


def time_ms(torch, fn, runs: int = 50, warmup: int = 5) -> float:
    """Median per-call device time (CUDA events between back-to-back calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(runs + 1)]
    torch.cuda._sleep(50_000_000)  # hold the stream while the host queues every call
    events[0].record()
    for i in range(runs):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(events[i].elapsed_time(events[i + 1]) for i in range(runs))


def phase_env(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(), "nvidia_smi": smi})
    return smi


def phase_build(build):
    t0 = time.perf_counter()
    logs = build.build(["fused_frontend"])
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": sorted(logs), "ptxas": ptxas})


def phase_kernel(torch, np, ff, peak):
    """B1 against its plain version at the serving shapes (B·C = 2, 8, 32 at
    L = 7782) and at a short L. Tolerance 1e-5: the JAX package holds its
    Pallas kernel to the XLA composition at atol 1e-6; the card's FMA
    summation order differs from the plain version's cuBLAS order, and the
    difference passes through log and the division by the channel's range."""
    flops_peak, bw_peak = peak
    rows = []
    for bc, length in [(2, 7782), (8, 7782), (32, 7782), (8, 4000)]:
        rng = np.random.default_rng(bc * 100_003 + length)
        wave_np = (rng.standard_normal((bc // 2, 2, length)) * 0.05).astype(np.float32)
        wave_np[0, 0] = 0.0  # a silent channel takes the max == min branch
        wave = torch.from_numpy(wave_np).cuda()
        got = ff.fused_mel_frontend(wave)
        want = ff.fused_mel_frontend_plain(wave)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        assert got.shape == want.shape and torch.isfinite(got).all()
        assert float(got[0, 0].abs().max()) == 0.0
        assert err <= KERNEL_TOL, f"B1 differs from its plain version by {err}"
        ms = time_ms(torch, lambda: ff.fused_mel_frontend(wave))
        plain_ms = time_ms(torch, lambda: ff.fused_mel_frontend_plain(wave))
        t_frames, win, n_freq, n_mels = got.shape[-1], 64, 257, 32
        flops = 2.0 * bc * t_frames * (win * 2 * n_freq + n_freq * n_mels)
        nbytes = 4.0 * (bc * length + bc * n_mels * t_frames
                        + win * 2 * n_freq + n_freq * n_mels)
        bound_ms = max(flops / (flops_peak * 1e12), nbytes / (bw_peak * 1e12)) * 1e3
        row = {"phase": "kernel", "name": ff.fused_mel_frontend.name, "bc": bc,
               "L": length, "T": t_frames, "max_abs_err": err, "us": ms * 1e3,
               "plain_us": plain_ms * 1e3, "bound_us": bound_ms * 1e3,
               "bound_by": "operations" if flops / flops_peak > nbytes / bw_peak else "bytes",
               "gflop": flops / 1e9, "mbytes": nbytes / 1e6}
        emit(row)
        rows.append(row)
    return rows


def _post(port, wave):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                 data=wave.astype("float32").tobytes(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        shape = tuple(int(s) for s in resp.headers["X-Shape"].split(","))
        return resp.read(), shape


def measure_profile(torch, np, runner):
    """Host wall and device time of one served batch at ladder sizes 1 and
    16 (torch.profiler: kernel time summed over CUDA activities)."""
    from torch.profiler import ProfilerActivity, profile

    out = {"phase": "profile"}
    for bs in (1, 16):
        waves = (np.random.default_rng(bs).standard_normal((bs, 2, runner.wave_len))
                 * 0.05).astype(np.float32)
        walls = []
        for _ in range(10):
            t0 = time.perf_counter()
            runner.run(waves)
            walls.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(5):
                runner.run(waves)
            wall = time.perf_counter() - t0
        kernels = sorted(
            ((e.self_device_time_total, e.key) for e in prof.key_averages()
             if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0),
            reverse=True)
        device_us = sum(d for d, _ in kernels)
        out[f"bs{bs}"] = {
            "wall_ms_median": statistics.median(walls) * 1e3,
            "device_ms_per_batch": device_us / 5 / 1e3 if device_us else "not measured",
            "device_busy_share": device_us / 1e6 / wall if device_us else "not measured",
            "n_kernel_names": len(kernels),
            "top_us_per_batch": [[k[:60], d / 5] for d, k in kernels[:8]]}
    return out


def phase_serve(torch, np, serve, kernels):
    args = serve.build_parser().parse_args(
        ["--random_init", "--seed", "0", "--generator", "unet_256", "--ngf", "64",
         "--compute_dtype", "bfloat16", "--batch_ladder", "1,4,16",
         "--loadtest", "48", "--loadtest_concurrency", "8"])
    cfg, task, source = serve.load_serving_state(args)
    assert cfg.dataset.images_size == 256 and cfg.dataset.name == "batvisionv2"
    n_params = sum(p.numel() for p in task.model.parameters())
    runner = serve.InferenceRunner(cfg, task, ladder=[1, 4, 16])
    for wrapper, _, _ in kernels:
        wrapper.launches = 0
    torch.cuda.reset_peak_memory_stats()
    warm = runner.warmup()
    batcher = serve.MicroBatcher(runner, wait_ms=args.batch_wait_ms)
    server = serve.make_server(batcher, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        # first requests pay one-time Python costs (imports, connections)
        warm_http = serve.run_loadtest(port, runner, 16, args.loadtest_concurrency)
        res = serve.run_loadtest(port, runner, args.loadtest, args.loadtest_concurrency)
        wave = (np.random.default_rng(7).standard_normal((2, runner.wave_len)) * 0.05
                ).astype(np.float32)
        body, shape = _post(port, wave)
        direct = runner.run(wave[None])[0, ..., 0]
        direct_again = runner.run(wave[None])[0, ..., 0]
        launches = {w.name: w.launches for w, _, _ in kernels}
        # the warm-up runs each ladder size once, then the server's batches
        # and the two direct runs
        device_batches = len(runner.ladder) + batcher.batches + 2
        stats = batcher.stats()
        profile = measure_profile(torch, np, runner)
    finally:
        server.shutdown()
        server.server_close()
        batcher.stop()
        runner.close()
        thread.join(timeout=10)
    served = np.frombuffer(body, np.float32).reshape(shape)
    assert res["answered"] == res["requests"] == 48 and res["bad_responses"] == 0, res
    assert warm_http["bad_responses"] == 0, warm_http
    assert shape == (256, 256)
    assert np.isfinite(served).all() and served.min() >= 0 and served.max() <= 30
    # cuDNN does not promise bit-reproducible bf16 answers from run to run
    # (an NCHW-contiguous model gave one-ulp differences between repeats),
    # so the served answer is held to four bf16 ulps at its largest value
    scale = float(np.abs(direct).max())
    served_err = float(np.abs(served - direct).max())
    assert served_err <= SERVED_TOL * scale, (served_err, scale)
    for name, n in launches.items():
        assert n == device_batches, f"{name}: {n} launches for {device_batches} device batches"
    emit({"phase": "serve", "model": "unet_baseline/unet_256", "ngf": 64,
          "params": n_params, "images_size": 256, "compute_dtype": "bfloat16",
          "weights": source, "ladder": runner.ladder, "warmup_s": warm,
          "requests": res["requests"], "concurrency": res["concurrency"],
          "warmup_http": {k: warm_http[k] for k in ("throughput_rps", "p50_ms", "p99_ms")},
          "throughput_rps": res["throughput_rps"], "p50_ms": res["p50_ms"],
          "p95_ms": res["p95_ms"], "p99_ms": res["p99_ms"],
          "device_batches": device_batches, "mean_batch_fill": stats.get("mean_batch_fill"),
          "launches": launches, "served_vs_direct_max_abs": served_err,
          "direct_max_abs": scale,
          "direct_repeat_max_abs": float(np.abs(direct_again - direct).max()),
          "depth_range_m": [float(served.min()), float(served.max())],
          "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20})
    emit(profile)
    return launches


def phase_f32_vs_cpu(torch, np, configs, models, init_unet_weights):
    cfg = configs.load_config("batvisionv2", "test", overrides={
        "mode.compute_dtype": "float32"})
    cpu = models.make_task(cfg, device="cpu")
    init_unet_weights(cpu.model, torch.Generator().manual_seed(0))
    gpu = models.make_task(cfg, device="cuda")
    gpu.model.load_state_dict(cpu.model.state_dict(), strict=True)
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    wave = (np.random.default_rng(11).standard_normal((1, 2, 7782)) * 0.05).astype(np.float32)
    want = cpu.predict_meters({"waveform": wave}).numpy()
    got = gpu.predict_meters({"waveform": wave}).cpu().numpy()
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape == (1, 256, 256, 1) and np.isfinite(got).all()
    assert scale > 0 and err <= F32_VS_CPU_TOL * scale, (err, scale)
    emit({"phase": "f32_vs_cpu", "max_abs_err": err, "max_abs_cpu": scale,
          "rel_err": err / scale, "tol_rel": F32_VS_CPU_TOL})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from audiodepth_tpu_torch import configs, models
    from audiodepth_tpu_torch._device import configure_precision
    from audiodepth_tpu_torch.cli import serve
    from audiodepth_tpu_torch.models import init_unet_weights
    from audiodepth_tpu_torch.ops.cuda import KERNELS, _build
    from audiodepth_tpu_torch.ops.cuda import fused_frontend as ff

    configure_precision()
    smi = phase_env(torch)
    peak_name, peak = peak_for(torch.cuda.get_device_name(0))
    phase_build(_build)
    rows = phase_kernel(torch, np, ff, peak)
    launches = phase_serve(torch, np, serve, KERNELS)
    phase_f32_vs_cpu(torch, np, configs, models, init_unet_weights)

    main_shape = next(r for r in rows if r["bc"] == 32 and r["L"] == 7782)
    kernels = []
    for wrapper, source, replaces in KERNELS:
        mine = [r for r in rows if r["name"] == wrapper.name]
        kernels.append({
            "name": wrapper.name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[wrapper.name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": main_shape["us"] / 1e3, "plain_ms": main_shape["plain_us"] / 1e3,
            "bound_ms": main_shape["bound_us"] / 1e3, "bound_by": main_shape["bound_by"],
            # no single PyTorch call computes the fused STFT→mel→log→min-max
            "library_ms": None, "us": main_shape["us"], "shape": "B*C=32, L=7782",
            "peak": peak_name})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
