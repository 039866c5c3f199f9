#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`audiodepth_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure raises and the script exits
non-zero:
  env        torch / CUDA versions, the card's name, power limit, SMs and
             maximum SM clock;
  build      compile every CUDA kernel of the port from `csrc/` (nvcc, one
             process per source, all started together);
  kernel     each kernel against its plain PyTorch version on the card at
             the shapes its path gives it, max |Δ| asserted, and its time,
             the plain version's time, the card's bound for the same work
             and, where one PyTorch call computes the same function, that
             call's time: B1 (the mel front end) and B2 (flash
             cross-attention forward, the four binaural level shapes, a
             ragged shape and float32);
  serve      the unet path: unet_256 / ngf 64 / 256² / bf16, random init
             from seed 0, batch ladder 1,4,16, the port's HTTP server
             in-process, 16 warm-up requests, then a 48-request loadtest
             at concurrency 8; every answer checked, one served answer
             compared with a direct run, and each kernel's launch count
             compared with what the path runs per device batch (B1 once,
             B2 never);
  serve      the binaural path: binaural_attention / base 64 / levels
             2,3,4,5 / bf16, random init from seed 0 with every γ then set
             to a seeded non-zero value (γ is zero at init, which would make
             the answer independent of the attention); the same loadtest and
             checks, B1 once and B2 four times per device batch, and the
             answer must change when γ is set back to zero;
  profile    host wall and device time of one served batch (sizes 1, 16)
             for each path, and B2's share of the binaural device time;
  f32_vs_cpu each model seeded in float32 (TF32 off) through
             `predict_meters` on the card and on the CPU;
  kernels    one line listing every kernel with its numbers at its main
             shape.
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

# (fp32 TFLOP/s on the CUDA cores, HBM TB/s, dense bf16 tensor TFLOP/s),
# NVIDIA data sheets
PEAKS = {"H100 SXM": (67.0, 3.35, 989.0), "H100 PCIe": (51.0, 2.0, 756.0),
         "H100 NVL": (60.0, 3.9, 835.0)}
EX2_PER_CLOCK_PER_SM = 16  # the SFU's exp2 rate on sm_90
KERNEL_TOL = 1e-5          # B1 vs its plain version (see the kernel phase)
F32_VS_CPU_TOL = 1e-3      # relative to max |cpu|
SERVED_TOL = 2 ** -5       # served vs direct bf16 answer, relative to max |direct|
# B2 vs its plain version (see phase_kernel_b2)
B2_TOL = {"bfloat16": 2 ** -7, "float32": 1e-5}  # o, relative to max |v|
B2_LSE_TOL = 1e-4                                 # lse, relative to max(1, |lse|)
# (2B, N = M, dk, dv, dtype) of every B2 shape; level l of base 64 at 256²
# has N = (256 / 2^(l-1))², dk = C/8, dv = C; 2B = 32 is a serve batch of 16
B2_SHAPES = [
    ("level 2", 32, 16384, 16384, 16, 128, "bfloat16"),
    ("level 3", 32, 4096, 4096, 32, 256, "bfloat16"),
    ("level 4", 32, 1024, 1024, 64, 512, "bfloat16"),
    ("level 5", 32, 256, 256, 64, 512, "bfloat16"),
    ("level 2, batch 1", 2, 16384, 16384, 16, 128, "bfloat16"),
    ("level 3, float32", 2, 4096, 4096, 32, 256, "float32"),
    ("ragged", 4, 1000, 777, 32, 256, "bfloat16"),
]
B2_MAIN = "level 2"
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")


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


def _smi(query: str, fmt: str = "csv,noheader") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def phase_env(torch):
    smi = _smi("name,power.limit")
    max_sm_mhz = float(_smi("clocks.max.sm", "csv,noheader,nounits"))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(), "nvidia_smi": smi,
          "sms": n_sm, "max_sm_clock_mhz": max_sm_mhz})
    return smi, n_sm * max_sm_mhz * 1e6 * EX2_PER_CLOCK_PER_SM


def phase_build(build):
    t0 = time.perf_counter()
    logs = build.build(["fused_frontend", "flash_attention"])
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
    flops_peak, bw_peak, _ = peak
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


def _sdpa_ms(torch, q, k, v, scale):
    """(ms, backend) of `F.scaled_dot_product_attention` on the same inputs,
    restricted to its fused backends; (None, reason) where none takes the
    shapes. The math backend is never timed: it would materialise the
    [2B, N, M] scores (17 GB at level 2). A yardstick only: the port never
    calls SDPA."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q4, k4, v4 = (t.unsqueeze(1) for t in (q, k, v))
    refused = {}
    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name)

        def call():
            with sdpa_kernel([backend]):
                return F.scaled_dot_product_attention(q4, k4, v4, scale=scale)

        try:
            call()
            torch.cuda.synchronize()
        except RuntimeError as exc:  # this backend does not take the shapes
            refused[name] = str(exc).splitlines()[0][:80]
            continue
        return time_ms(torch, call, runs=10, warmup=2), name
    return None, f"no fused SDPA backend takes these shapes: {refused}"


def phase_kernel_b2(torch, np, fa, peak, ex2_rate):
    """B2 against its plain version on the card at the binaural shapes.

    q and k are drawn with standard deviation 3, so that the scores spread
    over several units and the online softmax rescales often. Tolerances:
    o in bf16 within 2^-7·max|v| (P is rounded to bf16 before P·V, about
    2^-9 relative per weight, and o to bf16, 2^-9); o in f32 within
    1e-5·max|v| (the f32 path is full fp32 with an approximate exp2 of
    about 2^-22 relative); lse within 1e-4·max(1, |lse|) (fp32 statistics
    in another summation order)."""
    flops_peak, bw_peak, tensor_peak = peak
    rows = []
    for label, b, n, m, dk, dv, dtype in B2_SHAPES:
        dt = getattr(torch, dtype)
        g = torch.Generator(device="cuda").manual_seed(n + m + dk + dv + b)
        q = (3 * torch.randn(b, n, dk, device="cuda", generator=g)).to(dt)
        k = (3 * torch.randn(b, m, dk, device="cuda", generator=g)).to(dt)
        v = torch.randn(b, m, dv, device="cuda", generator=g).to(dt)
        scale = 1.0 / dv ** 0.5  # the model's 1/sqrt(C), C = dv
        o, lse = fa.flash_cross_attention(q, k, v, scale)
        want_o, want_lse = fa.flash_cross_attention_fwd_plain(q, k, v, scale)
        torch.cuda.synchronize()
        assert o.shape == want_o.shape == (b, n, dv) and o.dtype == dt
        assert lse.shape == want_lse.shape == (b, n, 1) and torch.isfinite(o).all()
        vmax = float(v.abs().max())
        err = float((o.float() - want_o.float()).abs().max())
        lse_err = float(((lse - want_lse).abs() / want_lse.abs().clamp_min(1.0)).max())
        assert err <= B2_TOL[dtype] * vmax, f"B2 {label}: o differs by {err} (max|v| {vmax})"
        assert lse_err <= B2_LSE_TOL, f"B2 {label}: lse differs by {lse_err} relative"
        heavy = n * m * b > 2 ** 31
        ms = time_ms(torch, lambda: fa.flash_cross_attention(q, k, v, scale),
                     runs=10 if heavy else 50)
        plain_ms = time_ms(torch, lambda: fa.flash_cross_attention_fwd_plain(q, k, v, scale),
                           runs=3 if heavy else 20, warmup=1 if heavy else 3)
        library_ms, library = _sdpa_ms(torch, q, k, v, scale)
        es = q.element_size()
        flops = 2.0 * b * n * m * (dk + dv)
        ex2 = float(b) * n * m
        nbytes = es * b * (n * dk + m * dk + m * dv + n * dv) + 4.0 * b * n
        terms = {"operations": flops / ((tensor_peak if dtype == "bfloat16" else flops_peak)
                                        * 1e12),
                 "ex2": ex2 / ex2_rate, "bytes": nbytes / (bw_peak * 1e12)}
        bound_by = max(terms, key=terms.get)
        row = {"phase": "kernel", "name": fa.flash_cross_attention.name, "shape": label,
               "B": b, "N": n, "M": m, "dk": dk, "dv": dv, "dtype": dtype,
               "max_abs_err": err, "max_abs_v": vmax, "tol_abs": B2_TOL[dtype] * vmax,
               "lse_rel_err": lse_err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": terms[bound_by] * 1e3,
               "bound_by": "bytes" if bound_by == "bytes" else "operations",
               "bound_terms_ms": {k_: t * 1e3 for k_, t in terms.items()},
               "library_ms": library_ms, "library": library,
               "tflops": flops / (ms * 1e9)}
        emit(row)
        rows.append(row)
        del q, k, v, o, lse, want_o, want_lse
    return rows


def _post(port, wave):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                 data=wave.astype("float32").tobytes(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        shape = tuple(int(s) for s in resp.headers["X-Shape"].split(","))
        return resp.read(), shape


def measure_profile(torch, np, runner, share_of=None):
    """Host wall and device time of one served batch at ladder sizes 1 and
    16 (torch.profiler: kernel time summed over CUDA activities), and the
    share of device time of the kernels whose name holds `share_of`."""
    from torch.profiler import ProfilerActivity, profile

    out = {"phase": "profile", "model": runner.cfg.model.name}
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
        row = {
            "wall_ms_median": statistics.median(walls) * 1e3,
            "device_ms_per_batch": device_us / 5 / 1e3 if device_us else "not measured",
            "device_busy_share": device_us / 1e6 / wall if device_us else "not measured",
            "n_kernel_names": len(kernels),
            "top_us_per_batch": [[k[:60], d / 5] for d, k in kernels[:8]]}
        if share_of:
            mine = sum(d for d, k in kernels if share_of in k)
            row[f"{share_of}_share"] = mine / device_us if device_us else "not measured"
            row[f"{share_of}_ms_per_batch"] = mine / 5 / 1e3
        out[f"bs{bs}"] = row
    return out


def _gammas(model):
    return [m.gamma for m in model.attention_modules.values()]


def set_gammas(torch, np, model, seed: int = 1234):
    """Give every attention gate a seeded γ ~ N(0, 0.5): γ is zero at init,
    and a zero γ makes the answer independent of the attention."""
    values = np.random.default_rng(seed).normal(0.0, 0.5, len(_gammas(model)))
    with torch.no_grad():
        for gamma, value in zip(_gammas(model), values):
            gamma.fill_(float(value))
    return [float(x) for x in values]


# the two serve paths: flags, the launches each kernel makes per device
# batch, and the kernel whose share of device time the profile reports
SERVE_PATHS = {
    "unet_baseline": {
        "argv": ["--generator", "unet_256", "--ngf", "64"],
        "per_batch": {"fused_mel_frontend": 1, "flash_cross_attention_fwd": 0},
        "share_of": None},
    "binaural_attention": {
        "argv": ["--model", "binaural_attention", "--base_channels", "64",
                 "--attention_levels", "2,3,4,5"],
        "per_batch": {"fused_mel_frontend": 1, "flash_cross_attention_fwd": 4},
        "share_of": "flash_fwd"},
}


def phase_serve(torch, np, serve, kernels, path: str):
    spec = SERVE_PATHS[path]
    args = serve.build_parser().parse_args(
        ["--random_init", "--seed", "0", *spec["argv"],
         "--compute_dtype", "bfloat16", "--batch_ladder", "1,4,16",
         "--loadtest", "48", "--loadtest_concurrency", "8"])
    cfg, task, source = serve.load_serving_state(args)
    assert cfg.dataset.images_size == 256 and cfg.dataset.name == "batvisionv2"
    assert cfg.model.name == path
    gammas = set_gammas(torch, np, task.model) if path == "binaural_attention" else None
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
        gamma_effect = None
        if gammas is not None:
            # the same model with every γ at zero must answer differently
            saved = [g.detach().clone() for g in _gammas(task.model)]
            with torch.no_grad():
                for g in _gammas(task.model):
                    g.zero_()
            no_attention = runner.run(wave[None])[0, ..., 0]
            with torch.no_grad():
                for g, v in zip(_gammas(task.model), saved):
                    g.copy_(v)
            gamma_effect = float(np.abs(direct - no_attention).max())
        profile = measure_profile(torch, np, runner, spec["share_of"])
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
    expected = {name: k * device_batches for name, k in spec["per_batch"].items()}
    assert launches == expected, f"{path}: launches {launches}, expected {expected}"
    if gammas is not None:
        assert gamma_effect > SERVED_TOL * scale, f"γ does not reach the answer: {gamma_effect}"
    emit({"phase": "serve", "model": path, "flags": spec["argv"],
          "params": n_params, "images_size": 256, "compute_dtype": "bfloat16",
          "weights": source, "gammas_set_to": gammas, "ladder": runner.ladder,
          "warmup_s": warm, "requests": res["requests"], "answered": res["answered"],
          "bad_responses": res["bad_responses"], "concurrency": res["concurrency"],
          "warmup_http": {k: warm_http[k] for k in ("throughput_rps", "p50_ms", "p99_ms")},
          "throughput_rps": res["throughput_rps"], "p50_ms": res["p50_ms"],
          "p95_ms": res["p95_ms"], "p99_ms": res["p99_ms"],
          "device_batches": device_batches, "mean_batch_fill": stats.get("mean_batch_fill"),
          "launches": launches, "expected_launches": expected,
          "served_vs_direct_max_abs": served_err, "direct_max_abs": scale,
          "direct_repeat_max_abs": float(np.abs(direct_again - direct).max()),
          "gamma_zero_vs_set_max_abs": gamma_effect,
          "depth_range_m": [float(served.min()), float(served.max())],
          "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20})
    emit(profile)
    return launches


def phase_f32_vs_cpu(torch, np, configs, models, path: str):
    """The same seeded model in float32 (TF32 off) through `predict_meters`
    on the card and on the CPU, at full width, 256² and batch 1; the
    binaural model with every γ non-zero, so B2's f32 path is in the sum."""
    cfg = configs.load_config("batvisionv2", "test", model_name=path, overrides={
        "mode.compute_dtype": "float32"})
    cpu = models.make_task(cfg, device="cpu")
    models.init_weights(cpu.model, torch.Generator().manual_seed(0))
    if path == "binaural_attention":
        set_gammas(torch, np, cpu.model)
    gpu = models.make_task(cfg, device="cuda")
    gpu.model.load_state_dict(cpu.model.state_dict(), strict=True)
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    wave = (np.random.default_rng(11).standard_normal((1, 2, 7782)) * 0.05).astype(np.float32)
    t0 = time.perf_counter()
    want = cpu.predict_meters({"waveform": wave}).numpy()
    cpu_s = time.perf_counter() - t0
    got = gpu.predict_meters({"waveform": wave}).cpu().numpy()
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape == (1, 256, 256, 1) and np.isfinite(got).all()
    assert scale > 0 and err <= F32_VS_CPU_TOL * scale, (err, scale)
    emit({"phase": "f32_vs_cpu", "model": path, "max_abs_err": err, "max_abs_cpu": scale,
          "rel_err": err / scale, "tol_rel": F32_VS_CPU_TOL, "cpu_seconds": cpu_s})


def kernel_entry(wrapper, source, replaces, rows, main_row, launches, peak_name):
    """One entry of the `kernels` line: numbers at the kernel's main shape,
    the largest error over all its shapes, launches summed over the paths."""
    mine = [r for r in rows if r["name"] == wrapper.name]
    return {
        "name": wrapper.name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": sum(by_path[wrapper.name] for by_path in launches.values()),
        "launches_by_path": {p: by_path[wrapper.name] for p, by_path in launches.items()},
        "max_abs_err": max(r["max_abs_err"] for r in mine),
        **{k: main_row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                    "library", "main_shape")},
        "peak": peak_name}


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
    from audiodepth_tpu_torch.ops.cuda import KERNELS, _build
    from audiodepth_tpu_torch.ops.cuda import flash_attention as fa
    from audiodepth_tpu_torch.ops.cuda import fused_frontend as ff

    configure_precision()
    smi, ex2_rate = phase_env(torch)
    peak_name, peak = peak_for(torch.cuda.get_device_name(0))
    phase_build(_build)
    b1_rows = phase_kernel(torch, np, ff, peak)
    b2_rows = phase_kernel_b2(torch, np, fa, peak, ex2_rate)
    launches = {path: phase_serve(torch, np, serve, KERNELS, path) for path in SERVE_PATHS}
    for path in SERVE_PATHS:
        phase_f32_vs_cpu(torch, np, configs, models, path)

    b1 = next(r for r in b1_rows if r["bc"] == 32 and r["L"] == 7782)
    b1_main = dict(b1, main_shape="B*C=32, L=7782", ms=b1["us"] / 1e3,
                   plain_ms=b1["plain_us"] / 1e3, bound_ms=b1["bound_us"] / 1e3,
                   # no single PyTorch call computes the fused STFT→mel→log→min-max
                   library_ms=None, library=None)
    b2_main = dict(next(r for r in b2_rows if r["shape"] == B2_MAIN),
                   main_shape="level 2: 2B=32, N=M=16384, dk=16, dv=128, bf16")
    main_rows = {ff.fused_mel_frontend.name: (b1_rows, b1_main),
                 fa.flash_cross_attention.name: (b2_rows, b2_main)}
    kernels = [kernel_entry(w, src, rep, *main_rows[w.name], launches, peak_name)
               for w, src, rep in KERNELS]
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
