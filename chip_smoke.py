#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`audiodepth_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure raises and the script exits
non-zero:
  env        torch / CUDA versions, the card's name, power limit, SMs and
             maximum SM clock;
  build      compile every CUDA kernel of the port from `csrc/` (nvcc, one
             process per source, all started together), its seconds,
             ptxas's registers and spills per kernel, and the count of
             HGMMA (wgmma) instructions per kernel in `cuobjdump -sass` of
             the built libraries (B2 and B3 must have some);
  kernel     each kernel against its plain PyTorch version on the card at
             the shapes its path gives it, max |Δ| asserted, and its time,
             the plain version's time, the card's bound for the same work
             and, where one PyTorch call computes the same function, that
             call's time: B1 (the mel front end), B2 (flash
             cross-attention forward) and B3 (its backward), each at the
             four binaural level shapes of a batch of 16, level 2 of a
             batch of 1, float32, and ragged shapes that reach every
             branch of the plan (`fwd_plan` / `bwd_plan`: dk 8 and 40
             padded, dv 136 and 320, N and M not multiples of 64, N = 1),
             each row naming the plan it ran;
  autograd   `cross_attention` gradients through FlashCrossAttentionFn
             (B2 forward, B3 backward) against autograd of the blockwise
             plain path on the card, level 3 in bf16, level 2 in f32;
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
  train      the training path: `cli/train.py`'s main in-process, the
             binaural net at base 64, levels 2-5, 256², bf16, remat on,
             batch 16, 64 synthetic samples (4 steps) and one validation
             pass of 64, with every γ set non-zero after init; every loss
             and grad_norm finite, every parameter moved, every attention
             projection's first-step gradient non-zero, and the launches
             per train step (B1 1, B2 4, B3 4) and per eval batch (B1 1,
             B2 4, B3 0); then 8 steps on one repeated batch, whose last
             loss must be below its first, timed step by step;
  f32_train_vs_cpu  one seeded float32 train step (TF32 off) at full
             width, 256², batch 2, γ non-zero, on the card and on the CPU
             from one state_dict, and in float64 on the CPU: the losses,
             and the card's gradients as close to the float64 ones as the
             CPU's float32 gradients are;
  profile    one bf16 train step at batch 16: host wall, device time, busy
             share, top items, B2's and B3's shares;
  kernels    one line listing every kernel with its numbers at its main
             shape, its launches on each path (by plan variant where the
             plan has several) and its SASS HGMMA count.
The last line is {"ok": true, "device": {...}}. Without a CUDA device, or
without the repository beside it, the script exits non-zero before printing
any result.
"""

from __future__ import annotations

import json
import os
import re
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
    # the plan's other branches: dk padded to 16 and 64, dv tiles of 64 and
    # 192, two forward dv slices and two B3 warpgroups sharing dv, one q row
    ("dk 8, ragged", 2, 300, 200, 8, 64, "bfloat16"),
    ("dk 40, dv 136, ragged", 2, 333, 129, 40, 136, "bfloat16"),
    ("dk 24, dv 320, ragged", 2, 200, 150, 24, 320, "bfloat16"),
    ("N 1", 2, 1, 70, 16, 128, "bfloat16"),
]
B2_MAIN = "level 2"
# B3 vs its plain version, relative to the plain version's max |·| of each
# of dq, dk, dv: in bf16, p and ds are rounded to bf16 before their products
# (2^-9 relative each) and the outputs to bf16 (2^-9), in sums of up to
# 16384 terms whose rounding errors partly cancel: 2^-6; in f32 the path is
# full fp32 with an approximate exp2 (2^-22 relative) and atomics in
# another order: 1e-4
B3_TOL = {"bfloat16": 2 ** -6, "float32": 1e-4}  # also the autograd phase's
F32_TRAIN_TOL = 1e-3   # train loss, card vs CPU in float32, relative
F32_GRAD_FACTOR = 2.0  # card's f32 gradient error vs the CPU's, both against f64 (see phase)
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


def kernel_name(text: str) -> str:
    """`flash_bwd_wgmma_kernel<16,128>` from a line holding its mangled name
    (the line itself where there is none)."""
    m = re.search(r"((?:flash_fwd|flash_bwd|fused_mel)\w*?_kernel)(I(?:Li\d+E)+E)?", text)
    if not m:
        return text.strip()
    args = re.findall(r"Li(\d+)E", m.group(2) or "")
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


def sass_hgmma(build, names) -> dict:
    """{kernel: its count of HGMMA (wgmma) instructions} in `cuobjdump
    -sass` of each built library."""
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    counts, name = {}, None
    for lib in names:
        out = subprocess.run([tool, "-sass", str(build.library_path(lib))], capture_output=True,
                             text=True, timeout=300, check=True).stdout
        for ln in out.splitlines():
            if "Function :" in ln:
                name = kernel_name(ln.split("Function :")[-1])
                counts.setdefault(name, 0)
            elif name and "HGMMA" in ln:
                counts[name] += 1
    return counts


def ptxas_report(logs) -> dict:
    """{kernel (template argument in <>): ptxas's registers and spills}
    from nvcc's `-Xptxas -v` output."""
    report, name = {}, None
    for log in logs.values():
        for ln in log.splitlines():
            if "entry function" in ln:
                name = kernel_name(ln)
            elif name and ("registers" in ln or "spill" in ln):
                part = ln.split("Used ")[-1].strip() if "registers" in ln else ln.strip()
                report[name] = f"{report[name]}; {part}" if name in report else part
    return report


def phase_build(build):
    # one library per source; B2 and B3 share csrc/flash_attention.cu
    names = ["fused_frontend", "flash_attention"]
    t0 = time.perf_counter()
    logs = build.build(names)
    seconds = time.perf_counter() - t0
    report = ptxas_report(logs)
    hgmma = sass_hgmma(build, names)
    emit({"phase": "build", "seconds": seconds, "built": sorted(logs), "ptxas": report,
          "sass_hgmma": hgmma})
    return report, hgmma

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


def plan_dict(plan) -> dict:
    return {"variant": plan.variant, "dkp": plan.dkp, "dvs": plan.dvs,
            "n_slices": plan.n_slices, "stages": plan.stages, "smem_bytes": plan.smem_bytes,
            "grid": list(plan.grid), "block": plan.block, "blocks_per_sm": plan.blocks_per_sm}


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
               "plan": plan_dict(fa.fwd_plan(b, n, m, dk, dv, dt)),
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


def _sdpa_bwd_ms(torch, q, k, v, do, scale):
    """(ms, backend) of the backward of `F.scaled_dot_product_attention` on
    its memory-efficient backend, the only fused one that takes dk != dv:
    `torch.autograd.grad` of its output alone is timed. A yardstick only."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q4, k4, v4 = (t.unsqueeze(1).detach().requires_grad_() for t in (q, k, v))
    do4 = do.unsqueeze(1)
    try:
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            out = F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
        torch.autograd.grad(out, (q4, k4, v4), do4, retain_graph=True)
        torch.cuda.synchronize()
    except RuntimeError as exc:  # the backend does not take the shapes
        return None, "EFFICIENT_ATTENTION refused: " + str(exc).splitlines()[0][:80]
    ms = time_ms(torch, lambda: torch.autograd.grad(out, (q4, k4, v4), do4, retain_graph=True),
                 runs=10, warmup=2)
    return ms, "EFFICIENT_ATTENTION backward"


def phase_kernel_b3(torch, fa, peak, ex2_rate):
    """B3 against its plain version on the card at B2's shapes, from B2's
    forward on inputs drawn as B2's phase draws them (q, k with standard
    deviation 3) and do ~ N(0, 1). Tolerances: B3_TOL."""
    flops_peak, bw_peak, tensor_peak = peak
    rows = []
    for label, b, n, m, dk, dv, dtype in B2_SHAPES:
        dt = getattr(torch, dtype)
        g = torch.Generator(device="cuda").manual_seed(n + m + dk + dv + b)
        q = (3 * torch.randn(b, n, dk, device="cuda", generator=g)).to(dt)
        k = (3 * torch.randn(b, m, dk, device="cuda", generator=g)).to(dt)
        v = torch.randn(b, m, dv, device="cuda", generator=g).to(dt)
        do = torch.randn(b, n, dv, device="cuda", generator=g).to(dt)
        scale = 1.0 / dv ** 0.5
        o, lse = fa.flash_cross_attention(q, k, v, scale)
        got = fa.flash_cross_attention_bwd(q, k, v, o, lse, do, scale)
        want = fa.flash_cross_attention_bwd_plain(q, k, v, o, lse, do, scale)
        torch.cuda.synchronize()
        errs, maxes = {}, {}
        for name, a, w, shape in zip(("dq", "dk", "dv"), got, want,
                                     ((b, n, dk), (b, m, dk), (b, m, dv))):
            assert a.shape == w.shape == shape and a.dtype == dt, (label, name, a.shape)
            assert torch.isfinite(a).all(), f"B3 {label}: {name} is not finite"
            maxes[name] = float(w.float().abs().max())
            errs[name] = float((a.float() - w.float()).abs().max())
            assert errs[name] <= B3_TOL[dtype] * maxes[name], \
                f"B3 {label}: {name} differs by {errs[name]} (max {maxes[name]})"
        del got, want
        heavy = n * m * b > 2 ** 31
        ms = time_ms(torch, lambda: fa.flash_cross_attention_bwd(q, k, v, o, lse, do, scale),
                     runs=10 if heavy else 50)
        plain_ms = time_ms(torch, lambda: fa.flash_cross_attention_bwd_plain(
            q, k, v, o, lse, do, scale), runs=3 if heavy else 20, warmup=1 if heavy else 3)
        library_ms, library = _sdpa_bwd_ms(torch, q, k, v, do, scale)
        es = q.element_size()
        flops = 2.0 * b * n * m * (3 * dk + 2 * dv)  # s, pᵀ·do, do·vᵀ, dsᵀ·q, ds·k
        ex2 = float(b) * n * m
        # in: q, k, v, o, do, lse; out: dq, dk, dv
        nbytes = es * b * (2 * n * dk + 2 * m * dk + 2 * m * dv + 2 * n * dv) + 4.0 * b * n
        terms = {"operations": flops / ((tensor_peak if dtype == "bfloat16" else flops_peak)
                                        * 1e12),
                 "ex2": ex2 / ex2_rate, "bytes": nbytes / (bw_peak * 1e12)}
        bound_by = max(terms, key=terms.get)
        row = {"phase": "kernel", "name": fa.flash_cross_attention_bwd.name, "shape": label,
               "B": b, "N": n, "M": m, "dk": dk, "dv": dv, "dtype": dtype,
               "plan": plan_dict(fa.bwd_plan(b, n, m, dk, dv, dt)),
               "max_abs_err": max(errs.values()), "max_abs_err_by_grad": errs,
               "max_abs_plain": maxes, "tol_rel": B3_TOL[dtype],
               "ms": ms, "plain_ms": plain_ms, "bound_ms": terms[bound_by] * 1e3,
               "bound_by": "bytes" if bound_by == "bytes" else "operations",
               "bound_terms_ms": {k_: t * 1e3 for k_, t in terms.items()},
               "library_ms": library_ms, "library": library,
               "tflops": flops / (ms * 1e9)}
        emit(row)
        rows.append(row)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return rows


def phase_autograd(torch, fa, blockwise):
    """`cross_attention` (FlashCrossAttentionFn: B2 forward, B3 backward)
    against autograd of the blockwise plain path on the card, values and
    gradients, at level 3 (2B = 32) in bf16 and level 2 (2B = 2) in f32."""
    for label, b, n, dk, dv, dtype in (("level 3", 32, 4096, 32, 256, "bfloat16"),
                                       ("level 2, batch 1", 2, 16384, 16, 128, "float32")):
        dt = getattr(torch, dtype)
        g = torch.Generator(device="cuda").manual_seed(b + n)
        q, k, v = ((torch.randn(b, n, d, device="cuda", generator=g)).to(dt).requires_grad_()
                   for d in (dk, dk, dv))
        do = torch.randn(b, n, dv, device="cuda", generator=g).to(dt)
        scale = 1.0 / dv ** 0.5
        before = fa.flash_cross_attention_bwd.launches
        got = torch.autograd.grad(fa.cross_attention(q, k, v, scale), (q, k, v), do)
        assert fa.flash_cross_attention_bwd.launches == before + 1
        want = torch.autograd.grad(blockwise(q, k, v, scale, block_q=512), (q, k, v), do)
        rel = {}
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            assert torch.isfinite(a).all()
            rel[name] = float((a.float() - w.float()).abs().max()) / float(w.float().abs().max())
            assert rel[name] <= B3_TOL[dtype], f"autograd {label}: {name} off by {rel}"
        emit({"phase": "autograd", "shape": label, "dtype": dtype, "rel_err": rel,
              "tol_rel": B3_TOL[dtype]})
        del q, k, v, do, got, want
        torch.cuda.empty_cache()


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


def reset_launches(kernels) -> None:
    """Every count to 0, just before a path is driven."""
    for wrapper, _, _ in kernels:
        wrapper.launches = 0
        if hasattr(wrapper, "variant_launches"):
            wrapper.variant_launches.clear()


def read_launches(kernels):
    """({kernel: launches}, {kernel: {plan variant: launches}}) since the reset."""
    return ({w.name: w.launches for w, _, _ in kernels},
            {w.name: dict(w.variant_launches) for w, _, _ in kernels
             if hasattr(w, "variant_launches")})


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
        "per_batch": {"fused_mel_frontend": 1, "flash_cross_attention_fwd": 0,
                      "flash_cross_attention_bwd": 0},
        "share_of": None},
    "binaural_attention": {
        "argv": ["--model", "binaural_attention", "--base_channels", "64",
                 "--attention_levels", "2,3,4,5"],
        "per_batch": {"fused_mel_frontend": 1, "flash_cross_attention_fwd": 4,
                      "flash_cross_attention_bwd": 0},
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
    reset_launches(kernels)
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
        launches, by_variant = read_launches(kernels)
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
          "launches": launches, "launches_by_variant": by_variant,
          "expected_launches": expected, "served_vs_direct_max_abs": served_err, "direct_max_abs": scale,
          "direct_repeat_max_abs": float(np.abs(direct_again - direct).max()),
          "gamma_zero_vs_set_max_abs": gamma_effect,
          "depth_range_m": [float(served.min()), float(served.max())],
          "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20})
    emit(profile)
    return launches, by_variant


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


# the training path: flags of cli/train.py's main, and the launches each
# kernel makes per train step and per eval batch
TRAIN_BATCH = 16
TRAIN_ARGV = ["--dataset", "synthetic", "--model", "binaural_attention",
              "--base_channels", "64", "--attention_levels", "2,3,4,5",
              "--compute_dtype", "bfloat16", "--batch_size", str(TRAIN_BATCH),
              "--num_samples", "64", "--epochs", "1", "--validation", "true",
              "--validation_iter", "1", "--seed", "0"]
VAL_SAMPLES = 64  # the synthetic val split (data/batvision.py)
PER_TRAIN_STEP = {"fused_mel_frontend": 1, "flash_cross_attention_fwd": 4,
                  "flash_cross_attention_bwd": 4}
PER_EVAL_BATCH = {"fused_mel_frontend": 1, "flash_cross_attention_fwd": 4,
                  "flash_cross_attention_bwd": 0}
REPEATED_STEPS = 8


def phase_train(torch, np, train_cli, kernels):
    """cli/train.py's main in-process on the card (see the module note),
    then REPEATED_STEPS steps on one batch, timed, and a profile of one."""
    from audiodepth_tpu_torch.data.batvision import make_dataset

    seen, steps = {}, []

    def on_task(task):
        seen["task"] = task
        seen["gammas"] = set_gammas(torch, np, task.model)
        seen["before"] = {n: p.detach().clone() for n, p in task.model.named_parameters()}

    def on_step(state, metrics):
        if not steps:  # the first step's gradients are still on the parameters
            seen["first_grads"] = {
                n: float(p.grad.abs().max()) for n, p in state.model.named_parameters()
                if n.startswith("attention_modules.") and ".gamma" not in n}
        steps.append(metrics)

    reset_launches(kernels)
    t0 = time.perf_counter()
    eng, state = train_cli.main(TRAIN_ARGV, on_task=on_task, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, by_variant = read_launches(kernels)
    task, record = seen["task"], eng.history[-1]
    cfg = task.cfg
    assert cfg.dataset.images_size == 256 and cfg.model.base_channels == 64
    assert cfg.mode.compute_dtype == "bfloat16" and task.model.left_encoder.remat
    assert tuple(cfg.model.attention_levels) == (2, 3, 4, 5)
    losses = [float(m["loss"]) for m in steps]
    norms = [float(m["grad_norm"]) for m in steps]
    assert len(steps) == 64 // TRAIN_BATCH, len(steps)
    assert all(np.isfinite(losses)) and all(np.isfinite(norms)), (losses, norms)
    unmoved = [n for n, p in task.model.named_parameters()
               if torch.equal(p.detach(), seen["before"][n])]
    assert not unmoved, f"parameters that did not move: {unmoved[:8]}"
    zero = [n for n, g in seen["first_grads"].items() if not g > 0]
    assert len(seen["first_grads"]) == 4 * 8 and not zero, f"zero attention gradients: {zero}"
    n_eval = -(-VAL_SAMPLES // TRAIN_BATCH)
    expected = {name: PER_TRAIN_STEP[name] * len(steps) + PER_EVAL_BATCH[name] * n_eval
                for name in PER_TRAIN_STEP}
    assert launches == expected, f"train: launches {launches}, expected {expected}"
    val = record["val"]
    assert val and all(np.isfinite(v) for v in val.values()), val

    # one batch, repeated: the loss must fall; each step timed to its end
    ds = make_dataset(cfg, "train", num_samples=TRAIN_BATCH)
    batch = eng.encode(next(ds.batches(TRAIN_BATCH, shuffle=False)))
    torch.cuda.reset_peak_memory_stats()
    rep_losses, times = [], []
    for _ in range(REPEATED_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, metrics = eng.train_step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        rep_losses.append(float(metrics["loss"]))
    assert all(np.isfinite(rep_losses)) and rep_losses[-1] < rep_losses[0], rep_losses
    step_ms = statistics.median(times[1:]) * 1e3
    emit({"phase": "train", "flags": TRAIN_ARGV, "remat": True, "gammas_set_to": seen["gammas"],
          "params": sum(p.numel() for p in task.model.parameters()),
          "steps": len(steps), "eval_batches": n_eval, "losses": losses, "grad_norms": norms,
          "first_step_attention_grad_min": min(seen["first_grads"].values()),
          "launches": launches, "launches_by_variant": by_variant,
          "expected_launches": expected, "epoch_record": record,
          "main_wall_s": wall, "repeated_batch_losses": rep_losses,
          "step_ms_median": step_ms, "step_ms_all": [t * 1e3 for t in times],
          "pairs_per_sec": TRAIN_BATCH / (step_ms / 1e3),
          "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20})
    emit(profile_train_step(torch, eng, state, batch))
    return launches, by_variant


def profile_train_step(torch, eng, state, batch):
    """Host wall and device time of one bf16 train step (torch.profiler:
    kernel time summed over CUDA activities), the top items, and the shares
    of B2 (flash_fwd) and B3 (flash_bwd)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.train_step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = sorted(
        ((e.self_device_time_total, e.key) for e in prof.key_averages()
         if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0),
        reverse=True)
    device_us = sum(d for d, _ in kernels)
    row = {"phase": "profile", "model": "binaural_attention", "what": "one bf16 train step",
           "batch": TRAIN_BATCH, "wall_ms": wall * 1e3,
           "device_ms": device_us / 1e3 if device_us else "not measured",
           "device_busy_share": device_us / 1e6 / wall if device_us else "not measured",
           "n_kernel_names": len(kernels),
           "top_ms": [[k[:60], d / 1e3] for d, k in kernels[:12]]}
    for tag in ("flash_fwd", "flash_bwd"):
        mine = sum(d for d, k in kernels if tag in k)
        row[f"{tag}_ms"] = mine / 1e3
        row[f"{tag}_share"] = mine / device_us if device_us else "not measured"
    return row


def phase_f32_train_vs_cpu(torch, np, configs, models):
    """One seeded float32 train step (TF32 off) at full width, 256², batch
    2, every γ non-zero, on the card and on the CPU from one state_dict, and
    the same step in float64 on the CPU as the reference.

    The loss: card within F32_TRAIN_TOL of the CPU's float32 loss. The
    gradients: this step's float32 gradient field is ill-conditioned (the
    CPU's own float32 gradients are 0.8 % off its float64 ones in global L2,
    7 % on the worst tensor), so a float32-vs-float32 gate at 1e-3 fails
    for correct code. Both float32 gradients are measured against float64,
    each tensor relative to max(its max, 1e-3 · the largest max over all
    tensors), and the card must be as close as the CPU: its global
    relative L2 error within F32_GRAD_FACTOR × the CPU's, and its worst
    tensor within F32_GRAD_FACTOR × the CPU's worst. A wrong kernel moves
    the tensors it feeds by O(1) and fails both."""
    from audiodepth_tpu_torch.data.batvision import make_dataset

    def cfg_for(dtype):
        return configs.load_config("synthetic", "train", model_name="binaural_attention",
                                   overrides={"mode.compute_dtype": dtype})

    cpu = models.make_task(cfg_for("float32"), device="cpu")
    models.init_weights(cpu.model, torch.Generator().manual_seed(0))
    set_gammas(torch, np, cpu.model)
    state_dict = cpu.model.state_dict()
    gpu = models.make_task(cfg_for("float32"), device="cuda")
    gpu.model.load_state_dict(state_dict, strict=True)
    ref = models.make_task(cfg_for("float64"), device="cpu")
    ref.model.double().load_state_dict(state_dict, strict=True)
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    batch = next(make_dataset(cfg_for("float32"), "train", num_samples=2).batches(2, shuffle=False))

    def step(task):
        t0 = time.perf_counter()
        task.model.zero_grad(set_to_none=True)
        dev = {k: torch.from_numpy(v).to(task.device) for k, v in batch.items()}
        loss, _ = task.loss_fn(dev, 0.0)
        loss.backward()
        grads = {n: p.grad.detach().cpu().double() for n, p in task.model.named_parameters()}
        return loss.item(), grads, time.perf_counter() - t0

    want_loss, want, cpu_s = step(ref)
    cpu_loss, cpu_grads, cpu32_s = step(cpu)
    got_loss, got, _ = step(gpu)
    assert np.isfinite(got_loss) and abs(got_loss - cpu_loss) <= F32_TRAIN_TOL * abs(cpu_loss)
    gmax = max(float(g.abs().max()) for g in want.values())
    ref_l2 = float(torch.sqrt(sum((g * g).sum() for g in want.values())))

    def errors(grads):
        per = {n: float((grads[n] - w).abs().max()) / max(float(w.abs().max()), 1e-3 * gmax)
               for n, w in want.items()}
        l2 = float(torch.sqrt(sum(((grads[n] - w) ** 2).sum() for n, w in want.items())))
        return per, l2 / ref_l2

    card_per, card_l2 = errors(got)
    cpu_per, cpu_l2 = errors(cpu_grads)
    worst = max(card_per, key=card_per.get)
    cpu_worst = max(cpu_per.values())
    assert card_l2 <= F32_GRAD_FACTOR * cpu_l2, (card_l2, cpu_l2)
    assert card_per[worst] <= F32_GRAD_FACTOR * cpu_worst, (worst, card_per[worst], cpu_worst)
    # the per-tensor measure card vs CPU float32, as reported before the f64 reference
    vs_cpu32 = max(float((got[n] - g).abs().max()) / max(float(g.abs().max()), 1e-3 * gmax)
                   for n, g in cpu_grads.items())
    attention = max(v for n, v in card_per.items() if n.startswith("attention_modules."))
    emit({"phase": "f32_train_vs_cpu", "loss_f64": want_loss, "loss_cpu_f32": cpu_loss,
          "loss_card_f32": got_loss, "loss_tol_rel": F32_TRAIN_TOL,
          "card_vs_f64_global_l2_rel": card_l2, "cpu_f32_vs_f64_global_l2_rel": cpu_l2,
          "card_vs_f64_worst_tensor": [worst, card_per[worst]],
          "cpu_f32_vs_f64_worst_tensor": cpu_worst, "grad_factor": F32_GRAD_FACTOR,
          "card_vs_f64_worst_attention_tensor": attention,
          "card_vs_cpu_f32_worst_tensor": vs_cpu32,
          "tensors_over_1e-3": {"card": sum(v > 1e-3 for v in card_per.values()),
                                "cpu_f32": sum(v > 1e-3 for v in cpu_per.values()),
                                "of": len(card_per)},
          "largest_grad_max": gmax, "cpu_f64_seconds": cpu_s, "cpu_f32_seconds": cpu32_s})

# the prefix of each wrapper's kernels in the ptxas report
PTXAS_PREFIX = {"fused_mel_frontend": "fused_mel", "flash_cross_attention_fwd": "flash_fwd",
                "flash_cross_attention_bwd": "flash_bwd"}


def kernel_entry(wrapper, source, replaces, rows, main_row, launches, peak_name, ptxas, hgmma):
    """One entry of the `kernels` line: numbers at the kernel's main shape,
    the largest error over all its shapes, launches summed over the paths
    (and by plan variant), ptxas's registers and spills of each of its
    instantiations, and their HGMMA count in the SASS."""
    mine = [r for r in rows if r["name"] == wrapper.name]
    prefix = PTXAS_PREFIX[wrapper.name]
    by_function = {k: v for k, v in hgmma.items() if k.startswith(prefix)}
    entry = {
        "name": wrapper.name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": sum(counts[wrapper.name] for counts, _ in launches.values()),
        "launches_by_path": {p: counts[wrapper.name] for p, (counts, _) in launches.items()},
        "max_abs_err": max(r["max_abs_err"] for r in mine),
        **{k: main_row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                    "library", "main_shape")},
        "peak": peak_name,
        "ptxas": {k: v for k, v in ptxas.items() if k.startswith(prefix)},
        "sass": {"HGMMA": sum(by_function.values()), "HGMMA_by_function": by_function}}
    if hasattr(wrapper, "variant_launches"):
        entry["launches_by_variant"] = {p: by_variant[wrapper.name]
                                        for p, (_, by_variant) in launches.items()}
    return entry


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
    from audiodepth_tpu_torch.cli import train as train_cli
    from audiodepth_tpu_torch.ops.attention import blockwise_cross_attention
    from audiodepth_tpu_torch.ops.cuda import KERNELS, _build
    from audiodepth_tpu_torch.ops.cuda import flash_attention as fa
    from audiodepth_tpu_torch.ops.cuda import fused_frontend as ff

    configure_precision()
    smi, ex2_rate = phase_env(torch)
    peak_name, peak = peak_for(torch.cuda.get_device_name(0))
    ptxas, hgmma = phase_build(_build)
    b1_rows = phase_kernel(torch, np, ff, peak)
    b2_rows = phase_kernel_b2(torch, np, fa, peak, ex2_rate)
    b3_rows = phase_kernel_b3(torch, fa, peak, ex2_rate)
    phase_autograd(torch, fa, blockwise_cross_attention)
    launches = {f"serve {path}": phase_serve(torch, np, serve, KERNELS, path)
                for path in SERVE_PATHS}
    for path in SERVE_PATHS:
        phase_f32_vs_cpu(torch, np, configs, models, path)
    launches["train binaural_attention"] = phase_train(torch, np, train_cli, KERNELS)
    phase_f32_train_vs_cpu(torch, np, configs, models)

    b1 = next(r for r in b1_rows if r["bc"] == 32 and r["L"] == 7782)
    b1_main = dict(b1, main_shape="B*C=32, L=7782", ms=b1["us"] / 1e3,
                   plain_ms=b1["plain_us"] / 1e3, bound_ms=b1["bound_us"] / 1e3,
                   # no single PyTorch call computes the fused STFT→mel→log→min-max
                   library_ms=None, library=None)
    level2 = "level 2: 2B=32, N=M=16384, dk=16, dv=128, bf16"
    b2_main = dict(next(r for r in b2_rows if r["shape"] == B2_MAIN), main_shape=level2)
    b3_main = dict(next(r for r in b3_rows if r["shape"] == B2_MAIN), main_shape=level2)
    main_rows = {ff.fused_mel_frontend.name: (b1_rows, b1_main),
                 fa.flash_cross_attention.name: (b2_rows, b2_main),
                 fa.flash_cross_attention_bwd.name: (b3_rows, b3_main)}
    kernels = [kernel_entry(w, src, rep, *main_rows[w.name], launches, peak_name, ptxas, hgmma)
               for w, src, rep in KERNELS]
    for entry in kernels:  # the wgmma designs of B2 and B3 must be in the binary
        if entry["name"] != ff.fused_mel_frontend.name:
            assert entry["sass"]["HGMMA"] > 0, f"{entry['name']}: no HGMMA in its SASS"
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
