"""What holds kernels B2 and B3 back: each variant removes one part of
`csrc/flash_attention.cu` and the bf16 kernels are timed at the binaural
level-2 and level-3 shapes (2B = 32) against the unchanged source, on the
card.

    python3 -m audiodepth_tpu_torch.tools.flash_ablation

Variants (their answers are wrong; only their time is read):
  no_exp2       ex2.approx becomes a move: the MUFU work of p (B2, B3) and
                of the softmax rescale factors (B2) goes;
  no_rescale    B2 no longer rescales its O accumulator by alpha per tile;
  no_dq_reduce  B3 no longer adds each q tile's dq into global memory (the
                cp.reduce.async.bulk); the dq product and its shared-memory
                tile stay.
Each variant is a copy of `csrc/` under `build/ablation/<variant>/` with one
text patch (the patch must match exactly once, or the tool stops), built
with the port's nvcc flags, all builds started together. Times: medians of
CUDA-event-timed back-to-back launches, in turns (baseline first and last).
Prints one JSON line per (shape, variant) and the card's nvidia-smi name and
power limit.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from ..ops.cuda import _build
from ..ops.cuda import flash_attention as fa

VARIANTS = {
    "baseline": [],
    "no_exp2": [('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "y = x;")],
    "no_rescale": [("      acc[4 * j] *= alpha_lo;\n      acc[4 * j + 1] *= alpha_lo;\n"
                    "      acc[4 * j + 2] *= alpha_hi;\n      acc[4 * j + 3] *= alpha_hi;\n", "")],
    "no_dq_reduce": [("      bulk_reduce_add_f32(dq + (size_t(b) * N + size_t(it) * kBwdBQ) * dk, dq_s,\n"
                      "                          uint32_t(rows * dk * 4));\n", "      (void)rows;\n")],
}
# (label, 2B, N = M, dk, dv): binaural levels 2 and 3 at a batch of 16
SHAPES = [("level 2", 32, 16384, 16, 128), ("level 3", 32, 4096, 32, 256)]
OUT = _build.BUILD_DIR.parent / "ablation"


def build_variants() -> dict:
    """{variant: loaded library}, each compiled from a patched copy of csrc/."""
    procs = {}
    for name, patches in VARIANTS.items():
        src_dir = OUT / name
        shutil.rmtree(src_dir, ignore_errors=True)
        shutil.copytree(_build.CSRC, src_dir)
        src = src_dir / "flash_attention.cu"
        text = src.read_text()
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the patch matches {text.count(old)} times: {old!r}")
            text = text.replace(old, new)
        src.write_text(text)
        lib = src_dir / "libflash_attention.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = fa.bind(ctypes.CDLL(str(lib)))
    return libs


def time_ms(fn, runs: int) -> float:
    """Median per-call device time of back-to-back calls (CUDA events)."""
    for _ in range(3):
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


def main(runs: int = 20) -> int:
    if not torch.cuda.is_available():
        print("flash_ablation: no CUDA device is available", file=sys.stderr)
        return 1
    libs = build_variants()
    order = list(VARIANTS) + ["baseline"]  # in turns, the baseline first and last
    for label, b, n, dk, dv in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(n + dk + dv + b)
        q, k = ((3 * torch.randn(b, n, dk, device="cuda", generator=g)).bfloat16()
                for _ in range(2))
        v, do = (torch.randn(b, n, dv, device="cuda", generator=g).bfloat16() for _ in range(2))
        scale = 1.0 / dv ** 0.5
        o, lse = fa.flash_cross_attention(q, k, v, scale)
        times = {}
        for name in order:
            fwd = fa.FlashCrossAttention(library=lambda lib=libs[name]: lib)
            bwd = fa.FlashCrossAttentionBwd(library=lambda lib=libs[name]: lib)
            times.setdefault(name, []).append(
                (time_ms(lambda: fwd(q, k, v, scale), runs),
                 time_ms(lambda: bwd(q, k, v, o, lse, do, scale), runs)))
        for name, pairs in times.items():
            fwd_ms = statistics.mean(p[0] for p in pairs)
            bwd_ms = statistics.mean(p[1] for p in pairs)
            print(json.dumps({"tool": "flash_ablation", "shape": label, "B": b, "N": n, "M": n,
                              "dk": dk, "dv": dv, "variant": name, "b2_ms": fwd_ms,
                              "b3_ms": bwd_ms, "turns": len(pairs)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
