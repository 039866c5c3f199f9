"""What holds kernel B1 back: each variant removes one part of
`csrc/fused_frontend.cu` (or puts back a slower one) and the kernel is timed
through its wrapper, with the wrapper's plan, at the serving shapes (B·C =
2, 8, 32, L = 7782) against the unchanged source, on the card.

    python3 -m audiodepth_tpu_torch.tools.frontend_ablation

Variants (their answers are wrong; only their time is read):
  ieee_sqrt    the magnitude's sqrt.approx becomes the IEEE sqrtf;
  one_product  the DFT keeps only a1·b1 of its six bf16 products (the tensor
               work of a plain bf16 DFT);
  no_dft       the DFT's n-tile loop does not run (the A fragments are
               still loaded and split);
  no_mel       the mel product's loop over each filter's bins does not run;
  no_consts    no multicast copy of the constants and no wait for it;
  bare         no DFT, no mel product, no constants, no A-fragment loads:
               launch, cluster barriers, waveform segments, log, min-max
               and the output;
  empty        the kernel returns at once (the launch of the clusters).
Each variant is a copy of `csrc/` under `build/frontend_ablation/<variant>/`
with text patches (each must match exactly once, or the tool stops), built
with the port's nvcc flags, all builds started together. Times: medians of
CUDA-event-timed back-to-back launches, in turns (baseline first and last).
Prints one JSON line per (B·C, variant) and the card's nvidia-smi name and
power limit.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import statistics
import subprocess
import sys

import numpy as np
import torch

from ..ops.cuda import _build
from ..ops.cuda import fused_frontend as ff
from .flash_ablation import time_ms

_SQRT = [("mg[0] = sqrt_approx(c[0] * c[0] + c[1] * c[1]);",
          "mg[0] = sqrtf(c[0] * c[0] + c[1] * c[1]);"),
         ("mg[8 * ms] = sqrt_approx(c[2] * c[2] + c[3] * c[3]);",
          "mg[8 * ms] = sqrtf(c[2] * c[2] + c[3] * c[3]);")]
_NO_DFT = [("for (int nt0 = warp * NT; nt0 < n_ntiles;", "for (int nt0 = n_ntiles; nt0 < n_ntiles;")]
_NO_MEL = [("for (int k = 0; k < len; ++k) {", "for (int k = 0; k < 0; ++k) {")]
_NO_CONSTS = [("    if (c1 > c0)\n", "    if (false)\n"),
              ("if (wait) sm90::mbar_wait(bar, 0);", "(void)wait;")]
_NO_ALOAD = [("split3_bf16(s_seg[seg_index(i)], s_seg[seg_index(i + 1)],", "split3_bf16(float(i), 1.f,")]
VARIANTS = {
    "baseline": [],
    "ieee_sqrt": _SQRT,
    "one_product": [("for (int pr = 0; pr < 6; ++pr)", "for (int pr = 5; pr < 6; ++pr)")],
    "no_dft": _NO_DFT,
    "no_mel": _NO_MEL,
    "no_consts": _NO_CONSTS,
    "bare": _NO_DFT + _NO_MEL + _NO_CONSTS + _NO_ALOAD,
    "empty": [("  const SmemLayout lay(p.frames_per_block",
               "  if (p.bc >= 0) return;\n  const SmemLayout lay(p.frames_per_block")],
}
BCS = (2, 8, 32)
LENGTH = 7782
OUT = _build.BUILD_DIR.parent / "frontend_ablation"


def build_variants() -> dict:
    """{variant: loaded library}, each compiled from a patched copy of csrc/."""
    procs = {}
    for name, patches in VARIANTS.items():
        src_dir = OUT / name
        shutil.rmtree(src_dir, ignore_errors=True)
        shutil.copytree(_build.CSRC, src_dir)
        src = src_dir / "fused_frontend.cu"
        text = src.read_text()
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the patch matches {text.count(old)} times: {old!r}")
            text = text.replace(old, new)
        src.write_text(text)
        lib = src_dir / "libfused_frontend.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ff.bind(ctypes.CDLL(str(lib)))
    return libs


def main(runs: int = 50) -> int:
    if not torch.cuda.is_available():
        print("frontend_ablation: no CUDA device is available", file=sys.stderr)
        return 1
    libs = build_variants()
    order = list(VARIANTS) + ["baseline"]  # in turns, the baseline first and last
    for bc in BCS:
        rng = np.random.default_rng(bc)
        wave = torch.from_numpy((rng.standard_normal((bc // 2, 2, LENGTH)) * 0.05)
                                .astype(np.float32)).cuda()
        times = {}
        for name in order:
            wrapper = ff.FusedMelFrontend(library=lambda lib=libs[name]: lib)
            times.setdefault(name, []).append(time_ms(lambda: wrapper(wave), runs) * 1e3)
        for name, us in times.items():
            print(json.dumps({"tool": "frontend_ablation", "bc": bc, "L": LENGTH,
                              "variant": name, "us": statistics.mean(us), "turns_us": us}),
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
