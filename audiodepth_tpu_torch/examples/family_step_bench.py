"""Per-family train-step time at full width (port of
`examples/family_step_bench.py`).

Times each family's train step at a fixed batch (default 32) on one
device-resident batch (`Engine.put_batch` of the compact encoding, decoded
by every step): 3 warm-up steps, then 20 steps between two
`torch.cuda.synchronize()` calls. This measures the compute path; real
training overlaps the copies through `data.prefetch` or the device cache.
The peak memory is `torch.cuda.max_memory_allocated` over the family's
whole run (model, optimizer state and steps). Prints ms/step, pairs/s and
the peak per family, then a markdown table sorted by time.

    python -m audiodepth_tpu_torch.examples.family_step_bench [--bs 32]
    # one family, small, on the CPU (no memory figure there):
    python -c "from audiodepth_tpu_torch.examples.family_step_bench import time_family; \\
        print(time_family('base_residual', {}, bs=2, n_steps=2, warmup=1, device='cpu', \\
        overrides={'model.base_channels': 4, 'dataset.images_size': 32}))"

The weights are `models.init_weights` from mode.seed (0 unless overridden).
A family that fails raises: nothing is caught.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..cli.train import IMAGE_MODELS
from .._device import synchronize

# the full-width configurations (the presets; the coarse hybrid with 32 bins)
FAMILIES: List[Tuple[str, Dict[str, object]]] = [
    ("unet_baseline", {}),
    ("unet_cvae", {}),
    ("base_residual", {}),
    ("binaural_attention", {}),
    ("rgb_depth", {}),
    ("adabins_distillation", {}),
    ("coarse_depth", {"model.model_type": "hybrid", "model.n_bins": 32}),
]


def time_family(name: str, over: Dict[str, object], bs: int = 32, n_steps: int = 20,
                warmup: int = 3, overrides: Optional[Dict[str, object]] = None,
                device: str = "cuda") -> Dict[str, object]:
    """One family's row: ms a step, pairs/s, the peak device memory in MiB
    (None on the CPU), its parameter count and the last step's loss."""
    from ..configs import load_config
    from ..data.bins import add_bins_to_batch
    from ..data.codec import encode_batch
    from ..data.synthetic import SyntheticEchoDataset
    from ..models import init_weights, make_task
    from ..train.engine import Engine

    cfg = load_config("batvisionv2", "train", f"stepbench_{name}", name,
                      overrides={"mode.batch_size": bs, **over, **(overrides or {})})
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    ds = SyntheticEchoDataset(cfg, num_samples=bs, seed=0, with_image=name in IMAGE_MODELS)
    task = make_task(cfg, device=device)
    init_weights(task.model, torch.Generator().manual_seed(int(cfg.mode.seed)))
    eng = Engine(cfg, task)
    units = 1.0 if cfg.dataset.depth_norm else cfg.dataset.max_depth
    batch = next(ds.batches(bs, shuffle=False))
    if name == "coarse_depth":
        batch = add_bins_to_batch(batch, task.bin_edges, cfg.dataset.max_depth,
                                  cfg.dataset.depth_norm)
    state = eng.init_state()
    dev_batch = eng.put_batch(encode_batch(batch, units))
    for _ in range(warmup):
        state, m = eng.train_step(state, dev_batch)
    synchronize(eng.device)
    t0 = time.perf_counter()
    for _ in range(n_steps):
        state, m = eng.train_step(state, dev_batch)
    synchronize(eng.device)
    dt = (time.perf_counter() - t0) / n_steps
    peak = (torch.cuda.max_memory_allocated(eng.device) / 2**20
            if eng.device.type == "cuda" else None)
    return {"family": name, "ms_per_step": dt * 1e3, "pairs_per_s": bs / dt,
            "peak_mem_mib": peak, "params": sum(p.numel() for p in task.model.parameters()),
            "loss": float(m["loss"]), "batch": bs, "steps": n_steps}


def format_table(rows: List[Dict[str, object]]) -> str:
    lines = ["| family | ms/step | pairs/s | peak MiB |", "|---|---|---|---|"]
    for r in sorted(rows, key=lambda r: r["ms_per_step"]):
        peak = "not measured" if r["peak_mem_mib"] is None else f"{r['peak_mem_mib']:.0f}"
        lines.append(f"| {r['family']} | {r['ms_per_step']:.1f} | {r['pairs_per_s']:.1f} | "
                     f"{peak} |")
    return "\n".join(lines)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="per-family train-step time (PyTorch/CUDA)")
    p.add_argument("--bs", type=int, default=32)
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, object]]:
    from .._device import resolve_device

    args = build_parser().parse_args(argv)
    resolve_device(args.device)  # no card: raise before any work
    rows = []
    for name, over in FAMILIES:
        rows.append(time_family(name, over, args.bs, device=args.device))
        r = rows[-1]
        peak = "" if r["peak_mem_mib"] is None else f"  {r['peak_mem_mib']:8.0f} MiB peak"
        print(f"{name:28s} {r['ms_per_step']:7.1f} ms/step  {r['pairs_per_s']:7.1f} pairs/s"
              f"{peak}", flush=True)
    print()
    print(format_table(rows))
    return rows


if __name__ == "__main__":
    main()
