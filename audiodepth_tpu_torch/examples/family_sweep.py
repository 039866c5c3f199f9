"""Family sweep: a short training run of every model family (port of
`examples/family_sweep.py`).

Each family trains 10 epochs at batch 32 on 256 synthetic samples (seed
0) and is validated on 32 held-out ones (seed 99) after epochs 1 and 10,
at the JAX script's widths: base 32 for the big families, 64 AdaBins bins,
the hybrid coarse model with 32 bins. Prints first → last RMSE, abs_rel,
δ3 and the wall seconds per family.

    python -m audiodepth_tpu_torch.examples.family_sweep
    # one family, small, on the CPU:
    python -c "from audiodepth_tpu_torch.examples.family_sweep import run_family; \\
        run_family('rgb_depth', {}, epochs=2, bs=2, n_train=4, n_val=2, device='cpu', \\
        overrides={'model.base_channels': 4, 'dataset.images_size': 32})"

As in the JAX script, the batches are drawn once (train shuffle seed 7)
and replayed every epoch; the image families (rgb_depth,
adabins_distillation) get the synthetic camera view, coarse_depth its int
bin targets from the task's edges before the compact encoding; each step
sees the 0-based epoch; validation takes `Engine.evaluate`'s default
epoch. The weights are `models.init_weights` from mode.seed (0 unless
overridden), as `cli.train` seeds them. A family that fails raises:
nothing is caught.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..cli.train import IMAGE_MODELS
from .._device import synchronize

FAMILIES: List[Tuple[str, Dict[str, object]]] = [
    ("unet_baseline", {}),
    ("unet_cvae", {}),
    ("base_residual", {"model.base_channels": 32}),
    ("binaural_attention", {"model.base_channels": 32}),
    ("rgb_depth", {"model.base_channels": 32}),
    ("adabins_distillation", {"model.base_channels": 32, "model.n_bins": 64}),
    ("coarse_depth", {"model.base_channels": 32, "model.n_bins": 32,
                      "model.model_type": "hybrid"}),
]


def family_config(name: str, over: Dict[str, object], bs: int,
                  overrides: Optional[Dict[str, object]] = None):
    from ..configs import load_config

    return load_config("batvisionv2", "train", f"sweep_{name}", name,
                       overrides={"mode.batch_size": bs, **over, **(overrides or {})})


def prepare_batches(cfg, task, name: str, bs: int, n_train: int, n_val: int):
    """(train batches, val batches): host numpy batches in the compact
    encoding, drawn once as the JAX script draws them."""
    from ..data.bins import add_bins_to_batch
    from ..data.codec import encode_batch
    from ..data.synthetic import SyntheticEchoDataset

    with_image = name in IMAGE_MODELS
    train_ds = SyntheticEchoDataset(cfg, num_samples=n_train, seed=0, with_image=with_image)
    val_ds = SyntheticEchoDataset(cfg, num_samples=n_val, seed=99, with_image=with_image)
    units = 1.0 if cfg.dataset.depth_norm else cfg.dataset.max_depth

    def prep(b):
        if name == "coarse_depth":
            b = add_bins_to_batch(b, task.bin_edges, cfg.dataset.max_depth,
                                  cfg.dataset.depth_norm)
        return encode_batch(b, units)

    return ([prep(b) for b in train_ds.batches(bs, shuffle=True, seed=7)],
            [prep(b) for b in val_ds.batches(bs, shuffle=False)])


def run_family(name: str, over: Dict[str, object], epochs: int = 10, bs: int = 32,
               n_train: int = 256, n_val: int = 32,
               overrides: Optional[Dict[str, object]] = None, device: str = "cuda",
               on_step: Optional[Callable[[object, Dict[str, torch.Tensor]], None]] = None,
               ) -> Dict[str, object]:
    """Train one family and validate it after the first and the last
    epoch; its row: the first and last val means, the steps and eval
    batches run, and the wall seconds. `on_step(state, metrics)` runs after
    every step (metrics on the device)."""
    from ..data.prefetch import device_prefetch
    from ..models import init_weights, make_task
    from ..train.engine import Engine

    cfg = family_config(name, over, bs, overrides)
    task = make_task(cfg, device=device)
    init_weights(task.model, torch.Generator().manual_seed(int(cfg.mode.seed)))
    train_batches, val_batches = prepare_batches(cfg, task, name, bs, n_train, n_val)
    eng = Engine(cfg, task, steps_per_epoch=n_train // bs)

    state = eng.init_state()
    t0 = time.perf_counter()
    first_val = last_val = None
    steps = eval_batches = 0
    for epoch in range(1, epochs + 1):
        for b in device_prefetch(iter(train_batches), eng.device, size=4):
            state, m = eng.train_step(state, b, epoch=float(epoch - 1))
            steps += 1
            if on_step is not None:
                on_step(state, m)
        if epoch in (1, epochs):
            val = eng.evaluate(state, iter(val_batches))
            eval_batches += len(val_batches)
            if epoch == 1:
                first_val = val
            last_val = val
    synchronize(eng.device)
    dt = time.perf_counter() - t0
    print(f"{name:24s} rmse {first_val['rmse']:6.2f} -> {last_val['rmse']:6.2f}  "
          f"abs_rel {first_val['abs_rel']:5.2f} -> {last_val['abs_rel']:5.2f}  "
          f"d3 {first_val['delta3']:4.2f} -> {last_val['delta3']:4.2f}  [{dt:.0f}s]",
          flush=True)
    return {"family": name, "first": first_val, "last": last_val, "steps": steps,
            "eval_batches": eval_batches, "wall_s": dt}


def format_table(rows: List[Dict[str, object]]) -> str:
    lines = ["| family | RMSE (first → last) | abs_rel | δ3 | wall s |", "|---|---|---|---|---|"]
    for r in rows:
        a, b = r["first"], r["last"]
        lines.append(f"| {r['family']} | {a['rmse']:.2f} → {b['rmse']:.2f} | "
                     f"{a['abs_rel']:.2f} → {b['abs_rel']:.2f} | "
                     f"{a['delta3']:.2f} → {b['delta3']:.2f} | {r['wall_s']:.1f} |")
    return "\n".join(lines)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="every family trained briefly (PyTorch/CUDA)")
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, object]]:
    from .._device import resolve_device

    args = build_parser().parse_args(argv)
    resolve_device(args.device)  # no card: raise before any work
    rows = [run_family(name, over, device=args.device) for name, over in FAMILIES]
    print(format_table(rows))
    return rows


if __name__ == "__main__":
    main()
