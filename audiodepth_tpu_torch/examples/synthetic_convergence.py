"""Convergence sanity run: UNet-256 on the synthetic corpus (port of
`examples/synthetic_convergence.py`).

The dataset-free analogue of the reference's toy_train_eval notebooks:
unet_baseline (unet_256, ngf 64, bf16) trained on 512 synthetic samples at
batch 64 for 30 epochs and validated on 64 held-out ones (seed 99) at
epoch 1 and every 5th epoch.

    python -m audiodepth_tpu_torch.examples.synthetic_convergence [--epochs 30] [--bs 64]
    # small, on the CPU:
    python -c "from audiodepth_tpu_torch.examples.synthetic_convergence import run; \\
        run(epochs=2, bs=4, n_train=8, n_val=4, device='cpu', overrides={ \\
        'model.generator': 'unet_128', 'model.ngf': 4, 'dataset.images_size': 128})"

As in the JAX script, the train batches are drawn ONCE (shuffle seed 7) and
replayed in the same order every epoch, each step sees the 0-based epoch,
and the batches reach the device through `data.prefetch.device_prefetch`
(4 in flight). The weights are `models.init_weights` from mode.seed (0
unless overridden), as `cli.train` seeds them.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from .._device import synchronize


def run(epochs: int = 30, bs: int = 64, n_train: int = 512, n_val: int = 64,
        overrides: Optional[Dict[str, object]] = None, device: str = "cuda",
        on_step: Optional[Callable[[object, Dict[str, torch.Tensor]], None]] = None,
        ) -> List[Dict[str, float]]:
    """Train and validate; one row per validated epoch: the last step's
    loss, the val means (rmse, abs_rel, delta1, delta3, mae), the seconds
    of that epoch's steps to their end (`epoch_s`), the steps' seconds so
    far (`train_s`) and the wall seconds since the first step (`wall_s`).
    `on_step(state, metrics)` runs after every step (metrics on the
    device)."""
    from ..configs import load_config
    from ..data.codec import encode_batch
    from ..data.prefetch import device_prefetch
    from ..data.synthetic import SyntheticEchoDataset
    from ..models import init_weights, make_task
    from ..train.engine import Engine

    cfg = load_config("batvisionv2", "train", "conv", "unet_baseline",
                      overrides={"mode.batch_size": bs, **(overrides or {})})
    task = make_task(cfg, device=device)
    init_weights(task.model, torch.Generator().manual_seed(int(cfg.mode.seed)))
    train_ds = SyntheticEchoDataset(cfg, num_samples=n_train, seed=0)
    val_ds = SyntheticEchoDataset(cfg, num_samples=n_val, seed=99)
    eng = Engine(cfg, task, steps_per_epoch=len(train_ds) // bs)

    units = 1.0 if cfg.dataset.depth_norm else cfg.dataset.max_depth
    train_batches = [encode_batch(b, units)
                     for b in train_ds.batches(bs, shuffle=True, seed=7)]
    val_batches = [encode_batch(b, units) for b in val_ds.batches(bs, shuffle=False)]

    state = eng.init_state()
    rows: List[Dict[str, float]] = []
    train_s = 0.0
    t0 = time.perf_counter()
    for epoch in range(1, epochs + 1):
        t1 = time.perf_counter()
        for b in device_prefetch(iter(train_batches), eng.device, size=4):
            state, m = eng.train_step(state, b, epoch=float(epoch - 1))
            if on_step is not None:
                on_step(state, m)
        synchronize(eng.device)
        epoch_s = time.perf_counter() - t1
        train_s += epoch_s
        if epoch % 5 == 0 or epoch == 1:
            val = eng.evaluate(state, iter(val_batches))
            rows.append({"epoch": epoch, "loss": float(m["loss"]), "rmse": val["rmse"],
                         "abs_rel": val["abs_rel"], "delta1": val["delta1"],
                         "delta3": val["delta3"], "mae": val["mae"], "epoch_s": epoch_s,
                         "train_s": train_s, "wall_s": time.perf_counter() - t0})
            r = rows[-1]
            print(f"epoch {epoch:3d} loss={r['loss']:.3f} rmse={r['rmse']:.3f} "
                  f"abs_rel={r['abs_rel']:.3f} d1={r['delta1']:.3f} d3={r['delta3']:.3f} "
                  f"mae={r['mae']:.3f} [{r['wall_s']:.0f}s]", flush=True)
    return rows


def format_table(rows: List[Dict[str, float]]) -> str:
    lines = ["| epoch | loss | RMSE (m) | abs_rel | δ1 | δ3 | MAE (m) | epoch s | wall s |",
             "|---|---|---|---|---|---|---|---|---|"]
    lines += [f"| {r['epoch']} | {r['loss']:.3f} | {r['rmse']:.3f} | {r['abs_rel']:.3f} | "
              f"{r['delta1']:.3f} | {r['delta3']:.3f} | {r['mae']:.3f} | {r['epoch_s']:.2f} | "
              f"{r['wall_s']:.1f} |" for r in rows]
    return "\n".join(lines)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="UNet-256 convergence on synthetic data")
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--bs", type=int, default=64)
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, float]]:
    from .._device import resolve_device

    args = build_parser().parse_args(argv)
    resolve_device(args.device)  # no card: raise before any work
    rows = run(args.epochs, args.bs, device=args.device)
    print(format_table(rows))
    return rows


if __name__ == "__main__":
    main()
