"""Side-by-side model comparison CSV (port of `examples/compare_checkpoints.py`,
the depth_model_comparison.ipynb twin).

The reference's only measured baseline artifact is
depth_model_comparison_results.csv: N models evaluated over the same val
slice, with the columns Model,ABS_REL,RMSE,MAE,Delta1. This script scores
any number of checkpoints over one shared val slice and writes that CSV.

    python -m audiodepth_tpu_torch.examples.compare_checkpoints \\
        --dataset synthetic --out comparison.csv \\
        --entry "UNet (ours)":unet_baseline:./checkpoints/<experiment> \\
        --entry "UNet (reference)":unet_baseline:./ckpt.pth \\
        [--num_samples 100] [--batch_size 16] [--device cuda]

Each --entry is LABEL:FAMILY:PATH[:KEY=V,KEY=V], split on ':' as the JAX
script splits it; the overrides take `cli.train`'s --override grammar and
apply after mode.compute_dtype=float32. A PATH ending in .pth is a
reference or port checkpoint, loaded strict, whose aux (the coarse
family's bins) the model adopts; any other PATH is an experiment
directory that `cli.train` wrote ({ckpt_dir}/{experiment}), restored at
its latest epoch. Both go through `cli.evaluate.restore_weights`, so a
row scores what `cli.evaluate` scores. Orbax directories (the JAX
package's checkpoints) are not read: export them to .pth first. The
means are `Engine.evaluate`'s: per-sample metrics averaged over the rows.
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import Dict, List, Optional, Sequence, Tuple

COLUMNS = ("Model", "ABS_REL", "RMSE", "MAE", "Delta1")


def parse_entry(spec: str) -> Tuple[str, str, str, Dict[str, object]]:
    """'LABEL:FAMILY:PATH[:k=v,k=v]' → (label, family, path, overrides)."""
    from . import parse_overrides

    parts = spec.split(":")
    label, family, path = parts[0], parts[1], parts[2]
    overrides = parse_overrides(parts[3].split(",")) if len(parts) > 3 else {}
    return label, family, path, overrides


def evaluate_entry(label: str, family: str, path: str, dataset: str,
                   overrides: Dict[str, object], num_samples: int, bs: int,
                   device: str = "cuda") -> Dict[str, object]:
    """One CSV row: the checkpoint at `path` scored on the val split."""
    from ..cli.evaluate import image_kwargs, restore_weights
    from ..configs import load_config
    from ..data.batvision import make_dataset
    from ..models import make_task
    from ..train.engine import Engine

    cfg = load_config(dataset, "test", label, family,
                      overrides={"mode.compute_dtype": "float32", **overrides})
    task = make_task(cfg, device=device)
    kwargs = {"num_samples": num_samples} if dataset == "synthetic" else {}
    ds = make_dataset(cfg, "val", **kwargs, **image_kwargs(cfg))
    if path.endswith(".pth"):
        restore_weights(task, torch_checkpoint=path)
    else:
        root, exp = os.path.split(os.path.abspath(path))
        epoch = restore_weights(task, ckpt_dir=root, experiment=exp)
        print(f"{label}: restored epoch {epoch}")
    means = Engine(cfg, task).evaluate(None, ds.batches(bs, shuffle=False, drop_last=False))
    return {"Model": label, "ABS_REL": means["abs_rel"], "RMSE": means["rmse"],
            "MAE": means["mae"], "Delta1": means["delta1"]}


def write_csv(rows: List[Dict[str, object]], path: str) -> None:
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(COLUMNS))
        w.writeheader()
        w.writerows(rows)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="checkpoint comparison CSV (PyTorch/CUDA)")
    p.add_argument("--dataset", default="synthetic",
                   choices=["batvisionv1", "batvisionv2", "synthetic"])
    p.add_argument("--entry", action="append", required=True,
                   help="LABEL:FAMILY:PATH[:k=v,k=v]")
    p.add_argument("--out", default="depth_model_comparison_results.csv")
    p.add_argument("--num_samples", type=int, default=100, help="val slice size (synthetic)")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, object]]:
    """Score every --entry and write the CSV; returns its rows."""
    from .._device import resolve_device

    args = build_parser().parse_args(argv)
    resolve_device(args.device)  # no card: raise before any work
    rows = []
    for spec in args.entry:
        label, family, path, overrides = parse_entry(spec)
        rows.append(evaluate_entry(label, family, path, args.dataset, overrides,
                                   args.num_samples, args.batch_size, args.device))
        print(rows[-1])
    write_csv(rows, args.out)
    print(f"wrote {args.out} ({len(rows)} models)")
    return rows


if __name__ == "__main__":
    main()
