"""Dataset factory (port of `data/batvision.py::make_dataset`).

Only the synthetic corpus is ported: the BatVision V1/V2 loaders read the
real corpora, which wait for ROADMAP.md A6.
"""

from __future__ import annotations

from ..configs import Config


def make_dataset(cfg: Config, split: str = "train", **kwargs):
    """split in {train, val, test} → dataset object for cfg.dataset.name."""
    name = cfg.dataset.name
    if name == "synthetic":
        from .synthetic import SyntheticEchoDataset

        kwargs.setdefault("num_samples", {"train": 256, "val": 64, "test": 64}[split])
        kwargs.setdefault("seed", {"train": 0, "val": 1, "test": 2}[split])
        return SyntheticEchoDataset(cfg, **kwargs)
    if name in ("batvisionv1", "batvisionv2"):
        raise NotImplementedError(
            f"the {name} loader is not ported yet (ROADMAP.md A6); use --dataset synthetic")
    raise ValueError(f"unknown dataset {name!r}")
