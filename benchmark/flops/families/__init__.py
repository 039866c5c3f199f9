"""The model FLOPs of each family, a file each: `<family>.py`, found by a
configuration's `family`. A family file provides `forward_flops(cfg)`, the
FLOPs of one pair's forward, and may provide `train_flops_per_pair(cfg)`,
where a trained pair is not 3 × the forward (a frozen teacher that runs
its forward only, say)."""

from __future__ import annotations

from types import ModuleType

from reference.named import load_named


def family(name: str) -> ModuleType:
    return load_named(__name__, name, "FLOP file")
