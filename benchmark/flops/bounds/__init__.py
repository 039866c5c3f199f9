"""Each hand-written op's bound, a file each, named after the op's name
after "::" and holding `OP` (the registered name) and `bound_s(shapes,
dtype, peak, cfg)` (see `flops.kernels`)."""

from __future__ import annotations

from pathlib import Path
from types import ModuleType
from typing import List

from reference.named import load_named


def bound_file(op: str) -> ModuleType:
    """The bound file of the registered op `op`."""
    module = load_named(__name__, op.split("::", 1)[-1], "bound file")
    if module.OP != op:
        raise ValueError(f"{module.__file__} bounds {module.OP!r}, not {op!r}")
    return module


def bounded_ops() -> List[str]:
    """The registered ops that have a bound file."""
    return [load_named(__name__, p.stem, "bound file").OP
            for p in sorted(Path(__file__).parent.glob("*.py")) if p.stem != "__init__"]
