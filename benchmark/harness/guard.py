"""The modules a run of the port may not hold: JAX and the JAX package.

A module counts by its top-level name, the part before the first dot,
compared whole: `audiodepth_tpu.ops` is caught, `audiodepth_tpu_torch` is
not.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "audiodepth_tpu")


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The loaded modules (or `names`) whose top-level name is forbidden."""
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
