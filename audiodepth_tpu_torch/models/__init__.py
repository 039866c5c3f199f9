"""Model registry of the port. `unet_baseline` and `binaural_attention` are
ported; the other families are queued in ROADMAP.md (queue A)."""

import torch
import torch.nn as nn

from .binaural_attention import BinauralAttentionNet, build_binaural, init_binaural_weights
from .unet import UNetGenerator, build_unet, init_unet_weights

__all__ = ["BinauralAttentionNet", "UNetGenerator", "build_binaural", "build_unet",
           "init_binaural_weights", "init_unet_weights", "init_weights", "make_task"]

# where each unported family stands in ROADMAP.md
_QUEUED = {
    "base_residual": "ROADMAP.md A5 (the other families)",
    "rgb_depth": "ROADMAP.md A5 (the other families)",
    "adabins_distillation": "ROADMAP.md A5 (the other families)",
    "unet_cvae": "ROADMAP.md A5 (the other families)",
    "coarse_depth": "ROADMAP.md A5 (the other families)",
}


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded init of a ported model with its family's JAX initializers."""
    if isinstance(model, BinauralAttentionNet):
        init_binaural_weights(model, generator)
    elif isinstance(model, UNetGenerator):
        init_unet_weights(model, generator)
    else:
        raise NotImplementedError(f"no init for {type(model).__name__}")


def make_task(cfg, device=None):
    """Build the Task for cfg.model.name on `device` (default ``cuda``)."""
    from ..train import tasks as t

    name = cfg.model.name
    if name == "unet_baseline":
        return t.UNetBaselineTask(cfg, device=device)
    if name == "binaural_attention":
        from ..train.tasks_extra import BinauralAttentionTask

        return BinauralAttentionTask(cfg, device=device)
    if name == "spline_depth":
        raise NotImplementedError(
            "spline_depth is dead config in the reference (no model code)")
    where = _QUEUED.get(name)
    if where is None:
        raise NotImplementedError(f"model family {name!r} not registered")
    raise NotImplementedError(
        f"model family {name!r} is not ported to the torch package yet; see {where}")
