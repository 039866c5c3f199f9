"""Model registry of the port. Only `unet_baseline` is ported so far; the
other families are queued in ROADMAP.md (queue A)."""

from .unet import UNetGenerator, build_unet, init_unet_weights

__all__ = ["UNetGenerator", "build_unet", "init_unet_weights", "make_task"]

# where each unported family stands in ROADMAP.md
_QUEUED = {
    "binaural_attention": "ROADMAP.md A2 (serving through kernel B2)",
    "base_residual": "ROADMAP.md A5 (the other families)",
    "rgb_depth": "ROADMAP.md A5 (the other families)",
    "adabins_distillation": "ROADMAP.md A5 (the other families)",
    "unet_cvae": "ROADMAP.md A5 (the other families)",
    "coarse_depth": "ROADMAP.md A5 (the other families)",
}


def make_task(cfg, device=None):
    """Build the Task for cfg.model.name on `device` (default ``cuda``)."""
    from ..train import tasks as t

    name = cfg.model.name
    if name == "unet_baseline":
        return t.UNetBaselineTask(cfg, device=device)
    if name == "spline_depth":
        raise NotImplementedError(
            "spline_depth is dead config in the reference (no model code)")
    where = _QUEUED.get(name)
    if where is None:
        raise NotImplementedError(f"model family {name!r} not registered")
    raise NotImplementedError(
        f"model family {name!r} is not ported to the torch package yet; see {where}")
