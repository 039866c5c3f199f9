"""Model registry of the port: unet_baseline, binaural_attention,
base_residual, unet_cvae, rgb_depth and adabins_distillation. coarse_depth
is queued in ROADMAP.md (queue A)."""

import torch
import torch.nn as nn

from .adabins import AdaBinsDistillationModel
from .base_residual import BaseResidualNet
from .binaural_attention import BinauralAttentionNet, build_binaural, init_binaural_weights
from .layers import init_modules, kaiming_init, lecun_normal_init, normal_init
from .rgb_depth import RGBDepthNet
from .unet import UNetGenerator, build_unet, init_unet_weights
from .unet_cvae import UNetCVAE, build_unet_cvae

__all__ = ["AdaBinsDistillationModel", "BaseResidualNet", "BinauralAttentionNet",
           "RGBDepthNet", "UNetCVAE", "UNetGenerator", "build_binaural", "build_unet",
           "build_unet_cvae", "init_binaural_weights", "init_unet_weights", "init_weights",
           "make_task"]

# where each unported family stands in ROADMAP.md
_QUEUED = {"coarse_depth": "ROADMAP.md A5 (the other families)"}


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded init of a ported model with its family's JAX initializers:
    kaiming fan_out for the residual-block families (flax's default
    lecun-normal for the base_residual heads), normal(0.02) for the pix2pix
    UNets (lecun-normal for the cVAE bottleneck's dense layers)."""
    if isinstance(model, BinauralAttentionNet):
        init_binaural_weights(model, generator)
    elif isinstance(model, UNetGenerator):
        init_unet_weights(model, generator)
    elif isinstance(model, BaseResidualNet):
        lecun = lecun_normal_init()
        init_modules(model, generator, kaiming_init(),
                     {model.base_head: lecun, model.res_head: lecun})
    elif isinstance(model, (RGBDepthNet, AdaBinsDistillationModel)):
        init_modules(model, generator, kaiming_init())
    elif isinstance(model, UNetCVAE):
        lecun = lecun_normal_init()
        init_modules(model, generator, normal_init(0.02),
                     {m: lecun for m in model.modules() if isinstance(m, nn.Linear)})
    else:
        raise NotImplementedError(f"no init for {type(model).__name__}")


def make_task(cfg, device=None):
    """Build the Task for cfg.model.name on `device` (default ``cuda``)."""
    from ..train import tasks as t
    from ..train import tasks_extra as te

    registry = {"unet_baseline": t.UNetBaselineTask,
                "binaural_attention": te.BinauralAttentionTask,
                "base_residual": te.BaseResidualTask,
                "unet_cvae": te.UNetCVAETask,
                "rgb_depth": te.RGBDepthTask,
                "adabins_distillation": te.AdaBinsDistillationTask}
    name = cfg.model.name
    if name in registry:
        return registry[name](cfg, device=device)
    if name == "spline_depth":
        raise NotImplementedError(
            "spline_depth is dead config in the reference (no model code)")
    where = _QUEUED.get(name)
    if where is None:
        raise NotImplementedError(f"model family {name!r} not registered")
    raise NotImplementedError(
        f"model family {name!r} is not ported to the torch package yet; see {where}")
