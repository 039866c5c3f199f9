"""Tasks of the non-baseline families, inference half (port of
`train/tasks_extra.py`). Only `binaural_attention` is ported so far; the
losses and the training half come with its training slice (ROADMAP.md)."""

from __future__ import annotations

import torch

from .._device import DeviceLike
from ..configs import Config
from ..models.binaural_attention import build_binaural
from .tasks import Task


class BinauralAttentionTask(Task):
    """binaural_attention: the model emits meters (sigmoid·max_depth head),
    so `pred_is_normalized` stays False. The config's `model.extra.remat`
    is a training knob and has no effect on inference."""

    name = "binaural_attention"

    def __init__(self, cfg: Config, device: DeviceLike = None):
        super().__init__(cfg, device)
        # channels-last: the encoders' conv outputs stay NHWC in memory, so
        # the attention's token view [B, H·W, C] is free
        self.model = build_binaural(cfg).to(self.device, memory_format=torch.channels_last)
