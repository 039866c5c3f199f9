"""Binaural cross-attention depth network, the `binaural_attention` family
(port of `models/binaural_attention.py`).

The stereo input is split into its two ears; each runs through its own
five-scale `SharedEncoder`; bidirectional cross-channel attention is applied
at the configured levels (default 2, 3, 4, 5) with shared Q/K/V/out
projections and a zero-initialised γ gate; per-level features are fused
(concat, 1×1 conv, BN, ReLU); a UNet decoder over the fused pyramid emits
sigmoid·max_depth, clipped to [0, max_depth].

The model takes and returns NCHW and runs channels-last, so the token view
[B, H·W, C] of a feature map is a free reshape of its NHWC permutation.
Both attention directions are stacked on the batch axis into one
`cross_attention` call per level: kernel B2 on the card, the blockwise plain
version on the CPU.

Module names are the reference's (`tools/import_torch.py::_spec_binaural`
of the JAX package), so a reference `.pth` loads with strict=True: the
projections are 1×1 convs ([O, I, 1, 1]) applied to tokens as matrix
products. With `remat` (the config's `model.extra.remat`, on by default as
in the JAX package) both encoders recompute their activations in the
backward of a train-mode forward instead of keeping them, and BatchNorm
folds its statistics once.

Sequence parallelism (`sp_axis`, the JAX model's field, default None):
with `sp_axis="model"` and a ('data', 'model') group active
(`parallel.use_group` of a `MeshGroup`) whose model axis has sp > 1 ranks,
each attention computes q, K and V on every token, then its ⌈N/sp⌉ query
rows against all N keys (B2 on the card at Nq = N/sp, B3 in the backward),
and all-gathers the outputs (`parallel/sequence.py`); everything else runs
replicated over the model axis. `build_binaural` leaves it None, as the JAX
factory does; set it on the net (`net.sp_axis = "model"`), which sets it on
every attention. Data parallelism is `parallel/`'s.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cuda.flash_attention import cross_attention
from ..ops.resize import resize_bilinear
from ..parallel.mesh import active_axis
from ..parallel.sequence import sequence_parallel_attention
from .base_residual import SharedEncoder
from .layers import BatchNorm, Conv2d, UpBilinear, at_least_f32, init_modules, kaiming_init

# Q/K projection bottleneck divisor (binaural_attention_model.py:90-98)
ATTENTION_REDUCTION = 8


def level_channels(base_channels: int) -> Dict[int, int]:
    """Feature channels at encoder levels 1-5 (SharedEncoder widths)."""
    c = base_channels
    return {1: c, 2: c * 2, 3: c * 4, 4: c * 8, 5: c * 8}


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] → [B, H·W, C] (a view when x is channels-last)."""
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, c)


class _Projection(Conv2d):
    """A 1×1 conv applied to tokens [B, N, I] → [B, N, O] (flax `nn.Dense`
    in the compute dtype); the weight keeps the reference's [O, I, 1, 1]."""

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(t.to(dt), self.weight.flatten(1).to(dt), self.bias.to(dt))


class BinauralCrossAttention(nn.Module):
    """Bidirectional cross-channel attention with shared projections;
    `sp_axis`: the mesh axis its query rows are split over (module note)."""

    def __init__(self, channels: int, reduction: int = ATTENTION_REDUCTION,
                 dtype: torch.dtype = torch.float32, sp_axis: Optional[str] = None):
        super().__init__()
        self.sp_axis = sp_axis
        inner = channels // reduction
        self.query = _Projection(channels, inner, 1, dtype=dtype)
        self.key = _Projection(channels, inner, 1, dtype=dtype)
        self.value = _Projection(channels, channels, 1, dtype=dtype)
        self.out = _Projection(channels, channels, 1, dtype=dtype)
        self.gamma = nn.Parameter(torch.zeros(1))
        self.scale = 1.0 / channels ** 0.5  # the reference scales by sqrt(C_full)

    def forward(self, left: torch.Tensor, right: torch.Tensor):
        b, c, h, w = left.shape
        lt, rt = _tokens(left), _tokens(right)
        # L→R and R→L share the projections: one attention call over 2B rows
        both = torch.cat([lt, rt], dim=0)
        swapped = torch.cat([rt, lt], dim=0)
        group = None if self.sp_axis is None else active_axis(self.sp_axis)
        q, k, v = self.query(both), self.key(swapped), self.value(swapped)
        if group is None or group.size == 1:
            att = cross_attention(q, k, v, self.scale)
        else:
            att = sequence_parallel_attention(cross_attention, q, k, v, self.scale, group)
        out = self.out(att)
        # γ is an fp32 parameter: the gated sum promotes, then casts back
        left_out = (lt + self.gamma * out[:b]).to(left.dtype)
        right_out = (rt + self.gamma * out[b:]).to(right.dtype)

        def image(t: torch.Tensor) -> torch.Tensor:
            return t.reshape(b, h, w, c).permute(0, 3, 1, 2)

        return image(left_out), image(right_out)


class BinauralAttentionNet(nn.Module):
    def __init__(self, base_channels: int = 64, max_depth: float = 30.0,
                 attention_levels: Sequence[int] = (2, 3, 4, 5), output_size: int = 256,
                 remat: bool = False, dtype: torch.dtype = torch.float32,
                 sp_axis: Optional[str] = None):
        super().__init__()
        c = base_channels
        ch = level_channels(c)
        self.max_depth = float(max_depth)
        self.attention_levels = tuple(int(lv) for lv in attention_levels)
        self.output_size = int(output_size)
        self.compute_dtype = dtype
        self.left_encoder = SharedEncoder(1, c, dtype=dtype, remat=remat)
        self.right_encoder = SharedEncoder(1, c, dtype=dtype, remat=remat)
        self.attention_modules = nn.ModuleDict({
            f"attn_{lv}": BinauralCrossAttention(ch[lv], dtype=dtype, sp_axis=sp_axis)
            for lv in self.attention_levels})
        self.fusion_layers = nn.ModuleDict({
            f"fusion_{lv}": nn.Sequential(Conv2d(2 * ch[lv], ch[lv], 1, dtype=dtype),
                                          BatchNorm(ch[lv], dtype, relu=True), nn.Identity())
            for lv in range(1, 6)})
        self.up1 = UpBilinear(ch[5] + ch[4], c * 4, dtype=dtype)
        self.up2 = UpBilinear(c * 4 + ch[3], c * 2, dtype=dtype)
        self.up3 = UpBilinear(c * 2 + ch[2], c, dtype=dtype)
        self.up4 = UpBilinear(c + ch[1], c, dtype=dtype)
        self.outc = nn.Sequential(Conv2d(c, 1, 1, dtype=dtype))

    @property
    def sp_axis(self) -> Optional[str]:
        """The mesh axis every attention splits its query rows over."""
        return next(iter(self.attention_modules.values())).sp_axis \
            if self.attention_modules else None

    @sp_axis.setter
    def sp_axis(self, axis: Optional[str]) -> None:
        for m in self.attention_modules.values():
            m.sp_axis = axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 2, H, W] → [B, 1, S, S] depth in meters (S = output_size)."""
        x = x.to(self.compute_dtype)
        lf = self.left_encoder(x[:, 0:1])
        rf = self.right_encoder(x[:, 1:2])
        fused = {}
        for lv in range(1, 6):
            lfeat, rfeat = lf[f"x{lv}"], rf[f"x{lv}"]
            if lv in self.attention_levels:
                lfeat, rfeat = self.attention_modules[f"attn_{lv}"](lfeat, rfeat)
            fused[lv] = self.fusion_layers[f"fusion_{lv}"](torch.cat([lfeat, rfeat], dim=1))
        h = self.up1(fused[5], fused[4])
        h = self.up2(h, fused[3])
        h = self.up3(h, fused[2])
        h = self.up4(h, fused[1])
        depth = torch.sigmoid(at_least_f32(self.outc(h))) * self.max_depth
        if depth.shape[-2] != self.output_size:
            depth = resize_bilinear(depth, self.output_size, self.output_size)
        return torch.clamp(depth, 0.0, self.max_depth)


def init_binaural_weights(model: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's init: kaiming fan_out (ReLU gain) conv and
    projection kernels, zero biases, BN scale 1 / bias 0 and running stats
    0 / 1, and γ = 0. Draws in module order from `generator`."""
    init_modules(model, generator, kaiming_init())
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BinauralCrossAttention):
                m.gamma.zero_()


def build_binaural(cfg) -> BinauralAttentionNet:
    """Factory from a Config (tasks_extra.py:186-193 of the JAX package)."""
    from ..configs import resolve_compute_dtype

    return BinauralAttentionNet(
        base_channels=cfg.model.base_channels,
        max_depth=float(cfg.dataset.max_depth),
        attention_levels=tuple(cfg.model.attention_levels),
        output_size=cfg.dataset.images_size,
        remat=bool(cfg.model.extra.get("remat", True)),
        dtype=resolve_compute_dtype(cfg),
    )
