"""FLOPs of the AdaBins distillation nets: a branch is its five-scale
encoder, its bin predictor's two Linears, its decoder's four up blocks and
1×1 class head, and the shared 1×1 residual head (each branch runs it);
the soft binning's elementwise passes are not counted. The student (2 input
channels) is trained, forward and backward; the teacher (3) runs its
forward only, once a step."""

from __future__ import annotations

from typing import Dict

from ..model import conv_macs

HIDDEN = 256


def branch_macs(size: int, c: int, n_bins: int, cin: int) -> Dict[str, float]:
    """Multiply-adds of one branch by part: encoder, bin predictor, decoder
    (its class head included), residual head."""
    ch = {1: c, 2: 2 * c, 3: 4 * c, 4: 8 * c, 5: 8 * c}
    side = {lv: size // 2 ** (lv - 1) for lv in range(1, 6)}
    enc = conv_macs(size, size, cin, c, 3) + conv_macs(size, size, c, c, 3)
    for lv in range(2, 6):
        s = side[lv]
        enc += conv_macs(s, s, ch[lv - 1], ch[lv], 3) + conv_macs(s, s, ch[lv], ch[lv], 3)
    bins = float(8 * c * HIDDEN + HIDDEN * n_bins)
    dec = 0.0
    for lv, width, out in ((4, 16 * c, 8 * c), (3, 12 * c, 4 * c), (2, 6 * c, 2 * c),
                           (1, 3 * c, c)):
        s = side[lv]
        dec += conv_macs(s, s, width, width // 2, 3) + conv_macs(s, s, width // 2, out, 3)
    dec += conv_macs(size, size, c, n_bins, 1)
    return {"encoder": enc, "bins": bins, "decoder": dec,
            "residual": conv_macs(size, size, c, 1, 1)}


def _branch_flops(cfg: Dict, cin: int) -> float:
    return 2.0 * sum(branch_macs(int(cfg["images_size"]), int(cfg["base_channels"]),
                                 int(cfg["n_bins"]), cin).values())


def forward_flops(cfg: Dict) -> float:
    """The student's forward, what a served pair costs."""
    return _branch_flops(cfg, 2)


def train_flops_per_pair(cfg: Dict) -> float:
    return 3.0 * _branch_flops(cfg, 2) + _branch_flops(cfg, 3)
