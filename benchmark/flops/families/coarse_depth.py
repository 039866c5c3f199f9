"""FLOPs of the coarse-depth hybrid: the five-scale encoder, two UNet
decoders (the classification one and the offset one), the 1×1 class head
of n_bins logits, and the offset branch's fusion (conv3 c+1 → c, conv3
c → c/2) and 1×1 head. The soft binning's and the cross entropy's
elementwise passes are not counted. A trained pair is 3 × the forward."""

from __future__ import annotations

from typing import Dict

from ..model import conv_macs


def hybrid_macs(size: int, c: int, n_bins: int) -> Dict[str, float]:
    """Multiply-adds of the hybrid by part: encoder, each decoder, the class
    head, the offset branch's fusion and head."""
    ch = {1: c, 2: 2 * c, 3: 4 * c, 4: 8 * c, 5: 8 * c}
    side = {lv: size // 2 ** (lv - 1) for lv in range(1, 6)}
    enc = conv_macs(size, size, 2, c, 3) + conv_macs(size, size, c, c, 3)
    for lv in range(2, 6):
        s = side[lv]
        enc += conv_macs(s, s, ch[lv - 1], ch[lv], 3) + conv_macs(s, s, ch[lv], ch[lv], 3)
    dec = 0.0
    for lv, width, out in ((4, 16 * c, 4 * c), (3, 8 * c, 2 * c), (2, 4 * c, c),
                           (1, 2 * c, c)):
        s = side[lv]
        dec += conv_macs(s, s, width, width // 2, 3) + conv_macs(s, s, width // 2, out, 3)
    fusion = conv_macs(size, size, c + 1, c, 3) + conv_macs(size, size, c, c // 2, 3)
    return {"encoder": enc, "coarse_decoder": dec, "class_head": conv_macs(size, size, c, n_bins, 1),
            "offset_decoder": dec, "fusion": fusion,
            "offset_head": conv_macs(size, size, c // 2, 1, 1)}


def forward_flops(cfg: Dict) -> float:
    return 2.0 * sum(hybrid_macs(int(cfg["images_size"]), int(cfg["base_channels"]),
                                 int(cfg["n_bins"])).values())
