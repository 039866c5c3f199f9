"""FLOPs of the binaural attention net: the two encoders, the attentions'
projections and products (both directions), the fusions, the decoder."""

from __future__ import annotations

from typing import Dict

from ..model import conv_macs


def binaural_macs(size: int, c: int, levels) -> Dict[str, float]:
    """Multiply-adds of the binaural net by part: the two encoders, the
    attentions' projections and products, the fusions, the decoder."""
    ch = {1: c, 2: 2 * c, 3: 4 * c, 4: 8 * c, 5: 8 * c}
    side = {lv: size // 2 ** (lv - 1) for lv in range(1, 6)}
    enc = conv_macs(size, size, 1, c, 3) + conv_macs(size, size, c, c, 3)
    for lv in range(2, 6):
        s = side[lv]
        enc += conv_macs(s, s, ch[lv - 1], ch[lv], 3) + conv_macs(s, s, ch[lv], ch[lv], 3)
    proj = products = 0.0
    for lv in levels:
        n, cc = side[lv] ** 2, ch[lv]
        dk = cc // 8
        # both directions: q, k to dk, v and out to C, over 2 · n tokens
        proj += 2 * n * cc * (2 * dk + 2 * cc)
        products += 2 * float(n) * n * (dk + cc)
    fusion = sum(conv_macs(side[lv], side[lv], 2 * ch[lv], ch[lv], 1) for lv in range(1, 6))
    dec = 0.0
    outs = {1: 4 * c, 2: 2 * c, 3: c, 4: c}
    cin = ch[5]
    for i, lv in enumerate((4, 3, 2, 1), start=1):
        s = side[lv]
        width = cin + ch[lv]
        dec += conv_macs(s, s, width, width // 2, 3) + conv_macs(s, s, width // 2, outs[i], 3)
        cin = outs[i]
    dec += conv_macs(size, size, c, 1, 1)
    return {"encoders": 2 * enc, "projections": proj, "attention": products,
            "fusion": fusion, "decoder": dec}


def forward_flops(cfg: Dict) -> float:
    return 2.0 * sum(binaural_macs(int(cfg["images_size"]), int(cfg["base_channels"]),
                                   cfg["attention_levels"]).values())
