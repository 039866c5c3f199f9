"""Closed-form model FLOPs of one pair's forward, from the configuration's
shapes (see the package note for what counts)."""

from __future__ import annotations

from typing import Dict


def _conv(h_out: int, w_out: int, cin: int, cout: int, k: int) -> float:
    return float(h_out) * w_out * cin * cout * k * k


def unet_macs(size: int, ngf: int, num_downs: int, input_nc: int = 2,
              output_nc: int = 1) -> float:
    """Multiply-adds of the pix2pix UNet: k4 s2 down convs, k4 s2 transposed
    up convs (each input pixel times the kernel)."""
    chans = [input_nc, ngf, ngf * 2, ngf * 4] + [ngf * 8] * (num_downs - 3)
    macs, s = 0.0, size
    for i in range(num_downs):
        s //= 2
        macs += _conv(s, s, chans[i], chans[i + 1], 4)
    # up: the innermost takes its own output, the others the skip concat
    for i in reversed(range(num_downs)):
        cin = chans[i + 1] * (1 if i == num_downs - 1 else 2)
        cout = output_nc if i == 0 else chans[i]
        macs += _conv(s, s, cin, cout, 4)
        s *= 2
    return macs


def binaural_macs(size: int, c: int, levels) -> Dict[str, float]:
    """Multiply-adds of the binaural net by part: the two encoders, the
    attentions' projections and products, the fusions, the decoder."""
    ch = {1: c, 2: 2 * c, 3: 4 * c, 4: 8 * c, 5: 8 * c}
    side = {lv: size // 2 ** (lv - 1) for lv in range(1, 6)}
    enc = _conv(size, size, 1, c, 3) + _conv(size, size, c, c, 3)
    for lv in range(2, 6):
        s = side[lv]
        enc += _conv(s, s, ch[lv - 1], ch[lv], 3) + _conv(s, s, ch[lv], ch[lv], 3)
    proj = products = 0.0
    for lv in levels:
        n, cc = side[lv] ** 2, ch[lv]
        dk = cc // 8
        # both directions: q, k to dk, v and out to C, over 2 · n tokens
        proj += 2 * n * cc * (2 * dk + 2 * cc)
        products += 2 * float(n) * n * (dk + cc)
    fusion = sum(_conv(side[lv], side[lv], 2 * ch[lv], ch[lv], 1) for lv in range(1, 6))
    dec = 0.0
    outs = {1: 4 * c, 2: 2 * c, 3: c, 4: c}
    cin = ch[5]
    for i, lv in enumerate((4, 3, 2, 1), start=1):
        s = side[lv]
        width = cin + ch[lv]
        dec += _conv(s, s, width, width // 2, 3) + _conv(s, s, width // 2, outs[i], 3)
        cin = outs[i]
    dec += _conv(size, size, c, 1, 1)
    return {"encoders": 2 * enc, "projections": proj, "attention": products,
            "fusion": fusion, "decoder": dec}


def model_flops(cfg: Dict) -> float:
    """FLOPs of one pair's forward for a configuration file's dict."""
    size = int(cfg["images_size"])
    if cfg["family"] == "unet_baseline":
        downs = {"unet_256": 8, "unet_128": 7}[cfg.get("generator", "unet_256")]
        return 2.0 * unet_macs(size, int(cfg["ngf"]), downs)
    if cfg["family"] == "binaural_attention":
        return 2.0 * sum(binaural_macs(size, int(cfg["base_channels"]),
                                       cfg["attention_levels"]).values())
    raise ValueError(f"no FLOP count for the family {cfg['family']!r}")


def train_flops_per_pair(cfg: Dict) -> float:
    """A trained pair: forward and backward, 3 × the forward."""
    return 3.0 * model_flops(cfg)
