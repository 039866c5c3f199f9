"""FLOPs of the pix2pix UNet (`unet_256`: 8 downsamplings, `unet_128`: 7)."""

from __future__ import annotations

from typing import Dict

from ..model import conv_macs


def unet_macs(size: int, ngf: int, num_downs: int, input_nc: int = 2,
              output_nc: int = 1) -> float:
    """Multiply-adds of the pix2pix UNet: k4 s2 down convs, k4 s2 transposed
    up convs (each input pixel times the kernel)."""
    chans = [input_nc, ngf, ngf * 2, ngf * 4] + [ngf * 8] * (num_downs - 3)
    macs, s = 0.0, size
    for i in range(num_downs):
        s //= 2
        macs += conv_macs(s, s, chans[i], chans[i + 1], 4)
    # up: the innermost takes its own output, the others the skip concat
    for i in reversed(range(num_downs)):
        cin = chans[i + 1] * (1 if i == num_downs - 1 else 2)
        cout = output_nc if i == 0 else chans[i]
        macs += conv_macs(s, s, cin, cout, 4)
        s *= 2
    return macs


def forward_flops(cfg: Dict) -> float:
    downs = {"unet_256": 8, "unet_128": 7}[cfg.get("generator", "unet_256")]
    return 2.0 * unet_macs(int(cfg["images_size"]), int(cfg["ngf"]), downs)
