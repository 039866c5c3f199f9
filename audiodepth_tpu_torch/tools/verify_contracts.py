"""Feature-shape contract checks (port of `tools/verify_contracts.py`, the
reference's verify_feature_compatibility twin).

The reference ships a standalone script asserting that the RGB teacher's
encoder features x1-x5 match the binaural student's fused pyramid shapes
and that both emit the same depth shape (verify_feature_compatibility.py:
75-235), returning a process exit code. Here the same contract is a
callable and a CLI. Shapes are the port's NCHW; the entry point runs on
`cuda` unless asked for the CPU, and raises without a card.
"""

from __future__ import annotations

import sys
from typing import Dict, Tuple

import torch

from .._device import DeviceLike, resolve_device

LEVELS = ("x1", "x2", "x3", "x4", "x5")


@torch.no_grad()
def contract_shapes(base_channels: int = 8, size: int = 64, device: DeviceLike = None
                    ) -> Dict[str, Tuple[tuple, tuple]]:
    """{level or "depth": (teacher shape, student shape)}: the RGB teacher's
    encoder features and depth, the student's fused pyramid (the
    `SharedEncoder` widths: attention and fusion keep C) and the binaural
    net's depth (attention at levels 4 and 5), all in eval mode on zeros."""
    from ..models.base_residual import SharedEncoder
    from ..models.binaural_attention import BinauralAttentionNet
    from ..models.rgb_depth import RGBDepthNet

    dev = resolve_device(device)
    rgb = RGBDepthNet(base_channels=base_channels, output_size=size).to(dev).eval()
    image = torch.zeros((1, 3, size, size), device=dev)
    rgb_feats, rgb_depth = SharedEncoder.forward(rgb, image), rgb(image)
    enc = SharedEncoder(1, base_channels).to(dev).eval()
    student_feats = enc(torch.zeros((1, 1, size, size), device=dev))
    net = BinauralAttentionNet(base_channels=base_channels, output_size=size,
                               attention_levels=(4, 5)).to(dev).eval()
    student_depth = net(torch.zeros((1, 2, size, size), device=dev))
    out = {lv: (tuple(rgb_feats[lv].shape), tuple(student_feats[lv].shape)) for lv in LEVELS}
    out["depth"] = (tuple(rgb_depth.shape), tuple(student_depth.shape))
    return out


def verify_compatibility(base_channels: int = 8, size: int = 64, verbose: bool = True,
                         device: DeviceLike = None) -> bool:
    ok = True
    for level, (a, b) in contract_shapes(base_channels, size, device).items():
        match = a == b
        ok &= match
        if verbose:
            print(f"  {level}: teacher {a} vs student {b} {'OK' if match else 'MISMATCH'}")
    if verbose:
        print("distillation readiness:", "READY" if ok else "NOT READY")
    return bool(ok)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="teacher/student feature-shape contract")
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    args = p.parse_args(argv)
    ok = verify_compatibility(device=args.device)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
