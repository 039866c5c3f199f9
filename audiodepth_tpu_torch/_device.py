"""Device resolution and matmul/conv precision settings for entry points."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. Raises when CUDA is asked for (explicitly or by default)
    and no card is present — the port never falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run on the CPU")
    return dev


def synchronize(device: DeviceLike) -> None:
    """Wait for the work queued on `device` (nothing to wait for on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def configure_precision() -> None:
    """Turn TF32 off for both cuBLAS matmuls and cuDNN convolutions.

    TF32 keeps about three decimal digits. The front end is defined as true
    fp32 (or f64), and the float32/float64 compute modes are parity modes,
    so no fp32 product on the port's path may round to TF32. The bfloat16
    mode's convolutions run in bf16 and are unaffected by either flag.
    These are process-wide settings of torch.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

