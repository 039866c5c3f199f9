"""Published peaks of the cards the benchmark may meet (NVIDIA data sheets,
dense rates without sparsity, at the card's full power limit)."""

from __future__ import annotations

from typing import Dict

# bf16 tensor FLOP/s, fp32 FLOP/s on the CUDA cores, HBM bytes/s, SMs, the
# largest SM clock (Hz) and the special-function unit's exp2 a clock and SM
PEAKS: Dict[str, Dict[str, float]] = {
    "H100 SXM": {"bf16": 989e12, "fp32": 67e12, "hbm": 3.35e12, "sms": 132,
                 "clock": 1.98e9, "ex2_per_clock_sm": 16},
    "H100 PCIe": {"bf16": 756e12, "fp32": 51e12, "hbm": 2.0e12, "sms": 114,
                  "clock": 1.755e9, "ex2_per_clock_sm": 16},
    "H100 NVL": {"bf16": 835e12, "fp32": 60e12, "hbm": 3.9e12, "sms": 132,
                 "clock": 1.785e9, "ex2_per_clock_sm": 16},
}


def peak_for(device_name: str) -> Dict[str, float]:
    """The peaks of a card by its `torch.cuda.get_device_name()`; an
    unknown card raises (a share of an unknown peak means nothing)."""
    if "H100" not in device_name:
        raise ValueError(f"no published peaks for {device_name!r}")
    key = "H100 PCIe" if "PCIe" in device_name else "H100 NVL" if "NVL" in device_name \
        else "H100 SXM"
    return PEAKS[key]
