"""Closed-form model FLOPs of one pair, from the configuration's shapes
(see the package note for what counts), by the family's own file
`families/<family>.py`."""

from __future__ import annotations

from typing import Dict

from .families import family


def conv_macs(h_out: int, w_out: int, cin: int, cout: int, k: int) -> float:
    """Multiply-adds of a k × k convolution over an h_out × w_out output."""
    return float(h_out) * w_out * cin * cout * k * k


def model_flops(cfg: Dict) -> float:
    """FLOPs of one pair's forward for a configuration file's dict."""
    return family(cfg["family"]).forward_flops(cfg)


def train_flops_per_pair(cfg: Dict) -> float:
    """A trained pair: the family's count, or forward and backward, 3 × the
    forward, where the family gives none."""
    count = getattr(family(cfg["family"]), "train_flops_per_pair", None)
    return count(cfg) if count is not None else 3.0 * model_flops(cfg)
