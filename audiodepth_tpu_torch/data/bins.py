"""Depth binning: linear / log / SID edges and bucketization (port of
`data/bins.py`, the reference's BinnedDepthDataset machinery):
  linear: linspace(d_min, d_max, n+1)
  log:    logspace(log10 d_min, log10 d_max, n+1)
  sid:    d_min · (d_max/d_min)^(t^α), t = linspace(0, 1, n+1), α = 0.6 (DORN)
  centers = edge midpoints (computed in float64, both cast to float32);
  indices = searchsorted(edges[1:-1], depth, side="left") clipped to
  [0, n-1], which is torch.bucketize(right=False).
Bins are always bucketized in meters.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def compute_bin_edges(n_bins: int, depth_min: float = 0.1, depth_max: float = 30.0,
                      mode: str = "linear", sid_alpha: float = 0.6
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(edges [n+1], centers [n]) as float32 numpy arrays."""
    if mode == "linear":
        edges = np.linspace(depth_min, depth_max, n_bins + 1)
    elif mode == "log":
        edges = np.logspace(np.log10(depth_min), np.log10(depth_max), n_bins + 1)
    elif mode == "sid":
        t = np.linspace(0.0, 1.0, n_bins + 1)
        edges = depth_min * (depth_max / depth_min) ** (t ** sid_alpha)
    else:
        raise ValueError(f"unknown bin mode {mode!r}")
    centers = 0.5 * (edges[:-1] + edges[1:])
    return edges.astype(np.float32), centers.astype(np.float32)


def depth_to_bins(depth: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Bin indices in [0, n_bins-1], int32, of a depth tensor in meters."""
    n_bins = edges.shape[0] - 1
    idx = torch.bucketize(depth, edges[1:-1].to(depth), right=False)
    return idx.clamp(0, n_bins - 1).to(torch.int32)


def depth_to_bins_np(depth: np.ndarray, edges: np.ndarray) -> np.ndarray:
    n_bins = edges.shape[0] - 1
    idx = np.searchsorted(edges[1:-1], depth, side="left")
    return np.clip(idx, 0, n_bins - 1).astype(np.int32)


def add_bins_to_batch(batch: dict, edges: np.ndarray, max_depth: float,
                      depth_norm: bool) -> dict:
    """The batch with int32 bin targets 'bins' [B, H, W], bucketized in
    meters: normalized depth is scaled by max_depth first, and compact
    uint16 depth (data/codec.py) is decoded to its units first."""
    depth = batch["depth"][..., 0]
    if depth.dtype == np.uint16:
        units = 1.0 if depth_norm else max_depth
        depth = depth.astype(np.float32) * (units / 65535.0)
    if depth_norm:
        depth = depth * max_depth
    out = dict(batch)
    out["bins"] = depth_to_bins_np(depth, edges)
    return out
