"""The sparse (coarse) depth datasets over the BatVision V2 layout (port of
`data/sparse_depth.py`, the reference's SparseDepth_Dataset.py).

`SparseDepthDataset` scans the locations like the BV2 loader but keeps a
location only where both its annotation CSV and its `sparse_depth_{method}/`
folder (written by `tools/preprocess_sparse_depth.py`) exist, warning and
skipping it otherwise; the rows come in location order. A sample's depth is
that folder's .npy: NaN → 0, mm → m, clipped to [0, max_depth], resized
with the antialiased bilinear (`ops.resize.resize_bilinear_np`, torchvision
Resize semantics, not the cv2 nearest of the BV2 ground truth), ÷ max_depth
when depth_norm. `use_original_depth` adds the dense depth, loaded the same
way, as 'original_depth'. The audio is BV2's. Batches come from the Python
decoder in float32.

`BinnedSparseDepthDataset` adds int32 'bins' targets, bucketized in meters
(`data/bins.py`). The CSVs are read with the `csv` module (see
`data/batvision.py`).
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..configs import Config
from ..ops.resize import resize_bilinear_np
from .batvision import _batch_iter, _fix_length, _read_csv, load_wav
from .bins import compute_bin_edges, depth_to_bins_np
from .frontend import tof_cut_samples


def _load_sparse_depth(path: str, size: int, max_depth: float) -> np.ndarray:
    depth = np.load(path).astype(np.float32)
    depth = np.nan_to_num(depth)
    depth = depth / 1000.0
    if max_depth:
        depth[depth > max_depth] = max_depth
    depth[depth < 0] = 0.0
    return resize_bilinear_np(depth, size, size)


class SparseDepthDataset:
    def __init__(self, cfg: Config, annotation_file: str,
                 sparse_depth_method: str = "downup_015", use_original_depth: bool = False,
                 location_blacklist: Optional[Sequence[str]] = None):
        self.cfg = cfg
        ds = cfg.dataset
        self.root = ds.dataset_dir
        self.method = sparse_depth_method
        self.folder = f"sparse_depth_{sparse_depth_method}"
        self.use_original_depth = use_original_depth
        self.wave_len = tof_cut_samples(ds.max_depth, ds.sample_rate)

        locations = [
            d for d in sorted(os.listdir(self.root))
            if os.path.isdir(os.path.join(self.root, d))
            and not d.startswith((".", "__")) and not d.endswith("_unzipped")
        ]
        if location_blacklist:
            locations = [l for l in locations if l not in location_blacklist]
        rows: List[Dict[str, str]] = []
        found = False
        for loc in locations:
            csv_path = os.path.join(self.root, loc, annotation_file)
            sparse_dir = os.path.join(self.root, loc, self.folder)
            if os.path.exists(csv_path) and os.path.exists(sparse_dir):
                rows.extend(dict(r, location=loc) for r in _read_csv(csv_path))
                found = True
            elif not os.path.exists(sparse_dir):
                print(f"Warning: {sparse_dir} not found, skipping {loc}")
            else:
                print(f"Warning: {csv_path} not found, skipping {loc}")
        if not found:
            raise ValueError(f"No valid locations with {self.folder} in {self.root}")
        self.instances = rows

    def __len__(self):
        return len(self.instances)

    def sample(self, idx: int) -> Dict[str, np.ndarray]:
        row = self.instances[idx]
        ds = self.cfg.dataset
        sparse = _load_sparse_depth(
            os.path.join(self.root, row["location"], self.folder, row["depth file name"]),
            ds.images_size, ds.max_depth)
        if ds.depth_norm:
            sparse = sparse / ds.max_depth
        out = {"depth": sparse[..., None]}
        if self.use_original_depth:
            orig = _load_sparse_depth(
                os.path.join(self.root, row["depth path"], row["depth file name"]),
                ds.images_size, ds.max_depth)
            if ds.depth_norm:
                orig = orig / ds.max_depth
            out["original_depth"] = orig[..., None]
        wav, _ = load_wav(os.path.join(self.root, row["audio path"], row["audio file name"]))
        out["waveform"] = _fix_length(wav, self.wave_len)
        return out

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                drop_last: bool = True, shard=None) -> Iterator[Dict[str, np.ndarray]]:
        yield from _batch_iter(self, batch_size, shuffle, seed, drop_last, shard)


class BinnedSparseDepthDataset(SparseDepthDataset):
    """SparseDepthDataset with 'bins' targets (BinnedDepthDataset's)."""

    def __init__(self, *args, n_bins: int = 128, bin_mode: str = "linear",
                 sid_alpha: float = 0.6, depth_min: float = 0.1,
                 depth_max: Optional[float] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.n_bins = n_bins
        self.bin_edges, self.bin_centers = compute_bin_edges(
            n_bins, depth_min, depth_max or self.cfg.dataset.max_depth, bin_mode, sid_alpha)

    def sample(self, idx: int) -> Dict[str, np.ndarray]:
        out = super().sample(idx)
        depth_m = out["depth"][..., 0]
        if self.cfg.dataset.depth_norm:
            depth_m = depth_m * self.cfg.dataset.max_depth
        out["bins"] = depth_to_bins_np(depth_m, self.bin_edges)
        return out
