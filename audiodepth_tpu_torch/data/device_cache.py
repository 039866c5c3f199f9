"""Device-resident dataset cache: upload once, gather batches on the device
(port of `data/device_cache.py`).

In the compact transport dtypes (int16 waveform, uint16 depth:
data/codec.py) a BatVision split is small beside a card's memory, so the
cache uploads the whole split once and each step gathers its shuffled batch
on the device by indices; the host sends only the index vector. Epoch
reshuffles draw the host loader's permutation, so a cached epoch yields the
host loader's batches, encoded. The sharded branch of the JAX cache (one
row shard a chip) waits for several devices (ROADMAP.md A8).
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from .batvision import _batch_order
from .codec import encode_batch


class DeviceDatasetCache:
    def __init__(self, dataset, max_depth_units: float, device):
        """Materialize `dataset` (an object with .sample(i) and __len__) on
        `device`: each sample encoded to the compact dtypes as it is
        loaded, then stacked a key at a time (popping the per-sample
        arrays, so the host holds about one compact copy of the split),
        then uploaded once."""
        self.device = torch.device(device)
        self.n = n = len(dataset)
        samples = []
        for i in range(n):
            s = dataset.sample(i)
            enc = encode_batch({k: v[None] for k, v in s.items()}, max_depth_units)
            samples.append({k: v[0] for k, v in enc.items()})
        self.arrays: Dict[str, torch.Tensor] = {}
        for k in list(samples[0]):
            stacked = np.stack([s.pop(k) for s in samples])
            self.arrays[k] = torch.from_numpy(stacked).to(self.device)

    def batch(self, indices) -> Dict[str, torch.Tensor]:
        idx = torch.as_tensor(np.asarray(indices, np.int64), device=self.device)
        # uint16 is a shell dtype in PyTorch, with few kernels: gather its
        # bits through an int16 view (the gather only moves bits)
        return {k: (v.view(torch.int16).index_select(0, idx).view(torch.uint16)
                    if v.dtype == torch.uint16 else v.index_select(0, idx))
                for k, v in self.arrays.items()}

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                drop_last: bool = True) -> Iterator[Dict[str, torch.Tensor]]:
        for idx in _batch_order(self.n, batch_size, shuffle, seed, drop_last):
            yield self.batch(idx)

    def nbytes(self) -> int:
        return sum(v.numel() * v.element_size() for v in self.arrays.values())
