"""Device-resident dataset cache: upload once, gather batches on the device
(port of `data/device_cache.py`).

In the compact transport dtypes (int16 waveform, uint16 depth:
data/codec.py) a BatVision split is small beside a card's memory, so the
cache uploads the whole split once and each step gathers its shuffled batch
on the device by indices; the host sends only the index vector. Epoch
reshuffles draw the host loader's permutation, so a cached epoch yields the
host loader's batches, encoded.

Row-sharded (`group`, the JAX cache's `sharding=`): each of the N ranks
loads and holds ⌈n/N⌉ contiguous rows of the split (the last rank's tail
padded with row 0, as the JAX cache pads), about 1/N of the split. A batch
is then gathered by a collective: every rank contributes the batch's rows
it holds, the contributions are all-gathered as bytes, and each row is
taken from its holder, so the batch is bit for bit the one-rank cache's.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..obs.spans import span
from ..parallel.mesh import DataGroup
from ..parallel.multihost import local_batch_slice
from .batvision import Shard, _batch_order
from .codec import encode_batch


def _bits(v: torch.Tensor) -> torch.Tensor:
    # uint16 is a shell dtype in PyTorch, with few kernels: move its bits
    # through an int16 view (a gather only moves bits)
    return v.view(torch.int16) if v.dtype == torch.uint16 else v


class DeviceDatasetCache:
    def __init__(self, dataset, max_depth_units: float, device,
                 group: Optional[DataGroup] = None):
        """Materialize `dataset` (an object with .sample(i) and __len__) on
        `device`: each sample encoded to the compact dtypes as it is
        loaded, then stacked a key at a time (popping the per-sample
        arrays, so the host holds about one compact copy of the rows),
        then uploaded once (span `cache.encode`: the rows' encode and the
        stacking). With a `group`, only this rank's rows."""
        self.device = torch.device(device)
        self.n = n = len(dataset)
        self.group = group
        size, rank = (1, 0) if group is None else (group.size, group.rank)
        self.rows_per_rank = k = -(-n // size)
        with span("cache.encode"):
            samples = []
            for i in range(rank * k, (rank + 1) * k):
                s = dataset.sample(i if i < n else 0)
                enc = encode_batch({key: v[None] for key, v in s.items()}, max_depth_units)
                samples.append({key: v[0] for key, v in enc.items()})
            stacked = {key: np.stack([s.pop(key) for s in samples]) for key in list(samples[0])}
        self.arrays: Dict[str, torch.Tensor] = {
            key: torch.from_numpy(stacked.pop(key)).to(self.device) for key in list(stacked)}

    def batch(self, indices) -> Dict[str, torch.Tensor]:
        """The rows `indices` of the split (global indices). Sharded, a
        collective: every rank of the group calls it with the same indices."""
        with span("cache.gather", self.device):
            return self._gather(np.asarray(indices, np.int64))

    def _gather(self, idx: np.ndarray) -> Dict[str, torch.Tensor]:
        if self.group is None:
            sel = torch.as_tensor(idx, device=self.device)
            return {key: _bits(v).index_select(0, sel).view(v.dtype)
                    for key, v in self.arrays.items()}
        owner = idx // self.rows_per_rank
        mine = np.nonzero(owner == self.group.rank)[0]
        pos = torch.as_tensor(mine, device=self.device)
        local = torch.as_tensor(idx[mine] % self.rows_per_rank, device=self.device)
        pick = torch.as_tensor(owner * len(idx) + np.arange(len(idx)), device=self.device)
        out = {}
        for key, v in self.arrays.items():
            bits = _bits(v)
            part = bits.new_zeros((len(idx),) + tuple(bits.shape[1:]))
            part.index_copy_(0, pos, bits.index_select(0, local))
            rows = self.group.all_gather_rows(part)
            out[key] = rows.index_select(0, pick).view(v.dtype)
        return out

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                drop_last: bool = True, shard: Shard = None
                ) -> Iterator[Dict[str, torch.Tensor]]:
        """The epoch's batches in the host loader's order; with
        `shard=(rank, world_size)`, that rank's rows of each."""
        for idx in _batch_order(self.n, batch_size, shuffle, seed, drop_last):
            if shard is None:
                yield self.batch(idx)
            elif self.group is None:
                yield self.batch(idx[local_batch_slice(len(idx), *shard)])
            else:
                rows = local_batch_slice(len(idx), *shard)
                yield {key: v[rows] for key, v in self.batch(idx).items()}

    def nbytes(self) -> int:
        """This rank's bytes of the split."""
        return sum(v.numel() * v.element_size() for v in self.arrays.values())
