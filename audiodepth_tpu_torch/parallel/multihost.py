"""Process-group setup and the per-rank batch slices (port of
`parallel/multihost.py`).

    group = initialize_multihost("file:///tmp/init", num_processes=2, process_id=r)
    eng = Engine(cfg, task, steps_per_epoch, group=group)
    # each rank loads local_batch_slice(global_batch) of every train batch

`torch.distributed` needs its address, world size and rank given: nothing
tells a process of a cluster. The backend is NCCL on cards and gloo on the
CPU (or where asked: two processes sharing one card need gloo, since NCCL
refuses two ranks on one GPU).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .mesh import DataGroup, pad_batch_to


def initialize_multihost(coordinator_address: str, num_processes: int, process_id: int,
                         backend: Optional[str] = None,
                         device: Optional[torch.device] = None) -> DataGroup:
    """Join the process group at `coordinator_address` (an init method:
    `tcp://host:port` or `file:///path`; a bare `host:port` is taken as
    tcp) as rank `process_id` of `num_processes`, and return the data
    group over all of them. `backend` defaults to nccl where a card is
    present and gloo elsewhere; `device`, a card, becomes the process's
    current device before the group starts (NCCL ranks need theirs)."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init, world_size=int(num_processes),
                            rank=int(process_id))
    return DataGroup()


def shutdown() -> None:
    """Leave the process group (where one was joined)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_world(rank: Optional[int], world_size: Optional[int]) -> Tuple[int, int]:
    if rank is not None and world_size is not None:
        return int(rank), int(world_size)
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_batch_slice(global_batch_size: int, rank: Optional[int] = None,
                      world_size: Optional[int] = None) -> slice:
    """The row range of the global batch this rank loads (default: the
    initialized group's rank and size, else one rank).

    The global batch must divide evenly: flooring would drop the remainder
    rows on every rank. Ragged (eval-tail) batches go through
    `local_shard`, which pads identically on every rank."""
    rank, nproc = _rank_world(rank, world_size)
    if global_batch_size % nproc != 0:
        raise ValueError(
            f"global batch {global_batch_size} is not divisible by "
            f"{nproc} processes; use local_shard for ragged eval batches")
    per_host = global_batch_size // nproc
    start = rank * per_host
    return slice(start, start + per_host)


def local_shard(global_batch: dict, axis_size: int, rank: Optional[int] = None,
                world_size: Optional[int] = None) -> dict:
    """This rank's rows of a (possibly ragged) GLOBAL batch: the batch
    padded to the next multiple of the data axis's size (pad rows repeat
    row 0 and carry `_valid` 0, `mesh.pad_batch_to`), then the rank's
    contiguous range. Every rank pads the same global batch the same way."""
    rank, nproc = _rank_world(rank, world_size)
    if axis_size % nproc != 0:
        raise ValueError(f"data axis {axis_size} not divisible by {nproc} processes")
    rows = int(next(iter(global_batch.values())).shape[0])
    target = -(-rows // axis_size) * axis_size
    padded = pad_batch_to(global_batch, target)
    per_host = target // nproc
    start = rank * per_host
    return {k: (v[start:start + per_host] if isinstance(v, torch.Tensor)
                else np.asarray(v)[start:start + per_host]) for k, v in padded.items()}
