"""The data group and the 2-D ('data', 'model') group (port of
`parallel/mesh.py`).

A JAX ('data',) mesh runs the single-device program on the global batch:
parameters replicated, the batch sharded on dim 0, gradients and BatchNorm
statistics reduced over the mesh. Here the same program runs in one process
a rank, each holding its contiguous rows of the global batch, and the
reductions are explicit:

  * `global_sum` sums a tensor over the group, differentiably: an
    all-reduce forward and an all-reduce backward. Every batch reduction of
    the losses and of BatchNorm goes through it, so each rank computes the
    global batch's loss and statistics. With no group active (or a group of
    one rank) it is the identity.
  * The backward of an all-reduce sums the incoming gradient over the
    ranks, so each rank's parameter gradient comes out N times its share of
    the global one: `all_reduce_grads_` sums the gradients and divides by N.
  * `broadcast_module` makes every rank start from rank 0's parameters and
    buffers.

A `MeshGroup` is the JAX package's ('data', 'model') mesh of dp × sp
ranks: world rank d·sp + m sits at (d, m), as in `make_mesh(n, ("data",
"model"), (dp, sp))`. Its data subgroup (the ranks of one model index)
takes every reduction above; its model subgroup (the sp ranks of one data
index) holds the same rows of the global batch and computes the same
program on them, except where a layer splits its work over the model axis
(the binaural attention's query rows, `parallel/sequence.py`; the plain
STFT's frames, `parallel/sharded_stft.py`).

The group a step runs in is the active one (`use_group`), which the engine
sets around its steps, so the losses and the layers take no group argument:
`active_group()` is the data group, `active_axis("model")` the model group.
It is a module global, not a thread-local: a backward on a CUDA device runs
on autograd's own thread, and a recomputed forward (`layers.remat`) there
must see the same group.

With the gloo backend, collectives on CUDA tensors (two processes sharing
one card) are staged through pinned host memory: gloo's all-gather does not
take CUDA tensors, and one staged path for all of them keeps the gloo route
uniform. NCCL takes the device tensors as they are.

Every collective is counted (`collectives`) by kind under the JAX names
(`all-reduce`, `all-gather`, `collective-permute`, `broadcast`) with the
bytes of its result on this rank, an all-gather at its gathered size, as
`tools/multichip_scaling.py` of the JAX package reads them from HLO.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Iterable, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


KINDS = ("all-reduce", "all-gather", "collective-permute", "broadcast")


class CollectiveCounts:
    """{kind: {"count", "bytes"}} of this process's collectives since the
    last `reset`; reset and read like the kernels' launch counters."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.counts = {k: {"count": 0, "bytes": 0} for k in KINDS}

    def add(self, kind: str, nbytes: int) -> None:
        self.counts[kind]["count"] += 1
        self.counts[kind]["bytes"] += int(nbytes)

    def read(self) -> dict:
        """The kinds that ran, as the JAX tool's `collective_stats` gives them."""
        return {k: dict(v) for k, v in self.counts.items() if v["count"]}


collectives = CollectiveCounts()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class DataGroup:
    """The ranks of one group: its size, this process's rank and the
    process group the collectives run on (None: the default one)."""

    def __init__(self, group: Optional[dist.ProcessGroup] = None):
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialized "
                               "(parallel.multihost.initialize_multihost)")
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = str(dist.get_backend(group))

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    @staticmethod
    def _to_host(t: torch.Tensor) -> torch.Tensor:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t.detach())
        return host

    def _global_rank(self, rank: int) -> int:
        return rank if self.group is None else dist.get_global_rank(self.group, rank)

    # -- collectives ----------------------------------------------------
    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the group in place."""
        collectives.add("all-reduce", _nbytes(t))
        if self._staged(t):
            host = self._to_host(t)
            dist.all_reduce(host, group=self.group)
            t.copy_(host)
        else:
            dist.all_reduce(t, group=self.group)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Overwrite `t` with rank `src`'s in place."""
        collectives.add("broadcast", _nbytes(t))
        src = self._global_rank(src)
        if self._staged(t):
            host = self._to_host(t)
            dist.broadcast(host, src, group=self.group)
            t.copy_(host)
        else:
            dist.broadcast(t, src, group=self.group)
        return t

    def _gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's `t` (equal shapes), in rank order, on t's device.
        The bytes are gathered, so any dtype goes (NCCL has no uint16) and
        the values arrive bit for bit."""
        t = t.contiguous()
        collectives.add("all-gather", self.size * _nbytes(t))
        flat = t.reshape(-1).view(torch.uint8)
        staged = self._staged(t)
        if staged:
            flat = self._to_host(flat)
        out = [torch.empty_like(flat) for _ in range(self.size)]
        dist.all_gather(out, flat, group=self.group)
        if staged:
            out = [o.to(t.device) for o in out]
        return [o.view(t.dtype).reshape(t.shape) for o in out]

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t` (equal shapes), concatenated on dim 0 in rank
        order, bit for bit."""
        return torch.cat(self._gather(t))

    def all_gather_cat(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's `t` (equal shapes), concatenated on `dim` in rank
        order, bit for bit (a new contiguous tensor)."""
        return torch.cat(self._gather(t), dim=dim)

    def from_right(self, t: torch.Tensor) -> Optional[torch.Tensor]:
        """The right neighbour's `t` (rank r receives rank r + 1's; every
        shape equal): JAX's ppermute i + 1 → i, point to point. Rank 0
        sends nothing and the last rank receives nothing (None). Counted as
        a `collective-permute` of the bytes this rank receives."""
        t = t.contiguous()
        staged = self._staged(t)
        send = self._to_host(t) if staged else t
        recv = torch.empty_like(send) if self.rank + 1 < self.size else None
        ops = []
        if self.rank > 0:
            ops.append(dist.P2POp(dist.isend, send, self._global_rank(self.rank - 1),
                                  self.group))
        if recv is not None:
            ops.append(dist.P2POp(dist.irecv, recv, self._global_rank(self.rank + 1),
                                  self.group))
            collectives.add("collective-permute", _nbytes(recv))
        for work in (dist.batch_isend_irecv(ops) if ops else ()):
            work.wait()
        if recv is not None and staged:
            recv = recv.to(t.device)
        return recv

    def barrier(self) -> None:
        dist.barrier(group=self.group)

    def any(self, flag: bool) -> bool:
        """Whether `flag` is set on any rank (an all-reduce of one number)."""
        t = torch.tensor([1.0 if flag else 0.0])
        if self.backend == "nccl":
            t = t.cuda()
        return float(self.all_reduce_(t)) > 0


class RankDevice(NamedTuple):
    """A position of a `MeshGroup`: its world rank and its process (in the
    port one process a rank), the fields of a JAX device the mesh helpers
    read."""

    id: int
    process_index: int


class MeshGroup:
    """The ('data', 'model') mesh of dp × sp ranks: world rank d·sp + m at
    (d, m). `world` holds every rank (the initial broadcast, rank 0's logs
    and checkpoints, the SIGTERM flag); `data` the dp ranks of this model
    index (the batch reductions); `model` the sp ranks of this data index
    (the sequence-parallel layers).

    Every process of the world must build every MeshGroup, in the same
    order: each creates every subgroup (`dist.new_group`), the ones it is
    not in included, or the world hangs."""

    axis_names = ("data", "model")

    def __init__(self, dp: int, sp: int, world: DataGroup, data: DataGroup, model: DataGroup):
        self.shape = (dp, sp)
        self.world, self.data, self.model = world, data, model
        self.coords = divmod(world.rank, sp)
        devices = np.empty(dp * sp, dtype=object)
        devices[:] = [RankDevice(r, r) for r in range(dp * sp)]
        self.devices = devices.reshape(dp, sp)

    @property
    def size(self) -> int:
        return self.world.size

    @property
    def rank(self) -> int:
        return self.world.rank

    @property
    def is_main(self) -> bool:
        return self.world.is_main

    def barrier(self) -> None:
        self.world.barrier()

    def axis(self, name: str) -> DataGroup:
        return {"data": self.data, "model": self.model}[name]

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]

    def local_rows(self, global_batch_size: int) -> slice:
        """The rows of the global batch this rank loads: its data index's
        (every rank of a model group holds the same rows)."""
        from .multihost import local_batch_slice

        return local_batch_slice(global_batch_size, self.coords[0], self.shape[0])


def make_mesh_group(dp: int, sp: int) -> MeshGroup:
    """The ('data', 'model') mesh of dp × sp over the whole initialized
    world, with JAX `make_mesh`'s layout. A collective call: every process
    makes it, in the same order."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized "
                           "(parallel.multihost.initialize_multihost)")
    if dist.get_world_size() != dp * sp:
        raise ValueError(f"a {dp} x {sp} mesh needs {dp * sp} ranks, "
                         f"the world has {dist.get_world_size()}")
    grid = np.arange(dp * sp).reshape(dp, sp)
    datas = [dist.new_group(grid[:, m].tolist()) for m in range(sp)]
    models = [dist.new_group(grid[d, :].tolist()) for d in range(dp)]
    d, m = divmod(dist.get_rank(), sp)
    return MeshGroup(dp, sp, DataGroup(), DataGroup(datas[m]), DataGroup(models[d]))


def model_axes_cross_processes(mesh, data_axis: str = "data",
                               process_count: Optional[int] = None) -> bool:
    """Whether stepping along a non-data axis of `mesh` (an object with
    `devices`, an array of things with `process_index`, and `axis_names`:
    a `MeshGroup` or a JAX mesh) changes the owning process: the condition
    under which per-process contiguous batch slices stop tiling the data
    axis (`shard_global_batch`). `process_count` defaults to the processes
    of the mesh's devices. In the port each rank is a process, so a model
    axis of more than one rank always crosses processes."""
    devs = np.asarray(mesh.devices)
    if process_count is None:
        process_count = len({d.process_index for d in devs.ravel()})
    if process_count <= 1:
        return False
    for i, name in enumerate(mesh.axis_names):
        if name == data_axis or devs.shape[i] == 1:
            continue
        first = np.take(devs, 0, axis=i).ravel()
        second = np.take(devs, 1, axis=i).ravel()
        if any(a.process_index != b.process_index for a, b in zip(first, second)):
            return True
    return False


def shard_global_batch(batch: Any, group) -> Any:
    """This rank's rows of a batch every rank holds in full (the JAX
    package's global-batch convention, for meshes whose model axis crosses
    processes): the rows of its data index, the same on every rank of a
    model group. A `DataGroup` takes its rank's contiguous rows; no group,
    the batch."""
    if group is None:
        return batch
    n = int(next(iter(batch.values())).shape[0])
    if isinstance(group, MeshGroup):
        rows = group.local_rows(n)
    else:
        from .multihost import local_batch_slice

        rows = local_batch_slice(n, group.rank, group.size)
    return {k: v[rows] for k, v in batch.items()}


def data_axis(group) -> Optional[DataGroup]:
    """The group's data axis (a `DataGroup` is one)."""
    return group.data if isinstance(group, MeshGroup) else group


def world_of(group) -> Optional[DataGroup]:
    """Every rank of the group (a `DataGroup`'s are its own)."""
    return group.world if isinstance(group, MeshGroup) else group


# the active (data, model) groups
_ACTIVE: List[Optional[DataGroup]] = [None, None]


def active_group() -> Optional[DataGroup]:
    """The data group of the step that is running (None outside one)."""
    return _ACTIVE[0]


def active_axis(name: str) -> Optional[DataGroup]:
    """The running step's group along a mesh axis, "data" or "model"
    (None outside a step, or for "model" under a 1-D group)."""
    return _ACTIVE[("data", "model").index(name)]


@contextlib.contextmanager
def use_group(group) -> Iterator[None]:
    """Run the enclosed steps in `group`: a `DataGroup`, a `MeshGroup`
    (its data and model axes) or None (one rank)."""
    prev = list(_ACTIVE)
    _ACTIVE[:] = ([group.data, group.model] if isinstance(group, MeshGroup)
                  else [group, None])
    try:
        yield
    finally:
        _ACTIVE[:] = prev


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group: DataGroup) -> torch.Tensor:
        ctx.group = group
        return group.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return ctx.group.all_reduce_(grad.clone()), None


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """`x` summed over the active data group, differentiably (all-reduce
    forward and backward); the identity on one rank."""
    group = active_group()
    if group is None or group.size == 1:
        return x
    return _AllReduceSum.apply(x, group)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of every element of `x` over the global batch: the global
    sum over the global element count. Every rank holds as many rows
    (`global_rows`), so that count is the local one times the group's size
    and needs no collective."""
    group = active_group()
    return global_sum(x.sum()) / (x.numel() * (1 if group is None else group.size))


def global_rows(local_rows: int) -> Tuple[int, int]:
    """(rows of the global batch, the first of this rank's) for a local
    batch of `local_rows`: every rank holds as many rows
    (`multihost.local_batch_slice`, `multihost.local_shard`)."""
    group = active_group()
    if group is None:
        return local_rows, 0
    return local_rows * group.size, local_rows * group.rank


def draw_global(draw: Callable[[int], torch.Tensor], local_rows: int) -> torch.Tensor:
    """`draw(n)` for the global batch's n rows, cut to this rank's: an
    N-rank step then draws what a one-rank step on the global batch does."""
    n, start = global_rows(local_rows)
    return draw(n)[start:start + local_rows]


def broadcast_module(module: torch.nn.Module, group: DataGroup, src: int = 0) -> None:
    """Every parameter and buffer of `module` set to rank `src`'s."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            group.broadcast_(t.data, src)


def all_reduce_grads_(grads: Iterable[torch.Tensor], group: DataGroup) -> None:
    """Sum the gradients over the group and divide by its size, in place:
    each rank's gradient of the global loss is N times its share (the
    backward of `global_sum` sums over the ranks), so the mean of the sums
    is the global gradient. One flat all-reduce per dtype."""
    by_dtype: dict = {}
    for g in grads:
        by_dtype.setdefault((g.dtype, g.device), []).append(g)
    for gs in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in gs])
        group.all_reduce_(flat)
        flat.div_(group.size)
        offset = 0
        for g in gs:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def _rows(x) -> int:
    return int(x.shape[0])


def pad_batch_to(batch: Any, target_rows: int) -> Any:
    """Pad every array's leading dim to target_rows and add a `_valid` row
    mask (float32): pad rows repeat row 0 and carry 0, so the forward sees
    well-formed data and the metrics and the criterion leave them out. An
    already padded batch keeps its mask (its pad rows stay invalid). Numpy
    arrays and tensors alike (the device cache's batches are tensors)."""
    rows = _rows(next(iter(batch.values())))
    pad = target_rows - rows
    if pad < 0:
        raise ValueError(f"batch of {rows} rows exceeds target {target_rows}")
    prior = (np.asarray(_to_numpy(batch["_valid"]), np.float32) if "_valid" in batch
             else np.ones(rows, np.float32))
    valid = np.concatenate([prior, np.zeros(pad, np.float32)])
    if pad:
        batch = {k: _pad_rows(v, pad) for k, v in batch.items()}
    else:
        batch = dict(batch)
    ref = next((v for k, v in batch.items() if k != "_valid"), None)
    if isinstance(ref, torch.Tensor):
        batch["_valid"] = torch.from_numpy(valid).to(ref.device)
    else:
        batch["_valid"] = valid
    return batch


def _to_numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _pad_rows(x, pad: int):
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x[:1].expand((pad,) + tuple(x.shape[1:]))])
    x = np.asarray(x)
    return np.concatenate([x, np.broadcast_to(x[:1], (pad,) + x.shape[1:])], axis=0)
