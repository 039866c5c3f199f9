"""The 1-D data group (port of `parallel/mesh.py`).

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

The group a step runs in is the active one (`use_group`), which the engine
sets around its steps, so the losses and the layers take no group argument.
It is a module global, not a thread-local: a backward on a CUDA device runs
on autograd's own thread, and a recomputed forward (`layers.remat`) there
must see the same group.

With the gloo backend, collectives on CUDA tensors (two processes sharing
one card) are staged through pinned host memory: gloo's all-gather does not
take CUDA tensors, and one staged path for all of them keeps the gloo route
uniform. NCCL takes the device tensors as they are.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


class DataGroup:
    """The ranks of one data-parallel group: its size, this process's rank
    and the process group the collectives run on (None: the default one)."""

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

    # -- collectives ----------------------------------------------------
    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the group in place."""
        if self._staged(t):
            host = self._to_host(t)
            dist.all_reduce(host, group=self.group)
            t.copy_(host)
        else:
            dist.all_reduce(t, group=self.group)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Overwrite `t` with rank `src`'s in place."""
        if self._staged(t):
            host = self._to_host(t)
            dist.broadcast(host, src, group=self.group)
            t.copy_(host)
        else:
            dist.broadcast(t, src, group=self.group)
        return t

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t` (equal shapes), concatenated on dim 0 in rank
        order. The bytes are gathered, so any dtype goes (NCCL has no
        uint16) and the rows arrive bit for bit."""
        t = t.contiguous()
        flat = t.reshape(-1).view(torch.uint8)
        staged = self._staged(t)
        if staged:
            flat = self._to_host(flat)
        out = [torch.empty_like(flat) for _ in range(self.size)]
        dist.all_gather(out, flat, group=self.group)
        rows = torch.cat(out)
        if staged:
            rows = rows.to(t.device)
        return rows.view(t.dtype).reshape((self.size * t.shape[0],) + tuple(t.shape[1:]))

    def barrier(self) -> None:
        dist.barrier(group=self.group)

    def any(self, flag: bool) -> bool:
        """Whether `flag` is set on any rank (an all-reduce of one number)."""
        t = torch.tensor([1.0 if flag else 0.0])
        if self.backend == "nccl":
            t = t.cuda()
        return float(self.all_reduce_(t)) > 0


_ACTIVE: List[Optional[DataGroup]] = [None]


def active_group() -> Optional[DataGroup]:
    """The data group of the step that is running (None outside one)."""
    return _ACTIVE[0]


@contextlib.contextmanager
def use_group(group: Optional[DataGroup]) -> Iterator[None]:
    """Run the enclosed steps in `group` (None: on one rank)."""
    prev = _ACTIVE[0]
    _ACTIVE[0] = group
    try:
        yield
    finally:
        _ACTIVE[0] = prev


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
