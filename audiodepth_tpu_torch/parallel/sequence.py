"""Sequence-parallel attention: the query rows split over the model axis
(the port of the JAX binaural attention's `sp_axis`).

Under a ('data', 'model') mesh JAX constrains q to P(None, 'model', None)
and GSPMD splits each attention by query rows, K and V whole. Every other
value is replicated over the model axis: each model rank of one data index
computes the same encoders, BatchNorms, decoder and loss on the same rows.
Here the collectives are explicit, each an autograd Function, so that every
parameter's gradient comes out whole on every rank and the model ranks stay
bit-equal without an all-reduce of the gradients over the model axis:

  * `take_rows`: this rank's rows of q (token axis, dim 1, padded with zero
    rows to sp·⌈N/sp⌉ where sp does not divide N); its backward all-gathers
    dq, so the replicated input of q's projection gets the whole gradient;
  * `sum_grad`: the identity, whose backward all-reduces the gradient (K's
    and V's: each rank's attention backward gives the sums over its own
    query rows only), in at least float32 and cast back once;
  * `gather_rows`: the attention outputs of every rank concatenated on the
    token axis and cut to N; its backward takes this rank's rows of the
    upstream gradient, which is the same on every rank (everything after
    the attention is replicated), so a reduce-scatter there would multiply
    it by sp.

Each slice is made contiguous: the attention kernels (B2 forward, B3
backward) take contiguous inputs only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .mesh import DataGroup


def rows_per_rank(n: int, sp: int) -> int:
    """Query rows a rank holds: ⌈N/sp⌉ (the last ranks' tails padded)."""
    return -(-n // sp)


def _mine(x: torch.Tensor, group: DataGroup) -> torch.Tensor:
    """This rank's rows of x [B, N, C] on dim 1, zero-padded, contiguous."""
    n = x.shape[1]
    per = rows_per_rank(n, group.size)
    pad = per * group.size - n
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    return x[:, group.rank * per:(group.rank + 1) * per].contiguous()


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group: DataGroup) -> torch.Tensor:
        ctx.group, ctx.n = group, x.shape[1]
        return _mine(x, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return ctx.group.all_gather_cat(grad, dim=1)[:, :ctx.n], None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group: DataGroup) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        acc = grad.to(torch.promote_types(grad.dtype, torch.float32))
        if acc is grad:
            acc = grad.clone()
        return ctx.group.all_reduce_(acc).to(grad.dtype), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group: DataGroup, n: int) -> torch.Tensor:
        ctx.group = group
        return group.all_gather_cat(x, dim=1)[:, :n]

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _mine(grad, ctx.group), None, None


def take_rows(x: torch.Tensor, group: DataGroup) -> torch.Tensor:
    return _TakeRows.apply(x, group)


def sum_grad(x: torch.Tensor, group: DataGroup) -> torch.Tensor:
    return _SumGrad.apply(x, group)


def gather_rows(x: torch.Tensor, group: DataGroup, n: int) -> torch.Tensor:
    return _GatherRows.apply(x, group, n)


def sequence_parallel_attention(attention, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                scale: float, group: DataGroup) -> torch.Tensor:
    """`attention(q, k, v, scale)` of q [B, N, dk] against k, v [B, M, ·]
    with the query rows split over `group`: this rank's ⌈N/sp⌉ rows
    against all M keys, the outputs gathered to [B, N, dv] on every rank."""
    n = q.shape[1]
    local = attention(take_rows(q, group), sum_grad(k, group), sum_grad(v, group), scale)
    return gather_rows(local, group, n)
