"""Rows over several processes: the reference's own data parallelism, for
a cell whose global batch does not fit one card.

Each rank holds a contiguous share of every global batch's rows. `total`
sums a tensor over the ranks (an all-reduce), and so does its backward:
a global statistic feeds every rank's rows, so its gradient is the sum of
what each rank's rows send back. Every rank computes the same global loss,
so each rank's parameter gradients come out N times its rows' share of the
global gradient, and `reduce_grads` sums them over the N ranks and divides
by N. BatchNorm's statistics and the loss's sums are taken over the global
batch through `total`. With no process group (`RowShards(None)`) every sum
is local.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist


class _Total(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


class RowShards:
    """`group`: a torch.distributed process group, or None (one process)."""

    def __init__(self, group=None):
        self.group = group

    @property
    def ranks(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    def total(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.group is None else _Total.apply(x)

    @torch.no_grad()
    def reduce_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        if self.group is None:
            return grads
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.group)
        flat /= self.ranks
        out, off = [], 0
        for g in grads:
            out.append(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        return out
