"""Optimizer and learning-rate schedule factory (port of `train/optim.py`).

The reference training scripts' settings: Adam / AdamW / SGD (train.py:471-476),
global-norm gradient clipping at 1.0, AdamW weight decay 0.01, cosine
annealing to 1% of lr, StepLR(50 epochs, 0.5) and CosineAnnealingWarmRestarts
(T_0 = 20 epochs, T_mult = 2). Every schedule is evaluated PER STEP, as the
JAX package's optax schedules are, and gives optax's values.

Clipping follows optax's `clip_by_global_norm`: the gradients are scaled by
max_norm / norm when norm ≥ max_norm, with no +1e-6 in the denominator (so
`torch.nn.utils.clip_grad_norm_` is not used); `grad_clip_norm ≤ 0` turns
clipping off. Adam and AdamW are torch's, whose update is optax's
`scale_by_adam` (eps 1e-8 outside the square root) with decoupled decay.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List

import torch

from ..configs import ModeConfig

Schedule = Callable[[int], float]


def _cosine(init_value: float, decay_steps: int, alpha: float) -> Schedule:
    def schedule(count: int) -> float:
        t = min(float(count), float(decay_steps))
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
        return init_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def make_schedule(mode: ModeConfig, steps_per_epoch: int) -> Schedule:
    """lr as a function of the 0-based step count."""
    lr = mode.learning_rate
    kind = (mode.lr_schedule or "constant").lower()
    total = max(1, mode.epochs * steps_per_epoch)
    if kind == "constant":
        return lambda count: lr
    if kind == "cosine":
        # anneal to 1% of peak (CosineAnnealingLR with eta_min = 0.01·lr)
        return _cosine(lr, total, 0.01)
    if kind == "step":
        # StepLR(step_size = 50 epochs, gamma = 0.5)
        boundaries = [i * 50 * steps_per_epoch for i in range(1, mode.epochs // 50 + 1)]
        return lambda count: lr * 0.5 ** sum(count >= b for b in boundaries)
    if kind == "warm_restarts":
        # CosineAnnealingWarmRestarts(T_0 = 20 epochs, T_mult = 2, eta_min = 1e-6)
        starts, periods = [], []
        t, covered = 20 * steps_per_epoch, 0
        while covered < total:
            starts.append(covered)
            periods.append(t)
            covered += t
            t *= 2
        cycles = [_cosine(lr, p, 1e-6 / lr) for p in periods]

        def schedule(count: int) -> float:
            i = max(j for j, s in enumerate(starts) if j == 0 or count >= s)
            return cycles[i](count - starts[i])

        return schedule
    raise ValueError(f"unknown lr_schedule {kind!r}")


def make_optimizer(params: Iterable[torch.nn.Parameter], mode: ModeConfig) -> torch.optim.Optimizer:
    """Adam, AdamW (decoupled decay mode.weight_decay) or SGD (momentum
    mode.sgd_momentum) over `params`; the engine sets each step's lr from
    `make_schedule`."""
    params = list(params)
    name = mode.optimizer.lower()
    lr = mode.learning_rate
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=mode.weight_decay)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=mode.sgd_momentum or 0.0)
    raise ValueError(f"unknown optimizer {mode.optimizer!r}")


@torch.no_grad()
def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ g²) over every gradient, in at least float32."""
    acc = torch.promote_types(grads[0].dtype, torch.float32)
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g, dtype=acc) for g in grads]))


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], norm: torch.Tensor, max_norm: float) -> None:
    """optax's `clip_by_global_norm` in place: g ← (g / norm)·max_norm
    where norm ≥ max_norm; nothing otherwise. No host synchronisation."""
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
