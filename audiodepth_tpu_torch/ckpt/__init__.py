"""Checkpoints on `torch.save` (port of `ckpt/__init__.py`).

One manager per experiment, the layout of the JAX package's:

  * `{root}/{experiment_name}/checkpoint_{epoch}.pth`, the reference's file
    names (./checkpoints/<exp>/checkpoint_<epoch>.pth), and `best.json`
    naming the best epoch;
  * each file is a reference-format dict: `state_dict` (the model's
    parameters and BatchNorm statistics under the reference's key names,
    so a port checkpoint is also a reference `.pth` that
    `tools/import_jax.load_torch_state_dict` and the reference itself load),
    `epoch`, `optimizer` (its state_dict), `step`, `aux` and `metrics`;
  * auto-resume from the latest epoch with the optimizer state and the step
    (`restore`), or the model alone (`restore_eval`).

Tensors are saved on the CPU, so a checkpoint written on the card restores
on the CPU and back. A save writes a temporary file and renames it, so a
crash never leaves half a checkpoint. Saves are synchronous (the JAX
manager's `wait` and `close` have nothing to do here).

In a data-parallel run (`group`) every rank calls `save` and `mark_best`
at the same points: rank 0 writes and the others wait at a barrier, so a
checkpoint is complete on the shared file system when any rank goes on.
Every rank restores from the file, and a file restores on any number of
ranks: the ranks hold the same replicated state, and the step and the
epoch (hence the epoch shuffle stream) do not depend on the world size.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

_FILE = re.compile(r"checkpoint_(\d+)\.pth$")


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


class CheckpointManager:
    def __init__(self, root: str, experiment_name: str, max_to_keep: int = 20,
                 create: bool = True, group=None):
        self.directory = os.path.abspath(os.path.join(root, experiment_name))
        self.max_to_keep = max_to_keep
        self.group = group
        if create:
            os.makedirs(self.directory, exist_ok=True)

    @property
    def _writes(self) -> bool:
        return self.group is None or self.group.is_main

    def _wait_for_writer(self) -> None:
        if self.group is not None:
            self.group.barrier()

    def path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"checkpoint_{int(epoch)}.pth")

    def all_epochs(self) -> List[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for m in map(_FILE.match, os.listdir(self.directory)) if m)

    def save(self, epoch: int, state, aux: Optional[Dict[str, Any]] = None,
             metrics: Optional[Dict[str, float]] = None) -> None:
        """Write epoch `epoch` of a TrainState (model, optimizer, step);
        idempotent per epoch (a best save and a periodic save may coincide).
        In a group rank 0 writes and every rank returns after the write."""
        if self._writes:
            self._write(epoch, state, aux, metrics)
        self._wait_for_writer()

    def _write(self, epoch, state, aux, metrics) -> None:
        if epoch in self.all_epochs():
            return
        os.makedirs(self.directory, exist_ok=True)
        payload = {"epoch": int(epoch), "step": int(state.step),
                   "state_dict": _to_cpu(state.model.state_dict()),
                   "optimizer": _to_cpu(state.optimizer.state_dict()),
                   "aux": _to_cpu(dict(aux or {})),
                   "metrics": {k: float(v) for k, v in (metrics or {}).items()}}
        tmp = self.path(epoch) + f".{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self.path(epoch))
        self._prune()

    def _prune(self) -> None:
        """Keep the newest `max_to_keep` epochs, and the best one."""
        best = self.best_epoch()
        for epoch in self.all_epochs()[:-self.max_to_keep]:
            if epoch != best:
                os.remove(self.path(epoch))

    def latest_epoch(self) -> Optional[int]:
        epochs = self.all_epochs()
        return epochs[-1] if epochs else None

    # -- 'best' alias ---------------------------------------------------
    # The reference keys best_model.pth next to the numbered checkpoints
    # (train.py:897-909); here the best epoch is recorded in best.json so
    # any tool can resolve it without knowing the metric history.
    def mark_best(self, epoch: int, metric: Optional[str] = None,
                  value: Optional[float] = None) -> None:
        if self._writes:
            with open(os.path.join(self.directory, "best.json"), "w") as f:
                json.dump({"epoch": int(epoch), "metric": metric,
                           "value": None if value is None else float(value)}, f)
        self._wait_for_writer()

    def best_epoch(self) -> Optional[int]:
        path = os.path.join(self.directory, "best.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return int(json.load(f)["epoch"])

    def _resolve(self, epoch) -> int:
        if epoch == "best":
            epoch = self.best_epoch()
            if epoch is None:
                raise FileNotFoundError(f"no best.json under {self.directory} "
                                        "(no validation ran?)")
        if epoch is None:
            epoch = self.latest_epoch()
        if epoch is None or not os.path.exists(self.path(epoch)):
            raise FileNotFoundError(f"no checkpoint {'' if epoch is None else epoch} "
                                    f"under {self.directory}")
        return int(epoch)

    def _load(self, epoch: int) -> Dict[str, Any]:
        return torch.load(self.path(epoch), map_location="cpu", weights_only=True)

    def restore(self, state, epoch=None) -> Tuple[Any, Optional[Dict[str, Any]], int]:
        """Restore (state, aux, epoch) into a TrainState in place: the
        model (strict), the optimizer's state and the step, at `epoch`
        (default the latest; 'best' resolves through best.json)."""
        epoch = self._resolve(epoch)
        payload = self._load(epoch)
        state.model.load_state_dict(payload["state_dict"], strict=True)
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        return state, payload["aux"] or None, epoch

    def restore_eval(self, epoch=None) -> Tuple[Dict[str, torch.Tensor],
                                                Optional[Dict[str, Any]], int]:
        """(state_dict, aux, epoch) without an optimizer: the model's
        parameters and BatchNorm statistics, for serving and evaluation."""
        epoch = self._resolve(epoch)
        payload = self._load(epoch)
        return payload["state_dict"], payload["aux"] or None, epoch


class BestTracker:
    """Best-model tracking by a chosen metric (train.py:613-620,873-913).

    delta1 is maximized; every other metric (rmse/abs_rel/mae/loss) is
    minimized.
    """

    MAXIMIZE = {"delta1", "delta2", "delta3"}

    def __init__(self, metric: str = "rmse"):
        self.metric = metric
        self.best_value: Optional[float] = None
        self.best_epoch: Optional[int] = None

    def update(self, epoch: int, metrics: Dict[str, float]) -> bool:
        value = float(metrics[self.metric])
        better = (
            self.best_value is None
            or (value > self.best_value if self.metric in self.MAXIMIZE
                else value < self.best_value)
        )
        if better:
            self.best_value = value
            self.best_epoch = epoch
        return better
