"""The reference of each model family, a file each: `<family>.py`, found by
a configuration's `family`. Plain torch and numpy, like the rest of the
reference: a family file imports nothing of the program under test.

A family file provides:
- `build_net(cfg, prec=None, checkpointed=False)`: the float32 net, under
  the parameter names of the family's published checkpoints, its products
  through `prec`; `checkpointed` lets it recompute activations in the
  backward where it can (training asks for it, evaluation does not);
- `param_specs(cfg)`: (name, shape, rule, std) of every entry of the net's
  state dict, in order, by the family's own initialisation; the rules are
  those `harness.inputs.make_weights` draws: "normal" (std given),
  "zeros", "ones", "gamma" (a gate drawn ±U(0.25, 1)), "count";
- `train_loss(net, batch, cfg, shards)`: from a batch dict of float32
  tensors (this process's rows), through the reference front end, to the
  scalar loss, its sums over the global batch through `shards`;
- `predict(net, batch, cfg)`: the evaluation depth [B, S, S] in meters;
and may provide:
- `trainable(name) -> bool`: the parameters AdamW updates (every one by
  default); the others keep their weights, and their change reads 0;
- `extra_inputs(depth, gen, cfg) -> dict`: the per-row tensors a pair
  holds beyond the waveform and the depth (none by default), drawn with
  `gen`, a generator of their own, from the rows' depth [n, S, S, 1] in
  meters.
"""

from __future__ import annotations

from types import ModuleType
from typing import Dict

from ..named import load_named


def _every_parameter(name: str) -> bool:
    return True


def _no_extra_inputs(depth, gen, cfg: Dict) -> Dict:
    return {}


def family(name: str) -> ModuleType:
    """The family file of `name`, its optional functions defaulted."""
    module = load_named(__name__, name, "reference family file")
    vars(module).setdefault("trainable", _every_parameter)
    vars(module).setdefault("extra_inputs", _no_extra_inputs)
    return module


def build_net(cfg: Dict, prec=None, checkpointed: bool = False):
    """The reference net of a configuration file's dict."""
    return family(cfg["family"]).build_net(cfg, prec, checkpointed)


def param_specs(cfg: Dict):
    """The initialisation rules of a configuration file's net."""
    return family(cfg["family"]).param_specs(cfg)
