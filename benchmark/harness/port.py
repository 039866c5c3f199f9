"""The program under test, `audiodepth_tpu_torch`, as a configuration file
builds it: its `Config` and its task with the benchmark's weights.

Each key of the configuration file that names a field of the port's
dataset, mode or model settings sets that field; `family` is the model
family and `dataset` the dataset preset; the model's extra settings, which
the family's own code reads (and so does its reference file), are the
entries of an `"extra": {...}` object, each one `model.extra.<key>`, and
the top-level `remat` and `loss_type`. The documentary keys (`DOC_KEYS`)
are not settings. Any other key is an error, so the file holds exactly
what is run.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

DOC_KEYS = {"name", "source", "deployment", "reduced", "assumed", "memory_reckoned"}
EXTRA_KEYS = {"remat", "loss_type"}


def port_config(cfg: Dict, mode: str = "train"):
    from audiodepth_tpu_torch.configs import (DatasetConfig, ModeConfig, ModelConfig,
                                              load_config)

    groups = {"dataset": DatasetConfig, "mode": ModeConfig, "model": ModelConfig}
    owners = {}
    for group, cls in groups.items():
        for f in dataclasses.fields(cls):
            if f.name not in ("name", "mode", "extra"):
                owners.setdefault(f.name, []).append(group)
    overrides = {}
    for key, value in cfg.items():
        if key in DOC_KEYS or key in ("family", "dataset"):
            continue
        if key in EXTRA_KEYS:
            overrides[f"model.extra.{key}"] = value
            continue
        if key == "extra":
            overrides.update({f"model.extra.{k}": v for k, v in value.items()})
            continue
        where = owners.get(key)
        if not where or len(where) != 1:
            raise KeyError(f"configuration key {key!r} names no single setting of the port")
        if isinstance(value, list):
            value = tuple(value)
        overrides[f"{where[0]}.{key}"] = value
    return load_config(cfg["dataset"], mode, "benchmark", cfg["family"], overrides=overrides)


def make_port_task(cfg: Dict, weights: Dict, device, mode: str = "train"):
    """(port Config, task on `device` holding `weights`)."""
    from audiodepth_tpu_torch.models import make_task

    pcfg = port_config(cfg, mode)
    task = make_task(pcfg, device=device)
    task.model.load_state_dict(weights, strict=True)
    return pcfg, task


def kernel_counters() -> Dict[str, int]:
    """{registered op: launches so far} of the port's hand-written kernels."""
    from audiodepth_tpu_torch.ops.cuda import KERNELS

    return {f"audiodepth::{w.name}": int(w.launches) for w, _, _ in KERNELS}
