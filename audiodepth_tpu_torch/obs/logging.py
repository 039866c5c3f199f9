"""Metric sink: stdout, JSONL and optionally wandb, and the profiler hook
(port of `obs/logging.py`).

Each record is printed as one `[experiment] key=value ...` line and, with a
log directory, appended to `{log_dir}/{experiment}.jsonl` as one JSON object
holding `step` and the record's keys. wandb is imported only when asked
for, and a run without it degrades to stdout and JSONL. `ProfilerHook`
traces a window of steps with `torch.profiler` into a chrome trace.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional


class MetricLogger:
    def __init__(
        self,
        log_dir: Optional[str] = None,
        experiment_name: str = "default",
        use_wandb: bool = False,
        wandb_project: str = "batvision-depth-estimation",
        config: Optional[Dict[str, Any]] = None,
        wandb_entity: Optional[str] = None,
        wandb_mode: Optional[str] = None,
    ):
        self.experiment_name = experiment_name
        self.path = None
        self._jsonl = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self.path = os.path.join(log_dir, f"{experiment_name}.jsonl")
            self._jsonl = open(self.path, "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                if getattr(wandb, "run", None) is not None:
                    # a run already exists (an early init by a sweep): adopt
                    # it, since a second wandb.init is ignored by an active run
                    wandb.run.name = experiment_name
                    if config:
                        wandb.config.update(config, allow_val_change=True)
                    self._wandb = wandb.run
                else:
                    init_kwargs: Dict[str, Any] = {
                        "project": wandb_project, "name": experiment_name,
                        "config": config or {},
                    }
                    if wandb_entity:
                        init_kwargs["entity"] = wandb_entity
                    if wandb_mode:
                        init_kwargs["mode"] = wandb_mode
                    self._wandb = wandb.init(**init_kwargs)
            except Exception as e:  # wandb absent or offline: degrade
                print(f"[obs] wandb unavailable ({e}); logging to stdout/jsonl only")

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        record = {"step": step, **{k: _to_py(v) for k, v in metrics.items()}}
        parts = " ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in record.items() if v is not None
        )
        print(f"[{self.experiment_name}] {parts}", flush=True)
        if self._jsonl:
            self._jsonl.write(json.dumps(record) + "\n")
            self._jsonl.flush()
        if self._wandb:
            self._wandb.log({k: v for k, v in record.items() if k != "step"}, step=step)

    def log_image(self, tag: str, image_path: str, step: Optional[int] = None) -> None:
        """Log a saved visualization PNG: its path in the JSONL, the image
        itself in wandb."""
        if self._jsonl:
            self._jsonl.write(json.dumps({"step": step, tag: image_path}) + "\n")
            self._jsonl.flush()
        if self._wandb:
            import wandb

            self._wandb.log({tag: wandb.Image(image_path)}, step=step)

    def close(self):
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None
        if self._wandb:
            self._wandb.finish()
            self._wandb = None


def _to_py(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


PRIMER_KERNELS = 16


def prime_trace(device) -> None:
    """PRIMER_KERNELS tiny kernels on a card, waited for: a trace may lose the
    records of the kernels launched right after the profiler starts (on the
    H100, 2 to 9 of 10 B1 and B2 launches issued right after it started),
    so what is traced starts after these."""
    import torch

    x = torch.zeros(1, device=device)
    for _ in range(PRIMER_KERNELS):
        x.add_(1)
    torch.cuda.synchronize(device)


class ProfilerHook:
    """`torch.profiler` trace around a window of steps (the JAX package's
    `jax.profiler` hook): `start(name)` traces the CPU activity and, where a
    card is present, the CUDA activity (after `prime_trace`); `stop` waits
    for the card, ends the trace and writes it to
    `{log_dir}/{name}.pt.trace.json` (`path`). `stop` without an active
    trace does nothing."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.path: Optional[str] = None
        self._prof = None
        self._name = None

    def start(self, name: str = "trace") -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._name = name
        self._prof.start()
        if torch.cuda.is_available():
            prime_trace("cuda")

    def stop(self) -> None:
        if self._prof is None:
            return
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof, self._prof = self._prof, None
        prof.stop()
        os.makedirs(self.log_dir, exist_ok=True)
        self.path = os.path.join(self.log_dir, f"{self._name}.pt.trace.json")
        prof.export_chrome_trace(self.path)
