"""Multi-rank scaling characterization (port of `tools/multichip_scaling.py`).

The JAX tool reads a train step's collectives from the compiled HLO of the
jitted step. Here each collective is counted where it runs
(`parallel.mesh.collectives`: kind, count and the bytes of its result on
the rank, an all-gather at its gathered size, the JAX tool's convention),
and the report holds rank 0's counts of one train step (after a warm-up
step):

  1. `dp8_unet256`: the UNet-256 flagship (54.4M parameters, 256²) over a
     ('data',) group of 8 ranks, 2 rows a rank;
  2. `dp4xsp2_binaural`: the binaural net (remat off, 128²) over a
     ('data', 'model') group of 4 × 2 ranks with `sp_axis="model"`, the
     attention's query rows split over the model axis (the JAX tool's
     `_mk` leaves the model's `sp_axis` unset);
  3. `weak_scaling_unet`: wall time a step at 1, 2, 4 and 8 ranks with 2
     rows a rank, and `vs_timeshared_ideal` = step_s / (ranks · t1), the
     JAX tool's measure for ranks that share one processor. A row whose
     ranks share a card (gloo) or the CPU is marked `time_shared`: it
     measures time-sharing and the collectives' cost, not scaling.

One world of 8 processes serves the whole report (`build_report` takes a
world of any even size; the keys name its ranks); the sweep's rows run in
subgroups of it, the ranks outside waiting at a barrier. The ranks use NCCL, one card each,
where the card count allows; otherwise, and on the CPU, gloo, the ranks
sharing the cards (collectives staged through pinned host memory).

    python -m audiodepth_tpu_torch.tools.multichip_scaling [--device cpu] [--fast]

`--fast` shrinks the models so the CPU can run the world: the UNet is
unet_128 at ngf 8 and 128², the binaural net base 8 at 32². Without a card
the tool raises unless asked for the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Dict, Optional, Sequence

import torch

from .._device import resolve_device, synchronize

JAX_KEYS = ("dp8_unet256", "dp4xsp2_binaural", "weak_scaling_unet")
RANKS = 8               # the JAX tool's devices
WEAK_RANKS = (1, 2, 4, 8)
STEPS = 3               # timed steps of each sweep row, the JAX tool's


def report_keys(n_ranks: int):
    """The report's keys for a world of `n_ranks` (JAX_KEYS at 8)."""
    return (f"dp{n_ranks}_unet256", f"dp{n_ranks // 2}xsp2_binaural", "weak_scaling_unet")


def _config(model: str, global_batch: int, size: int, extra: Optional[Dict] = None):
    from ..configs import load_config

    over = {"mode.batch_size": global_batch, "dataset.images_size": size,
            "mode.compute_dtype": "float32"}
    over.update(extra or {})
    return load_config("batvisionv2", "train", "scaling", model, overrides=over)


def _engine(model: str, group, global_batch: int, size: int, extra, device):
    """(engine, state, this rank's rows of the global batch) from seed 0."""
    from ..data.synthetic import SyntheticEchoDataset
    from ..models import init_weights, make_task
    from ..parallel import MeshGroup, shard_global_batch
    from ..train.engine import Engine

    cfg = _config(model, global_batch, size, extra)
    task = make_task(cfg, device=device)
    init_weights(task.model, torch.Generator().manual_seed(0))
    if isinstance(group, MeshGroup) and hasattr(task.model, "sp_axis"):
        task.model.sp_axis = "model"
    eng = Engine(cfg, task, group=group)
    state = eng.init_state()
    ds = SyntheticEchoDataset(cfg, num_samples=global_batch, seed=0)
    batch = eng.encode(next(ds.batches(global_batch, shuffle=False)))
    return eng, state, shard_global_batch(batch, group)


def collectives_for(model: str, world, bs_per_rank: int, size: int,
                    layout: Optional[Sequence[int]] = None, extra: Optional[Dict] = None,
                    device="cpu") -> dict:
    """This rank's collectives of one train step of `model` (the JAX tool's
    `hlo_for`) over `world`, a `DataGroup` of every rank (a collective
    call): the ('data',) group of them all, or the ('data', 'model') group
    of `layout` (dp, sp); global batch bs_per_rank × the ranks, counted
    after a warm-up step: {kind: {"count", "bytes"}}."""
    from ..parallel import collectives, make_mesh_group

    group = world if layout is None else make_mesh_group(*layout)
    eng, state, batch = _engine(model, group, bs_per_rank * world.size, size, extra, device)
    eng.train_step(state, batch)
    synchronize(device)
    collectives.reset()
    _, metrics = eng.train_step(state, batch)
    float(metrics["loss"])
    synchronize(device)
    return collectives.read()


def _time_steps(eng, state, batch, steps: int, device) -> float:
    _, m = eng.train_step(state, batch)  # warm
    float(m["loss"])
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = eng.train_step(state, batch)
    float(m["loss"])
    synchronize(device)
    return (time.perf_counter() - t0) / steps


def weak_scaling(world, groups, model: str, bs_per_rank: int, size: int, steps: int,
                 device, time_shared: bool, extra: Optional[Dict] = None) -> list:
    """Seconds a train step at each rank count of `groups` ({ranks: this
    rank's group of the first `ranks` world ranks, or None outside it}),
    with `bs_per_rank` rows a rank; rank 0's rows (the others get [])."""
    rows = []
    for k, group in groups.items():
        if world.rank < k:
            eng, state, batch = _engine(model, group if k > 1 else None, bs_per_rank * k,
                                        size, extra, device)
            step_s = _time_steps(eng, state, batch, steps, device)
            del eng, state, batch
            if world.rank == 0:
                rows.append({"devices": k, "global_batch": bs_per_rank * k, "step_s": step_s,
                             "time_shared": time_shared and k > 1})
        world.barrier()
    if rows:
        t1 = rows[0]["step_s"]
        for r in rows:
            r["vs_timeshared_ideal"] = r["step_s"] / (r["devices"] * t1)
    return rows


def sizes(fast: bool) -> dict:
    """The models' sizes: the JAX tool's, or `--fast`'s small ones."""
    if fast:
        unet = {"size": 128, "extra": {"model.generator": "unet_128", "model.ngf": 8}}
        binaural = {"size": 32, "extra": {"model.base_channels": 8,
                                          "model.extra.remat": False}}
    else:
        unet = {"size": 256, "extra": {}}
        binaural = {"size": 128, "extra": {"model.extra.remat": False}}
    return {"unet": unet, "binaural": binaural, "weak": unet}


def build_report(world, device, fast: bool, steps: int = STEPS) -> Optional[dict]:
    """The report over the world `world` (a `DataGroup` of every rank; a
    collective call): rank 0 gets it, the other ranks None."""
    import torch.distributed as dist

    from ..parallel import DataGroup

    n = world.size
    sz = sizes(fast)
    # the sweep's groups of the first k ranks: every rank makes each, in order
    groups = {}
    for k in (k for k in WEAK_RANKS if k <= n):
        pg = dist.new_group(list(range(k))) if 1 < k < n else None
        groups[k] = world if k == n else (
            DataGroup(pg) if pg is not None and world.rank < k else None)
    keys = report_keys(n)
    report = {
        keys[0]: collectives_for("unet_baseline", world, 2, sz["unet"]["size"],
                                 extra=sz["unet"]["extra"], device=device),
        keys[1]: collectives_for("binaural_attention", world, 2, sz["binaural"]["size"],
                                 layout=(n // 2, 2), extra=sz["binaural"]["extra"],
                                 device=device),
        keys[2]: weak_scaling(world, groups, "unet_baseline", 2, sz["weak"]["size"], steps,
                              device, world.backend != "nccl", sz["weak"]["extra"]),
    }
    if not world.is_main:
        return None
    report["setup"] = {"ranks": n, "backend": world.backend, "device": str(device),
                       "fast": fast, "sizes": sz,
                       "card": torch.cuda.get_device_name(0)
                       if torch.device(device).type == "cuda" else None}
    return report


def _rank_device(rank: int, n: int, device: str):
    """(this rank's device, backend): NCCL a card each where they suffice,
    else gloo with the ranks sharing the cards, gloo on the CPU."""
    if torch.device(device).type != "cuda":
        return "cpu", "gloo"
    count = torch.cuda.device_count()
    if n <= count:
        return f"cuda:{rank}", "nccl"
    return f"cuda:{rank % count}", "gloo"


def _rank_main(rank: int, n: int, device: str, init: str, outdir: str, fast: bool) -> None:
    from ..parallel import initialize_multihost, shutdown

    dev, backend = _rank_device(rank, n, device)
    if dev == "cpu":
        torch.set_num_threads(1)
    else:
        from .._device import configure_precision

        configure_precision()
    world = initialize_multihost(init, n, rank, backend=backend, device=dev)
    try:
        out = build_report(world, dev, fast)
        if rank == 0:
            with open(os.path.join(outdir, "rank0.json"), "w") as f:
                json.dump(out, f)
    finally:
        shutdown()


def _run_world(n: int, device, fast: bool):
    """Spawn `n` ranks, wait for them, return rank 0's report."""
    import torch.multiprocessing as mp

    device = str(resolve_device(device))
    if device.startswith("cuda"):
        from pathlib import Path

        from ..ops.cuda import KERNELS, _build

        _build.build(sorted({Path(src).stem for _, src, _ in KERNELS}))
    with tempfile.TemporaryDirectory(prefix="adepth_scaling_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        mp.start_processes(_rank_main, args=(n, device, init, tmp, fast), nprocs=n, join=True,
                           start_method="spawn")
        with open(os.path.join(tmp, "rank0.json")) as f:
            return json.load(f)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--fast", action="store_true", help="small models (module note)")
    p.add_argument("--out", default="scaling_analysis.json")
    args = p.parse_args(argv)
    report = _run_world(RANKS, resolve_device(args.device), args.fast)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
