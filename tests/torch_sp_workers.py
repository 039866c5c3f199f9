"""The cases of tests/test_torch_sequence_parallel.py, run by one rank each.

`run_world` is the body of one rank of a spawned world of four gloo ranks
(file:// rendezvous, one torch thread a rank). Inside it every rank builds
the same sub-layouts in one order: a 2 × 2 ('data', 'model') group, a
1 × 4 one (sp 4) and the world itself as a pure data group of 4. It runs
every case and writes its results to `rank<r>.pt`; the test process runs
the same functions with no group (one rank on the global batch) and the
JAX references, and compares. This module imports torch and the port only.
"""

from __future__ import annotations

import hashlib
import os
import signal

import numpy as np
import torch

import audiodepth_tpu_torch.losses.basic as basic_losses
from audiodepth_tpu_torch.ckpt import CheckpointManager
from audiodepth_tpu_torch.configs import load_config
from audiodepth_tpu_torch.data.batvision import make_dataset
from audiodepth_tpu_torch.data.bins import add_bins_to_batch
from audiodepth_tpu_torch.models import init_weights, make_task
from audiodepth_tpu_torch.parallel import (active_group, collectives, initialize_multihost,
                                           make_global_mesh, make_mesh_group,
                                           shard_global_batch, sharded_magnitude_stft,
                                           shutdown)
from audiodepth_tpu_torch.tools import multichip_scaling as scaling
from audiodepth_tpu_torch.train.engine import Engine

from tests import torch_dist_workers as W

WORLD = 4
N_FFT, WIN, HOP = 512, 64, 16
HALO = WIN - HOP
STFT_LENGTHS = (7782, 4096, 3000)
# sp: (a length whose chunk is exactly the halo, one frame a rank shorter)
STFT_EDGES = {2: (80, 50), 4: (150, 100)}
LITE_BATCH = 4        # the wired front end's global batch
FIT_BATCH = 8         # the pure-DP fit's global batch
FIT_EPOCHS = 3
TOOL_STEPS = 1        # timed steps of the tool's sweep rows


def stft_wave(length: int) -> np.ndarray:
    return np.random.default_rng(length).normal(size=(2, 2, length)).astype(np.float32)


def _padded_signal(wave: np.ndarray, sp: int):
    """(the sharded STFT's padded signal, by numpy: reflected by n_fft // 2,
    realigned by (n_fft − win) / 2, zero-padded to sp chunks and a halo;
    the chunk length)."""
    y = np.pad(wave, [(0, 0), (0, 0), (N_FFT // 2, N_FFT // 2)], mode="reflect")
    y = y[..., (N_FFT - WIN) // 2:]
    lc = -(-(1 + wave.shape[-1] // HOP) // sp) * HOP
    need = sp * lc + HALO
    return np.pad(y, [(0, 0), (0, 0), (0, max(0, need - y.shape[-1]))]), lc


def _sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().view(-1).view(torch.uint8).numpy().tobytes()).hexdigest()


def run_stft(groups) -> dict:
    """The sharded STFT over each model group ({sp: group}): each result's
    digest (the result itself on the group's rank 0), whether every halo
    this rank received equals its right neighbour's first win − hop samples
    of the padded signal, and the refusal's message one frame short."""
    out = {}
    for sp, group in groups.items():
        received = []
        send = group.from_right

        def spy(t, send=send):
            r = send(t)
            received.append(r)
            return r

        group.from_right = spy
        try:
            for length in STFT_LENGTHS + STFT_EDGES[sp][:1]:
                received.clear()
                wave = stft_wave(length)
                spec = sharded_magnitude_stft(torch.from_numpy(wave), group, N_FFT, WIN, HOP)
                y, lc = _padded_signal(wave, sp)
                start = (group.rank + 1) * lc
                want = (None if group.rank == sp - 1
                        else torch.from_numpy(np.ascontiguousarray(y[..., start:start + HALO])))
                (got,) = received
                halo_ok = got is None if want is None else torch.equal(got, want)
                out[(sp, length)] = {"sha": _sha(spec), "halo_ok": halo_ok,
                                     "spec": spec if group.rank == 0 else None}
            try:
                length = STFT_EDGES[sp][1]
                sharded_magnitude_stft(torch.from_numpy(stft_wave(length)), group)
                out[(sp, "refused")] = None
            except ValueError as e:
                out[(sp, "refused")] = str(e)
        finally:
            del group.from_right
    return out


def lite_config():
    """coarse lite at the JAX wired-front-end test's size (8 bins, base 8,
    64², float32, batch 4), on a plain spectrogram."""
    return load_config("batvisionv2", "train", "spstft", "coarse_depth", overrides={
        "dataset.audio_format": "spectrogram", "model.model_type": "lite",
        "model.n_bins": 8, "model.base_channels": 8, "dataset.images_size": 64,
        "mode.batch_size": LITE_BATCH, "mode.compute_dtype": "float32"})


def lite_batch(cfg, task):
    from audiodepth_tpu_torch.data.synthetic import SyntheticEchoDataset

    b = next(SyntheticEchoDataset(cfg, num_samples=LITE_BATCH, seed=0).batches(
        LITE_BATCH, shuffle=False))
    return add_bins_to_batch(b, task.bin_edges, cfg.dataset.max_depth, cfg.dataset.depth_norm)


def lite_task(cfg):
    task = make_task(cfg, device="cpu")
    init_weights(task.model, torch.Generator().manual_seed(0))
    return task


def run_wired_frontend(group=None) -> dict:
    """One train step of coarse lite on a plain spectrogram (this rank's
    rows of the global batch): whether the engine attached the sharded
    front end, the loss and this rank's collectives of the step."""
    cfg = lite_config()
    task = lite_task(cfg)
    plain = task._frontend
    eng = Engine(cfg, task, group=group)
    state = eng.init_state()
    batch = shard_global_batch(lite_batch(cfg, task), group)
    collectives.reset()
    state, m = eng.train_step(state, batch)
    return {"attached": task._frontend is not plain, "loss": float(m["loss"]),
            "collectives": collectives.read(), "rows": int(batch["waveform"].shape[0])}


def run_binaural_eval(group=None) -> dict:
    """evaluate() of the binaural net (sp over the model axis) on 13 global
    rows at batch 4 (a ragged tail of one)."""
    cfg, task = W.build("binaural_attention", sp_axis="model")
    eng = Engine(cfg, task, group=group)
    return eng.evaluate(eng.init_state(), W.ragged_eval_batches(cfg))


def fit_config():
    return load_config("synthetic", "train", model_name="coarse_depth", overrides={
        "model.model_type": "lite", "model.n_bins": 8, "model.base_channels": 8,
        "dataset.images_size": 32, "mode.batch_size": FIT_BATCH,
        "mode.compute_dtype": "float64", "mode.validation_iter": 1,
        "mode.saving_checkpoints": 10})


def fit_lite(root: str, group=None, preempt: bool = False, resume: bool = False) -> dict:
    """The JAX package's 4-process fit (tests/multihost_quad_worker.py,
    part 2) on the port: coarse lite, a ragged validation split of 6 rows
    and a holdout of 8 at global batch 8, 3 epochs of 2 steps; `preempt`
    raises SIGTERM inside the epoch-2 iterator, `resume` restores the latest
    epoch in a fresh manager and continues."""
    with W.f64_ce("coarse_depth"):
        cfg = fit_config()
        task = make_task(cfg, device="cpu")
        task.model.double()
        init_weights(task.model, torch.Generator().manual_seed(0))
        eng = Engine(cfg, task, steps_per_epoch=2, group=group)
        state = eng.init_state()

        def bins(b):
            return add_bins_to_batch(b, task.bin_edges, cfg.dataset.max_depth,
                                     cfg.dataset.depth_norm)

        train = make_dataset(cfg, "train", num_samples=2 * FIT_BATCH)
        val = make_dataset(cfg, "val", num_samples=FIT_BATCH - 2)
        hold = make_dataset(cfg, "test", num_samples=FIT_BATCH)
        shard = None if group is None else (group.rank, group.size)
        calls = [0]

        def train_batches():
            calls[0] += 1
            if preempt and calls[0] == 2:
                os.kill(os.getpid(), signal.SIGTERM)  # inside the epoch-2 iterator
            return (bins(b) for b in train.batches(FIT_BATCH, shuffle=False, shard=shard))

        def val_batches():
            return [bins(b) for b in val.batches(FIT_BATCH, shuffle=False, drop_last=False)]

        def hold_batches():
            return [bins(b) for b in hold.batches(FIT_BATCH, shuffle=False)]

        mgr = CheckpointManager(root, "quad", group=group)
        start = 1
        if resume:
            state, _, restored = CheckpointManager(root, "quad", group=group).restore(state)
            start = restored + 1
        state = eng.fit(state, train_batches, val_batches=val_batches,
                        holdout_batches={"h": hold_batches}, epochs=FIT_EPOCHS,
                        start_epoch=start, ckpt_manager=mgr)
        return {"preempted": eng.preempted, "latest": mgr.latest_epoch(), "start": start,
                "step": state.step, "state": W._state(state),
                "val": eng.evaluate(state, val_batches()),
                "holdout": eng.evaluate(state, hold_batches()),
                "history": [{k: v for k, v in r.items() if k != "epoch_time"}
                            for r in eng.history]}


class LossReductions:
    """Counts the bytes the losses reduce over the data group (the forward
    all-reduces of `losses.basic`'s global sums; each has a backward of the
    same size), snapshot at every read of the collective counters."""

    def __init__(self):
        self.nbytes, self.at_read = 0, []

    def __enter__(self):
        self.sum, self.mean = basic_losses.global_sum, basic_losses.global_mean

        def counted_sum(x):
            group = active_group()
            if group is not None and group.size > 1:
                self.nbytes += x.numel() * x.element_size()
            return self.sum(x)

        def counted_mean(x):
            group = active_group()
            if group is not None and group.size > 1:
                self.nbytes += x.element_size()
            return self.mean(x)

        basic_losses.global_sum, basic_losses.global_mean = counted_sum, counted_mean
        reset, read = collectives.reset, collectives.read

        def on_reset():
            self.nbytes = 0
            reset()

        def on_read():
            self.at_read.append(self.nbytes)
            return read()

        collectives.reset, collectives.read = on_reset, on_read
        return self

    def __exit__(self, *exc):
        basic_losses.global_sum, basic_losses.global_mean = self.sum, self.mean
        del collectives.reset, collectives.read


def run_tool(world) -> dict:
    """The scaling tool's report over the world (--fast sizes, one timed
    step a sweep row) and, on rank 0, the loss reductions' bytes of the two
    counted steps."""
    with LossReductions() as losses:
        report = scaling.build_report(world, "cpu", fast=True, steps=TOOL_STEPS)
    return {"report": report, "loss_bytes": losses.at_read}


def run_world(rank: int, world: int, init: str, outdir: str) -> None:
    """One rank of the test's world: every case, then rank<r>.pt."""
    torch.set_num_threads(1)
    group = initialize_multihost(init, world, rank, backend="gloo")
    try:
        mesh22 = make_global_mesh(("data", "model"), (2, 2))
        mesh14 = make_mesh_group(1, 4)
        res = {"layout": {"coords": mesh22.coords, "devices": [[d.id for d in row]
                                                               for row in mesh22.devices],
                          "one_axis": type(make_global_mesh()).__name__,
                          "model_ranks": [mesh22.model.rank, mesh14.model.rank],
                          "data_rank": mesh22.data.rank}}
        res["stft"] = run_stft({2: mesh22.model, 4: mesh14.model})
        res["frontend"] = run_wired_frontend(mesh22)
        res["sp22"] = W.run_family("binaural_attention", mesh22, sp_axis="model")
        res["sp14"] = W.run_family("binaural_attention", mesh14, sp_axis="model")
        res["sp14_48"] = W.run_family("binaural_attention", mesh14, steps=1, size=48,
                                      sp_axis="model")
        res["sp22_sgd"] = W.run_family("binaural_attention", mesh22, steps=1,
                                       optimizer="SGD", sp_axis="model")
        res["eval22"] = run_binaural_eval(mesh22)
        res["fit"] = fit_lite(os.path.join(outdir, "fit"), group, preempt=True)
        res["fit_resumed"] = fit_lite(os.path.join(outdir, "fit"), group, resume=True)
        res["tool"] = run_tool(group)
        torch.save(res, os.path.join(outdir, f"rank{rank}.pt"))
    finally:
        shutdown()
