"""The cases of tests/test_torch_parallel.py, run by one rank each.

`run_world` is the body of one rank of a spawned world of two gloo ranks
(file:// rendezvous, one torch thread a rank): it runs every case in the
group and writes its results to `rank<r>.pt`. The test process runs the
same functions with no group (one rank on the global batch) and the JAX
references, and compares. This module imports torch and the port only.

The models are the small ones of the family tests, in float64 (float64
parameters, so a gradient is not rounded to float32 before the
reduction): the 5-down ngf-8 UNet at 32², the binaural net at base 8 with
seeded γ, base 4 for base_residual, rgb_depth, AdaBins and the coarse
hybrid (8 bins), the 5-down ngf-8 cVAE with a 16-wide latent. Every global
batch has 4 rows, 2 a rank, and its last row's depth is zeroed over ten
image rows, so the ranks hold different counts of valid pixels.
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import os
import signal
from typing import Dict

import numpy as np
import torch

import audiodepth_tpu_torch.losses.coarse as coarse_losses
from audiodepth_tpu_torch.ckpt import CheckpointManager
from audiodepth_tpu_torch.configs import load_config
from audiodepth_tpu_torch.data.batvision import make_dataset
from audiodepth_tpu_torch.data.bins import add_bins_to_batch
from audiodepth_tpu_torch.data.device_cache import DeviceDatasetCache
from audiodepth_tpu_torch.models import init_weights, make_task
from audiodepth_tpu_torch.models.layers import BatchNorm, Conv2d, remat
from audiodepth_tpu_torch.models.unet import UNetGenerator
from audiodepth_tpu_torch.models.unet_cvae import UNetCVAE
from audiodepth_tpu_torch.parallel import (MeshGroup, all_reduce_grads_, global_sum,
                                           initialize_multihost, local_batch_slice, local_shard,
                                           shutdown, use_group)
from audiodepth_tpu_torch.train.engine import Engine

WORLD = 2
GLOBAL_BATCH = 4
FAMILIES = ("unet_baseline", "binaural_attention", "base_residual", "unet_cvae", "rgb_depth",
            "adabins_distillation", "coarse_depth")
IMAGE_FAMILIES = ("rgb_depth", "adabins_distillation")
# low enough that most steps clip
CLIP = 0.25
# the CLI's parameters are float32 whatever the compute dtype: a rank's
# gradient is rounded to float32 before the sum, which at the default
# learning rate moves the 2-rank losses ~2e-10 from the 1-rank ones over
# two epochs; at this one, ~1e-11
CLI_LR = "1e-4"
EPOCH_SAMPLES = 8  # two steps of the global batch an epoch


def family_config(family: str, optimizer: str = "AdamW", size: int = 32):
    over = {"dataset.images_size": size, "mode.compute_dtype": "float64",
            "mode.optimizer": optimizer, "mode.grad_clip_norm": CLIP,
            "mode.batch_size": GLOBAL_BATCH, "mode.saving_checkpoints": 1}
    if family in ("unet_baseline", "unet_cvae"):
        over["dataset.depth_norm"] = True  # the sigmoid head, off the SIlog clamp
    if family == "unet_cvae":
        over["model.kl_weight"] = 0.1
    over["model.base_channels"] = 8 if family == "binaural_attention" else 4
    if family in ("adabins_distillation", "coarse_depth"):
        over["model.n_bins"] = 8
    if family == "coarse_depth":
        over["model.model_type"] = "hybrid"
    return load_config("synthetic", "train", model_name=family, overrides=over)


def build(family: str, optimizer: str = "AdamW", size: int = 32, sp_axis=None):
    """(config, task) of a family's small float64 model, seeded; the
    binaural net's attention split over `sp_axis` where given."""
    cfg = family_config(family, optimizer, size)
    task = make_task(cfg, device="cpu")
    if family == "unet_baseline":
        task.model = UNetGenerator(2, 1, num_downs=5, ngf=8, depth_norm=True,
                                   dtype=torch.float64)
    elif family == "unet_cvae":
        task.model = UNetCVAE(2, 1, num_downs=5, ngf=8, depth_norm=True, latent_dim=16,
                              dtype=torch.float64)
    task.model.double()
    init_weights(task.model, torch.Generator().manual_seed(0))
    if family == "binaural_attention":
        # γ is zero at init, which hides the attention
        gammas = np.random.default_rng(1234).normal(0.0, 0.5, len(task.model.attention_modules))
        with torch.no_grad():
            for m, g in zip(task.model.attention_modules.values(), gammas):
                m.gamma.fill_(float(g))
        task.model.sp_axis = sp_axis
    return cfg, task


def global_batches(cfg, task, family: str, n: int = 3):
    kw = {"with_image": True} if family in IMAGE_FAMILIES else {}
    ds = make_dataset(cfg, "train", num_samples=GLOBAL_BATCH * n, **kw)
    out = []
    for b in ds.batches(GLOBAL_BATCH, shuffle=False):
        depth = b["depth"].copy()
        depth[-1, :10] = 0.0
        b = dict(b, depth=depth)
        if family == "coarse_depth":
            b = add_bins_to_batch(b, task.bin_edges, cfg.dataset.max_depth,
                                  cfg.dataset.depth_norm)
        out.append(b)
    return out


def rows_of(group) -> slice:
    """This rank's rows of a global batch: its data index's in a
    ('data', 'model') group."""
    if group is None:
        return slice(None)
    if isinstance(group, MeshGroup):
        return group.local_rows(GLOBAL_BATCH)
    return local_batch_slice(GLOBAL_BATCH, group.rank, group.size)


@contextlib.contextmanager
def f64_ce(family: str):
    """The coarse losses' float32 classification terms in float64 (as the
    family's own f64 tests lift them): float32 sums of two orders differ
    at 1e-7."""
    prev = coarse_losses.CE_DTYPE
    if family == "coarse_depth":
        coarse_losses.CE_DTYPE = torch.float64
    try:
        yield
    finally:
        coarse_losses.CE_DTYPE = prev


def _clone(named) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in named}


def digest(model) -> str:
    """sha256 of every parameter's and buffer's bytes, in state_dict order."""
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def run_family(family: str, group=None, steps: int = 3, optimizer: str = "AdamW",
               size: int = 32, sp_axis=None) -> dict:
    """`steps` train steps on the global batches (this rank's rows): the
    losses and norms, the first step's gradients (after the reduction and
    the clip) and buffers, a digest of the state after every step, and the
    final state."""
    with f64_ce(family):
        cfg, task = build(family, optimizer, size, sp_axis)
        batches = global_batches(cfg, task, family)
        eng = Engine(cfg, task, steps_per_epoch=steps, group=group)
        state = eng.init_state()
        rows = rows_of(group)
        out: dict = {"loss": [], "grad_norm": [], "digests": []}
        for i, b in enumerate(batches[:steps]):
            state, m = eng.train_step(state, {k: v[rows] for k, v in b.items()})
            out["loss"].append(float(m["loss"]))
            out["grad_norm"].append(float(m["grad_norm"]))
            out["digests"].append(digest(task.model))
            if i == 0:
                out["aux"] = {k: float(v) for k, v in m.items()}
                out["grads"] = {n: p.grad.detach().clone()
                                for n, p in task.model.named_parameters() if p.grad is not None}
                out["buffers"] = _clone(task.model.named_buffers())
        out["state"] = _clone(task.model.state_dict().items())
        return out


def run_batchnorm(group=None) -> dict:
    """One train-mode BatchNorm forward and backward on this rank's rows of
    a global [4, 6, 5, 5] input, in float64 and with bfloat16 compute
    (float32 statistics and buffers); and a conv + BatchNorm under `remat`."""
    rng = np.random.default_rng(7)
    x = rng.normal(1.0, 2.0, (GLOBAL_BATCH, 6, 5, 5))
    c = rng.normal(size=x.shape)
    rows = rows_of(group)
    out = {}
    for name, dtype in (("f64", torch.float64), ("bf16", torch.bfloat16)):
        bn = BatchNorm(6, dtype=dtype)
        if dtype == torch.float64:
            bn.double()
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 6)))
            bn.bias.copy_(torch.from_numpy(rng.normal(0.0, 0.1, 6)))
        xl = torch.tensor(x[rows], dtype=dtype, requires_grad=True)
        with use_group(group):
            y = bn(xl)
            loss = global_sum((y.double() * torch.from_numpy(c[rows])).sum())
            loss.backward()
        grads = [bn.weight.grad, bn.bias.grad]
        if group is not None:
            all_reduce_grads_(grads, group)
        out[name] = {"y": y.detach().clone(), "dx": xl.grad.clone(), "dweight": grads[0],
                     "dbias": grads[1], "mean": bn.running_mean.clone(),
                     "var": bn.running_var.clone()}
    torch.manual_seed(0)
    net = torch.nn.Sequential(Conv2d(6, 4, 3, dtype=torch.float64), BatchNorm(4, torch.float64))
    net.double()
    for name, recompute in (("remat", True), ("plain", False)):
        model = copy.deepcopy(net)
        xl = torch.tensor(x[rows], dtype=torch.float64, requires_grad=True)
        with use_group(group):
            y = remat(model, xl) if recompute else model(xl)
            global_sum(y.square().sum()).backward()
        out[name] = {"y": y.detach().clone(), "mean": model[1].running_mean.clone(),
                     "var": model[1].running_var.clone(), "dx": xl.grad.clone()}
    return out


def ragged_eval_batches(cfg, n: int = 13):
    return list(make_dataset(cfg, "val", num_samples=n).batches(GLOBAL_BATCH, shuffle=False,
                                                                drop_last=False))


def run_ragged_eval(group=None) -> dict:
    """evaluate() of 13 global rows at batch 4 (a tail of one), and whether
    train_step refuses a padded batch."""
    cfg, task = build("unet_baseline")
    eng = Engine(cfg, task, group=group)
    state = eng.init_state()
    batches = ragged_eval_batches(cfg)
    out = {"metrics": eng.evaluate(state, batches)}
    padded = local_shard(batches[-1], WORLD, 0 if group is None else group.rank, WORLD)
    try:
        eng.train_step(state, padded)
        out["refused"] = None
    except ValueError as e:
        out["refused"] = str(e)
    return out


# global rows gathered as they are: out of order, repeated, from one rank's
# rows only, from the padded rank's last row
CACHE_PICKS = ((12, 0, 7, 6, 3, 3, 11), (8, 9, 10), (2, 1), (12,))


def run_cache(group=None) -> dict:
    """A 13-row split in the device cache: the rows this rank holds, the
    global batches of a shuffled epoch (ragged tail kept), a sharded
    drop_last epoch's local batches, the batches of CACHE_PICKS and the
    cache's index uploads over all of them."""
    cfg = family_config("unet_baseline")
    ds = make_dataset(cfg, "train", num_samples=13)
    cache = DeviceDatasetCache(ds, 30.0, "cpu", group=group)
    shard = None if group is None else (group.rank, group.size)
    return {"held": {k: v.clone() for k, v in cache.arrays.items()},
            "global": list(cache.batches(GLOBAL_BATCH, shuffle=True, seed=5, drop_last=False)),
            "local": list(cache.batches(GLOBAL_BATCH, shuffle=True, seed=5, shard=shard)),
            "picked": [cache.batch(idx) for idx in CACHE_PICKS],
            "uploads": cache.uploads.read()}


def fit_unet(ckpt_root: str, epochs: int, group=None, resume: bool = False,
             on_step=None) -> tuple:
    """Engine.fit of the small UNet on 8 synthetic rows (2 steps an epoch)
    with the CLI's epoch shuffle stream (seed·100003 + epoch + 1) and a
    checkpoint every epoch under `ckpt_root`/run; a resumed fit continues
    from the latest epoch there."""
    cfg, task = build("unet_baseline")
    ds = make_dataset(cfg, "train", num_samples=EPOCH_SAMPLES)
    eng = Engine(cfg, task, steps_per_epoch=EPOCH_SAMPLES // GLOBAL_BATCH, group=group)
    state = eng.init_state()
    mgr = CheckpointManager(ckpt_root, "run", group=group)
    start = 1
    if resume:
        state, _, restored = mgr.restore(state)
        start = restored + 1
    shard = None if group is None else (group.rank, group.size)
    seed = [int(cfg.mode.seed) * 100_003 + start]

    def train_batches():
        seed[0] += 1
        return ds.batches(GLOBAL_BATCH, shuffle=True, seed=seed[0], shard=shard)

    state = eng.fit(state, train_batches, epochs=epochs, start_epoch=start, ckpt_manager=mgr,
                    on_step=on_step)
    return eng, state, mgr


def _state(state) -> Dict[str, torch.Tensor]:
    return _clone(state.model.state_dict().items())


def run_checkpoints(group, root: str) -> dict:
    """Save at 2 ranks (2 epochs, resumed at 1 rank by the test), resume at
    2 ranks a run the test saved at 1 (epoch 3), and SIGTERM on rank 1 in
    the second epoch, then its resume to epoch 3."""
    out = {}
    _, state, _ = fit_unet(os.path.join(root, "save2"), 2, group)
    out["save2_step"] = state.step
    _, state, _ = fit_unet(os.path.join(root, "save1"), 3, group, resume=True)
    out["resume2"] = _state(state)
    out["resume2_step"] = state.step

    steps = [0]

    def on_step(state, metrics):
        steps[0] += 1
        if steps[0] == 3 and group.rank == 1:
            os.kill(os.getpid(), signal.SIGTERM)

    eng, state, mgr = fit_unet(os.path.join(root, "sigterm"), 3, group, on_step=on_step)
    out["sigterm"] = {"preempted": eng.preempted, "steps_run": steps[0], "step": state.step,
                      "epochs_saved": mgr.all_epochs()}
    _, state, _ = fit_unet(os.path.join(root, "sigterm"), 3, group, resume=True)
    out["sigterm_resumed"] = _state(state)
    return out


def run_world(rank: int, world: int, init: str, outdir: str) -> None:
    """One rank of the test's world: every case, then rank<r>.pt."""
    torch.set_num_threads(1)
    group = initialize_multihost(init, world, rank, backend="gloo")
    try:
        res = {"families": {f: run_family(f, group) for f in FAMILIES},
               "unet_sgd": run_family("unet_baseline", group, steps=1, optimizer="SGD"),
               "batchnorm": run_batchnorm(group),
               "eval": run_ragged_eval(group),
               "cache": run_cache(group),
               "ckpt": run_checkpoints(group, outdir)}
        torch.save(res, os.path.join(outdir, f"rank{rank}.pt"))
    finally:
        shutdown()


def cli_args(log_dir: str, extra=()) -> list:
    """The CLI run of the test: the small unet_128 (ngf 4, 128²) in float64
    compute, two epochs of two steps, validation after the second (its
    detectors, not its PNG), JSONL under log_dir."""
    return ["--device", "cpu", "--dataset", "synthetic", "--model", "unet_baseline",
            "--override", "model.generator=unet_128", "--override", "model.ngf=4",
            "--override", "dataset.images_size=128", "--override", "dataset.depth_norm=true",
            "--num_samples", str(EPOCH_SAMPLES), "--batch_size", str(GLOBAL_BATCH),
            "--epochs", "2", "--validation_iter", "2", "--compute_dtype", "float64",
            "--learning_rate", CLI_LR, "--log_dir", log_dir, "--no_visualize", *extra]
