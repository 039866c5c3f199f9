"""Training CLI (port of `cli/train.py`, the flags of the ported path).

    python -m audiodepth_tpu_torch.cli.train --dataset batvisionv2 \
        --dataset_dir /data/BatvisionV2 --holdout_locations <location> \
        --log_dir logs --ckpt_dir checkpoints

Builds the config from the flags, the train and val splits (BatVision V2 or
V1 from --dataset_dir, or the synthetic corpus), the task on --device
(default cuda; it raises without a card) with a seeded init, and the
Engine, then runs `Engine.fit` and prints one JSON line per epoch with its
record. Flags of parts that are not ported yet exit with the ROADMAP.md
item that ports them.

Families: unet_baseline, binaural_attention, base_residual, unet_cvae,
rgb_depth and adabins_distillation, with the JAX CLI's family flags.
rgb_depth reads camera images, adabins_distillation paired audio and
images (its teacher frozen), and --eval_img trains a family with input_nc
3 (the baseline) on the images, the experiment named with IMG (BatVision V2
and the synthetic corpus; V1 has no camera).

Data: BatVision V2 batches decode in the native thread pool and reach the
card through `data/prefetch.py`; --device_cache uploads each split once
and gathers batches on the card. --holdout_locations (or the reference's
--holdout_test_seq/--holdout_eval_seq) blacklists locations from train and
val, and evaluates each on its own at every validation, from the full train
split.

Observability (`obs/`): the JAX fit's metric keys go to stdout and, with
--log_dir, to {log_dir}/{experiment}.jsonl (and wandb with --use_wandb);
--log_dir also gets {experiment}_architecture.txt. The first validation
batch is drawn to {results_dir or log_dir}/{experiment}/val_epoch<N>.png
unless --no_visualize; a run given neither directory draws nothing. Where
it would draw and matplotlib does not import, the CLI exits before
training.

Checkpoints (`ckpt/`): with --ckpt_dir ROOT the run saves under
ROOT/<experiment name>/ every --saving_checkpoints epochs, at each new best
--best_metric, at its last epoch and on SIGTERM (the JAX CLI saves under
./checkpoints by default; the port saves only where it is asked to).
--resume continues from the latest epoch there, --checkpoints N from epoch
N, both with the optimizer state and the step; --init_from_torch PTH
warm-starts the model from a reference .pth (weights only, a fresh
optimizer, from the epoch after the one it names).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

# the families `cli.train` trains
TRAINED_MODELS = ("unet_baseline", "binaural_attention", "base_residual", "unet_cvae",
                  "rgb_depth", "adabins_distillation")
# the families that read camera images
IMAGE_MODELS = ("rgb_depth", "adabins_distillation")
# flag → the ROADMAP.md item that ports what it needs
_UNPORTED = {
    "profile_dir": "the profiler hook (ROADMAP.md A7)",
    "sparse_method": "the sparse-depth coarse workflow (ROADMAP.md A5)",
}
# family knobs that live in model.extra (the JAX CLI's names)
_EXTRA_FLAGS = ("loss_type", "lambda_recon", "lambda_edge", "lambda_smooth", "remat",
                "warmup_epochs", "use_adaptive_loss", "temperature", "recon", "lambda_base",
                "lambda_sparse", "lowpass_kernel", "lambda_l1", "lambda_task",
                "lambda_response", "lambda_feature", "lambda_bin")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="audio-depth training (PyTorch/CUDA)")
    p.add_argument("--dataset", default="batvisionv2",
                   choices=["batvisionv1", "batvisionv2", "synthetic"])
    p.add_argument("--model", default="unet_baseline")
    p.add_argument("--experiment_name", default="default")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, cuda:1, cpu)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--dataset_dir", default=None,
                   help="root of the BatVision corpus (default: the dataset config's)")
    p.add_argument("--num_samples", type=int, default=256, help="synthetic train split size")
    p.add_argument("--learning_rate", type=float, default=None)
    p.add_argument("--optimizer", default=None, choices=[None, "Adam", "AdamW", "SGD"])
    p.add_argument("--criterion", default=None, choices=[None, "L1", "SIlog", "Combined"])
    p.add_argument("--l1_weight", type=float, default=None)
    p.add_argument("--silog_weight", type=float, default=None)
    p.add_argument("--silog_lambda", type=float, default=None)
    p.add_argument("--weight_decay", type=float, default=None,
                   help="AdamW decoupled weight decay (default 0.01)")
    p.add_argument("--lr_schedule", default=None,
                   choices=[None, "constant", "cosine", "step", "warm_restarts"])
    p.add_argument("--base_channels", type=int, default=None)
    p.add_argument("--ngf", type=int, default=None)
    p.add_argument("--generator", default=None, choices=[None, "unet_256", "unet_128"])
    p.add_argument("--n_bins", type=int, default=None, help="AdaBins bins")
    p.add_argument("--attention_levels", default=None,
                   help="comma-separated encoder levels for cross-attention, e.g. 2,3,4,5")
    p.add_argument("--loss_type", default=None, choices=[None, "standard", "edge_aware", "adaptive"],
                   help="binaural-attention loss family")
    p.add_argument("--lambda_recon", type=float, default=None,
                   help="base_residual recon weight and binaural edge-aware recon weight "
                        "(default 1.0)")
    p.add_argument("--lambda_edge", type=float, default=None,
                   help="edge-aware edge weight (default 0.2)")
    p.add_argument("--lambda_smooth", type=float, default=None,
                   help="smoothness weight (binaural edge-aware and rgb_depth, default 0.1)")
    p.add_argument("--remat", action=argparse.BooleanOptionalAction, default=None,
                   help="recompute the encoders' activations in the backward "
                        "(binaural_attention, default on)")
    p.add_argument("--warmup_epochs", type=int, default=None,
                   help="base_residual: adaptive-loss warmup and detach flip (default 50)")
    p.add_argument("--use_adaptive_loss", action=argparse.BooleanOptionalAction, default=None,
                   help="the adaptive schedule (base_residual default on, adabins off)")
    p.add_argument("--recon", default=None, choices=[None, "silog", "l1", "l2", "frequency_aware"],
                   help="base_residual reconstruction term (default silog)")
    p.add_argument("--lambda_base", type=float, default=None,
                   help="base_residual structural-guidance weight (default 1.2)")
    p.add_argument("--lambda_sparse", type=float, default=None,
                   help="residual sparsity weight (base_residual 0.05, adabins 0.1)")
    p.add_argument("--lowpass_kernel", type=int, default=None,
                   help="base_residual guidance avg-pool kernel (default 16)")
    p.add_argument("--kl_weight", type=float, default=None, help="cVAE KL weight")
    p.add_argument("--latent_dim", type=int, default=None, help="cVAE latent dim")
    p.add_argument("--lambda_l1", type=float, default=None, help="rgb_depth L1 weight (default 1.0)")
    p.add_argument("--temperature", type=float, default=None,
                   help="distillation KL temperature (default 4)")
    p.add_argument("--lambda_task", type=float, default=None,
                   help="adabins task-loss weight (default 1.0)")
    p.add_argument("--lambda_response", type=float, default=None,
                   help="adabins response-distillation weight (default 0.5)")
    p.add_argument("--lambda_feature", type=float, default=None,
                   help="adabins feature-distillation weight (default 0.3)")
    p.add_argument("--lambda_bin", type=float, default=None,
                   help="adabins bin-distribution weight (default 0.2)")
    p.add_argument("--eval_img", action="store_true",
                   help="train on camera images (input_nc 3) instead of audio; not on BV1")
    p.add_argument("--validation", type=lambda x: str(x).lower() == "true", default=None,
                   help="true|false")
    p.add_argument("--validation_iter", type=int, default=None, help="validate every N epochs")
    p.add_argument("--seed", type=int, default=None,
                   help="seed of the init and the epoch shuffles (mode.seed)")
    p.add_argument("--compute_dtype", default=None,
                   choices=[None, "bfloat16", "float32", "float64"])
    p.add_argument("--override", action="append", default=None, metavar="SECTION.KEY=VALUE",
                   help="dotted config override, repeatable, applied after every named flag")
    p.add_argument("--num_devices", type=int, default=None,
                   help="1 only: several devices are ROADMAP.md A8")
    p.add_argument("--ckpt_dir", default=None,
                   help="save checkpoints under CKPT_DIR/<experiment name> (default: none)")
    p.add_argument("--saving_checkpoints", type=int, default=None,
                   help="checkpoint every N epochs (train.py:1005 cadence)")
    p.add_argument("--best_metric", default="rmse",
                   choices=["rmse", "abs_rel", "delta1", "mae", "loss"])
    p.add_argument("--checkpoints", type=int, default=None,
                   help="epoch to resume from (default with --resume: the latest)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--init_from_torch", default=None, metavar="PTH",
                   help="warm-start the model from a reference .pth (weights only, "
                        "a fresh optimizer; the reference's own resume semantics)")
    p.add_argument("--holdout_locations", nargs="*", default=None,
                   help="locations kept out of train and val and evaluated on their own")
    # the reference's sequence-holdout spelling (train.py:76-82): both named
    # sequences are blacklisted from train and val and get holdout loaders
    p.add_argument("--sequence_holdout", action="store_true",
                   help="the reference's flag; the sequences come from "
                        "--holdout_test_seq/--holdout_eval_seq or --holdout_locations")
    p.add_argument("--holdout_test_seq", default=None,
                   help="sequence held out of training (train.py:78)")
    p.add_argument("--holdout_eval_seq", default=None,
                   help="sequence held out and evaluated each validation (train.py:80)")
    p.add_argument("--device_cache", action="store_true",
                   help="upload each split to the card once and gather batches there")
    p.add_argument("--log_dir", default=None,
                   help="write {experiment}.jsonl and {experiment}_architecture.txt here")
    p.add_argument("--results_dir", default=None,
                   help="validation PNGs under RESULTS_DIR/<experiment> (default: --log_dir)")
    p.add_argument("--no_visualize", action="store_true")
    p.add_argument("--use_wandb", action="store_true",
                   help="also log to wandb (its WANDB_* variables pick project and mode)")
    # parts not ported yet: accepted by the parser, refused by main
    p.add_argument("--profile_dir", default=None)
    p.add_argument("--sparse_method", default=None)
    return p


def _parse_override(spec: str):
    """'section.key=value' → (dotted key, value coerced to bool/int/float/
    null, else the string)."""
    from ..configs import NULL

    if "=" not in spec:
        raise SystemExit(f"--override expects SECTION.KEY=VALUE, got {spec!r}")
    key, raw = spec.split("=", 1)
    low = raw.strip().lower()
    if low in ("true", "false"):
        return key.strip(), low == "true"
    if low in ("null", "none", ""):
        return key.strip(), NULL
    for cast in (int, float):
        try:
            return key.strip(), cast(raw)
        except ValueError:
            pass
    return key.strip(), raw


def config_from_args(args):
    from ..configs import apply_overrides, load_config

    direct = {
        "mode.epochs": args.epochs,
        "mode.learning_rate": args.learning_rate,
        "mode.batch_size": args.batch_size,
        "mode.optimizer": args.optimizer,
        "mode.lr_schedule": args.lr_schedule,
        "mode.compute_dtype": args.compute_dtype,
        "mode.seed": args.seed,
        "mode.validation": args.validation,
        "mode.validation_iter": args.validation_iter,
        "mode.saving_checkpoints": args.saving_checkpoints,
        "mode.weight_decay": args.weight_decay,
        "mode.l1_weight": args.l1_weight,
        "mode.silog_weight": args.silog_weight,
        "mode.silog_lambda": args.silog_lambda,
        "model.base_channels": args.base_channels,
        "model.ngf": args.ngf,
        "model.generator": args.generator,
        "model.n_bins": args.n_bins,
        "model.kl_weight": args.kl_weight,
        "model.latent_dim": args.latent_dim,
        "model.attention_levels": args.attention_levels,
        "dataset.dataset_dir": args.dataset_dir,
    }
    if args.eval_img:
        direct["model.input_nc"] = 3
    overrides = {k: v for k, v in direct.items() if v is not None}
    # an explicit loss weight implies Combined (train.py:394-399)
    if args.criterion is not None:
        overrides["mode.criterion"] = args.criterion
    elif any(v is not None for v in (args.l1_weight, args.silog_weight, args.silog_lambda)):
        overrides["mode.criterion"] = "Combined"
    for name in _EXTRA_FLAGS:
        if getattr(args, name) is not None:
            overrides[f"model.extra.{name}"] = getattr(args, name)
    cfg = load_config(args.dataset, "train", args.experiment_name, args.model,
                      overrides=overrides)
    if args.override:
        cfg = apply_overrides(cfg, dict(_parse_override(s) for s in args.override))
    return cfg


def fold_holdout_args(args) -> None:
    """Fold the reference's sequence-holdout spelling into holdout_locations
    (train.py:76-82: both named sequences are blacklisted from train and
    val; here each held-out location gets its own holdout loader)."""
    seq_holdouts = [s for s in (args.holdout_test_seq, args.holdout_eval_seq) if s]
    if seq_holdouts:
        args.holdout_locations = list(args.holdout_locations or []) + seq_holdouts
    elif args.sequence_holdout and not args.holdout_locations:
        raise SystemExit("--sequence_holdout needs --holdout_test_seq/"
                         "--holdout_eval_seq or --holdout_locations")


def _refuse_unported(args) -> None:
    for flag, what in _UNPORTED.items():
        if getattr(args, flag):
            raise SystemExit(f"--{flag}: {what} is not ported yet")
    if args.num_devices is not None and args.num_devices > 1:
        raise SystemExit("--num_devices > 1: several devices are not ported yet "
                         "(ROADMAP.md A8)")
    if args.holdout_locations and args.dataset == "synthetic":
        raise SystemExit("--holdout_locations: the synthetic corpus has no locations")
    if args.dataset == "batvisionv1" and (args.eval_img or args.model in IMAGE_MODELS):
        raise SystemExit("camera images (--eval_img, rgb_depth, adabins_distillation) are "
                         "not supported on batvisionv1 (no camera; train.py:322-323)")
    if args.model not in TRAINED_MODELS:
        raise SystemExit(f"--model {args.model}: training is ported for "
                         f"{', '.join(TRAINED_MODELS)} only (the other families are "
                         "ROADMAP.md A5)")
    if (args.resume or args.checkpoints is not None) and not args.ckpt_dir:
        raise SystemExit("--resume/--checkpoints restore from --ckpt_dir, which is not given")
    if args.init_from_torch and (args.resume or args.checkpoints is not None):
        raise SystemExit("--init_from_torch conflicts with --resume/--checkpoints: a torch "
                         "warm-start is the reference's resume (weights only); drop one")


def _image_kwargs(cfg, eval_img: bool) -> dict:
    """The loader's image option: the synthetic corpus's shaded view, or
    BV2's camera images (alone for rgb_depth and --eval_img, paired with the
    audio for adabins_distillation)."""
    if not (eval_img or cfg.model.name in IMAGE_MODELS):
        return {}
    if cfg.dataset.name == "synthetic":
        return {"with_image": True}
    return {"use_image": True if (eval_img or cfg.model.name == "rgb_depth") else "both"}


def _warm_start(task, path: str) -> int:
    """Load a reference .pth into the model (strict); the epoch to start
    from: the one after the epoch the file names, else 1."""
    from ..tools.import_jax import torch_state_dict

    payload = torch.load(path, map_location="cpu", weights_only=True)
    task.model.load_state_dict(torch_state_dict(payload), strict=True)
    epoch = payload.get("epoch") if isinstance(payload, dict) else None
    return int(epoch) + 1 if epoch is not None else 1


def _vis_dir(args) -> Optional[str]:
    """Where validation PNGs go: --results_dir, else --log_dir; None when
    --no_visualize or neither is given."""
    if args.no_visualize:
        return None
    return args.results_dir or args.log_dir


def _require_matplotlib() -> None:
    from ..obs.visualize import pyplot

    try:
        pyplot()
    except ImportError as e:
        raise SystemExit(f"visualization needs matplotlib, which does not import ({e}); "
                         "install it or pass --no_visualize") from e


def _make_vis_callback(cfg, out_dir: str, logger):
    """The first validation batch's GT/pred grid, a PNG an epoch (the
    reference's visualization at train.py:861-871), logged as an image."""
    from ..data.codec import depth_storage_units
    from ..obs import save_batch_visualization

    def vis_callback(epoch, first_batch, pred_m):
        gt = first_batch["depth"]
        gt = np.asarray(gt.cpu() if isinstance(gt, torch.Tensor) else gt)
        if gt.dtype == np.uint16:  # compact transport form
            gt = gt.astype(np.float32) * (depth_storage_units(cfg) / 65535.0)
        if cfg.dataset.depth_norm:
            gt = gt * cfg.dataset.max_depth
        png = os.path.join(out_dir, f"val_epoch{epoch}.png")
        save_batch_visualization(gt, pred_m, png, max_depth=cfg.dataset.max_depth)
        logger.log_image("val/visualization", png, step=epoch)

    return vis_callback


def _write_architecture(path: str, exp: str, cfg, task) -> None:
    """The reference's architecture.txt (train.py:576-597): the config, the
    parameter count and the module tree."""
    n_params = sum(p.numel() for p in task.model.parameters())
    with open(path, "w") as f:
        f.write(f"experiment: {exp}\nconfig: {dataclasses.asdict(cfg)}\n")
        f.write(f"model: {type(task.model).__name__}\nparams: {n_params:,}\n\n")
        f.write(repr(task.model) + "\n")


def main(argv: Optional[Sequence[str]] = None, on_task=None, on_step=None):
    """Train from the flags; returns (engine, state). `on_task(task)` runs
    after the seeded init, before the first step; `on_step` goes to
    `Engine.fit`."""
    args = build_parser().parse_args(argv)
    fold_holdout_args(args)
    _refuse_unported(args)
    vis_dir = _vis_dir(args)
    if vis_dir is not None:
        _require_matplotlib()
    from ..ckpt import BestTracker, CheckpointManager
    from ..configs import experiment_name
    from ..data.batvision import make_dataset
    from ..data.codec import depth_storage_units
    from ..models import init_weights, make_task
    from ..obs import MetricLogger
    from ..train.engine import Engine

    cfg = config_from_args(args)
    holdout_locs = list(args.holdout_locations or [])
    image_kw = _image_kwargs(cfg, args.eval_img)
    if cfg.dataset.name == "synthetic":
        train_ds = make_dataset(cfg, "train", num_samples=args.num_samples, **image_kw)
        val_ds = make_dataset(cfg, "val", **image_kw)
    else:
        if not os.path.isdir(cfg.dataset.dataset_dir):
            raise SystemExit(f"--dataset_dir {cfg.dataset.dataset_dir!r} is not a directory")
        # held-out locations leave train AND val (train.py:326,330), so
        # neither the val metrics nor the best epoch see them
        kwargs = dict(image_kw, **({"location_blacklist": holdout_locs} if holdout_locs else {}))
        train_ds = make_dataset(cfg, "train", **kwargs)
        val_ds = make_dataset(cfg, "val", **kwargs)
    task = make_task(cfg, device=args.device)
    init_weights(task.model, torch.Generator().manual_seed(int(cfg.mode.seed)))
    if on_task is not None:
        on_task(task)
    steps_per_epoch = max(len(train_ds) // cfg.mode.batch_size, 1)
    eng = Engine(cfg, task, steps_per_epoch=steps_per_epoch)
    state = eng.init_state()
    # the reference's suffixes (train.py:288-313): [_IMG][_holdout_{locs}]
    suffixes = (["IMG"] if args.eval_img else []) + (
        ["holdout_" + "_".join(holdout_locs)] if holdout_locs else [])
    exp = experiment_name(cfg, suffix="_".join(suffixes))
    mgr = CheckpointManager(args.ckpt_dir, exp) if args.ckpt_dir else None
    resuming = args.resume or args.checkpoints is not None
    if mgr is not None and not resuming and mgr.all_epochs():
        # a new run would keep the old run's files (saves are idempotent per
        # epoch) under its own best.json
        raise SystemExit(f"{mgr.directory} holds epochs {mgr.all_epochs()} of an earlier "
                         "run: continue it with --resume, or give a new --ckpt_dir")
    start_epoch = 1
    if args.init_from_torch:
        start_epoch = _warm_start(task, args.init_from_torch)
    elif resuming:
        try:
            state, _, restored = mgr.restore(state, epoch=args.checkpoints)
            start_epoch = restored + 1
            print(json.dumps({"resumed_from_epoch": restored, "step": state.step}), flush=True)
        except FileNotFoundError:
            if args.checkpoints is not None:
                raise SystemExit(f"no checkpoint of epoch {args.checkpoints} under "
                                 f"{mgr.directory}; available: {mgr.all_epochs()}")
            print(json.dumps({"resumed_from_epoch": None}), flush=True)

    train_src, val_src, cache_bytes = train_ds, val_ds, None
    if args.device_cache:
        from ..data.device_cache import DeviceDatasetCache

        units = depth_storage_units(cfg)
        train_src = DeviceDatasetCache(train_ds, units, task.device)
        val_src = DeviceDatasetCache(val_ds, units, task.device)
        cache_bytes = {"train": train_src.nbytes(), "val": val_src.nbytes()}

    # the reshuffle stream: epoch e draws seed mode.seed * 100003 + e + 1,
    # the JAX CLI's (its init sample draws + 1, its epoch 1 + 2), so a run
    # sees the JAX CLI's batch order and a resumed run the uninterrupted one's
    epoch_seed = [int(cfg.mode.seed) * 100_003 + start_epoch]

    def train_batches():
        epoch_seed[0] += 1
        return train_src.batches(cfg.mode.batch_size, shuffle=cfg.mode.shuffle,
                                 seed=epoch_seed[0])

    def val_batches():
        # keep the ragged tail: a val split smaller than the batch would
        # otherwise evaluate nothing
        return val_src.batches(cfg.mode.batch_size, shuffle=False, drop_last=False)

    # each held-out location's rows of the full train split (with the
    # images the task reads)
    full = make_dataset(cfg, "train", **image_kw) if holdout_locs else None
    held_out = {loc: full.filter_by_audio_path(loc) for loc in holdout_locs}
    # drop_last=False: a location with fewer samples than the batch still
    # evaluates (train.py:915-999)
    holdout = {loc: (lambda sub=sub: sub.batches(cfg.mode.batch_size, shuffle=False,
                                                 drop_last=False))
               for loc, sub in held_out.items()} or None

    logger = MetricLogger(args.log_dir, exp, use_wandb=args.use_wandb,
                          config=dataclasses.asdict(cfg))
    if args.log_dir:
        _write_architecture(os.path.join(args.log_dir, f"{exp}_architecture.txt"),
                            exp, cfg, task)
    vis_callback = (_make_vis_callback(cfg, os.path.join(vis_dir, exp), logger)
                    if vis_dir is not None else None)
    print(json.dumps({"train": len(train_ds), "val": len(val_ds), "model": cfg.model.name,
                      "device": str(task.device), "compute_dtype": cfg.mode.compute_dtype,
                      "steps_per_epoch": steps_per_epoch, "experiment": exp,
                      "checkpoints": mgr.directory if mgr else None,
                      "holdout": {loc: len(sub) for loc, sub in held_out.items()} or None,
                      "device_cache_bytes": cache_bytes, "log": logger.path,
                      "visualize": os.path.join(vis_dir, exp) if vis_dir else None,
                      "start_epoch": start_epoch}), flush=True)
    try:
        state = eng.fit(state, train_batches, val_batches, start_epoch=start_epoch,
                        log=lambda rec: print(json.dumps(rec), flush=True), on_step=on_step,
                        ckpt_manager=mgr, best_tracker=BestTracker(args.best_metric),
                        logger=logger, holdout_batches=holdout, vis_callback=vis_callback)
    finally:
        logger.close()
    return eng, state


if __name__ == "__main__":
    main()
