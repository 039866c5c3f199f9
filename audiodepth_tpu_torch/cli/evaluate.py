"""Evaluation CLI (port of `cli/evaluate.py`, the reference's test.py twin).

    python -m audiodepth_tpu_torch.cli.evaluate --dataset batvisionv2 \
        --dataset_dir /data/BatvisionV2 --checkpoint_path checkpoints/<exp> --use_best

Resolves a checkpoint that `cli.train` saved as the port's serve does
(--checkpoint_path DIR[/EPOCH], or --ckpt_dir with the experiment's name;
--checkpoints N, --use_best; a missing one exits naming the epochs there),
or takes a reference .pth (--torch_checkpoint; a port checkpoint is one
too). It evaluates the --eval_on split (test or val) on --device (default
cuda) in batches of --batch_size (default 16, the ragged tail kept), one
forward a batch, and prints the means of the per-sample metrics
(test.py:322-332); a coarse_depth checkpoint soft-bins over the bins it
was trained with (its aux, or a reference wrapper's bin_centers /
bin_edges). rgb_depth and --eval_img (input_nc 3) checkpoints are
scored on camera images (BatVision V2 and the synthetic corpus); an
adabins_distillation checkpoint, which holds the teacher, is scored by its
student alone on audio. It writes
{stat_dir}/{dataset}/{eval_on}/stats_on_{experiment}_epoch{epoch}.npz with
one vector a metric, one row a sample (and the gt and pred tensors in
meters under --save_tensors); --visualize writes one PNG per
--vis_batch_size samples under {results_dir}/{experiment}/{eval_on}/.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    from .common import add_model_shape_args

    p = argparse.ArgumentParser(description="audio-depth evaluation (PyTorch/CUDA)")
    p.add_argument("--dataset", default="batvisionv2",
                   choices=["batvisionv1", "batvisionv2", "synthetic"])
    p.add_argument("--model", default="unet_baseline")
    p.add_argument("--experiment_name", default="default")
    p.add_argument("--dataset_dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to evaluate on (cuda, cuda:1, cpu)")
    p.add_argument("--eval_on", default="test", choices=["test", "val"])
    p.add_argument("--checkpoints", type=int, default=None, help="epoch (default: the latest)")
    p.add_argument("--checkpoint_path", default=None,
                   help="one experiment's checkpoint directory, or DIR/EPOCH")
    p.add_argument("--use_best", action="store_true",
                   help="the best validation epoch (best.json) instead of the latest")
    p.add_argument("--torch_checkpoint", default=None,
                   help="a reference .pth (checkpoint['state_dict']); a port checkpoint is one")
    p.add_argument("--eval_img", action="store_true",
                   help="a model trained on camera images (input_nc 3): score it on images")
    p.add_argument("--ckpt_dir", default="./checkpoints")
    p.add_argument("--stat_dir", default="./eval/")
    p.add_argument("--batch_size", type=int, default=None)
    add_model_shape_args(p)
    p.add_argument("--compute_dtype", default=None,
                   choices=[None, "bfloat16", "float32", "float64"])
    p.add_argument("--visualize", action="store_true",
                   help="GT/pred/error PNG grids over the whole split, one file per "
                        "--vis_batch_size samples (test.py:288-320)")
    p.add_argument("--vis_batch_size", type=int, default=4)
    p.add_argument("--results_dir", default="./results",
                   help="visualizations under {results_dir}/{experiment}/{eval_on}/")
    p.add_argument("--save_tensors", action="store_true",
                   help="add the gt and pred tensors (meters) to the stats artifact")
    p.add_argument("--override", action="append", default=[], metavar="SECTION.KEY=VALUE",
                   help="dotted config override, cli.train's grammar, applied last")
    return p


def restore_weights(task, torch_checkpoint: Optional[str] = None,
                    ckpt_dir: Optional[str] = None, experiment: Optional[str] = None,
                    epoch=None):
    """Load a checkpoint into task.model (strict) and adopt its aux (the
    coarse family's trained bins) before the first forward: a reference or
    port `.pth` (`torch_checkpoint`), else epoch `epoch` (default the
    latest; 'best' through best.json) of the experiment directory
    {ckpt_dir}/{experiment} that `cli.train` wrote. Returns the epoch
    restored, or 'torch' for a `.pth`; a missing checkpoint exits naming the
    epochs there."""
    from ..ckpt import CheckpointManager
    from ..tools.import_jax import load_torch_aux, load_torch_state_dict

    if torch_checkpoint:
        task.model.load_state_dict(load_torch_state_dict(torch_checkpoint), strict=True)
        task.restore_aux(load_torch_aux(torch_checkpoint))
        print(f"loaded torch checkpoint {torch_checkpoint}")
        return "torch"
    mgr = CheckpointManager(ckpt_dir, experiment, create=False)
    try:
        sd, aux, epoch = mgr.restore_eval(epoch=epoch)
    except FileNotFoundError:
        raise SystemExit(f"checkpoint not found under {mgr.directory}; "
                         f"available epochs: {mgr.all_epochs()}")
    task.model.load_state_dict(sd, strict=True)
    task.restore_aux(aux)
    return epoch


def _restore(args, cfg, task):
    """Resolve the checkpoint the flags name and load it
    (`restore_weights`); (experiment, epoch)."""
    from ..configs import experiment_name

    default_exp = (experiment_name(cfg) if args.experiment_name == "default"
                   else args.experiment_name)
    if args.torch_checkpoint:
        return default_exp, restore_weights(task, torch_checkpoint=args.torch_checkpoint)
    epoch_req = args.checkpoints
    ckpt_dir, exp = args.ckpt_dir, default_exp
    if args.checkpoint_path:
        path = os.path.abspath(args.checkpoint_path).rstrip("/")
        if os.path.basename(path).isdigit():
            epoch_req = int(os.path.basename(path))
            path = os.path.dirname(path)
        ckpt_dir, exp = os.path.dirname(path), os.path.basename(path)
        print(f"extracted experiment name from path: {exp}")
    if args.use_best and epoch_req is None:
        epoch_req = "best"
    return exp, restore_weights(task, ckpt_dir=ckpt_dir, experiment=exp, epoch=epoch_req)


def image_kwargs(cfg) -> dict:
    """The loader's option for a model that reads camera images (input_nc
    3: rgb_depth and --eval_img): the synthetic corpus's shaded view or
    BatVision V2's camera; none for the others (adabins validates its
    student alone on audio, train_adabins_distillation.py:481-522)."""
    if cfg.model.input_nc != 3:
        return {}
    if cfg.dataset.name == "batvisionv1":
        raise SystemExit("image-input evaluation is not supported on batvisionv1 "
                         "(no camera images)")
    return {"with_image": True} if cfg.dataset.name == "synthetic" else {"use_image": True}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Evaluate from the flags; returns the metric means."""
    args = build_parser().parse_args(argv)
    from ..configs import apply_overrides, load_config
    from ..data.batvision import make_dataset
    from ..models import make_task
    from ..train.engine import Engine
    from .common import model_shape_overrides
    from .train import _parse_override

    overrides = {"mode.eval_on": args.eval_on, **model_shape_overrides(args)}
    for key, val in {"dataset.dataset_dir": args.dataset_dir,
                     "mode.batch_size": args.batch_size,
                     "mode.compute_dtype": args.compute_dtype}.items():
        if val is not None:
            overrides[key] = val
    if args.eval_img:
        overrides["model.input_nc"] = 3
    cfg = load_config(args.dataset, "test", args.experiment_name, args.model,
                      overrides=overrides)
    if args.override:
        cfg = apply_overrides(cfg, dict(_parse_override(s) for s in args.override))
    ds_kwargs = image_kwargs(cfg)
    task = make_task(cfg, device=args.device)
    exp, epoch = _restore(args, cfg, task)
    ds = make_dataset(cfg, args.eval_on, **ds_kwargs)
    return _run_eval(args, cfg, Engine(cfg, task), ds, exp, epoch, args.batch_size or 16)


def _run_eval(args, cfg, eng, ds, exp, epoch, bs):
    from ..metrics import METRIC_NAMES

    print(f"evaluating {exp} @ epoch {epoch} on {args.eval_on}")
    per_sample = {k: [] for k in METRIC_NAMES + ("loss",)}
    gts, preds = [], []
    vis_dir = os.path.join(args.results_dir, exp, args.eval_on)
    vis = {"gts": [], "preds": [], "group": 0, "seen": 0}
    if args.visualize:
        os.makedirs(vis_dir, exist_ok=True)
        print(f"visualization output directory: {vis_dir}")

    def flush_vis():
        from ..obs import save_batch_visualization

        n = len(vis["gts"])
        lo, hi = vis["seen"], vis["seen"] + n - 1
        path = os.path.join(vis_dir, f"batch_{vis['group']:04d}_samples_{lo:04d}-{hi:04d}.png")
        save_batch_visualization(np.stack(vis["gts"]), np.stack(vis["preds"]), path,
                                 max_depth=cfg.dataset.max_depth, max_cols=n)
        print(f"saved visualization: {path}")
        vis.update(gts=[], preds=[], group=vis["group"] + 1, seen=hi + 1)

    want_pred = args.save_tensors or args.visualize
    for batch in ds.batches(bs, shuffle=False, drop_last=False):
        # metrics and the prediction in meters from one forward
        out, pred, gt_m = eng.eval_step_pred(None, batch)
        valid = (out["_valid"].cpu().numpy().astype(bool) if "_valid" in out else None)
        if want_pred:
            pred, gt_m = (t.detach().cpu().numpy() for t in (pred, gt_m))
            if valid is not None:  # pad rows never reach the tensors or the PNGs
                pred, gt_m = pred[valid], gt_m[valid]
        for k in per_sample:
            v = out[k].detach().cpu().numpy()
            per_sample[k].append(v[valid] if valid is not None else v)
        if args.visualize:
            for g, p_ in zip(gt_m, pred):
                vis["gts"].append(g)
                vis["preds"].append(p_)
                if len(vis["gts"]) >= args.vis_batch_size:
                    flush_vis()
        if args.save_tensors:
            gts.append(gt_m)
            preds.append(pred)
    if args.visualize and vis["gts"]:
        flush_vis()
    if args.visualize:
        print(f"visualizations saved to {vis_dir}: {vis['group']} files, "
              f"{vis['seen']} samples")
    per_sample = {k: np.concatenate(v) for k, v in per_sample.items()}
    means = {k: float(v.mean()) for k, v in per_sample.items()}
    print("  ".join(f"{k}={v:.4f}" for k, v in means.items()))
    out_dir = os.path.join(args.stat_dir, cfg.dataset.name, args.eval_on)
    os.makedirs(out_dir, exist_ok=True)
    artifact = os.path.join(out_dir, f"stats_on_{exp}_epoch{epoch}.npz")
    payload = dict(per_sample)
    if args.save_tensors and gts:
        payload["gt"] = np.concatenate(gts)
        payload["pred"] = np.concatenate(preds)
    np.savez_compressed(artifact, **payload)
    print(f"stats artifact: {artifact}")
    return means


if __name__ == "__main__":
    main()
