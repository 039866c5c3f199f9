"""How often a draw of the initial weights leaves a head with a floor at 0
dead or slow, in the JAX package and in the port, each from its own RNG, at
the family sweep's widths, on the CPU (a diagnostic, not a test):

    python -m tests.torch_head_init_witness --family unet_cvae --side jax [--draws 6]
    python -m tests.torch_head_init_witness --family unet_cvae --side port [--draws 6] \\
        [--first_draw 0]

Draw k (k from --first_draw, --draws of them) is the JAX engine's init
from PRNGKey(k), or the port's `models.init_weights` from torch seed k.
Each draw trains on the batch lists of `examples/family_sweep.py` (the
sweep's config and widths, batch 32, 256 train / 32 val samples, train
shuffle seed 7) in float32 for `--epochs` epochs, as the sweep steps
(0-based epoch). Before the first step and after every epoch it prints the
share of val predictions at or below 0 (the cVAE's ReLU head with
depth_norm off, rgb_depth's clamp at 0) and the val RMSE. Last it prints,
for every weight tensor, the mean over the draws of its standard
deviation, under the port's parameter names (JAX's through
`tools/import_jax.py`), so the two sides' initializers can be compared.
One JSON line per draw and one for the stds.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

FAMILIES = ("unet_cvae", "rgb_depth")


def _val_share_rmse(eval_pred, val):
    """(share of val predictions <= 0, the per-sample mean val RMSE)."""
    share, rmse, n = 0.0, 0.0, 0
    for b in val:
        out, pred, _ = eval_pred(b)
        pred = np.asarray(pred, np.float64)
        share += float((pred <= 0).mean()) * len(pred)
        rmse += float(np.asarray(out["rmse"], np.float64).sum())
        n += len(pred)
    return share / n, rmse / n


def _weight_stds(sd):
    return {k: float(np.asarray(v, np.float64).std()) for k, v in sd.items()
            if k.endswith("weight") and np.asarray(v).ndim > 1}


def _jax_engine(name, cfg_over, steps_per_epoch):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from audiodepth_tpu.configs import load_config as jax_load_config
    from audiodepth_tpu.models import make_task as jax_make_task
    from audiodepth_tpu.train import Engine as JaxEngine

    jcfg = jax_load_config("batvisionv2", "train", f"sweep_{name}", name, overrides=cfg_over)
    return jcfg, JaxEngine(jcfg, jax_make_task(jcfg), steps_per_epoch=steps_per_epoch)


def _jax_draw(name, jcfg, jeng, k, sample):
    """JAX's init from PRNGKey(k): (its TrainState, the port's state dict of it)."""
    import jax

    from audiodepth_tpu_torch.tools import import_jax
    from tests.torch_parity import to_np

    state = jeng.init_state(jax.random.PRNGKey(k), sample)
    params, stats = to_np(state.params), to_np(state.batch_stats)
    if name == "unet_cvae":
        sd = import_jax.unet_cvae_state_dict_from_jax(
            params, stats, num_downs=8 if jcfg.model.generator == "unet_256" else 7,
            ngf=jcfg.model.ngf)
    else:
        sd = import_jax.rgb_depth_state_dict_from_jax(params, stats)
    return state, sd


def _port_draw(cfg, k):
    """The port's task with `models.init_weights` from torch seed k."""
    import torch

    from audiodepth_tpu_torch.models import init_weights, make_task

    task = make_task(cfg, device="cpu")
    init_weights(task.model, torch.Generator().manual_seed(k))
    return task


def _state_dict_np(task):
    return {n: p.detach().numpy() for n, p in task.model.state_dict().items()
            if p.is_floating_point()}


def run_jax(name, cfg, cfg_over, train, val, draws, epochs, carried):
    """JAX's loop; `carried`: from the port's draws, through the JAX
    package's `tools/import_torch.py`."""
    from audiodepth_tpu.tools import import_torch as itorch
    from tests.torch_parity import jax_state

    jcfg, jeng = _jax_engine(name, cfg_over, len(train))
    stds = []
    for k in draws:
        if carried:
            sd = _state_dict_np(_port_draw(cfg, k))
            state = jax_state(jeng, itorch.import_for_config(jcfg, sd))
        else:
            state, sd = _jax_draw(name, jcfg, jeng, k, train[0])
        stds.append(_weight_stds(sd))
        yield k, _trajectory(lambda s, b, e: jeng.train_step(s, b, epoch=e),
                             lambda s: (lambda b: jeng.eval_step_pred(s, b)),
                             lambda s, m: float(m["loss"]), state, train, val, epochs)
    yield "stds", stds


def run_port(name, cfg, cfg_over, train, val, draws, epochs, carried):
    """The port's loop; `carried`: from JAX's draws, through the port's
    `tools/import_jax.py`."""
    import torch

    from audiodepth_tpu_torch.train.engine import Engine

    if carried:
        jcfg, jeng = _jax_engine(name, cfg_over, len(train))
    stds = []
    for k in draws:
        task = _port_draw(cfg, k)
        if carried:
            sd = _jax_draw(name, jcfg, jeng, k, train[0])[1]
            task.model.load_state_dict({n: torch.from_numpy(np.asarray(v, np.float32))
                                        for n, v in sd.items()}, strict=True)
        stds.append(_weight_stds(_state_dict_np(task)))
        eng = Engine(cfg, task, steps_per_epoch=len(train))
        state = eng.init_state()

        def eval_pred(s):
            def f(b):
                out, pred, gt = eng.eval_step_pred(s, b)
                return {k2: v.float().numpy() for k2, v in out.items()}, pred.float().numpy(), gt
            return f

        yield k, _trajectory(lambda s, b, e: eng.train_step(s, b, epoch=e), eval_pred,
                             lambda s, m: float(m["loss"]), state, train, val, epochs)
    yield "stds", stds


def _trajectory(step, eval_pred, loss_of, state, train, val, epochs):
    share, rmse = _val_share_rmse(eval_pred(state), val)
    rows = [{"epoch": 0, "le0_share": share, "rmse": rmse}]
    losses = []
    for epoch in range(1, epochs + 1):
        for b in train:
            state, m = step(state, b, float(epoch - 1))
            losses.append(loss_of(state, m))
        share, rmse = _val_share_rmse(eval_pred(state), val)
        rows.append({"epoch": epoch, "le0_share": share, "rmse": rmse})
    return {"evals": rows, "losses": losses}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--family", required=True, choices=FAMILIES)
    p.add_argument("--side", required=True, choices=["jax", "port"],
                   help="whose training loop runs")
    p.add_argument("--carried", action="store_true",
                   help="start from the other side's draws instead of its own")
    p.add_argument("--draws", type=int, default=6)
    p.add_argument("--first_draw", type=int, default=0)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--bs", type=int, default=32)
    p.add_argument("--n_train", type=int, default=256)
    p.add_argument("--n_val", type=int, default=32)
    p.add_argument("--override", action="append", default=[],
                   help="SECTION.KEY=VALUE after the sweep's own (for a small rehearsal)")
    args = p.parse_args(argv)

    from audiodepth_tpu_torch.examples import family_sweep, parse_overrides
    from audiodepth_tpu_torch.models import make_task

    over = dict(family_sweep.FAMILIES)[args.family]
    cfg_over = {"mode.batch_size": args.bs, **over, "mode.compute_dtype": "float32",
                **parse_overrides(args.override)}
    cfg = family_sweep.family_config(args.family, {}, args.bs, cfg_over)
    task = make_task(cfg, device="cpu")
    train, val = family_sweep.prepare_batches(cfg, task, args.family, args.bs,
                                              args.n_train, args.n_val)
    run = run_jax if args.side == "jax" else run_port
    t0 = time.perf_counter()
    draws = range(args.first_draw, args.first_draw + args.draws)
    for k, res in run(args.family, cfg, cfg_over, train, val, draws, args.epochs,
                      args.carried):
        if k == "stds":
            mean = {n: float(np.mean([s[n] for s in res])) for n in res[0]}
            print(json.dumps({"side": args.side, "carried": args.carried,
                              "family": args.family, "weight_std": mean}))
        else:
            print(json.dumps({"side": args.side, "carried": args.carried,
                              "family": args.family, "draw": k, **res,
                              "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
