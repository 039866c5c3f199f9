"""The cVAE's sweep loop in the JAX package and in the port, side by side on
the CPU (a diagnostic, not a test):

    python -m tests.torch_cvae_side_by_side [--dtype float64] [--ngf 8] [--bs 8] \\
        [--n_train 64] [--epochs 3]

Both engines start from the JAX engine's PRNGKey(0) init, carried across by
`tools/import_jax.py`, train on the batch lists of
`examples/family_sweep.py` (unet_128 at 128², the sweep's BV2 config) with
the latent's eps = 0 on both sides, and validate after every epoch. Each
step prints both losses and their relative difference, the end the step
where they part (1e-6 in float64, 1e-3 in float32). The ReLU head's SIlog
gradient (1/pred at near-zero answers) amplifies a rounding difference by
orders of magnitude a step, so the two float64 runs of the same step part
after a few steps; see ROADMAP.md §C.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dtype", default="float64", choices=["float64", "float32"])
    p.add_argument("--ngf", type=int, default=8)
    p.add_argument("--bs", type=int, default=8)
    p.add_argument("--n_train", type=int, default=64)
    p.add_argument("--epochs", type=int, default=3)
    args = p.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from audiodepth_tpu.configs import load_config as jax_load_config
    from audiodepth_tpu.models import make_task as jax_make_task
    from audiodepth_tpu.train import Engine as JaxEngine
    from audiodepth_tpu_torch.examples import family_sweep
    from audiodepth_tpu_torch.models import make_task
    from audiodepth_tpu_torch.models import unet_cvae
    from audiodepth_tpu_torch.tools.import_jax import unet_cvae_state_dict_from_jax
    from audiodepth_tpu_torch.train.engine import Engine
    from tests.torch_parity import jax_state, to_np

    # eps = 0 on both sides: the latent is its mean, the draws out of the way
    jax.random.normal = lambda key, shape=(), dtype=None: jnp.zeros(shape, dtype or jnp.float32)
    unet_cvae.draw_global = lambda draw, rows: draw(rows) * 0
    bs, n_train = args.bs, args.n_train
    overrides = {"mode.batch_size": bs, "model.ngf": args.ngf, "model.generator": "unet_128",
                 "dataset.images_size": 128, "mode.compute_dtype": args.dtype}
    jcfg = jax_load_config("batvisionv2", "train", "sweep_unet_cvae", "unet_cvae",
                           overrides=overrides)
    cfg = family_sweep.family_config("unet_cvae", {}, bs, overrides)
    task = make_task(cfg, device="cpu")
    train, val = family_sweep.prepare_batches(cfg, task, "unet_cvae", bs, n_train, bs)
    jeng = JaxEngine(jcfg, jax_make_task(jcfg), steps_per_epoch=n_train // bs)
    init = jeng.init_state(jax.random.PRNGKey(0), train[0])
    dtype = np.float64 if args.dtype == "float64" else np.float32
    variables = {k: jax.tree_util.tree_map(lambda x: np.asarray(x, dtype), to_np(v))
                 for k, v in (("params", init.params), ("batch_stats", init.batch_stats))}
    jstate = jax_state(jeng, variables)
    if args.dtype == "float64":
        task.model.double()
    task.model.load_state_dict(unet_cvae_state_dict_from_jax(
        variables["params"], variables["batch_stats"], num_downs=7, ngf=args.ngf), strict=True)
    eng = Engine(cfg, task, steps_per_epoch=n_train // bs)
    state = eng.init_state()
    tol = 1e-6 if args.dtype == "float64" else 1e-3
    step, parted = 0, None
    for epoch in range(1, args.epochs + 1):
        for batch in train:
            jstate, jm = jeng.train_step(jstate, batch, epoch=float(epoch - 1))
            state, m = eng.train_step(state, batch, epoch=float(epoch - 1))
            jl, pl = float(jm["loss"]), float(m["loss"])
            rel = abs(jl - pl) / abs(jl)
            step += 1
            if parted is None and rel > tol:
                parted = step
            print(f"step {step:3d}  jax {jl:.8f}  port {pl:.8f}  rel {rel:.2e}", flush=True)
        jv, pv = jeng.evaluate(jstate, iter(val)), eng.evaluate(state, iter(val))
        print(f"epoch {epoch}  val rmse  jax {jv['rmse']:.5f}  port {pv['rmse']:.5f}", flush=True)
    print(f"parted (rel > {tol:g}) at step {parted}")
    return parted


if __name__ == "__main__":
    main(sys.argv[1:])
