"""Export the fused waveform→depth inference graph (port of `tools/export.py`).

The deployment artifact of the port: ONE `torch.export` program holding the
whole audio→depth path, the time-of-flight cut, the mel front end, the
model's eval-mode forward, the unit conversion and the clip to
[0, max_depth], saved as a `.pt2`:

    python -m audiodepth_tpu_torch.tools.export --model binaural_attention \
        --ckpt_dir checkpoints --experiment_name <exp> --use_best --out g.pt2

The hand-written kernels stay in the graph as the registered ops
`audiodepth::fused_mel_frontend` (B1) and `audiodepth::flash_cross_attention_fwd`
(B2), so the exported program launches them on the card (and runs their
plain versions on the CPU). A `.pt2` that holds them loads only where the
ops are registered: `load_exported` imports `audiodepth_tpu_torch.ops.cuda`
first, as the JAX package's artifact needs jax. The float64 mode's front end
is plain tensor ops (B1 is float32 by definition), so an f64 graph holds no
B1 op.

The program is exported at one batch size, as the JAX package's is, from
the model in eval mode under `no_grad`: it updates no BatchNorm statistic.
A checkpoint's aux (the coarse family's bins) is adopted with
`task.restore_aux` before tracing and baked into the graph. The cVAE's eval
latent comes from a generator reseeded to 0 on every call; export cannot
trace an explicit generator, so `InferenceGraph` draws that eps once, at
export time, for the exported batch size, and holds it as a buffer: the
program answers what eager `predict_meters` answers.
"""

from __future__ import annotations

import argparse
import functools
import os
from typing import Optional

import torch
import torch.nn as nn

# the audio families; rgb_depth (input_nc 3) is refused, as serve refuses it
AUDIO_MODELS = ("unet_baseline", "binaural_attention", "base_residual", "unet_cvae",
                "adabins_distillation", "coarse_depth")


class InferenceGraph(nn.Module):
    """waveform [B, 2, L] → depth in meters [B, S, S, 1], clipped to
    [0, max_depth]: the task's `predict_meters` on its module."""

    def __init__(self, cfg, task, batch_size: Optional[int] = None):
        super().__init__()
        if cfg.model.input_nc != 2:
            raise ValueError("the inference graph is waveform→depth; image-input models "
                             "(rgb_depth / --eval_img baselines) are not exportable")
        self.model = task.model
        self.task = task
        self.max_depth = float(cfg.dataset.max_depth)
        self.register_buffer("eps", _cvae_eval_eps(cfg, task, batch_size)
                             if cfg.model.name == "unet_cvae" and batch_size is not None
                             else None)

    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        if self.eps is not None:
            pred = self.task.pred_to_meters(_cvae_predict(self.task, waveform, self.eps))
        else:
            pred = self.task.predict_meters({"waveform": waveform})
        return torch.clamp(pred, 0.0, self.max_depth)


def build_inference_fn(cfg, task) -> InferenceGraph:
    """The eager inference module, waveform [B, 2, L] → depth [B, S, S, 1]."""
    return InferenceGraph(cfg, task).eval()


def _cvae_eval_eps(cfg, task, batch_size: int) -> torch.Tensor:
    """The eps the cVAE task's eval forward draws for a batch of
    `batch_size`: N(0, 1) of the latent's shape from its eval generator
    reseeded to 0 (`UNetCVAETask.predict_raw`)."""
    from ..configs import resolve_compute_dtype

    dtype = torch.promote_types(resolve_compute_dtype(cfg), torch.float32)
    task._eval_generator.manual_seed(0)
    return torch.randn((batch_size, int(cfg.model.latent_dim)), generator=task._eval_generator,
                       dtype=dtype, device=task.device)


def _cvae_predict(task, waveform: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """`UNetCVAETask.predict_raw` with the latent's eps given: the
    bottleneck's forward takes `eps` for this call instead of drawing."""
    from ..models.unet_cvae import VAEBottleneck

    vae = next(m for m in task.model.modules() if isinstance(m, VAEBottleneck))
    vae.forward = functools.partial(VAEBottleneck.forward, vae, eps=eps)
    try:
        return task.predict_raw({"waveform": waveform})
    finally:
        del vae.forward


def wave_length(cfg) -> int:
    """The exported waveform's length: the time-of-flight cut + 256 (the
    JAX package's)."""
    from ..data.frontend import tof_cut_samples

    return tof_cut_samples(cfg.dataset.max_depth, cfg.dataset.sample_rate) + 256


def export_inference(cfg, task, batch_size: int = 1, out_path: Optional[str] = None):
    """`torch.export` of the inference graph at `batch_size` on the task's
    device; saved to `out_path` when given. Returns (exported, path)."""
    graph = InferenceGraph(cfg, task, batch_size).eval()
    wave = torch.zeros((batch_size, 2, wave_length(cfg)), dtype=torch.float32,
                       device=task.device)
    with torch.no_grad():
        graph(wave)  # eager first: caches (resize matrices) hold real tensors
        exported = torch.export.export(graph, (wave,))
    mutated = exported.graph_signature.buffers_to_mutate
    if mutated:
        raise RuntimeError(f"the exported inference graph mutates buffers: {sorted(mutated)}")
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        torch.export.save(exported, out_path)
    return exported, out_path


def load_exported(path: str):
    """The exported program saved at `path`, with the port's ops registered
    first (a `.pt2` that holds them does not load without). Call its
    `module()` under `torch.no_grad()`: its parameters require grad."""
    from .._device import configure_precision
    from ..ops import cuda  # noqa: F401  (registers audiodepth::*)

    configure_precision()  # the port's numerics: no TF32, as make_task sets
    return torch.export.load(path)


def main(argv=None):
    p = argparse.ArgumentParser(description="Export the fused inference graph")
    p.add_argument("--dataset", default="batvisionv2")
    p.add_argument("--model", default="unet_baseline")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--out", default="./export/inference.pt2")
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--experiment_name", default=None)
    p.add_argument("--checkpoints", type=int, default=None,
                   help="epoch to export (default latest)")
    p.add_argument("--use_best", action="store_true",
                   help="export the best-validation checkpoint (best.json)")
    p.add_argument("--torch_checkpoint", default=None,
                   help="reference .pth checkpoint (train.py:1005-1021 format) to export "
                        "directly; a port checkpoint is one too")
    p.add_argument("--device", default="cuda",
                   help="torch device to trace and run on (cuda, cuda:1, cpu)")
    from ..cli.common import add_model_shape_args, model_shape_overrides

    add_model_shape_args(p)
    args = p.parse_args(argv)
    if args.model not in AUDIO_MODELS:
        raise SystemExit(f"--model {args.model}: the inference graph is waveform→depth "
                         f"({', '.join(AUDIO_MODELS)})")

    from ..configs import load_config
    from ..models import init_weights, make_task

    cfg = load_config(args.dataset, "test", "export", args.model,
                      overrides=model_shape_overrides(args))
    task = make_task(cfg, device=args.device)
    init_weights(task.model, torch.Generator().manual_seed(0))
    if args.torch_checkpoint:
        from .import_jax import load_torch_aux, load_torch_state_dict

        sd = load_torch_state_dict(args.torch_checkpoint)
        task.model.load_state_dict(sd, strict=True)
        # a coarse wrapper's bins (train_coarse_depth.py:632-640), baked in
        task.restore_aux(load_torch_aux(args.torch_checkpoint))
        print(f"imported torch checkpoint {args.torch_checkpoint} ({len(sd)} tensors)")
    elif args.ckpt_dir and args.experiment_name:
        from ..ckpt import CheckpointManager

        mgr = CheckpointManager(args.ckpt_dir, args.experiment_name, create=False)
        epoch_req = "best" if (args.use_best and args.checkpoints is None) else args.checkpoints
        sd, aux, epoch = mgr.restore_eval(epoch=epoch_req)
        task.model.load_state_dict(sd, strict=True)
        print(f"restored epoch {epoch} from {mgr.directory}")
        task.restore_aux(aux)  # e.g. coarse bin centers baked into the graph

    _, path = export_inference(cfg, task, args.batch_size, args.out)
    print(f"exported fused inference graph → {path}")
    return path


if __name__ == "__main__":
    main()
