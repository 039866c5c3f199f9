"""Plain training steps: the Combined loss in meters over the valid pixels,
the global-norm clip, and AdamW (decoupled decay, bias-corrected moments,
eps outside the square root), all in float32.

`reference_steps` runs the first steps of a cell from the benchmark's
weights on the same batches the program trained on, and returns what the
comparison reads: each step's loss, each leaf's norm of the first clipped
gradient, and each leaf's norm of its change over the steps. The net, its
loss and the parameters AdamW updates are the family file's
(`families/<family>.py`); the clip, AdamW and the readings are the same
for every family.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List

import torch

from .families import family
from .frontend import mel_frontend
from .precision import Precision, set_float32_exact
from .ranks import RowShards


def combined_loss(pred: torch.Tensor, gt: torch.Tensor, l1_weight: float,
                  silog_weight: float, silog_lambda: float,
                  shards: RowShards = None) -> torch.Tensor:
    """l1_weight·L1 + silog_weight·SIlog over the pixels with gt ≠ 0 (of
    the global batch, where `shards` spreads its rows over processes)."""
    shards = shards or RowShards()
    w = (gt != 0).to(pred.dtype)
    d = torch.log(pred.clamp_min(1e-6)) - torch.log(gt.clamp_min(1e-6))
    sums = shards.total(torch.stack([w.sum(), ((pred - gt).abs() * w).sum(), (d * w).sum(),
                                     (d * d * w).sum()]))
    count = sums[0].clamp_min(1.0)
    l1, m1, m2 = sums[1] / count, sums[2] / count, sums[3] / count
    silog = torch.sqrt((m2 - silog_lambda * m1 * m1).clamp_min(0.0))
    return l1_weight * l1 + silog_weight * silog


def mel_combined_loss(net, batch: Dict[str, torch.Tensor], cfg: Dict,
                      shards: RowShards = None) -> torch.Tensor:
    """The Combined loss of a net that reads the mel front end's image of
    the batch's waveforms (a family file's `train_loss`)."""
    x = mel_frontend(batch["waveform"], int(cfg["images_size"]), float(cfg["max_depth"]),
                     int(cfg["sample_rate"]))
    pred = net(x)
    return combined_loss(pred, batch["depth"], float(cfg["l1_weight"]),
                         float(cfg["silog_weight"]), float(cfg["silog_lambda"]), shards)


def mel_predict(net, batch: Dict[str, torch.Tensor], cfg: Dict) -> torch.Tensor:
    """Depth [B, S, S] in meters of a net that reads the mel front end's
    image of the batch's waveforms (a family file's `predict`)."""
    x = mel_frontend(batch["waveform"], int(cfg["images_size"]), float(cfg["max_depth"]),
                     int(cfg["sample_rate"]))
    return net(x)[..., 0]


def clipped_grads(grads: List[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """g·max_norm/‖g‖ where the global norm reaches max_norm, else g."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
    if max_norm and max_norm > 0 and norm >= max_norm:
        return [g * (max_norm / norm) for g in grads]
    return list(grads)


def reference_steps(cfg: Dict, weights: Dict[str, torch.Tensor],
                    batches: Iterable[Callable[[], Dict[str, torch.Tensor]]],
                    prec: Precision = None, device="cuda",
                    shards: RowShards = None) -> Dict[str, object]:
    """Train the reference from `weights` over `batches` (callables giving
    the pairs' per-row tensors, {'waveform' [B, 2, L], 'depth' [B, S, S, 1]}
    and the family's extra inputs, float32 on `device`: this process's rows
    of each global batch where `shards` has several ranks).

    Returns {"loss": [per step], "grad": {trained leaf: ‖g₁‖}, "change":
    {leaf: ‖θ_end − θ₀‖}, "bn": {layer: (mean, unbiased variance) of the
    first step's batch}}; the gradient is the first step's after the clip,
    as AdamW receives it."""
    set_float32_exact()
    prec = prec or Precision()
    fam = family(cfg["family"])
    net = fam.build_net(cfg, prec, checkpointed=True).to(device)
    net.load_state_dict({k: v.to(device) for k, v in weights.items()}, strict=True)
    net.train()
    shards = shards or RowShards()
    for mod in net.modules():
        if hasattr(mod, "shards"):
            mod.shards = shards
    names = [n for n, _ in net.named_parameters()]
    params = [p for _, p in net.named_parameters()]
    start = [p.detach().clone() for p in params]
    trained = [(n, p) for n, p in zip(names, params) if fam.trainable(n)]
    lr, wd = float(cfg["learning_rate"]), float(cfg["weight_decay"])
    b1, b2, eps = 0.9, 0.999, 1e-8
    m = [torch.zeros_like(p) for _, p in trained]
    v = [torch.zeros_like(p) for _, p in trained]
    out: Dict[str, object] = {"loss": [], "grad": {}}
    for t, make in enumerate(batches, start=1):
        batch = make()
        loss = fam.train_loss(net, batch, cfg, shards)
        grads = shards.reduce_grads(list(torch.autograd.grad(loss, [p for _, p in trained])))
        del batch
        grads = clipped_grads(grads, float(cfg["grad_clip_norm"]))
        out["loss"].append(float(loss.detach()))
        if t == 1:
            out["grad"] = {n: float(torch.linalg.vector_norm(g.double()))
                           for (n, _), g in zip(trained, grads)}
            out["bn"] = {n: tuple(s.double().cpu() for s in m.batch_stats)
                         for n, m in net.named_modules() if hasattr(m, "batch_stats")}
        with torch.no_grad():
            for (_, p), g, mi, vi in zip(trained, grads, m, v):
                p.mul_(1.0 - lr * wd)
                mi.mul_(b1).add_(g, alpha=1.0 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = (vi.sqrt() / (1.0 - b2 ** t) ** 0.5).add_(eps)
                p.addcdiv_(mi, denom, value=-lr / (1.0 - b1 ** t))
        del grads
    with torch.no_grad():
        out["change"] = {n: float(torch.linalg.vector_norm((p - p0).double()))
                         for n, p, p0 in zip(names, params, start)}
    return out


@torch.no_grad()
def reference_predict(cfg: Dict, weights: Dict[str, torch.Tensor],
                      batch: Dict[str, torch.Tensor], prec: Precision = None,
                      rows: int = 16) -> torch.Tensor:
    """Evaluation-mode depth in meters [B, S, S] of a batch's per-row
    tensors ({'waveform' [B, 2, L]} and the family's extra inputs), `rows`
    at a time, clipped to [0, max_depth]."""
    set_float32_exact()
    prec = prec or Precision()
    fam = family(cfg["family"])
    device = batch["waveform"].device
    net = fam.build_net(cfg, prec).to(device)
    net.load_state_dict({k: v.to(device) for k, v in weights.items()}, strict=True)
    net.eval()
    outs = []
    for s in range(0, batch["waveform"].shape[0], rows):
        part = {k: v[s:s + rows] for k, v in batch.items()}
        outs.append(fam.predict(net, part, cfg).clamp(0.0, float(cfg["max_depth"])))
    return torch.cat(outs)
