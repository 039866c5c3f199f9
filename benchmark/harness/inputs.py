"""Inputs and weights of a run, made on the device from `--seed`.

`make_pairs` is the benchmark's frozen copy of the synthetic echo
generator (the port's `data/synthetic.py`), in bulk: each scene is a smooth
random depth field (an 8 × 8 uniform grid, bilinearly upsampled, scaled to
[0.05, 0.95]·max_depth) with dropout pixels at 0 where a second field is
under 0.15; its two-channel waveform of the time-of-flight length plus 256
samples sums five 256-sample chirp echoes at the delays of the valid
depth's 10/30/50/70/90 % quantiles (amplitudes 1, .8, .6, .4, .3), panned
left/right with an inter-channel delay of int(4·(pan − 0.5)) samples, plus
N(0, 0.01) noise. Two steps make the data a recording and a depth frame:
the waveform is kept under full scale and rounded to the 16-bit PCM grid,
and the depth to the uint16 grid of max_depth/65535 m, so the program's
compact transport (int16 / uint16) carries every value exactly and both
sides read the same numbers. A family whose pairs hold more than the
waveform and the depth (a camera frame, say) draws those tensors in its
reference file's `extra_inputs`, from the rows' depth, with a generator of
their own (seed + `EXTRA_STREAM`): the waveform and depth rows of a seed
are the same whatever the family.

`make_weights` draws every entry of a net's state dict from the seed in one
normal draw on the device, by the family's initialisation (its reference
file's `param_specs`), with each attention gate γ drawn non-zero
(±U(0.25, 1)): at its published init of 0 no answer and no gradient would
depend on the attention.
"""

from __future__ import annotations

from typing import Dict

import torch

from reference import family, param_specs, tof_cut_samples

SPEED_OF_SOUND = 340.0
QUANTILES = (0.1, 0.3, 0.5, 0.7, 0.9)
AMPLITUDES = (1.0, 0.8, 0.6, 0.4, 0.3)
CHIRP = 256
FULL_SCALE = 0.999
WEIGHT_STREAM = 2 ** 40  # the weights' generator: seed + this
EXTRA_STREAM = 2 ** 41   # the family's extra inputs' generator: seed + this


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)


def _smooth(coarse: torch.Tensor, size: int) -> torch.Tensor:
    """[..., c, c] → [..., size, size], separable linear interpolation at
    linspace(0, c − 1, size)."""
    c = coarse.shape[-1]
    xs = torch.linspace(0, c - 1, size, dtype=torch.float64, device=coarse.device)
    x0 = xs.floor().long()
    x1 = (x0 + 1).clamp_max(c - 1)
    fx = (xs - x0).to(coarse.dtype)
    rows = coarse[..., x0, :] * (1 - fx)[:, None] + coarse[..., x1, :] * fx[:, None]
    return rows[..., x0] * (1 - fx) + rows[..., x1] * fx


def _chirp(device) -> torch.Tensor:
    t = torch.arange(CHIRP, dtype=torch.float32, device=device)
    n = torch.arange(CHIRP, dtype=torch.float64, device=device)
    hann = (0.5 - 0.5 * torch.cos(2 * torch.pi * n / (CHIRP - 1))).float()
    return torch.sin(2 * torch.pi * (0.01 + 0.0008 * t) * t) * hann


def _quantiles(depth: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[n, len(QUANTILES)] linear-interpolated quantiles of each row's valid
    entries (numpy's default method)."""
    flat = torch.where(valid, depth, torch.full_like(depth, float("inf"))).flatten(1)
    srt = flat.sort(dim=1).values
    k = valid.flatten(1).sum(1).clamp_min(1)
    out = []
    for q in QUANTILES:
        pos = q * (k - 1).to(torch.float64)
        lo = pos.floor().long()
        hi = torch.minimum(lo + 1, k - 1)
        frac = (pos - lo).to(depth.dtype)
        a = srt.gather(1, lo[:, None])[:, 0]
        b = srt.gather(1, hi[:, None])[:, 0]
        out.append(a * (1 - frac) + b * frac)
    return torch.stack(out, 1)


def _pairs_chunk(n: int, gen: torch.Generator, size: int, max_depth: float,
                 sample_rate: int, device) -> Dict[str, torch.Tensor]:
    length = tof_cut_samples(max_depth, sample_rate) + CHIRP
    fields = _smooth(torch.rand(n, 2, 8, 8, generator=gen, device=device), size)
    depth_m = fields[:, 0] * (0.9 * max_depth) + 0.05 * max_depth
    valid = fields[:, 1] >= 0.15
    depth_m = torch.where(valid, depth_m, torch.zeros_like(depth_m))
    qs = _quantiles(depth_m, valid)                                  # [n, 5]
    pan = torch.rand(n, generator=gen, device=device) * 0.6 + 0.2
    delay = torch.floor((2 * qs / SPEED_OF_SOUND) * sample_rate).long()
    itd = torch.trunc(4 * (pan - 0.5)).long()
    amp = torch.tensor(AMPLITUDES, device=device)[None, :].expand(n, -1)
    amp = torch.where(delay + CHIRP + 4 >= length, torch.zeros_like(amp), amp)
    chirp = _chirp(device)
    t = torch.arange(CHIRP, device=device)
    wave = torch.zeros(n, 2, length, device=device)
    for ch, (start, gain) in enumerate(((delay, pan), (delay + itd[:, None], 1 - pan))):
        idx = (start[:, :, None] + t).clamp(0, length - 1).reshape(n, -1)
        val = (amp * gain[:, None])[:, :, None] * chirp
        wave[:, ch].scatter_add_(1, idx, val.reshape(n, -1))
    wave += torch.randn(n, 2, length, generator=gen, device=device) * 0.01
    peak = wave.abs().flatten(1).amax(1).clamp_min(FULL_SCALE)
    wave = wave * (FULL_SCALE / peak)[:, None, None]
    wave = torch.round(wave * 32768.0).clamp(-32768, 32767) / 32768.0
    units = torch.round(depth_m * (65535.0 / max_depth)).clamp(0, 65535)
    depth = units.to(torch.float32) * (max_depth / 65535.0)
    return {"waveform": wave, "depth": depth[..., None]}


def make_pairs(n: int, seed: int, cfg: Dict, device, chunk: int = 1024
               ) -> Dict[str, torch.Tensor]:
    """n (waveform [n, 2, L], depth [n, S, S, 1], and the family's extra
    inputs) float32 pairs on `device`, the same for the same seed (drawn
    `chunk` rows at a time)."""
    gen = _generator(seed, device)
    extra_gen = _generator(int(seed) + EXTRA_STREAM, device)
    extra_inputs = family(cfg["family"]).extra_inputs
    parts = []
    for s in range(0, n, chunk):
        part = _pairs_chunk(min(chunk, n - s), gen, int(cfg["images_size"]),
                            float(cfg["max_depth"]), int(cfg["sample_rate"]), device)
        part.update(extra_inputs(part["depth"], extra_gen, cfg))
        parts.append(part)
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every entry of the net's state dict, float32 (BatchNorm's counter
    int64), from the seed."""
    specs = param_specs(cfg)
    gen = _generator(int(seed) + WEIGHT_STREAM, device)
    sizes = [torch.Size(s).numel() for _, s, rule, _ in specs if rule == "normal"]
    draw = torch.randn(sum(sizes), generator=gen, device=device)
    gammas = [s for s in specs if s[2] == "gamma"]
    g = torch.rand(len(gammas), generator=gen, device=device) * 0.75 + 0.25
    sign = torch.randint(0, 2, (len(gammas),), generator=gen, device=device) * 2 - 1
    g = g * sign
    out, off, gi = {}, 0, 0
    for name, shape, rule, std in specs:
        if rule == "normal":
            n = torch.Size(shape).numel()
            out[name] = draw[off:off + n].view(shape) * std
            off += n
        elif rule == "gamma":
            out[name] = g[gi:gi + 1].view(shape)
            gi += 1
        elif rule == "count":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
        elif rule == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out
