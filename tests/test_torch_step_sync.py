"""A cached train step issues no host synchronisation.

The device cache uploads each step's index vector from pinned memory with
`non_blocking=True` (`data/device_cache.py`), and the binaural losses make
their Sobel taps once per (device, dtype) (`losses/binaural.py`), so the
host can queue the next step while the card still runs this one.

On the CPU (torch only, a few seconds):
  * the one-rank gather returns `arrays[idx]`: the same rows, order and
    dtypes, and uploads nothing (its counter reads 0 and 0);
  * the Sobel taps are made once per (device, dtype), and
    `binaural_attention_loss` gives the value and gradient of its former
    code (the taps built on every call) bit for bit;
  * the card test's steps, run on the CPU.
The sharded gather is held to `arrays[idx]` in `tests/test_torch_parallel.py`.
Marked `card` (skipped without one; on the card: `python3 -m pytest -m card
tests/test_torch_step_sync.py`): the UNet, binaural (standard and
edge-aware losses) and AdaBins families at reduced widths train three
steps from a device cache under `torch.cuda.set_sync_debug_mode("error")`,
which raises at any synchronising call, and the cache counts no blocking
upload.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from audiodepth_tpu_torch.configs import load_config
from audiodepth_tpu_torch.data.device_cache import DeviceDatasetCache
from audiodepth_tpu_torch.data.synthetic import SyntheticEchoDataset
from audiodepth_tpu_torch.losses import binaural
from audiodepth_tpu_torch.models import init_weights, make_task
from audiodepth_tpu_torch.train.engine import Engine

BATCH = 4
WARMUP_STEPS = 2
CHECKED_STEPS = 3

# family, config overrides: reduced widths, the port's default bf16 mode
CASES = {
    "unet": ("unet_baseline", {"model.generator": "unet_128", "model.ngf": 8,
                               "dataset.images_size": 128}),
    "binaural_standard": ("binaural_attention", {"model.base_channels": 16,
                                                 "dataset.images_size": 64}),
    "binaural_edge_aware": ("binaural_attention", {"model.base_channels": 16,
                                                   "dataset.images_size": 64,
                                                   "model.extra.loss_type": "edge_aware"}),
    "adabins": ("adabins_distillation", {"model.base_channels": 16, "model.n_bins": 16,
                                         "dataset.images_size": 64}),
}


def _dataset(family: str, overrides: dict, rows: int) -> SyntheticEchoDataset:
    cfg = load_config("synthetic", "train", model_name=family, overrides=overrides)
    return SyntheticEchoDataset(cfg, num_samples=rows, seed=3,
                                with_image=family == "adabins_distillation")


# ---- the one-rank gather -------------------------------------------------------------------


def _bits(v: torch.Tensor) -> np.ndarray:
    # uint16 has few CPU kernels in torch: compare its bits
    return (v.view(torch.int16) if v.dtype == torch.uint16 else v).numpy()


@pytest.mark.parametrize("idx", [[5, 0, 3], [6, 6, 1, 2, 0], list(range(7))[::-1], [4]])
def test_one_rank_gather_is_the_rows_at_idx(idx):
    cache = DeviceDatasetCache(_dataset("unet_baseline", {"dataset.images_size": 32}, 7),
                               30.0, "cpu")
    got = cache.batch(idx)
    assert got.keys() == cache.arrays.keys()
    for k, v in cache.arrays.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(v)[idx], err_msg=k)
    assert cache.uploads.read() == {"queued": 0, "blocking": 0}


# ---- the Sobel taps ------------------------------------------------------------------------


def _sobel_built_each_call(x):
    """`losses/binaural.py::_sobel` as it was: the taps built on every call."""
    kx = torch.tensor(binaural._SOBEL, dtype=torch.float32, device=x.device)
    weight = torch.stack([kx, kx.t()])[:, None]
    g = F.conv2d(x.to(torch.float32).permute(0, 3, 1, 2), weight, padding=1)
    g = g.permute(0, 2, 3, 1)
    return g[..., 0:1], g[..., 1:2]


def test_sobel_taps_are_made_once_per_device_and_dtype():
    binaural._sobel_taps.cache_clear()
    cpu = torch.device("cpu")
    a = binaural._sobel_taps(cpu, torch.float32)
    assert binaural._sobel_taps(cpu, torch.float32) is a
    b = binaural._sobel_taps(cpu, torch.float64)
    assert b is not a and b.dtype == torch.float64 and torch.equal(b.float(), a)
    assert a.shape == (2, 1, 3, 3) and torch.equal(a[1, 0], a[0, 0].t())
    pred = torch.rand(2, 8, 8, 1)
    for _ in range(3):
        binaural.binaural_attention_loss(pred, pred.flip(1))
    info = binaural._sobel_taps.cache_info()
    assert (info.misses, info.currsize) == (2, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lam", [(1.0, 0.2, 0.1), (1.0, 0.05, 0.0)])
def test_binaural_attention_loss_unchanged_bit_for_bit(dtype, lam, monkeypatch):
    gen = torch.Generator().manual_seed(7)
    gt = torch.rand(3, 16, 16, 1, generator=gen, dtype=dtype) * 30.0
    gt[gt < 4.0] = 0.0
    pred0 = torch.rand(3, 16, 16, 1, generator=gen, dtype=dtype) * 30.0

    def run():
        pred = pred0.clone().requires_grad_(True)
        total, parts = binaural.binaural_attention_loss(pred, gt, *lam)
        total.backward()
        return total.detach(), {k: v.detach() for k, v in parts.items()}, pred.grad

    got = run()
    monkeypatch.setattr(binaural, "_sobel", _sobel_built_each_call)
    want = run()
    assert torch.equal(got[0], want[0])
    assert got[1].keys() == want[1].keys() and all(torch.equal(got[1][k], want[1][k])
                                                   for k in want[1])
    assert torch.equal(got[2], want[2])


# ---- the cached train step -----------------------------------------------------------------


def _cached_steps(case: str, device: torch.device, guard) -> dict:
    """Build `case`'s task on `device` with a small device cache, take
    WARMUP_STEPS steps, then CHECKED_STEPS steps inside `guard()`; the
    cache's uploads over the checked steps and their losses."""
    family, overrides = CASES[case]
    overrides = {**overrides, "mode.batch_size": BATCH}
    cfg = load_config("synthetic", "train", model_name=family, overrides=overrides)
    task = make_task(cfg, device=device)
    init_weights(task.model, torch.Generator().manual_seed(0))
    rows = BATCH * (WARMUP_STEPS + CHECKED_STEPS)
    eng = Engine(cfg, task, steps_per_epoch=rows // BATCH)
    state = eng.init_state()
    cache = DeviceDatasetCache(_dataset(family, overrides, rows), eng._depth_units, device)
    feed = cache.batches(BATCH, shuffle=True, seed=5)
    for _ in range(WARMUP_STEPS):
        state, _ = eng.train_step(state, next(feed))
    cache.uploads.reset()
    losses = []
    with guard():
        for _ in range(CHECKED_STEPS):
            state, metrics = eng.train_step(state, next(feed))
            losses.append(metrics["loss"])
    return {"uploads": cache.uploads.read(), "losses": torch.stack(losses).float().cpu(),
            "step": state.step}


@pytest.mark.parametrize("case", list(CASES))
def test_cached_steps_on_the_cpu(case):
    out = _cached_steps(case, torch.device("cpu"), contextlib.nullcontext)
    assert out["uploads"] == {"queued": 0, "blocking": 0}  # nothing goes up to a CPU
    assert out["step"] == WARMUP_STEPS + CHECKED_STEPS
    assert torch.isfinite(out["losses"]).all()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a host synchronisation exists only against a card")
    return torch.device("cuda")


class _NoSync:
    """`torch.cuda.set_sync_debug_mode("error")` over the block, the former
    mode restored after it."""

    def __enter__(self):
        self.prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(self.prev)
        return False


@pytest.mark.card
@pytest.mark.parametrize("case", list(CASES))
def test_cached_steps_never_wait_on_the_card(card, case):
    mode = torch.cuda.get_sync_debug_mode()
    out = _cached_steps(case, card, _NoSync)
    assert torch.cuda.get_sync_debug_mode() == mode
    assert out["uploads"] == {"queued": CHECKED_STEPS, "blocking": 0}
    assert out["step"] == WARMUP_STEPS + CHECKED_STEPS
    assert torch.isfinite(out["losses"]).all()
