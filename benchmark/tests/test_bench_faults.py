"""Whole runs on the CPU at a tiny width, past the look for a card, with the
timed path broken underneath: `correct` has to come out false for every
fault a cell can have, and true for the same run unbroken. The program
runs in float32 here (the cells' bfloat16 is for the card), so a sound run
reads far inside each cell's limits.

Faults: a step that returns its state unchanged (AdamW's update skipped);
half of the batch left out, the mean taken over the rest; an answer
altered where the runner produces it. No cell of the benchmark runs on
several cards yet; the harness's data-parallel path (ranks spawned, the
reference row-sharded over them) is driven on two gloo ranks, and the
exchange between ranks left out shows in the first gradient's median leaf,
which such a cell compares (`DP_GRAD_LIMIT`).
"""

import pytest

from harness.cell import run_cell
from harness.spec import load_cell

SEED = 2 ** 31 + 4242
# the first gradient's median leaf: a data-parallel cell's number for the
# exchange between ranks (sound bf16 runs read 0.004-0.029 at batch 64 on
# one card, the exchange left out 0.42-0.54 here)
DP_GRAD_LIMIT = 0.12


def _train_cell(name, **traffic):
    cell = load_cell(name)
    if cell.config["family"] == "unet_baseline":
        cell.config.update(generator="unet_128", ngf=8, images_size=128)
    else:
        cell.config.update(base_channels=8, images_size=32)
    cell.config["compute_dtype"] = "float32"
    cell.traffic.update(batch_size=8, cache_rows=32, warmup_steps=1, **traffic)
    return cell


def _serve_cell():
    cell = load_cell("binaural-serve-poisson")
    cell.config.update(base_channels=8, images_size=32, compute_dtype="float32")
    cell.traffic.update(rate_rps=40.0, warmup_s=0.3, checked=8)
    return cell


def _correct(cell, seconds=0.5, plant=None):
    out = run_cell(cell, SEED, seconds, False, "cpu", plant=plant)
    return out["result"]["correct"], out


TRAIN = ["unet256-train-b256-cached", "binaural-train-b64-cached"]


@pytest.mark.parametrize("name", TRAIN)
def test_sound_run_is_correct(name):
    ok, out = _correct(_train_cell(name))
    assert ok, out["checks"]
    assert out["result"]["failed"] == 0 and out["result"]["attempted"] >= 1


@pytest.mark.parametrize("name", TRAIN)
def test_state_left_unchanged(name, monkeypatch):
    import torch

    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    ok, out = _correct(_train_cell(name))
    assert not ok
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", TRAIN)
def test_half_the_batch_left_out(name, monkeypatch):
    import audiodepth_tpu_torch.train.engine as engine

    decode = engine.decode_batch

    def half(batch, units):
        out = decode(batch, units)
        return {k: v[: v.shape[0] // 2] for k, v in out.items()}

    monkeypatch.setattr(engine, "decode_batch", half)
    ok, out = _correct(_train_cell(name))
    assert not ok, out["checks"]


def drop_exchange():
    """Every rank trains on its own gradients (the all-reduce skipped)."""
    import audiodepth_tpu_torch.train.engine as engine

    engine.all_reduce_grads_ = lambda grads, group: None


def test_exchange_between_ranks_left_out(monkeypatch):
    import audiodepth_tpu_torch.train.engine as engine

    cell = _train_cell("binaural-train-b64-cached", ranks=2)
    cell.limits["numbers"]["grad_median_gap"] = {"limit": DP_GRAD_LIMIT}
    ok, out = _correct(cell)
    assert ok, out["checks"]
    monkeypatch.setattr(engine, "all_reduce_grads_", lambda grads, group: None)
    ok, out = _correct(cell, plant=drop_exchange)
    assert not ok, out["checks"]


def test_serving_sound_and_answer_altered(monkeypatch):
    from audiodepth_tpu_torch.cli.serve import InferenceRunner

    ok, out = _correct(_serve_cell(), seconds=1.0)
    assert ok, out["checks"]
    forward = InferenceRunner._forward

    def altered(self, waves):
        out = forward(self, waves)
        out[:, :8, :8] = 0.0   # a block of the answer lost
        return out

    monkeypatch.setattr(InferenceRunner, "_forward", altered)
    ok, out = _correct(_serve_cell(), seconds=1.0)
    assert not ok, out["checks"]
