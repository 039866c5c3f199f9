"""The port's coarse-depth hybrid against the benchmark's plain reference of
it (`reference/families/coarse_depth.py`), on the CPU, at base 8, 16 bins,
32², batch 4, from the benchmark's seeded weights (`harness.inputs.make_weights`)
and pairs (`make_pairs`: echo, depth and bins):

  * the state dicts: the same names and shapes, each loading the other's
    strictly, the bin centres written by each side whatever the weights hold;
  * the forward's logits, coarse, offset and final in float32, train and eval;
  * the loss's three terms and every leaf's first clipped gradient in float64;
  * two AdamW steps through the benchmark's own path (`harness.train.TrainRun`
    against `reference.reference_steps`, read by `harness.check`);
  * the bins of `extra_inputs` equal to the port's `compute_bin_edges` +
    `depth_to_bins_np`, and carried bit for bit by the device cache as int32;
  * the FLOP count pinned at base 64, and equal to torch's FLOP counter on the
    reference net at small width;
  * the whole-run tests of every train cell (`test_bench_faults`) on this
    cell: `correct` true for a sound run, false with AdamW's update skipped or
    half of the batch left out; on the card, the float8 control of
    `test_bench_control` fails the cell's limits (`card`).

Each tolerance says why it is what it is; a bfloat16 copy of the reference
fails the forward's.
"""

from __future__ import annotations

import json
from statistics import median

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from flops import model_flops, train_flops_per_pair
from harness.check import train_numbers
from harness.inputs import make_pairs, make_weights
from harness.port import make_port_task, port_config
from harness.spec import BENCH_DIR, load_cell
from harness.train import TrainRun, _Pairs
from reference import Precision, clipped_grads, family, mel_frontend
from reference.ranks import RowShards
from reference.train import reference_steps

import test_bench_control as control
import test_bench_faults as faults

CELL = "coarse-hybrid-train-b64-cached"
SEED = 2 ** 31 + 24_680
BATCH = 4
REF = family("coarse_depth")
OUTPUTS = ("logits", "coarse", "offset", "final")

# Tolerances, float32 program against float32 reference (two independent
# implementations whose sums and convolutions round in other orders):
# - a forward's outputs, relative to the largest magnitude: float32 keeps
#   about 7 digits; measured ≤ 1.5e-6 in eval mode and ≤ 8.9e-6 in train
#   mode over 6 seeds, where BatchNorm's statistics over 4 rows of 2 × 2 at
#   the bottom level amplify the rounding; a bfloat16 reference reads
#   6.4e-3 to 1.6e-2.
FORWARD_TOL = 1e-3
# - a loss term in float64 on both sides, relative: float64 rounding
#   (measured ≤ 2.8e-15 over 6 seeds).
TERM_TOL = 1e-12
# - a leaf's first clipped gradient in float64 on both sides, the gap's norm
#   over the larger of its norm and the median leaf's (`harness.check`'s
#   measure): float64 rounding, except that the reference's clip rounds the
#   global norm to float32 (measured ≤ 6.5e-8 over 6 seeds).
GRAD_TOL = 1e-6
# - the same measure in float32 through the benchmark's path (the gradient
#   norms AdamW received): measured 9.7e-5 to 1.04e-2 over 6 seeds, the
#   worst leaf a kernel or bias next to a BatchNorm of the first levels,
#   whose statistics over 4 rows pass float32's rounding on unshrunk.
GRAD_NORM_TOL = 5e-2
# - after two AdamW steps (`harness.check`'s measure): the first steps of
#   AdamW move an element by about ±lr whatever its gradient's size, so an
#   element whose gradient is within rounding of zero flips by up to 2·lr;
#   in a bias or BatchNorm leaf of 8-64 elements that reads 0.011-0.077
#   over 6 seeds.
CHANGE_TOL = 0.2
# - the steps' losses and the BatchNorm statistics (measured ≤ 6.3e-5 and
#   ≤ 2e-4 over 6 seeds).
STEP_TOL = 1e-3


def tiny_config(compute_dtype="float32"):
    cell = load_cell(CELL)
    cfg = dict(cell.config, base_channels=8, n_bins=16, images_size=32, batch_size=BATCH,
               compute_dtype=compute_dtype)
    return cell, cfg


def rel(a, b) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.fixture(scope="module")
def tiny():
    """The tiny configuration, its weights, 8 pairs, and the first four's
    mel image, NCHW."""
    torch.set_num_threads(1)
    _, cfg = tiny_config()
    weights = make_weights(cfg, SEED, "cpu")
    pairs = make_pairs(2 * BATCH, SEED, cfg, "cpu")
    x = mel_frontend(pairs["waveform"][:BATCH], 32, float(cfg["max_depth"]),
                     int(cfg["sample_rate"])).permute(0, 3, 1, 2).contiguous()
    return {"cfg": cfg, "pcfg": port_config(cfg), "weights": weights, "pairs": pairs, "x": x}


def _fresh(tiny, cfg=None):
    """A task and a reference net on the fixture's weights (fresh for each
    test: a train-mode forward folds BatchNorm's statistics)."""
    cfg = cfg or tiny["cfg"]
    _, task = make_port_task(cfg, tiny["weights"], "cpu")
    net = REF.build_net(cfg)
    net.load_state_dict(tiny["weights"], strict=True)
    return task, net


def test_state_dicts_load_each_other_strictly(tiny):
    task, net = _fresh(tiny)
    port, ref = task.model.state_dict(), net.state_dict()
    assert list(port) == list(ref)
    assert all(port[k].shape == ref[k].shape for k in port)
    for name in ("inc.conv.0.weight", "down4.pool_conv.1.conv.4.running_var",
                 "coarse_up1.conv.conv.0.weight", "coarse_head.bias",
                 "offset_up4.conv.conv.3.weight", "offset_fusion.0.weight",
                 "offset_fusion.4.bias", "offset_head.weight", "bin_centers"):
        assert name in port, name
    assert tuple(port["offset_fusion.0.weight"].shape) == (8, 9, 3, 3)   # c + 1 in
    # the drawn weights hold zeros for the centres; both sides write their own
    assert float(tiny["weights"]["bin_centers"].abs().max()) == 0.0
    assert torch.equal(port["bin_centers"], ref["bin_centers"])
    assert float(ref["bin_centers"].min()) > 0.1 and float(ref["bin_centers"].max()) < 30.0
    task.model.load_state_dict(ref, strict=True)
    net.load_state_dict(port, strict=True)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_forward_matches_the_reference(tiny, train):
    task, net = _fresh(tiny)
    task.model.train(train)
    net.train(train)
    with torch.no_grad():
        port = dict(zip(OUTPUTS, task.model(tiny["x"])))
        ref = net.outputs(tiny["x"])
    for key in OUTPUTS:
        assert port[key].shape == ref[key].shape, key
        assert rel(port[key], ref[key]) <= FORWARD_TOL, key


def test_a_bfloat16_reference_fails_the_forward_tolerance(tiny):
    task, _ = _fresh(tiny)
    task.model.eval()
    low = REF.build_net(tiny["cfg"]).to(torch.bfloat16).eval()
    low.load_state_dict(tiny["weights"], strict=True)
    with torch.no_grad():
        port = task.model(tiny["x"])[3]
        got = low.outputs(tiny["x"].to(torch.bfloat16))["final"].float()
    assert rel(got, port) > FORWARD_TOL


@pytest.fixture
def f64_ce(monkeypatch):
    """The port computes the classification terms in float32 whatever the
    compute dtype (`losses/coarse.py::CE_DTYPE`, the JAX package's cast);
    a float64 comparison lifts that cast."""
    import audiodepth_tpu_torch.losses.coarse as coarse

    monkeypatch.setattr(coarse, "CE_DTYPE", torch.float64)


def _f64_losses(tiny):
    """(port loss, its parts, reference loss, its terms, the port model, the
    reference net), float64, from the same mel image, depth and bins."""
    from audiodepth_tpu_torch.losses.coarse import coarse_offset_loss

    cfg = dict(tiny["cfg"], compute_dtype="float64")
    task, net = _fresh(tiny, cfg)
    model, net = task.model.double().train(), net.double().train()
    x = tiny["x"].double()
    gt = tiny["pairs"]["depth"][:BATCH].double()
    bins = tiny["pairs"]["bins"][:BATCH]
    out = [t.permute(0, 2, 3, 1) for t in model(x)]
    loss, parts = coarse_offset_loss(*out, gt, bins, ce_weight=1.0, regression_weight=0.5,
                                     offset_reg_weight=0.01, label_smoothing=0.1)
    terms = REF.loss_terms(net.outputs(x), gt.permute(0, 3, 1, 2), bins, RowShards())
    ref_loss = terms["ce"] + 0.5 * terms["regression"] + 0.01 * terms["offset_reg"]
    return loss, parts, ref_loss, terms, model, net


@pytest.mark.parametrize("term", ["ce", "regression", "offset_reg", "total"])
def test_loss_terms_match_in_float64(tiny, f64_ce, term):
    loss, parts, ref_loss, terms, _, _ = _f64_losses(tiny)
    got = float(parts[term].detach())
    want = float((ref_loss if term == "total" else terms[term]).detach())
    assert want != 0.0
    assert abs(got - want) <= TERM_TOL * abs(want)
    if term == "total":
        assert float(loss.detach()) == got


def test_first_clipped_gradient_of_every_leaf_in_float64(tiny, f64_ce):
    """Both sides in float64 from the same mel image, depth and bins: the
    net and the loss alone, so the two implementations' own rounding is all
    that can part them. The coarse depth enters the offset branch detached
    on both sides, so the classification branch gets no gradient from the
    offset's terms."""
    from audiodepth_tpu_torch.train.optim import clip_by_global_norm_, global_norm

    loss, _, ref_loss, _, model, net = _f64_losses(tiny)
    names = [n for n, _ in model.named_parameters()]
    port = list(torch.autograd.grad(loss, [model.get_parameter(n) for n in names]))
    clip_by_global_norm_(port, global_norm(port), 1.0)
    ref = clipped_grads(list(torch.autograd.grad(ref_loss, [net.get_parameter(n)
                                                            for n in names])), 1.0)
    assert float(global_norm(port)) == pytest.approx(1.0, rel=1e-12)   # the clip acted
    floor = median(float(g.norm()) for g in ref)
    gaps = {n: float((p - g).norm()) / max(float(g.norm()), floor)
            for n, p, g in zip(names, port, ref)}
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= GRAD_TOL, worst
    assert all(float(g.norm()) > 0 for g in ref)   # every leaf is trained


@pytest.fixture(scope="module")
def two_steps():
    """Two checked steps through the benchmark's path at the tiny size, the
    float32 reference after them, and what `harness.check` reads."""
    torch.set_num_threads(1)
    cell, cfg = tiny_config()
    cell.config = cfg
    cell.traffic = dict(cell.traffic, batch_size=BATCH, cache_rows=2 * BATCH, checked_steps=2,
                        warmup_steps=0)
    run = TrainRun(cell, SEED, "cpu")
    readings, weights = run.readings, run.weights
    batches = run.reference_batches("cpu")
    run.free()
    ref = reference_steps(cfg, weights, batches, Precision(), "cpu")
    numbers, where = train_numbers(readings, ref)
    return {"readings": readings, "ref": ref, "numbers": numbers, "where": where}


@pytest.mark.parametrize("number,tol", [("loss_gap", STEP_TOL), ("grad_gap", GRAD_NORM_TOL),
                                        ("change_gap", CHANGE_TOL), ("bn_mean_gap", STEP_TOL),
                                        ("bn_var_gap", STEP_TOL)])
def test_two_adamw_steps_match_the_reference(two_steps, number, tol):
    assert two_steps["numbers"][number] <= tol, two_steps["where"].get(number)
    losses = zip(two_steps["readings"]["loss"], two_steps["ref"]["loss"])
    assert all(abs(p - r) <= STEP_TOL * abs(r) for p, r in losses)
    # the 28 BatchNorms: 10 in the encoder, 8 in each decoder, 2 in the fusion
    assert len(two_steps["ref"]["bn"]) == 28


def test_bins_equal_the_port_bucketisation_and_ride_the_cache(tiny):
    from audiodepth_tpu_torch.data.bins import compute_bin_edges, depth_to_bins_np
    from audiodepth_tpu_torch.data.codec import decode_batch, depth_storage_units
    from audiodepth_tpu_torch.data.device_cache import DeviceDatasetCache

    pairs = tiny["pairs"]
    bins = pairs["bins"]
    assert bins.dtype == torch.int32 and bins.shape == (2 * BATCH, 32, 32)
    edges, centres = compute_bin_edges(16, depth_min=0.1, depth_max=30.0, mode="sid",
                                       sid_alpha=0.6)
    want = depth_to_bins_np(pairs["depth"][..., 0].numpy(), edges)
    assert np.array_equal(bins.numpy(), want)
    assert np.array_equal(REF.sid_edges(tiny["cfg"]), edges)
    assert np.array_equal(REF.sid_centres(tiny["cfg"]), centres)
    assert int(bins.min()) == 0 and int(bins.max()) > 8   # the invalid pixels' bin and deep ones
    host = {k: v.numpy() for k, v in pairs.items()}
    units = depth_storage_units(tiny["pcfg"])
    cache = DeviceDatasetCache(_Pairs(host), units, "cpu")
    assert cache.arrays["bins"].dtype == torch.int32
    rows = np.array([5, 0, 7, 2])
    got = decode_batch(cache.batch(rows), units)
    assert torch.equal(got["bins"], bins[torch.from_numpy(rows)])
    assert torch.equal(got["depth"], pairs["depth"][torch.from_numpy(rows)])


def test_flops_pinned_at_base_64():
    with open(BENCH_DIR / "configs" / "coarse_hybrid.json") as f:
        cfg = json.load(f)
    forward = model_flops(cfg)
    assert forward == 139_011_817_472
    assert train_flops_per_pair(cfg) == 3 * forward
    net = REF.build_net(cfg)
    assert sum(p.numel() for p in net.parameters()) == 25_181_825


def test_flops_equal_the_counter_on_the_reference(tiny):
    net = REF.build_net(tiny["cfg"]).eval()
    x = torch.rand(1, 32, 32, 2)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        net(x)
    assert counter.get_total_flops() == model_flops(tiny["cfg"])


# ---- whole runs of the cell and its control -------------------------------------------
# The existing tests of every train cell, run on this one: whole runs on the CPU at base 8
# (`test_bench_faults`) and the float8 control on the card (`test_bench_control`).


def test_whole_run_sound():
    faults.test_sound_run_is_correct(CELL)


def test_whole_run_state_left_unchanged(monkeypatch):
    faults.test_state_left_unchanged(CELL, monkeypatch)


def test_whole_run_half_the_batch_left_out(monkeypatch):
    faults.test_half_the_batch_left_out(CELL, monkeypatch)


@pytest.mark.card
def test_float8_control_fails_the_limits(card):
    """python -m pytest benchmark/tests/test_bench_coarse.py -m card"""
    control.test_training_control_fails(CELL, card)
