"""The port's adabins_distillation family against the benchmark's plain
reference of it (`benchmark/reference/families/adabins_distillation.py`),
on the CPU, at base 4, 8 bins, 32², batch 4, float32 on both sides, from
the benchmark's seeded weights (`harness.inputs.make_weights`) and pairs
(`make_pairs`: echo, depth and camera frame):

  * the eval forward of both branches (the same mel image and frame in);
  * the train forward, the keep masks drawn by the reference's copy of the
    port's stream (`keep_masks`) equal to the task's own draws;
  * the loss's five terms (six numbers: the bin term is a KL and a MSE);
  * the first clipped gradient of every trained leaf, in float64 from the
    same net inputs;
  * two AdamW steps through the benchmark's own path (`harness.train.TrainRun`
    against `reference.reference_steps`, read by `harness.check`), the
    teacher's parameters bit-unchanged while its BatchNorm statistics moved
    and agree;
  * the FLOP count pinned at base 64, and equal to torch's FLOP counter on
    the reference student at small width;
  * the camera frame on the k/255 grid, and carried bit for bit by the cache.

Each tolerance says why it is what it is; a bfloat16 copy of the reference
fails the forward's.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from statistics import median

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "benchmark") not in sys.path:
    sys.path.append(str(ROOT / "benchmark"))   # after the repository's own packages

from flops import model_flops, train_flops_per_pair  # noqa: E402
from harness.check import train_numbers  # noqa: E402
from harness.inputs import make_pairs, make_weights  # noqa: E402
from harness.port import make_port_task, port_config  # noqa: E402
from harness.spec import load_cell  # noqa: E402
from harness.train import TrainRun, _Pairs  # noqa: E402
from reference import Precision, clipped_grads, family, mel_frontend  # noqa: E402
from reference.ranks import RowShards  # noqa: E402
from reference.train import reference_steps  # noqa: E402

from audiodepth_tpu_torch.data.codec import decode_batch, depth_storage_units  # noqa: E402
from audiodepth_tpu_torch.data.device_cache import DeviceDatasetCache  # noqa: E402
from audiodepth_tpu_torch.losses.distillation import distillation_loss  # noqa: E402
from audiodepth_tpu_torch.train.optim import clip_by_global_norm_, global_norm  # noqa: E402

CELL = "adabins-distill-train-b64-cached"
SEED = 2 ** 31 + 12_345
BATCH = 4
REF = family("adabins_distillation")

# Tolerances, float32 program against float32 reference (two independent
# implementations: their sums and convolutions round in other orders):
# - a forward's outputs, relative to the largest magnitude: float32 keeps
#   about 7 digits; measured ≤ 2.1e-6 in eval mode and ≤ 8.1e-5 in train
#   mode, where BatchNorm's statistics over 4 rows of 2 × 2 at the bottom
#   level amplify the rounding; a bfloat16 reference reads 6.3e-3.
FORWARD_TOL = 1e-3
# - a loss term, relative: measured ≤ 6.8e-6.
TERM_TOL = 1e-4
# - a leaf's first clipped gradient in float64 on both sides, the gap's norm
#   over the larger of its norm and the median leaf's (`harness.check`'s
#   measure): float64 rounding (measured ≤ 2e-13), except that the
#   reference's clip rounds the global norm to float32, 6e-8 at most.
GRAD_TOL = 1e-6
# - the same measure in float32 through the benchmark's path (the gradient
#   norms AdamW received): measured ≤ 3.5e-4 over 6 seeds.
GRAD_NORM_TOL = 2e-3
# - after two AdamW steps (`harness.check`'s measure): the first steps of
#   AdamW move an element by about ±lr whatever its gradient's size, so an
#   element whose gradient is within rounding of zero flips by up to 2·lr;
#   in a BatchNorm leaf of 16-32 elements that reads 0.0002-0.027 over 6
#   seeds (the bf16 program reads 0.16).
CHANGE_TOL = 0.1
# - the step's loss and the BatchNorm statistics (measured ≤ 8e-5).
STEP_TOL = 1e-3


def tiny_config(compute_dtype="float32"):
    cell = load_cell(CELL)
    cfg = dict(cell.config, base_channels=4, n_bins=8, images_size=32, batch_size=BATCH,
               compute_dtype=compute_dtype)
    return cell, cfg


def rel(a, b) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.fixture(scope="module")
def tiny():
    """The tiny configuration, its weights, 8 pairs, and the first four's
    mel image and frame, NCHW."""
    torch.set_num_threads(1)
    _, cfg = tiny_config()
    weights = make_weights(cfg, SEED, "cpu")
    pairs = make_pairs(2 * BATCH, SEED, cfg, "cpu")
    pcfg = port_config(cfg)
    x = mel_frontend(pairs["waveform"][:BATCH], 32, float(cfg["max_depth"]),
                     int(cfg["sample_rate"])).permute(0, 3, 1, 2).contiguous()
    frame = pairs["image"][:BATCH].permute(0, 3, 1, 2).contiguous()
    return {"cfg": cfg, "pcfg": pcfg, "weights": weights, "pairs": pairs,
            "inputs": {"audio": x, "rgb": frame}}


def _fresh(tiny):
    """A task and a reference net on the fixture's weights (fresh for each
    test: a train-mode forward folds BatchNorm's statistics)."""
    _, task = make_port_task(tiny["cfg"], tiny["weights"], "cpu")
    net = REF.build_net(tiny["cfg"])
    net.load_state_dict(tiny["weights"], strict=True)
    return task, net


def _port_out(out):
    return {"final": out["final_depth"], "logits": out["bin_logits"],
            "centres": out["bin_centers"], "residual": out["residual"]}


@pytest.mark.parametrize("branch", ["audio", "rgb"])
def test_eval_forward_matches_the_reference(tiny, branch):
    task, net = _fresh(tiny)
    task.model.eval()
    net.eval()
    x = tiny["inputs"][branch]
    with torch.no_grad():
        port = _port_out(task.model._branch(branch, x, None))
        ref = net.branch(branch, x)
    for key in ("final", "logits", "centres", "residual"):
        assert rel(port[key], ref[key]) <= FORWARD_TOL, key


def _train_forward(tiny):
    """Both branches in train mode from one step's masks: (port, reference,
    port masks, reference masks)."""
    task, net = _fresh(tiny)
    task.model.train()
    net.train()
    task.begin_step(0)
    model = task.model
    port_keep = [getattr(model, f"{b}_bin_predictor").draw_keep(BATCH, task.generator, "cpu")
                 for b in ("audio", "rgb")]
    ref_keep = REF.keep_masks(net, BATCH, "cpu", RowShards())
    x = tiny["inputs"]
    with torch.no_grad():
        port = {b: model._branch(b, x[b], None, k) for b, k in zip(("audio", "rgb"), port_keep)}
        ref = {b: net.branch(b, x[b], k) for b, k in zip(("audio", "rgb"), ref_keep)}
    return port, ref, port_keep, ref_keep


@pytest.mark.parametrize("branch", ["audio", "rgb"])
def test_train_forward_with_the_reference_mask_stream(tiny, branch):
    port, ref, port_keep, ref_keep = _train_forward(tiny)
    i = ("audio", "rgb").index(branch)
    assert torch.equal(port_keep[i], ref_keep[i])
    assert 0 < int(ref_keep[i].sum()) < ref_keep[i].numel()   # dropout did drop
    assert not torch.equal(ref_keep[0], ref_keep[1])          # two draws, not one
    got = _port_out(port[branch])
    for key in ("final", "logits", "centres", "residual"):
        assert rel(got[key], ref[branch][key]) <= FORWARD_TOL, key


@pytest.mark.parametrize("term", ["task", "response", "feature", "bin", "bin_centers",
                                  "sparse"])
def test_loss_terms_match_the_reference(tiny, term):
    port, ref, _, _ = _train_forward(tiny)
    gt = tiny["pairs"]["depth"][:BATCH].permute(0, 3, 1, 2)
    _, parts = distillation_loss(port, gt, gt > 0, 1.0, 0.5, 0.3, 0.2, lambda_sparse=0.1,
                                 temperature=4.0)
    terms = REF.loss_terms(ref["audio"], ref["rgb"], gt, tiny["cfg"], RowShards())
    want = terms["bin_centres" if term == "bin_centers" else term]
    assert float(want) != 0.0
    assert abs(float(parts[term]) - float(want)) <= TERM_TOL * abs(float(want))


def test_a_bfloat16_reference_fails_the_forward_tolerance(tiny):
    task, _ = _fresh(tiny)
    task.model.eval()
    low = REF.build_net(tiny["cfg"]).to(torch.bfloat16).eval()
    low.load_state_dict(tiny["weights"], strict=True)
    x = tiny["inputs"]["audio"]
    with torch.no_grad():
        port = task.model._branch("audio", x, None)["final_depth"]
        got = low.branch("audio", x.to(torch.bfloat16))["final"].float()
    assert rel(got, port) > FORWARD_TOL


def test_first_clipped_gradient_of_every_trained_leaf(tiny):
    """Both sides in float64 from the same mel image, frame, depth and
    masks: the net and the loss alone, so the two implementations' own
    rounding is all that can part them."""
    cfg = dict(tiny["cfg"], compute_dtype="float64")
    _, task = make_port_task(cfg, tiny["weights"], "cpu")
    model = task.model.double().train()
    net = REF.build_net(cfg).double().train()
    net.load_state_dict(tiny["weights"], strict=True)
    x = {b: v.double() for b, v in tiny["inputs"].items()}
    gt = tiny["pairs"]["depth"][:BATCH].permute(0, 3, 1, 2).double()
    task.begin_step(0)
    keep = [getattr(model, f"{b}_bin_predictor").draw_keep(BATCH, task.generator, "cpu")
            for b in ("audio", "rgb")]
    audio = model._branch("audio", x["audio"], None, keep[0])
    with torch.no_grad():
        rgb = model._branch("rgb", x["rgb"], None, keep[1])
    loss, _ = distillation_loss({"audio": audio, "rgb": rgb}, gt, gt > 0, 1.0, 0.5, 0.3, 0.2,
                                lambda_sparse=0.1, temperature=4.0)
    trained = [n for n, _ in model.named_parameters() if REF.trainable(n)]
    port = list(torch.autograd.grad(loss, [model.get_parameter(n) for n in trained]))
    clip_by_global_norm_(port, global_norm(port), float(cfg["grad_clip_norm"]))
    a = net.branch("audio", x["audio"], keep[0])
    with torch.no_grad():
        r = net.branch("rgb", x["rgb"], keep[1])
    t = REF.loss_terms(a, r, gt, cfg, RowShards())
    ref_loss = (t["task"] + 0.5 * t["response"] + 0.3 * t["feature"]
                + 0.2 * (t["bin"] + t["bin_centres"]) + 0.1 * t["sparse"])
    got, want = float(loss.detach()), float(ref_loss.detach())
    assert abs(got - want) <= 1e-12 * abs(want)
    ref = clipped_grads(list(torch.autograd.grad(ref_loss, [net.get_parameter(n)
                                                            for n in trained])),
                        float(cfg["grad_clip_norm"]))
    assert float(global_norm(port)) == pytest.approx(1.0, rel=1e-12)   # the clip acted
    floor = median(float(g.norm()) for g in ref)
    gaps = {n: float((p - g).norm()) / max(float(g.norm()), floor)
            for n, p, g in zip(trained, port, ref)}
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= GRAD_TOL, worst
    assert len(trained) == sum(1 for n, _ in model.named_parameters()
                               if not n.startswith("rgb_"))


@pytest.fixture(scope="module")
def two_steps():
    """Two checked steps through the benchmark's path at the tiny size,
    the float32 reference after them, and what `harness.check` reads."""
    torch.set_num_threads(1)
    cell, cfg = tiny_config()
    cell.config = cfg
    cell.traffic = dict(cell.traffic, batch_size=BATCH, cache_rows=2 * BATCH, checked_steps=2,
                        warmup_steps=0)
    run = TrainRun(cell, SEED, "cpu")
    params = {n: p.detach().clone() for n, p in run.state.model.named_parameters()}
    buffers = {n: b.detach().clone() for n, b in run.state.model.named_buffers()}
    readings, weights = run.readings, run.weights
    batches = run.reference_batches("cpu")
    run.free()
    ref = reference_steps(cfg, weights, batches, Precision(), "cpu")
    numbers, where = train_numbers(readings, ref)
    return {"readings": readings, "ref": ref, "numbers": numbers, "where": where,
            "params": params, "buffers": buffers, "weights": weights}


@pytest.mark.parametrize("number,tol", [("loss_gap", STEP_TOL), ("grad_gap", GRAD_NORM_TOL),
                                        ("change_gap", CHANGE_TOL), ("bn_mean_gap", STEP_TOL),
                                        ("bn_var_gap", STEP_TOL)])
def test_two_adamw_steps_match_the_reference(two_steps, number, tol):
    assert two_steps["numbers"][number] <= tol, two_steps["where"].get(number)
    losses = zip(two_steps["readings"]["loss"], two_steps["ref"]["loss"])
    assert all(abs(p - r) <= STEP_TOL * abs(r) for p, r in losses)


def test_the_teacher_is_frozen_and_its_statistics_move_and_agree(two_steps):
    teacher = [n for n in two_steps["params"] if n.startswith("rgb_")]
    assert len(teacher) > 0
    for n in teacher:
        assert torch.equal(two_steps["params"][n], two_steps["weights"][n]), n
        assert two_steps["ref"]["change"][n] == 0.0
        assert n not in two_steps["ref"]["grad"]
    moved = [n for n in two_steps["buffers"] if n.startswith("rgb_")
             and n.endswith(("running_mean", "running_var"))]
    assert moved and all(not torch.equal(two_steps["buffers"][n], two_steps["weights"][n])
                         for n in moved)
    layers = [n for n in two_steps["ref"]["bn"] if n.startswith("rgb_")]
    assert len(layers) == 18   # 10 in the encoder, 8 in the decoder
    prog, ref = two_steps["readings"]["bn"], two_steps["ref"]["bn"]
    for n in layers:
        for p, r in zip(prog[n], ref[n]):
            assert float((p - r).abs().max() / r.abs().max()) <= STEP_TOL, n


def test_flops_pinned_at_base_64():
    with open(ROOT / "benchmark" / "configs" / "adabins_distillation.json") as f:
        cfg = json.load(f)
    student, pair = model_flops(cfg), train_flops_per_pair(cfg)
    teacher = pair - 3 * student
    assert student == 131_693_084_672
    assert teacher == 131_768_582_144     # the third input channel's first convolution
    assert pair == 526_847_836_160
    assert sum(p.numel() for p in REF.build_net(cfg).parameters()) == 42_614_529


def test_flops_equal_the_counter_on_the_reference_student(tiny):
    net = REF.build_net(tiny["cfg"]).eval()
    x = torch.rand(1, 32, 32, 2)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        net(x)
    assert counter.get_total_flops() == model_flops(tiny["cfg"])


def test_frame_on_the_uint8_grid_and_carried_bit_for_bit(tiny):
    frame = tiny["pairs"]["image"]
    assert frame.shape == (2 * BATCH, 32, 32, 3) and frame.dtype == torch.float32
    k = frame * 255.0
    assert torch.equal(k, k.round()) and float(frame.min()) >= 0 and float(frame.max()) <= 1
    # the shading: red is depth / max_depth and blue its complement, on the grid
    shade = tiny["pairs"]["depth"][..., 0] / 30.0
    assert float((frame[..., 0] - shade).abs().max()) <= 0.5 / 255 + 1e-7
    assert float((frame[..., 2] - (1 - shade)).abs().max()) <= 0.5 / 255 + 1e-7
    pairs = {k: v.numpy() for k, v in tiny["pairs"].items()}
    cache = DeviceDatasetCache(_Pairs(pairs), depth_storage_units(tiny["pcfg"]), "cpu")
    assert cache.arrays["image"].dtype == torch.uint8
    rows = np.array([5, 0, 7, 2])
    got = decode_batch(cache.batch(rows), depth_storage_units(tiny["pcfg"]))
    assert torch.equal(got["image"], frame[torch.from_numpy(rows)])
    # the frame's uint8 beside the echo's int16 (and its scale) and the depth's uint16
    n, wave = 2 * BATCH, pairs["waveform"]
    assert cache.nbytes() == n * (wave[0].size * 2 + 4 + 32 * 32 * 2 + 32 * 32 * 3)
