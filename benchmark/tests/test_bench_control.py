"""The control on the card, at each single-card cell's own size: the
reference computed in float8 (the step below the configurations'
bfloat16) in the program's place has to come out as not correct against
the cell's limits. Run on a machine with a card:

    python -m pytest benchmark/tests/test_bench_control.py -m card
"""

import pytest
import torch

from harness import check
from harness.spec import load_cell
from reference import Precision
from reference.train import reference_predict, reference_steps

SEED = 2 ** 31 + 8080


@pytest.mark.card
@pytest.mark.parametrize("name", ["unet256-train-b256-cached", "binaural-train-b64-cached"])
def test_training_control_fails(name, card):
    from harness.train import TrainRun

    cell = load_cell(name)
    run = TrainRun(cell, SEED, card)
    weights, batches = run.weights, run.reference_batches(card)
    run.free()
    ref = reference_steps(cell.config, weights, batches, Precision(), card)
    ctl = reference_steps(cell.config, weights, batches, Precision.fp8(), card)
    correct, checks = check.judge(check.train_numbers(ctl, ref)[0], cell.limits)
    assert not correct, checks


@pytest.mark.card
def test_serving_control_fails(card):
    from harness.inputs import make_pairs, make_weights

    cell = load_cell("binaural-serve-poisson")
    waves = make_pairs(int(cell.traffic["checked"]), SEED, cell.config, card)["waveform"]
    weights = {k: v.cpu() for k, v in make_weights(cell.config, SEED, card).items()}
    ref = reference_predict(cell.config, weights, {"waveform": waves}, Precision()).cpu()
    ctl = reference_predict(cell.config, weights, {"waveform": waves}, Precision.fp8()).cpu()
    numbers = check.serve_numbers(ctl, ref, float(cell.config["max_depth"]))[0]
    correct, checks = check.judge(numbers, cell.limits)
    assert not correct, checks
    torch.cuda.empty_cache()
