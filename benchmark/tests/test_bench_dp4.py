"""The four-card cell `binaural-train-b256-dp4` on the CPU: four gloo ranks at
base 8, each with a row-shard of the cache, through the harness's spawned
data-parallel path, against the cell's own limits. A sound run is correct;
with the gradient exchange between ranks left out it is not
(`grad_median_gap`). The whole-run helpers are `test_bench_faults`'s.
"""

import pytest

import test_bench_faults as faults

CELL = "binaural-train-b256-dp4"


@pytest.mark.parametrize("exchange", [True, False], ids=["sound", "exchange_left_out"])
def test_four_ranks_against_the_cells_limits(exchange, monkeypatch):
    import audiodepth_tpu_torch.train.engine as engine

    cell = faults._train_cell(CELL)
    assert cell.chips == 4 and cell.traffic["ranks"] == 4
    plant = None
    if not exchange:
        monkeypatch.setattr(engine, "all_reduce_grads_", lambda grads, group: None)
        plant = faults.drop_exchange
    ok, out = faults._correct(cell, plant=plant)
    assert ok == exchange, out["checks"]
    assert out["result"]["failed"] == 0 and out["result"]["attempted"] >= 1
    if not exchange:
        gap = out["checks"]["grad_median_gap"]
        assert gap["value"] > gap["limit"], out["checks"]
