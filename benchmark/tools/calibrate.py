"""Readings that the correctness limits are set from, for one cell, in one
process on the card: the program's numbers over many seeds, and over a few
of them the float8 control's and the planted faults'.

    python3 benchmark/tools/calibrate.py --workload <name> --seeds 1,2,... \
        --control_seeds 1,2,3 [--seconds 2]

Training cells: each seed builds the cell's set-up (its checked steps are
the program's readings) and the float32 reference; on the control seeds
also the reference in float8 in the program's place (the control), the
reference on the first half of each batch's rows (the fault "half of the
batch left out, the mean taken over the rest"), and the state left
unchanged (the change reads 1 by its measure, no run). Serving cells: each
seed serves a window of `--seconds` at the cell's rate and checks its
sample; on the control seeds also the float8 reference, and the fault
"an answer altered where it is produced" (each answer handed to the
request after it). One JSON line a seed and kind.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import _path  # noqa: F401


def _emit(**row) -> None:
    print(json.dumps(row, default=float), flush=True)


def train(cell, seeds, control_seeds, device) -> None:
    import torch
    from harness.check import train_numbers
    from harness.train import TrainRun
    from reference import Precision
    from reference.train import reference_steps

    for seed in seeds:
        t = time.perf_counter()
        run = TrainRun(cell, seed, device)
        readings, weights = run.readings, run.weights
        batches = run.reference_batches(run.device)
        run.free()
        ref = reference_steps(cell.config, weights, batches, Precision(), device)
        _emit(kind="program", seed=seed, numbers=train_numbers(readings, ref)[0],
              where=train_numbers(readings, ref)[1], loss=readings["loss"],
              loss_ref=ref["loss"], setup_s=run.setup_s, seconds=time.perf_counter() - t)
        if seed in control_seeds:
            ctl = reference_steps(cell.config, weights, batches, Precision.fp8(), device)
            _emit(kind="control_fp8", seed=seed, numbers=train_numbers(ctl, ref)[0],
                  where=train_numbers(ctl, ref)[1])

            def half(make):
                def cut():
                    b = make()
                    return {k: v[: v.shape[0] // 2] for k, v in b.items()}
                return cut

            halved = reference_steps(cell.config, weights, [half(m) for m in batches],
                                     Precision(), device)
            _emit(kind="fault_half_batch", seed=seed, numbers=train_numbers(halved, ref)[0])
            frozen = dict(readings, change={n: 0.0 for n in readings["change"]})
            _emit(kind="fault_state_unchanged", seed=seed,
                  numbers=train_numbers(frozen, ref)[0])
        del run, ref
        torch.cuda.empty_cache()


def drop_exchange():
    """The fault: every rank keeps its own gradients (the all-reduce left out)."""
    import audiodepth_tpu_torch.train.engine as engine

    engine.all_reduce_grads_ = lambda grads, group: None


def half_batch():
    """The fault: every rank's step trains on the first half of its rows,
    the mean taken over them."""
    import audiodepth_tpu_torch.train.engine as engine

    decode = engine.decode_batch
    engine.decode_batch = lambda batch, units: {
        k: v[: v.shape[0] // 2] for k, v in decode(batch, units).items()}


def train_ranks(cell, seeds, control_seeds, device) -> None:
    """A data-parallel cell: each seed a whole run (its ranks spawned), its
    window 1 s; on the control seeds the control, and the faults "the
    exchange between chips left out" and "half of the batch left out",
    each planted in every rank."""
    import torch
    import audiodepth_tpu_torch.train.engine as engine
    from harness.cell import run_cell
    from harness.check import train_numbers
    from reference import Precision

    for seed in seeds:
        t = time.perf_counter()
        also = (Precision.fp8(),) if seed in control_seeds else ()
        out = run_cell(cell, seed, 1.0, False, device, also=also)
        ref = out["reference"]
        _emit(kind="program", seed=seed, numbers=out["notes"]["numbers"],
              where=out["notes"]["worst"], correct=out["result"]["correct"],
              setup_s=out["result"]["metrics"]["setup_s"]["value"],
              reference_s=out["notes"]["reference_s"],
              reference_peak_bytes=out["notes"]["reference_peak_bytes"],
              seconds=time.perf_counter() - t)
        if seed in control_seeds:
            _emit(kind="control_fp8", seed=seed, numbers=train_numbers(out["also"][0], ref)[0])
            for name, plant in (("fault_exchange_left_out", drop_exchange),
                                ("fault_half_batch", half_batch)):
                keep = engine.all_reduce_grads_, engine.decode_batch
                plant()
                try:
                    fault = run_cell(cell, seed, 1.0, False, device, plant=plant)
                finally:
                    engine.all_reduce_grads_, engine.decode_batch = keep
                _emit(kind=name, seed=seed, numbers=fault["notes"]["numbers"])
        del out, ref
        torch.cuda.empty_cache()


def serve(cell, seeds, control_seeds, seconds, device) -> None:
    import torch
    from harness.check import serve_numbers
    from harness.serve import ServeRun
    from reference import Precision
    from reference.train import reference_predict

    for seed in seeds:
        run = ServeRun(cell, seed, seconds, device)
        try:
            win = run.window(seconds)
        finally:
            run.close()
        served = run.served_answers(win["answers"])
        waves = torch.from_numpy(run.waves[run.checked]).to(run.device)
        ref = reference_predict(cell.config, run.weights, {"waveform": waves}, Precision()).cpu()
        lat = sorted(win["latency_s"])
        top = float(cell.config["max_depth"])
        _emit(kind="program", seed=seed, numbers=serve_numbers(served, ref, top)[0],
              failed=win["failed"], p95_ms=1e3 * lat[int(0.95 * (len(lat) - 1))],
              setup_s=run.setup_s)
        if seed in control_seeds:
            ctl = reference_predict(cell.config, run.weights, {"waveform": waves},
                                    Precision.fp8()).cpu()
            _emit(kind="control_fp8", seed=seed, numbers=serve_numbers(ctl, ref, top)[0])
            _emit(kind="fault_answer_moved", seed=seed,
                  numbers=serve_numbers(served.roll(1, 0), ref, top)[0])
            q = ref.flatten()
            _emit(kind="reference_spread", seed=seed,
                  quantiles_m=[float(x) for x in torch.quantile(
                      q[torch.randperm(q.numel())[:100000]],
                      torch.tensor([0.01, 0.1, 0.5, 0.9, 0.99])).tolist()])
        del run
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control_seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    from harness.spec import load_cell

    cell = load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    if cell.traffic["kind"] == "train_cached" and int(cell.traffic.get("ranks", 1)) > 1:
        train_ranks(cell, seeds, control, "cuda:0")
    elif cell.traffic["kind"] == "train_cached":
        train(cell, seeds, control, "cuda:0")
    else:
        serve(cell, seeds, control, args.seconds, "cuda:0")
    return 0


if __name__ == "__main__":
    sys.exit(main())
