"""Find the serving knee once: the highest offered rate at which
completions keep up with arrivals: the completed rate is within 2 % of the
offered one, and at the window's end no more requests wait than are in
flight by Little's law (the rate times the median latency) plus one largest
ladder batch, so the queue does not grow. One process, the server built
once; each rate runs a window.

    python3 benchmark/tools/sweep.py --workload <serving cell> --seed <n> \
        --rates 150,200,250 [--seconds 10]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

import _path  # noqa: F401


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    from harness.serve import ServeRun
    from harness.spec import load_cell

    cell = load_cell(args.workload)
    rates = [float(r) for r in args.rates.split(",")]
    cell.traffic["rate_rps"] = max(rates)
    run = ServeRun(cell, args.seed, args.seconds, "cuda:0")
    largest = max(cell.traffic["ladder"])
    try:
        for rate in rates:
            run.rate, run.n = rate, max(1, round(rate * args.seconds))
            run.checked = []
            win = run.window(args.seconds)
            rec = run.record
            end = float(rec["due"][-1])
            done = np.nan_to_num(rec["done"], nan=np.inf)
            backlog = int(((rec["due"] <= end) & (done > end)).sum())
            completed = int((done <= end).sum())
            lat = np.sort(np.asarray(win["latency_s"]))
            print(json.dumps({
                "rate_rps": rate, "offered": run.n, "window_s": end,
                "completed_rps": completed / end, "backlog_at_end": backlog,
                "keeps_up": bool(completed >= 0.98 * run.n
                                 and backlog <= rate * float(lat[len(lat) // 2]) + largest),
                "p50_ms": 1e3 * float(lat[len(lat) // 2]),
                "p95_ms": 1e3 * float(lat[int(0.95 * (len(lat) - 1))]),
                "failed": win["failed"], "batch_fill": win["served_rows"] / max(1, win["batches"]),
                "runner_ms": 1e3 * float(np.mean(win["runner_s"])) if win["runner_s"] else None,
                "late_p99_ms": 1e3 * float(np.nanquantile(win["late_s"], 0.99))}), flush=True)
    finally:
        run.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
