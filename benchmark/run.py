"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Reads the cell from `BENCHMARK.json` and the files it names, looks for the
cards the cell asks for (none, or too few: exit 2, no result), runs it on
`audiodepth_tpu_torch`, and prints as the last line of its standard output
one JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with --trace 1 its per-layer metrics), `device`,
with --trace 1 `breakdown`, and last `checks`, each number the correctness
check compared beside its limit (also the last lines of its standard
error). A run that finds JAX or the JAX package among its loaded modules,
in this process or a rank's, exits 3 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
for _p in (os.path.dirname(BENCH), BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from harness.spec import load_cell

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"the cell asks for {cell.chips} cards, {torch.cuda.device_count()} present",
              file=sys.stderr)
        return 2
    from harness.cell import run_cell
    from harness.guard import forbidden_modules

    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START)
    foreign = sorted(set(forbidden_modules()) | set(out["foreign"]))
    if foreign:
        print(f"forbidden modules loaded: {foreign}", file=sys.stderr)
        return 3
    print(json.dumps({"notes": out["notes"]}, default=str), file=sys.stderr)
    # a number that could not be read is null (and the run not correct)
    checks = {name: {"value": c["value"] if math.isfinite(c["value"]) else None,
                     "limit": c["limit"]} for name, c in out["checks"].items()}
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    result = dict(out["result"])
    result["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
