"""A cell, found by name: `BENCHMARK.json`'s entry and the files the
harness reads for it.

- `configs/<config>.json`: the model configuration as it is run.
- `traffic/<traffic>.json`: the traffic mix's parameters, read by the one
  generator of its `kind` (`train_cached`, `serve_open_loop`).
- `limits/<workload>.json`: each number the correctness check compares,
  with its limit and the readings the limit was set from. A cell measured
  and kept for a later `BENCHMARK.json` entry names its `config` and
  `traffic` here; the tools and the tests find it by name all the same.
- `metrics/<metric>.py`: one reader per per-layer metric, a `read(ctx)`
  that returns the value, or None where the run gives it nothing to read.
- `reference/families/<family>.py`, by the configuration's `family`: the
  family's plain reference, `build_net(cfg, prec, checkpointed)`,
  `param_specs(cfg)`, `train_loss(net, batch, cfg, shards)`,
  `predict(net, batch, cfg)`, and, where the defaults do not hold,
  `trainable(name)` (every parameter) and `extra_inputs(depth, gen, cfg)`
  (no per-row tensors beyond the waveform and the depth); that package's
  note sets out each.
- `flops/families/<family>.py`: the family's `forward_flops(cfg)`, and
  `train_flops_per_pair(cfg)` where a trained pair is not 3 × the forward.
- `flops/bounds/<op name after "::">.py`: a hand-written op's `OP` and
  `bound_s(shapes, dtype, peak, cfg)`, the least time of one call, which
  its roofline reader (`harness.readings.roofline`) sums.

A later change adds a configuration, a mix, a cell, a metric, a model
family or a kernel's bound by adding these files and entries; no file of
the harness, and none of the reference or the FLOP code outside
`families/` and `bounds/`, names one (`tests/test_bench_families.py`).
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def _load(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    read: Callable = None   # per-layer metrics: the reader


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Metric]
    per_layer: List[Metric]
    run_seconds: int


def _applies(entry: Dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def load_reader(name: str) -> Callable:
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_cell(workload: str, bench: Dict = None) -> Cell:
    bench = bench or _load(ROOT / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    limits_path = BENCH_DIR / "limits" / f"{workload}.json"
    if workload in entries:
        w = entries[workload]
    elif limits_path.exists() and "config" in _load(limits_path):
        kept = _load(limits_path)
        w = {"name": workload, "config": kept["config"], "traffic": kept["traffic"], "chips": 1}
    else:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"(there are {sorted(entries)})")
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load(ROOT / configs[w["config"]]["file"])
    traffic = _load(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    limits = _load(limits_path)
    e2e = [Metric(m["name"], m["unit"], m["better"], m["source"])
           for m in bench["end_to_end"] if _applies(m, workload)]
    layers = [Metric(m["name"], m["unit"], m["better"], m["source"], load_reader(m["name"]))
              for m in bench["per_layer"] if _applies(m, workload)]
    return Cell(workload, int(w["chips"]), config, traffic, limits, e2e, layers,
                int(bench["run_seconds"]))
