"""`BENCHMARK.json` against its contract, and every file it names resolved
by name: configurations, traffic mixes, limits and per-layer readers."""

import json
import re

import pytest
from harness.spec import BENCH_DIR, ROOT, load_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


BENCH = _bench()
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"][1] == "benchmark/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    names = [c["name"] for c in BENCH["configs"]] + WORKLOADS
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in BENCH["workloads"]:
        assert _line(w["why"]) and w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert _line(c["why"]) and _line(c["source"])


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for w in WORKLOADS:
        mine = [m for m in e2e.values() if w in m.get("workloads", WORKLOADS)]
        assert "setup_s" in [m["name"] for m in mine] and len(mine) >= 2
        layers = [m for m in BENCH["per_layer"] if w in m.get("workloads", WORKLOADS)]
        assert layers
        for m in layers:
            moved = e2e[m["moves"]]
            assert w in moved.get("workloads", WORKLOADS), (m["name"], w)


def test_layers_named_alike():
    by_layer = {}
    for m in BENCH["per_layer"]:
        assert _line(m["layer"])
        by_layer.setdefault(m["layer"], []).append(m["name"])
    assert len(by_layer) >= 5


def test_roofline_and_mfu_names():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_resolves_by_name(workload):
    cell = load_cell(workload, BENCH)
    assert cell.traffic["kind"] in ("train_cached", "serve_open_loop")
    assert cell.limits["numbers"]
    for spec in cell.limits["numbers"].values():
        assert spec["limit"] > 0
    for m in cell.per_layer:
        assert callable(m.read)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(entry):
    path = ROOT / entry["file"]
    assert path.is_relative_to(BENCH_DIR)
    with open(path) as f:
        cfg = json.load(f)
    assert cfg["reduced"] == entry["reduced"]
    for key in cfg["reduced"]:
        assert NAME.match(key) and key in cfg
    assert "source" in cfg and "assumed" in cfg and "deployment" in cfg


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_builds_the_port_config(entry):
    from harness.port import port_config

    with open(ROOT / entry["file"]) as f:
        cfg = json.load(f)
    pcfg = port_config(cfg)
    assert pcfg.model.name == cfg["family"]
    assert pcfg.mode.batch_size == cfg["batch_size"]
    assert pcfg.mode.compute_dtype == cfg["compute_dtype"]
    assert pcfg.dataset.images_size == cfg["images_size"]


def test_port_config_refuses_unknown_keys():
    from harness.port import port_config

    with open(BENCH_DIR / "configs" / "unet_256.json") as f:
        cfg = json.load(f)
    cfg["hidden_sizes"] = 3
    with pytest.raises(KeyError):
        port_config(cfg)


def test_port_config_takes_an_extra_object():
    """An `extra` object's entries are the model's extra settings, beside
    the top-level `remat` and `loss_type`."""
    from harness.port import port_config

    with open(BENCH_DIR / "configs" / "binaural_attention.json") as f:
        cfg = json.load(f)
    plain = port_config(cfg).model.extra
    cfg["extra"] = {"temperature": 4.0, "lambda_kl": 0.5}
    extra = port_config(cfg).model.extra
    assert extra == dict(plain, temperature=4.0, lambda_kl=0.5)
    assert extra["remat"] is True and extra["loss_type"] == "standard"


def test_check_budget_fits():
    # 2 + 14 runs a cell, run_seconds + 60 each, 2 x 90 s a cell to compile,
    # 1200 s spare, for the full 24 cells
    s = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (s + 60) + 24 * 180 + 1200 <= 43200


def test_four_chip_cells_within_quota():
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
