"""The port's example scripts (`audiodepth_tpu_torch/examples/`) against the
JAX package's `examples/`, on the CPU at small widths:

  * compare_checkpoints: one tiny checkpoint trained by the port's CLI (a
    unet_128, and a coarse unet on its config's own bins), scored by the
    JAX script from its .pth and by the port's script from the same .pth
    and from the port's experiment directory: the three rows agree cell by
    cell within 1e-5 relative (float32 on both sides); the CSV header is
    the reference's;
  * the --entry grammar: each script's main hands the same label, family,
    path and overrides to its evaluate_entry, and the overrides build the
    same config;
  * the sweep's batch lists (coarse_depth with bins, rgb_depth with camera
    views) equal, bit for bit, those the JAX script's run_family builds
    (its Engine and prefetch replaced by recorders);
  * every family's sweep run, one convergence run and three step-bench
    families run and give finite numbers; a failing family makes main raise;
    every script raises without a card unless --device cpu;
  * commands.sh: every port CLI line parses with that CLI's parser and has
    the JAX file's flags plus the port's.
"""

from __future__ import annotations

import csv
import dataclasses
import importlib.util
import os
import shlex

import numpy as np
import pytest
import torch

from audiodepth_tpu_torch.examples import (compare_checkpoints, family_step_bench,
                                           family_sweep, synthetic_convergence)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSV_REL_TOL = 1e-5  # float32 forwards on both sides, summed in float32 (JAX) and float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small models: one intra-op thread, the cores left to other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def _jax_example(name):
    """The JAX package's examples/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- compare_checkpoints ------------------------------------------------------

# family → (cli.train flags of its shapes, the same shapes as entry overrides)
CSV_CASES = {
    "unet_baseline": (["--generator", "unet_128", "--ngf", "4"],
                      "model.generator=unet_128,model.ngf=4"),
    "coarse_depth": (["--base_channels", "4", "--n_bins", "8",
                      "--override", "dataset.images_size=32"],
                     "model.base_channels=4,model.n_bins=8,dataset.images_size=32"),
}


@pytest.mark.parametrize("family", sorted(CSV_CASES))
def test_compare_csv_matches_jax_script(tmp_path, family):
    from audiodepth_tpu_torch.cli.train import main as train_main

    flags, ov = CSV_CASES[family]
    ckpt = tmp_path / "ck"
    train_main(["--device", "cpu", "--dataset", "synthetic", "--model", family,
                "--experiment_name", "cmpsmoke", "--epochs", "1", "--batch_size", "4",
                "--num_samples", "8", "--saving_checkpoints", "1",
                "--compute_dtype", "float32", "--ckpt_dir", str(ckpt), *flags])
    (exp,) = os.listdir(ckpt)
    exp_dir = str(ckpt / exp)
    pth = os.path.join(exp_dir, "checkpoint_1.pth")  # a port checkpoint is a reference .pth
    common = ["--dataset", "synthetic", "--num_samples", "8", "--batch_size", "4"]

    jax_csv, port_csv = str(tmp_path / "jax.csv"), str(tmp_path / "port.csv")
    want = _jax_example("compare_checkpoints").main(
        common + ["--out", jax_csv, "--entry", f"jax pth:{family}:{pth}:{ov}"])
    got = compare_checkpoints.main(
        common + ["--device", "cpu", "--out", port_csv,
                  "--entry", f"port pth:{family}:{pth}:{ov}",
                  "--entry", f"port dir:{family}:{exp_dir}:{ov}"])
    assert [r["Model"] for r in got] == ["port pth", "port dir"]
    for row in got:
        for col in compare_checkpoints.COLUMNS[1:]:
            ref = want[0][col]
            assert np.isfinite(row[col]), (row, col)
            assert abs(row[col] - ref) <= CSV_REL_TOL * abs(ref), (col, row[col], ref)
    for path in (jax_csv, port_csv):
        with open(path) as f:
            header = next(csv.reader(f))
        assert header == ["Model", "ABS_REL", "RMSE", "MAE", "Delta1"]
    with open(port_csv) as f:
        assert [r["Model"] for r in csv.DictReader(f)] == ["port pth", "port dir"]


def test_compare_adopts_checkpoint_bins(tmp_path):
    """A coarse checkpoint trained on linear bins, entered with the config's
    sid bins: the port's rows (its .pth and its directory) score it on the
    bins it was trained with, as cli.evaluate does, so they agree with each
    other and differ from the JAX script's row, which keeps the config's
    bins (it never reads a checkpoint's aux)."""
    from audiodepth_tpu_torch.cli.train import main as train_main

    flags, ov = CSV_CASES["coarse_depth"]
    ckpt = tmp_path / "ck"
    train_main(["--device", "cpu", "--dataset", "synthetic", "--model", "coarse_depth",
                "--bin_strategy", "linear", "--epochs", "1", "--batch_size", "4",
                "--num_samples", "8", "--compute_dtype", "float32", "--ckpt_dir", str(ckpt),
                *flags])
    (exp,) = os.listdir(ckpt)
    exp_dir = str(ckpt / exp)
    pth = os.path.join(exp_dir, "checkpoint_1.pth")
    common = ["--dataset", "synthetic", "--num_samples", "8", "--batch_size", "4"]
    want = _jax_example("compare_checkpoints").main(
        common + ["--out", str(tmp_path / "j.csv"), "--entry", f"jax:coarse_depth:{pth}:{ov}"])
    got = compare_checkpoints.main(
        common + ["--device", "cpu", "--out", str(tmp_path / "p.csv"),
                  "--entry", f"pth:coarse_depth:{pth}:{ov}",
                  "--entry", f"dir:coarse_depth:{exp_dir}:{ov}"])
    for col in compare_checkpoints.COLUMNS[1:]:
        assert abs(got[0][col] - got[1][col]) <= CSV_REL_TOL * abs(got[1][col]), col
    assert abs(got[0]["RMSE"] - want[0]["RMSE"]) > 100 * CSV_REL_TOL * abs(want[0]["RMSE"])


ENTRY_SPECS = [
    "UNet (ours, best):unet_baseline:/ckpts/exp one",
    "with overrides:coarse_depth:/ckpts/c.pth:model.n_bins=16,model.extra.use_focal=true,"
    "mode.learning_rate=0.001,model.attention_levels=null,model.model_type=hybrid",
    "flags:binaural_attention:x.pth:mode.validation=False,model.extra.lambda_edge=2.5e-1",
]


def _null_free(overrides, null):
    return {k: ("<NULL>" if v is null else v) for k, v in overrides.items()}


@pytest.mark.parametrize("spec", ENTRY_SPECS)
def test_entry_parsing_matches_jax_script(tmp_path, monkeypatch, spec):
    from audiodepth_tpu.configs import NULL as JAX_NULL
    from audiodepth_tpu.configs import load_config as jax_load_config
    from audiodepth_tpu_torch.configs import NULL, load_config

    seen = {}

    def recorder(side):
        def evaluate_entry(label, family, path, dataset, overrides, *rest):
            seen[side] = (label, family, path, dataset, overrides)
            return {"Model": label, "ABS_REL": 0.0, "RMSE": 0.0, "MAE": 0.0, "Delta1": 0.0}
        return evaluate_entry

    jax_mod = _jax_example("compare_checkpoints")
    monkeypatch.setattr(jax_mod, "evaluate_entry", recorder("jax"))
    monkeypatch.setattr(compare_checkpoints, "evaluate_entry", recorder("port"))
    jax_mod.main(["--entry", spec, "--out", str(tmp_path / "j.csv")])
    compare_checkpoints.main(["--device", "cpu", "--entry", spec, "--out",
                              str(tmp_path / "p.csv")])
    jl, jf, jp, jd, jov = seen["jax"]
    pl, pf, pp, pd, pov = seen["port"]
    assert (pl, pf, pp, pd) == (jl, jf, jp, jd)
    assert compare_checkpoints.parse_entry(spec)[:3] == (jl, jf, jp)
    assert _null_free(pov, NULL) == _null_free(jov, JAX_NULL)
    for a, b in zip(pov.values(), jov.values()):
        assert type(a) is type(b) or (a is NULL and b is JAX_NULL)
    base = {"mode.compute_dtype": "float32"}
    assert dataclasses.asdict(load_config("synthetic", "test", pl, pf, overrides={**base, **pov})) \
        == dataclasses.asdict(jax_load_config("synthetic", "test", jl, jf,
                                              overrides={**base, **jov}))


# -- the sweep's data streams -------------------------------------------------

SMALL = {"dataset.images_size": 32, "model.base_channels": 4, "model.n_bins": 8}


@pytest.mark.parametrize("name", ["coarse_depth", "rgb_depth"])
def test_sweep_batches_equal_jax_script(monkeypatch, name):
    """The JAX script's run_family, its engine and prefetch replaced by
    recorders, against the port's prepare_batches: bit for bit."""
    from audiodepth_tpu_torch.models import make_task

    jax_mod = _jax_example("family_sweep")
    seen = {"train": [], "val": []}

    class Recorder:
        def __init__(self, cfg, task, steps_per_epoch=1):
            pass

        def init_state(self, rng, batch):
            return None

        def train_step(self, state, batch, epoch=0.0):
            return state, {"loss": 0.0}

        def evaluate(self, state, batches):
            seen["val"].append(list(batches))
            return {"rmse": 0.0, "abs_rel": 0.0, "delta3": 0.0}

    def prefetch(batches, size=2):
        seen["train"].append(list(batches))
        return iter(seen["train"][-1])

    monkeypatch.setattr(jax_mod, "Engine", Recorder)
    monkeypatch.setattr(jax_mod, "device_prefetch", prefetch)
    over = {**dict(family_sweep.FAMILIES)[name], **SMALL}
    assert dict(jax_mod.FAMILIES)[name] == dict(family_sweep.FAMILIES)[name]
    jax_mod.run_family(name, over, epochs=1, bs=2, n_train=6, n_val=4)

    cfg = family_sweep.family_config(name, over, 2)
    train, val = family_sweep.prepare_batches(cfg, make_task(cfg, device="cpu"), name, 2, 6, 4)
    for got, want in ((train, seen["train"][0]), (val, seen["val"][0])):
        assert len(got) == len(want) and len(got) >= 2
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in g:
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
    key = "bins" if name == "coarse_depth" else "image"
    assert all(key in b for b in train + val)


# -- small runs ---------------------------------------------------------------

# per family, the overrides of a small run (the unet families need unet_128
# at 128², the others run at 32²)
UNET_SMALL = {"model.generator": "unet_128", "model.ngf": 2, "dataset.images_size": 128}
FAMILY_SMALL = {name: (UNET_SMALL if name in ("unet_baseline", "unet_cvae") else SMALL)
                for name, _ in family_sweep.FAMILIES}


@pytest.mark.parametrize("name", [name for name, _ in family_sweep.FAMILIES])
def test_sweep_family_runs(name):
    over = dict(family_sweep.FAMILIES)[name]
    losses = []
    row = family_sweep.run_family(name, over, epochs=2, bs=2, n_train=4, n_val=2,
                                  overrides=FAMILY_SMALL[name], device="cpu",
                                  on_step=lambda state, m: losses.append(float(m["loss"])))
    assert row["steps"] == 4 and row["eval_batches"] == 2
    assert len(losses) == 4 and np.isfinite(losses).all()
    for val in (row["first"], row["last"]):
        assert val and all(np.isfinite(v) for v in val.values()), val


def test_convergence_runs():
    rows = synthetic_convergence.run(epochs=5, bs=2, n_train=4, n_val=2,
                                     overrides=UNET_SMALL, device="cpu")
    assert [r["epoch"] for r in rows] == [1, 5]
    for r in rows:
        assert all(np.isfinite(v) for v in r.values()), r
    assert rows[1]["train_s"] >= rows[0]["train_s"] > 0


@pytest.mark.parametrize("name", ["coarse_depth", "base_residual", "binaural_attention"])
def test_step_bench_runs(name):
    row = family_step_bench.time_family(name, dict(family_step_bench.FAMILIES)[name], bs=2,
                                        n_steps=2, warmup=1, overrides=SMALL, device="cpu")
    assert row["family"] == name and row["peak_mem_mib"] is None
    assert np.isfinite(row["loss"]) and row["ms_per_step"] > 0 and row["batch"] == 2


@pytest.mark.parametrize("script", [family_sweep, family_step_bench])
def test_failing_family_raises(monkeypatch, script):
    monkeypatch.setattr(script, "FAMILIES", [("no_such_family", {}), ("unet_baseline", {})])
    with pytest.raises(NotImplementedError, match="no_such_family"):
        script.main(["--device", "cpu"])


@pytest.mark.parametrize("script,argv", [
    (compare_checkpoints, ["--entry", "a:unet_baseline:x.pth"]),
    (synthetic_convergence, []), (family_sweep, []), (family_step_bench, []),
])
def test_scripts_need_a_card_unless_asked_for_cpu(script, argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        script.main(argv)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        script.main(argv + ["--device", "cuda"])


# -- commands.sh --------------------------------------------------------------

def _commands(path, package):
    """(module, argv) of every `python -m <package>.<module>` command of a
    shell file, continuation lines joined."""
    with open(path) as f:
        text = f.read().replace("\\\n", " ")
    out = []
    for line in text.splitlines():
        words = shlex.split(line, comments=True)
        if words[:2] == ["python", "-m"] and words[2].startswith(package + "."):
            out.append((words[2][len(package) + 1:], words[3:]))
    return out


# flags the port's lines add to the JAX file's: the device, and where the
# run the evaluations read saves its checkpoints (the port saves only there)
PORT_FLAGS = {"--device": "cuda", "--ckpt_dir": "./checkpoints"}


def _without_port_flags(argv):
    out, it = [], iter(argv)
    for word in it:
        if word in PORT_FLAGS:
            assert next(it) == PORT_FLAGS[word]
        else:
            out.append(word)
    return out


def test_commands_sh_parses_and_matches_jax_flags():
    from audiodepth_tpu_torch.cli import evaluate, serve, train

    parsers = {"cli.train": train.build_parser, "cli.evaluate": evaluate.build_parser,
               "cli.serve": serve.build_parser}
    port = _commands(os.path.join(REPO, "audiodepth_tpu_torch", "examples", "commands.sh"),
                     "audiodepth_tpu_torch")
    jax = _commands(os.path.join(REPO, "examples", "commands.sh"), "audiodepth_tpu")
    assert [m for m, _ in port] == [m for m, _ in jax]
    n_cli = 0
    for (module, argv), (_, jax_argv) in zip(port, jax):
        if module in parsers:
            args = parsers[module]().parse_args(argv)
            assert args.device == "cuda"
            assert _without_port_flags(argv) == jax_argv, module
            n_cli += 1
    assert n_cli == sum(m.startswith("cli.") for m, _ in jax) >= 10
