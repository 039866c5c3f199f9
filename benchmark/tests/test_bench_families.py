"""A model family, its FLOPs and a kernel's bound are files found by name:
a new family joins the benchmark with new files alone, and no file of the
harness, the shared reference or the shared FLOP code names a family or a
registered op."""

import ast
import json
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

from flops import bounded_ops, kernel_bound_s
from flops.families import family as flops_family
from harness.spec import BENCH_DIR
from reference import family

# the port's families (`audiodepth_tpu_torch.models.make_task`), and any
# the benchmark has files for
FAMILIES = {"unet_baseline", "binaural_attention", "base_residual", "unet_cvae", "rgb_depth",
            "adabins_distillation", "coarse_depth"}
FAMILIES |= {p.stem for d in ("reference", "flops")
             for p in (BENCH_DIR / d / "families").glob("*.py") if p.stem != "__init__"}
OP = re.compile(r"audiodepth::[A-Za-z_]")
SHARED = sorted([BENCH_DIR / "run.py"] + list((BENCH_DIR / "harness").glob("*.py"))
                + list((BENCH_DIR / "tools").glob("*.py"))
                + list((BENCH_DIR / "reference").glob("*.py"))
                + list((BENCH_DIR / "flops").glob("*.py")))


def _strings(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            yield node.value


@pytest.mark.parametrize("path", SHARED, ids=lambda p: p.relative_to(BENCH_DIR).as_posix())
def test_shared_code_names_no_family_and_no_op(path):
    for text in _strings(path):
        for name in FAMILIES:
            assert not re.search(rf"(?<![A-Za-z0-9_]){name}(?![A-Za-z0-9_])", text), (name, text)
        assert not OP.search(text), text


FILES = sorted(p for d in ("reference/families", "flops") for p in (BENCH_DIR / d).rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(BENCH_DIR).as_posix())
def test_family_and_flop_files_import_neither_the_port_nor_jax(path):
    allowed = {"torch", "numpy", "reference", "flops"} | set(sys.stdlib_module_names)
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            tops = [node.module.split(".")[0]]
        else:
            continue
        assert all(t in allowed for t in tops), (path.name, tops)


def test_every_family_file_provides_the_contract():
    for path in (BENCH_DIR / "reference" / "families").glob("*.py"):
        if path.stem == "__init__":
            continue
        fam = family(path.stem)
        for fn in ("build_net", "param_specs", "train_loss", "predict", "trainable",
                   "extra_inputs"):
            assert callable(getattr(fam, fn)), (path.stem, fn)
        assert callable(flops_family(path.stem).forward_flops)


def test_bound_files_name_their_ops():
    assert bounded_ops() == ["audiodepth::flash_cross_attention_bwd",
                             "audiodepth::flash_cross_attention_fwd",
                             "audiodepth::fused_mel_frontend"]


@pytest.mark.parametrize("lookup", [
    lambda: family("no_such_family"),
    lambda: flops_family("no_such_family"),
    lambda: kernel_bound_s("audiodepth::no_such_op", [[1]], "float", {}),
], ids=["reference", "flops", "bound"])
def test_a_missing_file_is_named(lookup):
    with pytest.raises(ValueError, match=r"expected the file .*no_such_(family|op)\.py"):
        lookup()


def test_today_families_draw_no_extra_inputs():
    import torch

    assert family("unet_baseline").extra_inputs(torch.zeros(1, 4, 4, 1), None, {}) == {}


def test_run_exits_3_with_jax_loaded(monkeypatch, capsys):
    """Past the look for a card, a run that finds JAX among its modules
    prints no result."""
    import types

    import torch

    import harness.cell
    import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness.cell, "run_cell", lambda *a, **k: {
        "foreign": [], "notes": {}, "checks": {}, "result": {"correct": True}})
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = run.main(["--workload", "unet256-train-b256-cached", "--seed", "1", "--seconds", "1"])
    assert rc == 3
    assert capsys.readouterr().out == ""


# ---- a family joins by new files alone -------------------------------------------------

TOY_REFERENCE = '''
"""A toy family: the mel image and a camera frame through a frozen 1x1
teacher, two convolutions with a BatchNorm between, a Linear head."""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..frontend import mel_frontend
from ..nets import BatchNorm, Conv, state_specs
from ..train import combined_loss


class Toy(nn.Module):
    def __init__(self, c, prec=None):
        super().__init__()
        self.teacher = nn.Conv2d(3, 3, 1)
        self.conv1 = Conv(5, c, 3, padding=1, prec=prec)
        self.norm = BatchNorm(c)
        self.conv2 = Conv(c, 1, 3, padding=1, prec=prec)
        self.head = nn.Linear(1, 1)

    def forward(self, x, image):
        with torch.no_grad():
            guide = self.teacher(image.permute(0, 3, 1, 2))
        h = torch.relu(self.norm(self.conv1(torch.cat([x.permute(0, 3, 1, 2), guide], 1))))
        return F.softplus(self.head(self.conv2(h).permute(0, 2, 3, 1)))


def build_net(cfg, prec=None, checkpointed=False):
    return Toy(int(cfg["base_channels"]), prec)


def param_specs(cfg):
    with torch.device("meta"):
        specs = state_specs(build_net(cfg), lambda shape: 0.1)
    return [(n, s, "normal", 0.5) if n == "head.weight" else (n, s, r, std)
            for n, s, r, std in specs]


def trainable(name):
    return not name.startswith("teacher.")


def extra_inputs(depth, gen, cfg):
    noise = torch.rand(depth.shape[:3] + (3,), generator=gen, device=depth.device)
    return {"image": depth / float(cfg["max_depth"]) + 0.1 * noise}


def _mel(batch, cfg):
    return mel_frontend(batch["waveform"], int(cfg["images_size"]), float(cfg["max_depth"]),
                        int(cfg["sample_rate"]))


def train_loss(net, batch, cfg, shards):
    pred = net(_mel(batch, cfg), batch["image"])
    return float(cfg["extra"]["loss_scale"]) * combined_loss(
        pred, batch["depth"], float(cfg["l1_weight"]), float(cfg["silog_weight"]),
        float(cfg["silog_lambda"]), shards)


def predict(net, batch, cfg):
    return net(_mel(batch, cfg), batch["image"])[..., 0]
'''

TOY_FLOPS = '''
from ..model import conv_macs


def _teacher(cfg):
    s = int(cfg["images_size"])
    return 2.0 * conv_macs(s, s, 3, 3, 1)


def forward_flops(cfg):
    s, c = int(cfg["images_size"]), int(cfg["base_channels"])
    return 2.0 * (conv_macs(s, s, 5, c, 3) + conv_macs(s, s, c, 1, 3) + s * s) + _teacher(cfg)


def train_flops_per_pair(cfg):
    return 3.0 * (forward_flops(cfg) - _teacher(cfg)) + _teacher(cfg)
'''

TOY_CONFIG = {"name": "toy_echo", "family": "toy_echo", "dataset": "batvisionv2",
              "base_channels": 4, "images_size": 32, "max_depth": 30.0, "sample_rate": 44100,
              "compute_dtype": "float32", "batch_size": 4, "learning_rate": 0.002,
              "weight_decay": 0.01, "l1_weight": 0.237, "silog_weight": 0.637,
              "silog_lambda": 0.869, "grad_clip_norm": 1.0, "extra": {"loss_scale": 0.5}}

DRIVE = '''
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/benchmark"]
import torch
import flops, reference
from harness.inputs import make_pairs, make_weights
from harness.spec import load_cell

with open(sys.argv[1] + "/benchmark/BENCHMARK.toy.json") as f:
    cell = load_cell("toy-train-cached", json.load(f))
cfg = cell.config
weights = make_weights(cfg, 11, "cpu")
pairs = make_pairs(8, 11, cfg, "cpu")
plain = make_pairs(8, 11, dict(cfg, family="unet_baseline"), "cpu")
batches = [lambda s=s: {k: v[s:s + 4] for k, v in pairs.items()} for s in (0, 4)]
out = reference.reference_steps(cfg, weights, batches, reference.Precision(), "cpu")
print(json.dumps({
    "modules": [reference.__file__, flops.__file__],
    "keys": sorted(pairs), "image": list(pairs["image"].shape),
    "same_rows": all(torch.equal(pairs[k], plain[k]) for k in ("waveform", "depth")),
    "head_weight": float(weights["head.weight"]),
    "change": out["change"], "grad": sorted(out["grad"]), "loss": out["loss"],
    "bn": sorted(out["bn"]),
    "flops": [flops.model_flops(cfg), flops.train_flops_per_pair(cfg)]}))
'''


def test_a_family_joins_by_new_files(tmp_path):
    root = tmp_path / "checkout"
    bench = root / "benchmark"
    shutil.copytree(BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(bench): p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    (bench / "reference" / "families" / "toy_echo.py").write_text(TOY_REFERENCE)
    (bench / "flops" / "families" / "toy_echo.py").write_text(TOY_FLOPS)
    (bench / "configs" / "toy_echo.json").write_text(json.dumps(TOY_CONFIG))
    (bench / "limits" / "toy-train-cached.json").write_text(
        json.dumps({"numbers": {"change_gap": {"limit": 0.3}}}))
    with open(BENCH_DIR.parent / "BENCHMARK.json") as f:
        spec = json.load(f)
    spec["configs"].append({"name": "toy_echo", "file": "benchmark/configs/toy_echo.json"})
    spec["workloads"].append({"name": "toy-train-cached", "config": "toy_echo",
                              "traffic": "cached-b64", "chips": 1})
    (bench / "BENCHMARK.toy.json").write_text(json.dumps(spec))
    (tmp_path / "drive.py").write_text(textwrap.dedent(DRIVE))
    run = subprocess.run([sys.executable, str(tmp_path / "drive.py"), str(root)],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert run.returncode == 0, run.stderr
    got = json.loads(run.stdout.strip().splitlines()[-1])
    # no file that was there changed
    assert all(p.read_bytes() == data for p, data in
               ((bench / rel, data) for rel, data in before.items()))
    assert all(m.startswith(str(bench)) for m in got["modules"])
    assert got["keys"] == ["depth", "image", "waveform"] and got["image"] == [8, 32, 32, 3]
    assert got["same_rows"]
    assert got["head_weight"] != 1.0            # drawn by the family's own rule, not "ones"
    frozen = {n: c for n, c in got["change"].items() if n.startswith("teacher.")}
    assert sorted(frozen) == ["teacher.bias", "teacher.weight"]
    assert all(c == 0.0 for c in frozen.values())
    assert all(c > 0.0 for n, c in got["change"].items() if n not in frozen)
    assert got["grad"] == sorted(n for n in got["change"] if n not in frozen)
    assert got["bn"] == ["norm"] and len(got["loss"]) == 2
    s, c = 32, 4
    teacher = 2.0 * s * s * 3 * 3
    forward = 2.0 * (s * s * 5 * c * 9 + s * s * c * 9 + s * s) + teacher
    assert got["flops"] == [forward, 3.0 * (forward - teacher) + teacher]
