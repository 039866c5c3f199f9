"""The check for JAX and the JAX package compares whole top-level names."""

import subprocess
import sys

from harness.guard import forbidden_modules
from harness.spec import BENCH_DIR


def test_top_level_names_whole():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "audiodepth_tpu",
             "audiodepth_tpu.ops.pallas", "audiodepth_tpu_torch", "audiodepth_tpu_torch.ops",
             "jaxtyping", "flaxen", "numpy", "torch"]
    assert forbidden_modules(names) == ["audiodepth_tpu", "audiodepth_tpu.ops.pallas", "flax.linen",
                                        "jax", "jax.numpy", "jaxlib.xla_client"]


def test_the_port_and_the_harness_load_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import harness.cell, harness.serve, harness.train, harness.client, reference, flops\n"
            "import audiodepth_tpu_torch.cli.serve, audiodepth_tpu_torch.train.engine\n"
            "from harness.guard import forbidden_modules\n"
            "print(forbidden_modules())" % (str(BENCH_DIR.parent), str(BENCH_DIR)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_a_card_or_without_the_port(tmp_path):
    """Without a card the run exits 2 and prints no result; in a directory
    that holds only the benchmark it exits non-zero."""
    import shutil

    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH_DIR.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    cmd = [sys.executable, "benchmark/run.py", "--workload", "unet256-train-b256-cached",
           "--seed", "3000000001", "--seconds", "1", "--trace", "0"]
    alone = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert alone.returncode != 0 and alone.stdout.strip() == ""
    import torch

    if not torch.cuda.is_available():
        here = subprocess.run(cmd, cwd=BENCH_DIR.parent, capture_output=True, text=True,
                              timeout=300)
        assert here.returncode == 2 and here.stdout.strip() == ""
