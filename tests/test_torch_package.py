"""Package rules of the port, checked on a host without a card.

  * every module of `audiodepth_tpu_torch` imports with jax, flax, optax
    and the JAX package blocked (by exact top-level name: a prefix check on
    "audiodepth_tpu" would also match the port);
  * an entry point called without device="cpu" raises here rather than
    running on the CPU;
  * the fused front end's wrapper sends a CPU tensor to the plain version
    and launches nothing;
  * the port's own copy of the config system gives the JAX package's
    configs, field for field.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from audiodepth_tpu_torch.configs import load_config
from audiodepth_tpu_torch.models import make_task
from audiodepth_tpu_torch.ops.cuda.fused_frontend import (
    fused_mel_frontend, fused_mel_frontend_plain)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = {"jax", "jaxlib", "flax", "optax", "orbax", "audiodepth_tpu", "triton"}

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import audiodepth_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(len(names))
"""


def test_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15  # every module was walked


def test_entry_points_need_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = load_config("batvisionv2", "test", overrides={
        "model.generator": "unet_128", "model.ngf": 4})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_task(cfg)
    with pytest.raises(RuntimeError):
        make_task(cfg, device="cuda")
    assert make_task(cfg, device="cpu").device.type == "cpu"


def test_unported_family_names_its_roadmap_item():
    cfg = load_config("batvisionv2", "test", model_name="binaural_attention")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        make_task(cfg, device="cpu")


def test_fused_wrapper_cpu_goes_to_plain_version():
    wave = torch.from_numpy(
        np.random.default_rng(0).normal(size=(1, 2, 7782)).astype(np.float32))
    before = fused_mel_frontend.launches
    got = fused_mel_frontend(wave)
    assert fused_mel_frontend.launches == before
    assert torch.equal(got, fused_mel_frontend_plain(wave))
    assert got.shape == (1, 2, 32, 244)
    assert float(got.min()) == 0.0 and float(got.max()) == 1.0


@pytest.mark.parametrize("bad,err", [
    (torch.zeros(2, 7782), ValueError),                    # not [B, C, L]
    (torch.zeros(1, 2, 7782, dtype=torch.float64), TypeError),
    (torch.zeros(1, 2, 200), ValueError),                  # L <= n_fft // 2
])
def test_fused_wrapper_rejects_bad_input(bad, err):
    with pytest.raises(err):
        fused_mel_frontend(bad)


@pytest.mark.parametrize("dataset,mode,model", [
    ("batvisionv2", "test", "unet_baseline"), ("batvisionv1", "train", "unet_baseline"),
    ("synthetic", "train", "binaural_attention"), ("batvisionv2", "test", "rgb_depth"),
])
def test_config_copy_matches_jax(dataset, mode, model):
    from audiodepth_tpu.configs import load_config as jax_load_config
    from audiodepth_tpu_torch.configs import resolve_compute_dtype

    overrides = {"model.ngf": "16", "mode.compute_dtype": "float64",
                 "model.attention_levels": "3,4"}
    want = jax_load_config(dataset, mode, "x", model, overrides=overrides)
    got = load_config(dataset, mode, "x", model, overrides=overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert resolve_compute_dtype(got) == torch.float64
    assert resolve_compute_dtype("bfloat16") == torch.bfloat16
    assert resolve_compute_dtype("float32") == torch.float32
