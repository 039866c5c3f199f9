"""Package rules of the port, checked on a host without a card.

  * every module of `audiodepth_tpu_torch` imports with jax, flax, optax
    and the JAX package blocked (by exact top-level name: a prefix check on
    "audiodepth_tpu" would also match the port), the training slice's
    modules among them, and the data-parallel ones (`parallel`);
  * the corpus path's modules (the loaders, the native decoder, prefetch,
    the device cache, the metric sink, both CLIs, the sparse datasets and
    the sparse-depth preprocessor, which imports OpenCV in its functions)
    import with pandas, OpenCV and matplotlib blocked as well: the card's
    machine may lack them;
  * an entry point called without device="cpu" raises here rather than
    running on the CPU, the tools' CLIs (export, profile_step,
    verify_contracts) among them;
  * the fused front end's wrapper sends a CPU tensor to the plain version
    and launches nothing;
  * the port's own copy of the config system gives the JAX package's
    configs, field for field, and the experiment names that key
    checkpoints.
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
BLOCKED |= set(sys.argv[1:])

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
print(" ".join(names))
"""

# the modules of the training slice, which must be among those walked
_TRAINING_SLICE = {
    "cli.train", "data.batvision", "data.codec", "data.synthetic", "losses",
    "losses.basic", "losses.binaural", "metrics", "metrics.errors", "train.engine",
    "train.optim", "train.tasks", "train.tasks_extra", "ops.cuda.flash_attention",
    "ckpt", "cli.serve", "configs.config", "ops.cuda.fused_frontend",
    "models.base_residual", "models.unet_cvae", "models.rgb_depth", "models.adabins",
    "losses.base_residual", "losses.distillation", "models.coarse_depth", "models.legacy",
    "losses.coarse", "data.bins", "train.tasks_coarse", "tools.import_jax",
}
# the tools and the last family pieces
_TOOLS_SLICE = {"tools.export", "tools.profile_step", "tools.verify_contracts", "obs.logging",
                "obs.visualize", "models.adabins", "models.unet_cvae", "ops.cuda"}
# the data-parallel modules
_PARALLEL_SLICE = {"parallel", "parallel.mesh", "parallel.multihost", "train.engine", "ckpt",
                   "data.device_cache", "cli.train"}
# the corpus path's modules
_CORPUS_SLICE = {
    "data.batvision", "data.native_io", "data.prefetch", "data.device_cache", "obs",
    "obs.logging", "obs.visualize", "cli.train", "cli.evaluate", "data.sparse_depth",
    "data.bins", "tools.preprocess_sparse_depth", "train.tasks_coarse", "models.coarse_depth",
}


def test_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    walked = {n.split(".", 1)[1] for n in out.stdout.split()}
    assert len(walked) >= 48  # every module was walked
    slices = _TRAINING_SLICE | _CORPUS_SLICE | _TOOLS_SLICE | _PARALLEL_SLICE
    assert slices <= walked, slices - walked


def test_corpus_path_imports_without_pandas_opencv_matplotlib():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL, "pandas", "cv2", "matplotlib"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    walked = {n.split(".", 1)[1] for n in out.stdout.split()}
    assert _CORPUS_SLICE <= walked, _CORPUS_SLICE - walked


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


def test_tools_need_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from audiodepth_tpu_torch.tools import export, profile_step, verify_contracts

    with pytest.raises(RuntimeError, match="device='cpu'"):
        profile_step.main(["--batch_size", "2", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export.main(["--model", "unet_baseline"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        verify_contracts.main([])


def test_unported_family_names_its_roadmap_item():
    """Every family of the reference is ported: what make_task still refuses
    is spline_depth, dead config in the reference, and unknown names."""
    cfg = load_config("batvisionv2", "test", model_name="spline_depth")
    with pytest.raises(NotImplementedError, match="dead config in the reference"):
        make_task(cfg, device="cpu")
    cfg = load_config("batvisionv2", "test", model_name="no_such_family")
    with pytest.raises(NotImplementedError, match="'no_such_family' not registered"):
        make_task(cfg, device="cpu")


@pytest.mark.parametrize("name,task_cls,model_cls", [
    ("base_residual", "BaseResidualTask", "BaseResidualNet"),
    ("unet_cvae", "UNetCVAETask", "UNetCVAE"),
    ("rgb_depth", "RGBDepthTask", "RGBDepthNet"),
    ("adabins_distillation", "AdaBinsDistillationTask", "AdaBinsDistillationModel"),
    ("coarse_depth", "CoarseDepthTask", "CoarseDepthUNet"),
])
def test_registry_builds_and_seeds_the_families(name, task_cls, model_cls):
    """Each family's task and model, on the CPU when asked for, seeded by
    `init_weights` the same from the same seed; the families that draw
    random numbers hold a generator on the task's device."""
    from audiodepth_tpu_torch import models

    cfg = load_config("synthetic", "train", model_name=name, overrides={
        "model.base_channels": 4, "model.ngf": 2, "model.generator": "unet_128",
        "model.n_bins": 8, "dataset.images_size": 128})
    a, b = make_task(cfg, device="cpu"), make_task(cfg, device="cpu")
    assert type(a).__name__ == task_cls and type(a.model).__name__ == model_cls
    assert isinstance(a.model, getattr(models, model_cls)) and a.name == name
    for task in (a, b):
        models.init_weights(task.model, torch.Generator().manual_seed(4))
    for (k, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), k
    assert (a.generator is not None) == (name in ("unet_cvae", "adabins_distillation"))
    if a.generator is not None:
        assert a.generator.device.type == "cpu"


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


@pytest.mark.parametrize("dataset,model,overrides", [
    ("batvisionv2", "unet_baseline", {}), ("batvisionv1", "unet_baseline", {}),
    ("synthetic", "binaural_attention", {"mode.batch_size": 16}),
])
def test_experiment_name_copy_matches_jax(dataset, model, overrides):
    from audiodepth_tpu.configs import experiment_name as jax_experiment_name
    from audiodepth_tpu.configs import load_config as jax_load_config
    from audiodepth_tpu_torch.configs import experiment_name

    want = jax_load_config(dataset, "train", "x", model, overrides=overrides)
    got = load_config(dataset, "train", "x", model, overrides=overrides)
    assert experiment_name(got, "IMG") == jax_experiment_name(want, "IMG")
    assert experiment_name(got) == jax_experiment_name(want)
