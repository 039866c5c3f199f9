"""The port's sparse-depth workflow against the JAX package, on the CPU.

  * `tools/preprocess_sparse_depth.py`: every method of `parse_method`
    (downup, superpixel with the built-in SLIC, sp_extreme, sp_hier,
    quantized, grid, blur) writes the JAX tool's files bit for bit on a
    small fabricated tree with holes;
  * `ops/resize.py::resize_bilinear_np` equals the JAX package's bit for bit;
  * on a fabricated BatVision V2 tree with one location lacking its
    `sparse_depth_{method}/` folder: the sparse datasets' rows (and the
    scan's warnings), samples (with `use_original_depth`) and binned
    samples and batches are bit-equal to JAX's, the location blacklist
    included;
  * `cli.train --model coarse_depth --sparse_method downup_015` trains two
    steps on the CPU streamed and with --device_cache, a location held out:
    the bins each step receives are the host dataset's, both paths agree,
    and no holdout loader is built (as in the JAX CLI).
"""

from __future__ import annotations

import shutil

import numpy as np
import pytest

from audiodepth_tpu.configs import load_config as jax_load_config
from audiodepth_tpu.data import sparse_depth as jsparse
from audiodepth_tpu.ops.resize import resize_bilinear_np as jax_resize_bilinear_np
from audiodepth_tpu.tools import preprocess_sparse_depth as jtool

from audiodepth_tpu_torch.cli import train as train_cli
from audiodepth_tpu_torch.configs import load_config
from audiodepth_tpu_torch.data import sparse_depth
from audiodepth_tpu_torch.ops.resize import resize_bilinear_np
from audiodepth_tpu_torch.tools import preprocess_sparse_depth as tool
from audiodepth_tpu_torch.train.engine import Engine

from tests.torch_bv_trees import write_bv2_tree
from tests.torch_parity import one_torch_thread  # noqa: F401

METHODS = ("downup_015", "superpixel_12", "sp_extreme_6_2", "sp_hier_20_8_4", "quantized_8",
           "grid_8", "blur_3_2")


def _depth_tree(root, seed=0):
    """One location of three 24×32 depth maps in mm with holes (≤ 0, NaN)."""
    rng = np.random.default_rng(seed)
    (root / "Hall" / "depth").mkdir(parents=True)
    for i in range(3):
        d = rng.uniform(-300, 12000, (24, 32)).astype(np.float32)
        d[3, 4] = np.nan
        np.save(root / "Hall" / "depth" / f"depth_{i}.npy", d)
    return root


@pytest.mark.parametrize("method", METHODS)
def test_preprocess_writes_the_jax_tools_files(method, tmp_path, capsys):
    port_root = _depth_tree(tmp_path / "port")
    jax_root = tmp_path / "jax"
    shutil.copytree(port_root, jax_root)
    tool.main(["--dataset_dir", str(port_root), "--method", method])
    jtool.main(["--dataset_dir", str(jax_root), "--method", method])
    out = capsys.readouterr().out
    assert out.count("Hall: 3 files") == 2
    folder = f"sparse_depth_{method}"
    names = sorted(p.name for p in (port_root / "Hall" / folder).iterdir())
    assert names == sorted(p.name for p in (jax_root / "Hall" / folder).iterdir())
    assert names == ["depth_0.npy", "depth_1.npy", "depth_2.npy"]
    for name in names:
        got = np.load(port_root / "Hall" / folder / name)
        want = np.load(jax_root / "Hall" / folder / name)
        assert got.dtype == want.dtype == np.float32 and np.isfinite(got).all()
        np.testing.assert_array_equal(got, want)


def test_resize_bilinear_np_bit_equal_to_jax():
    x = np.random.default_rng(1).uniform(0, 30, (2, 48, 64)).astype(np.float32)
    for size in ((32, 32), (64, 96), (48, 64)):
        got, want = resize_bilinear_np(x, *size), jax_resize_bilinear_np(x, *size)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def sparse_tree(tmp_path_factory):
    """A BV2 tree with depth_*.npy, sparse_depth_downup_015/ in Hall and
    Office (written by the port's tool) and none in Stairs."""
    root = tmp_path_factory.mktemp("bv2")
    write_bv2_tree(root, locations=("Hall", "Office", "Stairs"),
                   rows=(("train", 4), ("val", 2)), depth_prefix="depth_")
    tool.main(["--dataset_dir", str(root), "--method", "downup_015",
               "--sequences", "Hall", "Office"])
    return root


def _cfgs(root, **extra):
    ov = {"dataset.dataset_dir": str(root), "dataset.images_size": 32, **extra}
    return (load_config("batvisionv2", "train", model_name="coarse_depth", overrides=ov),
            jax_load_config("batvisionv2", "train", model_name="coarse_depth", overrides=ov))


@pytest.mark.parametrize("blacklist,depth_norm", [(None, False), (("Office",), True)])
def test_sparse_datasets_bit_equal_to_jax(sparse_tree, blacklist, depth_norm, capsys):
    cfg, jcfg = _cfgs(sparse_tree, **{"dataset.depth_norm": depth_norm})
    kwargs = dict(use_original_depth=True, location_blacklist=blacklist)
    ds = sparse_depth.SparseDepthDataset(cfg, "train.csv", **kwargs)
    port_out = capsys.readouterr().out
    jds = jsparse.SparseDepthDataset(jcfg, "train.csv", **kwargs)
    assert port_out == capsys.readouterr().out
    assert "sparse_depth_downup_015 not found, skipping Stairs" in port_out
    assert len(ds) == len(jds) == (4 if blacklist else 8)
    assert [r["location"] for r in ds.instances] == list(jds.instances["location"])
    for i in range(len(ds)):
        got, want = ds.sample(i), jds.sample(i)
        assert set(got) == set(want) == {"depth", "original_depth", "waveform"}
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    bkw = dict(kwargs, n_bins=16, bin_mode="sid", sid_alpha=0.5, depth_min=0.2)
    binned = sparse_depth.BinnedSparseDepthDataset(cfg, "val.csv", **bkw)
    jbinned = jsparse.BinnedSparseDepthDataset(jcfg, "val.csv", **bkw)
    np.testing.assert_array_equal(binned.bin_edges, jbinned.bin_edges)
    for got, want in zip(binned.batches(2, seed=3), jbinned.batches(2, seed=3)):
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["bins"].shape == (2, 32, 32) and got["bins"].max() < 16


def test_sparse_scan_without_any_folder_raises(tmp_path):
    write_bv2_tree(tmp_path, rows=(("train", 1),))
    cfg, _ = _cfgs(tmp_path)
    with pytest.raises(ValueError, match="No valid locations with sparse_depth_downup_015"):
        sparse_depth.SparseDepthDataset(cfg, "train.csv")


def test_cli_trains_sparse_coarse_streamed_and_cached(sparse_tree, monkeypatch):
    argv = ["--device", "cpu", "--dataset", "batvisionv2", "--dataset_dir", str(sparse_tree),
            "--model", "coarse_depth", "--model_type", "hybrid", "--sparse_method",
            "downup_015", "--base_channels", "4", "--n_bins", "8", "--override",
            "dataset.images_size=32", "--batch_size", "2", "--epochs", "1",
            "--validation_iter", "1", "--holdout_locations", "Office", "--no_visualize"]
    runs = {}
    for name, extra in (("streamed", ["--use_original_depth"]), ("cached", ["--device_cache"])):
        received = []
        orig = Engine.train_step

        def spy(eng, state, batch, epoch=0.0):
            received.append({k: np.array(v) for k, v in batch.items()})
            return orig(eng, state, batch, epoch)

        monkeypatch.setattr(Engine, "train_step", spy)
        eng, state = train_cli.main(argv + extra)
        monkeypatch.setattr(Engine, "train_step", orig)
        (record,) = eng.history
        assert state.step == 2 and len(received) == 2 and "holdout" not in record
        assert {"loss", "ce", "regression", "offset_reg", "coarse_l1"} <= set(record)
        assert np.isfinite(record["loss"]) and np.isfinite(record["val"]["rmse"])
        runs[name] = received
    cfg = eng.task.cfg
    ds = sparse_depth.BinnedSparseDepthDataset(
        cfg, "train.csv", sparse_depth_method="downup_015", location_blacklist=["Office"],
        n_bins=8, bin_mode="sid")
    host = list(ds.batches(2, seed=2))  # epoch 1 draws seed·100003 + 2
    assert "original_depth" in runs["streamed"][0] and "original_depth" not in runs["cached"][0]
    for got, cached, want in zip(runs["streamed"], runs["cached"], host):
        assert got["bins"].dtype == cached["bins"].dtype == np.int32
        np.testing.assert_array_equal(got["bins"], want["bins"])
        np.testing.assert_array_equal(cached["bins"], want["bins"])
        np.testing.assert_array_equal(cached["depth"], got["depth"])
