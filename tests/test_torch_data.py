"""The port's data path against the JAX package's, on fabricated trees.

Every comparison here is bit for bit: the loaders are numpy on both sides,
the native decoders are copies of one C++ source, and the prefetch and the
device cache only move bytes.
  * `resize_nearest_cv2_np` equals the JAX one at odd sizes;
  * BV2 and BV1 rows (after the scan, the blacklist and
    `filter_by_audio_path`), samples and `batches()` (shuffle on and off,
    drop_last on and off, native and Python) equal the JAX loaders';
  * the port's `decode_wav_i16`, `load_depth_u16` and `assemble_batch`
    equal the JAX `native_io`'s over the WAV formats and depth dtypes of
    tests/test_native_io.py, native batches equal the Python path after
    `encode_batch`, a missing file raises, and a source that does not
    compile raises with g++'s output (nothing falls back);
  * `device_prefetch` and `DeviceDatasetCache` on the CPU yield the host
    batches, encoded.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from audiodepth_tpu.configs import load_config as jax_load_config
from audiodepth_tpu.data import batvision as jbv
from audiodepth_tpu.data import native_io as jnative
from audiodepth_tpu.ops.resize import resize_nearest_cv2_np as jax_resize_nearest

from audiodepth_tpu_torch.configs import load_config
from audiodepth_tpu_torch.data import batvision as bv
from audiodepth_tpu_torch.data import native_io
from audiodepth_tpu_torch.data.codec import encode_batch
from audiodepth_tpu_torch.data.device_cache import DeviceDatasetCache
from audiodepth_tpu_torch.data.prefetch import device_prefetch
from audiodepth_tpu_torch.ops.resize import resize_nearest_cv2_np

from tests.torch_bv_trees import write_bv1_tree, write_bv2_tree, write_wav, write_wav_fmt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


@pytest.fixture
def bv2_root(tmp_path):
    return write_bv2_tree(tmp_path, locations=("Hall", "Office", "room(1)"),
                          rows=(("train", 5), ("val", 2)))


@pytest.fixture
def bv1_root(tmp_path):
    return write_bv1_tree(tmp_path)


def _cfgs(name, root, size=64, **extra):
    overrides = {"dataset.dataset_dir": str(root), "dataset.images_size": size, **extra}
    return jax_load_config(name, overrides=overrides), load_config(name, overrides=overrides)


def _rows(jax_ds):
    return jax_ds.instances.astype(str).to_dict("records")


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# ---------------------------------------------------------------------------
# resize and loaders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("in_hw,out_hw", [((48, 64), (32, 32)), ((37, 53), (64, 64)),
                                          ((101, 7), (13, 29)), ((5, 5), (5, 5))])
def test_resize_nearest_matches_jax(in_hw, out_hw):
    x = np.random.default_rng(0).normal(size=(2,) + in_hw).astype(np.float32)
    got = resize_nearest_cv2_np(x, *out_hw)
    assert got.shape == (2,) + out_hw
    np.testing.assert_array_equal(got, jax_resize_nearest(x, *out_hw))


def test_bv2_rows_match_jax(bv2_root):
    jcfg, cfg = _cfgs("batvisionv2", bv2_root)
    want, got = jbv.BatvisionV2Dataset(jcfg, "train.csv"), bv.BatvisionV2Dataset(cfg, "train.csv")
    assert len(got) == len(want) == 15
    assert got.instances == _rows(want)
    jb = jbv.BatvisionV2Dataset(jcfg, "train.csv", location_blacklist=["Office", "room"])
    b = bv.BatvisionV2Dataset(cfg, "train.csv", location_blacklist=["Office", "room"])
    assert b.instances == _rows(jb) and len(b) == 10  # exact names: 'room' keeps 'room(1)'
    for sub in ("Hall", "room(1)", "n+o(n.e", "audio"):
        assert (got.filter_by_audio_path(sub).instances
                == _rows(want.filter_by_audio_path(sub))), sub
    assert len(got.filter_by_audio_path("room(1)")) == 5


def test_bv2_missing_csv_warns_and_skips(bv2_root, capsys):
    (bv2_root / "Empty").mkdir()
    _, cfg = _cfgs("batvisionv2", bv2_root)
    assert len(bv.BatvisionV2Dataset(cfg, "train.csv")) == 15
    out = capsys.readouterr().out
    assert "skipping location Empty" in out and "__pycache__" not in out
    with pytest.raises(ValueError, match="No valid locations"):
        bv.BatvisionV2Dataset(cfg, "absent.csv")


@pytest.mark.parametrize("size", [64, 37])
def test_bv2_samples_match_jax(bv2_root, size):
    jcfg, cfg = _cfgs("batvisionv2", bv2_root, size=size)
    want, got = jbv.BatvisionV2Dataset(jcfg, "train.csv"), bv.BatvisionV2Dataset(cfg, "train.csv")
    assert got.wave_len == want.wave_len == 7782
    for i in range(len(want)):
        w, g = want.sample(i), got.sample(i)
        assert set(g) == set(w) == {"depth", "waveform"}
        assert g["depth"].shape == (size, size, 1) and g["waveform"].shape == (2, 7782)
        for k in w:
            assert g[k].dtype == w[k].dtype == np.float32
            np.testing.assert_array_equal(g[k], w[k])


def test_bv2_ignores_depth_norm_like_jax(bv2_root):
    jcfg, cfg = _cfgs("batvisionv2", bv2_root, **{"dataset.depth_norm": True})
    got = next(bv.BatvisionV2Dataset(cfg, "train.csv").batches(4, shuffle=False))
    want = next(jbv.BatvisionV2Dataset(jcfg, "train.csv").batches(4, shuffle=False))
    np.testing.assert_array_equal(got["depth"], want["depth"])
    assert got["depth"].max() > 65535 / 30 * 2  # meters in the codec, not [0, 1]


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (True, False), (False, True),
                                               (False, False)])
def test_bv2_batches_match_jax(bv2_root, native, shuffle, drop_last):
    jcfg, cfg = _cfgs("batvisionv2", bv2_root, size=32)
    want = list(jbv.BatvisionV2Dataset(jcfg, "train.csv").batches(
        4, shuffle=shuffle, seed=7, drop_last=drop_last, native=native))
    got = list(bv.BatvisionV2Dataset(cfg, "train.csv").batches(
        4, shuffle=shuffle, seed=7, drop_last=drop_last, native=native))
    assert len(got) == (3 if drop_last else 4)
    _assert_batches_equal(got, want)
    if native:
        assert got[0]["waveform"].dtype == np.int16 and got[0]["depth"].dtype == np.uint16


def test_bv2_native_batches_equal_python_path_encoded(bv2_root):
    _, cfg = _cfgs("batvisionv2", bv2_root)
    ds = bv.BatvisionV2Dataset(cfg, "train.csv")
    nat = list(ds.batches(4, seed=3, drop_last=False))
    py = [encode_batch(b, 30.0) for b in ds.batches(4, seed=3, drop_last=False, native=False)]
    for n, p in zip(nat, py):
        np.testing.assert_array_equal(n["waveform"], p["waveform"])
        np.testing.assert_array_equal(n["depth"], p["depth"])
        np.testing.assert_array_equal(p["waveform_scale"], 1.0)


def test_bv2_images_are_refused_naming_a5(bv2_root):
    _, cfg = _cfgs("batvisionv2", bv2_root)
    for use_image in (True, "both"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md A5"):
            bv.BatvisionV2Dataset(cfg, "train.csv", use_image=use_image)


def test_bv1_rows_and_samples_match_jax(bv1_root, capsys):
    jcfg, cfg = _cfgs("batvisionv1", bv1_root, size=32)
    want, got = jbv.BatvisionV1Dataset(jcfg, "train.csv"), bv.BatvisionV1Dataset(cfg, "train.csv")
    assert got.instances == _rows(want) and len(got) == 3
    for i in range(3):
        w, g = want.sample(i), got.sample(i)
        assert list(g) == list(w) == ["waveform", "depth"]
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
        assert np.isfinite(g["depth"]).all() and g["depth"].max() <= 1.0  # depth_norm on BV1
    jb = jbv.BatvisionV1Dataset(jcfg, "train.csv", location_blacklist=["seqA"])
    b = bv.BatvisionV1Dataset(cfg, "train.csv", location_blacklist=["seqA"])
    assert b.instances == _rows(jb) and len(b) == 1
    assert "filtered 2 instances" in capsys.readouterr().out
    for drop_last in (True, False):
        _assert_batches_equal(list(got.batches(2, seed=5, drop_last=drop_last)),
                              list(want.batches(2, seed=5, drop_last=drop_last)))


def test_bv1_holdout_clone_pins_the_parent_wave_len(tmp_path):
    root = write_bv1_tree(tmp_path, lengths=(("seqA", 4000), ("seqA", 4000), ("seqB", 3000)))
    jcfg, cfg = _cfgs("batvisionv1", root, size=16)
    ds = bv.BatvisionV1Dataset(cfg, "train.csv")
    holdout = ds.filter_by_audio_path("seqB")  # cloned before wave_len is read
    assert holdout.wave_len == ds.wave_len == 4000
    want = jbv.BatvisionV1Dataset(jcfg, "train.csv").filter_by_audio_path("seqB").sample(0)
    got = holdout.sample(0)
    assert got["waveform"].shape == (2, 4000)
    np.testing.assert_array_equal(got["waveform"], want["waveform"])


def test_make_dataset_builds_each_corpus(bv2_root, tmp_path_factory):
    _, cfg = _cfgs("batvisionv2", bv2_root)
    assert isinstance(bv.make_dataset(cfg, "val"), bv.BatvisionV2Dataset)
    assert len(bv.make_dataset(cfg, "val")) == 6
    bv1 = write_bv1_tree(tmp_path_factory.mktemp("bv1"))
    _, cfg1 = _cfgs("batvisionv1", bv1)
    assert isinstance(bv.make_dataset(cfg1, "train"), bv.BatvisionV1Dataset)


# ---------------------------------------------------------------------------
# the native decoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["pcm16", "pcm24", "pcm32", "f32", "ext_pcm16"])
def test_native_wav_decode_matches_jax(tmp_path, fmt):
    data = np.random.default_rng(len(fmt)).uniform(-0.9, 0.9, size=(2, 3000)).astype(np.float32)
    path = str(tmp_path / f"x_{fmt}.wav")
    write_wav_fmt(path, data, fmt)
    for fixed_len in (2000, 3500):
        got = native_io.decode_wav_i16(path, fixed_len)
        assert got.shape == (2, fixed_len) and got.dtype == np.int16
        np.testing.assert_array_equal(got, jnative.decode_wav_i16(path, fixed_len))


@pytest.mark.parametrize("depth_norm", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.uint16, np.int16])
def test_native_depth_load_matches_jax(tmp_path, depth_norm, dtype):
    depth_mm = np.random.default_rng(2).uniform(-100, 40000, size=(48, 64))
    if np.issubdtype(dtype, np.integer):
        depth_mm = np.clip(depth_mm, np.iinfo(dtype).min, np.iinfo(dtype).max)
    else:
        depth_mm[0, 0], depth_mm[0, 1] = np.nan, np.inf
    path = str(tmp_path / "d.npy")
    np.save(path, depth_mm.astype(dtype))
    for hw in ((32, 32), (37, 53)):
        got = native_io.load_depth_u16(path, hw, 30.0, depth_norm)
        np.testing.assert_array_equal(got, jnative.load_depth_u16(path, hw, 30.0, depth_norm))


def test_native_assemble_batch_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    wavs, depths = [], []
    for i in range(5):
        write_wav(tmp_path / f"w{i}.wav", rng.uniform(-0.5, 0.5, size=(2, 3000 + 700 * i)))
        np.save(tmp_path / f"d{i}.npy", rng.uniform(0, 35000, size=(48, 64)).astype(np.float32))
        wavs.append(str(tmp_path / f"w{i}.wav"))
        depths.append(str(tmp_path / f"d{i}.npy"))
    kw = dict(fixed_len=4096, out_hw=(32, 32), max_depth=30.0, depth_norm=False, n_threads=3)
    got_w, got_d = native_io.assemble_batch(wavs, depths, **kw)
    want_w, want_d = jnative.assemble_batch(wavs, depths, **kw)
    assert got_w.shape == (5, 2, 4096) and got_d.shape == (5, 32, 32, 1)
    np.testing.assert_array_equal(got_w, want_w)
    np.testing.assert_array_equal(got_d, want_d)
    none_w, only_d = native_io.assemble_batch(None, depths, **kw)
    assert none_w is None
    np.testing.assert_array_equal(only_d, want_d)


def test_native_missing_file_raises(tmp_path):
    with pytest.raises(IOError):
        native_io.decode_wav_i16(str(tmp_path / "absent.wav"), 100)
    with pytest.raises(IOError):
        native_io.load_depth_u16(str(tmp_path / "absent.npy"), (8, 8), 30.0, False)
    with pytest.raises(IOError):
        native_io.assemble_batch([str(tmp_path / "absent.wav")], [str(tmp_path / "a.npy")],
                                 100, (8, 8), 30.0, False)


def test_native_failed_build_raises_with_the_compiler_output(tmp_path):
    broken = tmp_path / "adepth_io.cpp"
    broken.write_text(native_io.SRC.read_text() + "\nthis is not C++;\n")
    out_dir = tmp_path / "build"
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error: expected"):
        native_io.build(broken, out_dir)
    assert not any(out_dir.glob("*.so"))  # nothing half-built is left to load


def test_native_library_is_keyed_by_source_and_built_outside_the_package(tmp_path):
    lib = native_io.build()
    assert lib.exists() and lib.parent == native_io.BUILD_DIR
    assert lib.parent == __import__("pathlib").Path(REPO) / "build" / "native"
    assert not any((native_io.SRC.parent).glob("*.so"))
    edited = tmp_path / "adepth_io.cpp"
    edited.write_text(native_io.SRC.read_text() + "\n// edited\n")
    assert native_io.library_path(edited).name != lib.name


# ---------------------------------------------------------------------------
# prefetch and the device cache on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("encode_units", [None, 30.0])
def test_device_prefetch_cpu_yields_every_batch_in_order(bv2_root, encode_units):
    _, cfg = _cfgs("batvisionv2", bv2_root, size=32)
    ds = bv.BatvisionV2Dataset(cfg, "train.csv")
    host = list(ds.batches(4, seed=1, drop_last=False, native=False))
    got = list(device_prefetch(iter(host), "cpu", size=2, encode_units=encode_units))
    want = [encode_batch(b, encode_units) if encode_units else b for b in host]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), w[k])
    tensors = [{k: torch.from_numpy(v) for k, v in w.items()} for w in want]
    passed = list(device_prefetch(iter(tensors), "cpu"))
    assert all(p[k] is t[k] for p, t in zip(passed, tensors) for k in t)


def test_device_cache_batches_match_host_path(bv2_root):
    _, cfg = _cfgs("batvisionv2", bv2_root, size=32)
    ds = bv.BatvisionV2Dataset(cfg, "train.csv")
    cache = DeviceDatasetCache(ds, 30.0, "cpu")
    assert cache.n == 15
    assert cache.nbytes() == 15 * (2 * 7782 * 2 + 32 * 32 * 2 + 4)
    for shuffle, drop_last in ((True, True), (False, False)):
        got = list(cache.batches(4, shuffle=shuffle, seed=11, drop_last=drop_last))
        py = [encode_batch(b, 30.0) for b in
              ds.batches(4, shuffle=shuffle, seed=11, drop_last=drop_last, native=False)]
        nat = list(ds.batches(4, shuffle=shuffle, seed=11, drop_last=drop_last))
        assert len(got) == len(py) == len(nat)
        for g, p, n in zip(got, py, nat):
            assert g["depth"].dtype == torch.uint16 and g["waveform"].dtype == torch.int16
            for k in p:
                np.testing.assert_array_equal(g[k].numpy(), p[k], err_msg=k)
            for k in n:
                np.testing.assert_array_equal(g[k].numpy(), n[k], err_msg=k)
