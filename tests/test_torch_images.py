"""Camera images in the port: the BV2 image loaders against the JAX
package's, and the paths that read them, on fabricated trees.

  * BV2 samples and batches with `use_image` True (the image alone) and
    "both" (paired with the audio) equal the JAX loaders' bit for bit:
    `sample` (float32 image /255), the native batches (uint8 image, int16
    waveform, uint16 depth) and the Python batches, shuffled and not;
  * streamed through `device_prefetch` and cached in `DeviceDatasetCache`
    (on the CPU), the batches equal the JAX device cache's, and decode to
    the JAX codec's float32 image;
  * the image path needs OpenCV and says so when it does not import;
  * ADEPTH_IMAGE_THREADS sizes the image pool, as in the JAX package;
  * `cli.train --eval_img` trains the baseline on camera images under the
    JAX CLI's experiment name (with IMG), and `cli.evaluate --eval_img`
    scores its checkpoint on images; BatVision V1, which has no camera,
    is refused by both;
  * adabins_distillation trains on paired batches from the tree, and its
    checkpoint, which holds the teacher, is evaluated and served on audio
    alone; rgb_depth trains from the tree and is evaluated on images;
    `serve` refuses it.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from audiodepth_tpu.configs import experiment_name as jax_experiment_name
from audiodepth_tpu.configs import load_config as jax_load_config
from audiodepth_tpu.data import batvision as jbv
from audiodepth_tpu.data import codec as jcodec
from audiodepth_tpu.data.device_cache import DeviceDatasetCache as JaxCache

from audiodepth_tpu_torch.cli import evaluate as evaluate_cli
from audiodepth_tpu_torch.cli import serve
from audiodepth_tpu_torch.cli import train as train_cli
from audiodepth_tpu_torch.configs import experiment_name, load_config
from audiodepth_tpu_torch.data import batvision as bv
from audiodepth_tpu_torch.data.codec import decode_batch
from audiodepth_tpu_torch.data.device_cache import DeviceDatasetCache
from audiodepth_tpu_torch.data.prefetch import device_prefetch
from audiodepth_tpu_torch.metrics import METRIC_NAMES

from tests.torch_bv_trees import write_bv2_tree
from tests.torch_parity import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_bv2_tree(tmp_path_factory.mktemp("bv2"), locations=("Hall", "Office"),
                          rows=(("train", 4), ("val", 2), ("test", 3)), camera_hw=(48, 64))


def _cfgs(root, size=32):
    overrides = {"dataset.dataset_dir": str(root), "dataset.images_size": size}
    return (jax_load_config("batvisionv2", overrides=overrides),
            load_config("batvisionv2", overrides=overrides))


def _assert_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("use_image", [True, "both"])
def test_bv2_image_samples_and_batches_match_jax(tree, use_image):
    jcfg, cfg = _cfgs(tree)
    want = jbv.BatvisionV2Dataset(jcfg, "train.csv", use_image=use_image)
    got = bv.BatvisionV2Dataset(cfg, "train.csv", use_image=use_image)
    keys = {"depth", "image"} | ({"waveform"} if use_image == "both" else set())
    for i in range(len(want)):
        g = got.sample(i)
        assert set(g) == keys and g["image"].shape == (32, 32, 3)
        _assert_equal(g, want.sample(i))
    for native in (True, False):
        for shuffle in (True, False):
            gb = list(got.batches(3, shuffle=shuffle, seed=5, drop_last=False, native=native))
            wb = list(want.batches(3, shuffle=shuffle, seed=5, drop_last=False, native=native))
            assert len(gb) == len(wb) == 3
            for g, w in zip(gb, wb):
                _assert_equal(g, w)
            if native:
                assert gb[0]["image"].dtype == np.uint8


@pytest.mark.parametrize("threads", [1, 8])
def test_image_pool_width_follows_env_and_batches_match_jax(tree, threads, monkeypatch):
    """ADEPTH_IMAGE_THREADS sets the camera-image pool's width (default 8),
    as in the JAX package, and the image batches stay bit-equal to JAX's."""
    monkeypatch.setenv("ADEPTH_IMAGE_THREADS", str(threads))
    monkeypatch.setattr(jbv, "_IMAGE_POOL", None)
    bv._image_pool.cache_clear()
    try:
        assert bv._image_pool()._max_workers == threads
        jcfg, cfg = _cfgs(tree)
        got = bv.BatvisionV2Dataset(cfg, "train.csv", use_image="both")
        want = jbv.BatvisionV2Dataset(jcfg, "train.csv", use_image="both")
        gb = list(got.batches(3, seed=5, drop_last=False))
        wb = list(want.batches(3, seed=5, drop_last=False))
        assert jbv._image_pool()._max_workers == threads
        assert len(gb) == len(wb) == 3
        for g, w in zip(gb, wb):
            _assert_equal(g, w)
    finally:
        bv._image_pool.cache_clear()


@pytest.mark.parametrize("use_image", [True, "both"])
def test_image_batches_streamed_and_cached_match_jax(tree, use_image):
    jcfg, cfg = _cfgs(tree)
    want_cache = JaxCache(jbv.BatvisionV2Dataset(jcfg, "train.csv", use_image=use_image),
                          max_depth_units=30.0)
    ds = bv.BatvisionV2Dataset(cfg, "train.csv", use_image=use_image)
    cache = DeviceDatasetCache(ds, 30.0, "cpu")
    assert cache.arrays["image"].dtype == torch.uint8
    for got, want in zip(cache.batches(4, seed=3), want_cache.batches(4, seed=3)):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    host = list(ds.batches(4, seed=3, native=False))
    streamed = list(device_prefetch(iter(host), "cpu", encode_units=30.0))
    for got, h in zip(streamed, host):
        enc = jcodec.encode_batch(h, 30.0)
        assert set(got) == set(enc)
        for k in enc:
            np.testing.assert_array_equal(got[k].numpy(), enc[k], err_msg=k)
        want_img = jcodec.decode_batch({"image": jnp.asarray(enc["image"])}, 30.0)["image"]
        np.testing.assert_array_equal(decode_batch(dict(got), 30.0)["image"].numpy(),
                                      np.asarray(want_img))
        np.testing.assert_array_equal(decode_batch(dict(got), 30.0)["image"].numpy(),
                                      h["image"])  # the float32 /255 of the loader


def test_image_path_needs_opencv(tree, monkeypatch):
    _, cfg = _cfgs(tree)
    monkeypatch.setitem(sys.modules, "cv2", None)
    ds = bv.BatvisionV2Dataset(cfg, "train.csv", use_image=True)  # the scan needs no cv2
    with pytest.raises(ImportError, match="cv2"):
        ds.sample(0)
    with pytest.raises(ImportError, match="cv2"):
        next(ds.batches(2))
    assert set(bv.BatvisionV2Dataset(cfg, "train.csv").sample(0)) == {"depth", "waveform"}


def _train(tree, tmp_path, *flags):
    return train_cli.main(["--device", "cpu", "--dataset", "batvisionv2", "--dataset_dir",
                           str(tree), "--batch_size", "2", "--epochs", "1",
                           "--validation_iter", "1", "--ckpt_dir", str(tmp_path / "ck"),
                           "--no_visualize", *flags])


def _evaluate(tree, tmp_path, ckpt, *flags):
    return evaluate_cli.main(["--device", "cpu", "--dataset", "batvisionv2", "--dataset_dir",
                              str(tree), "--checkpoint_path", ckpt, "--use_best", "--eval_on",
                              "val", "--stat_dir", str(tmp_path / "eval"), *flags])


def test_eval_img_trains_and_evaluates_on_images(tree, tmp_path):
    shape = ["--generator", "unet_128", "--ngf", "2", "--override", "dataset.images_size=128"]
    seen = []
    eng, state = train_cli.main(
        ["--device", "cpu", "--dataset", "batvisionv2", "--dataset_dir", str(tree),
         "--batch_size", "2", "--epochs", "1", "--validation_iter", "1", "--ckpt_dir",
         str(tmp_path / "ck"), "--no_visualize", "--eval_img", *shape],
        on_task=lambda task: seen.append(task))
    task = seen[0]
    assert eng.cfg.model.input_nc == 3 and state.step == 4
    assert task.model.model.model[0].weight.shape[1] == 3  # the first conv reads RGB
    jcfg = jax_load_config("batvisionv2", "train", "default", "unet_baseline", overrides={
        "model.generator": "unet_128", "model.ngf": 2, "dataset.images_size": 128,
        "mode.batch_size": 2, "mode.epochs": 1, "model.input_nc": 3})
    exp = jax_experiment_name(jcfg, "IMG")
    assert "_IMG_" in exp and os.path.isdir(tmp_path / "ck" / exp)
    assert np.isfinite(eng.history[0]["val"]["rmse"])
    means = _evaluate(tree, tmp_path, str(tmp_path / "ck" / exp), "--eval_img",
                      "--generator", "unet_128", "--ngf", "2", "--override",
                      "dataset.images_size=128")
    assert set(means) == set(METRIC_NAMES) | {"loss"}
    for k in means:
        np.testing.assert_allclose(means[k], eng.history[0]["val"][k], rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("flags", [["--eval_img"], ["--model", "rgb_depth"],
                                   ["--model", "adabins_distillation"]])
def test_bv1_refuses_camera_images(flags):
    with pytest.raises(SystemExit, match="batvisionv1"):
        train_cli.main(["--device", "cpu", "--dataset", "batvisionv1", *flags])


def test_evaluate_bv1_refuses_camera_images():
    with pytest.raises(SystemExit, match="batvisionv1"):
        evaluate_cli.main(["--device", "cpu", "--dataset", "batvisionv1", "--eval_img"])


SMALL = ["--base_channels", "4", "--n_bins", "8", "--override", "dataset.images_size=32"]


def test_adabins_trains_on_pairs_and_serves_and_evaluates_on_audio(tree, tmp_path):
    eng, state = _train(tree, tmp_path, "--model", "adabins_distillation", *SMALL)
    assert state.step == 4 and eng.history[0]["response"] > 0  # the teacher ran
    exp = str(tmp_path / "ck" / experiment_name(eng.cfg))
    means = _evaluate(tree, tmp_path, exp, "--model", "adabins_distillation",
                      "--base_channels", "4", "--n_bins", "8", "--override",
                      "dataset.images_size=32")
    for k in means:
        np.testing.assert_allclose(means[k], eng.history[0]["val"][k], rtol=1e-6, err_msg=k)
    args = serve.build_parser().parse_args([
        "--device", "cpu", "--model", "adabins_distillation", "--checkpoint_path", exp,
        "--use_best", "--base_channels", "4", "--n_bins", "8"])
    cfg, task, source = serve.load_serving_state(args)
    assert source.endswith("@1") and any(n.startswith("rgb_") for n in task.model.state_dict())
    runner = serve.InferenceRunner(cfg, task, ladder=[1])
    try:
        wave = np.random.default_rng(0).normal(0, 0.05, (1, 2, runner.wave_len))
        depth = runner.run(wave.astype(np.float32))
    finally:
        runner.close()
    assert depth.shape == (1, 256, 256, 1) and np.isfinite(depth).all()


def test_rgb_depth_trains_and_evaluates_on_images_and_serve_refuses_it(tree, tmp_path):
    eng, state = _train(tree, tmp_path, "--model", "rgb_depth", *SMALL[:2], *SMALL[4:])
    assert state.step == 4
    exp = str(tmp_path / "ck" / experiment_name(eng.cfg))
    means = _evaluate(tree, tmp_path, exp, "--model", "rgb_depth", "--base_channels", "4",
                      "--override", "dataset.images_size=32")
    for k in means:
        np.testing.assert_allclose(means[k], eng.history[0]["val"][k], rtol=1e-6, err_msg=k)
    with pytest.raises(SystemExit, match="not servable"):
        serve.main(["--device", "cpu", "--model", "rgb_depth", "--random_init"])
