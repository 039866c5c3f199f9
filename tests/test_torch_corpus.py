"""Training and evaluation of the port on a fabricated BatVision V2 tree,
against the JAX package, on the CPU.

  * the epoch shuffle stream: the port's train CLI and the JAX CLI draw the
    same batches in epochs 1 and 2 (epoch e shuffles with seed
    mode.seed·100003 + e + 1 in both);
  * `Engine.fit` with a holdout loader and a `MetricLogger` writes the JAX
    fit's key set; from the same weights in float64 (one SGD epoch of 4
    steps), its train loss and its val and holdout criterion losses
    (float64) match JAX's at 1e-8, the SGD trajectory tolerance of
    tests/test_torch_train.py, and its val and holdout metrics at 1e-6:
    the metrics are float32 on both sides by definition
    (`compute_errors_batch` casts its inputs to float32), so float64 makes
    their inputs agree and the remaining difference is the order of the
    float32 sums;
  * the negative and stuck-at-zero detectors warn;
  * a SIGTERM in epoch 2 leaves epoch 1's checkpoint, equal bit for bit to
    an uninterrupted run's, and --resume then ends where the uninterrupted
    3-epoch run ends;
  * `cli/evaluate.py` against the JAX `cli/evaluate.py --torch_checkpoint`
    on one .pth in float64: the gt and pred tensors of the two artifacts at
    1e-10, δ1-3 exactly, the other metrics at 1e-6 (float32, as above);
  * the evaluate CLI's four ways of naming a checkpoint, its refusal of a
    missing one, and --visualize;
  * the train CLI: held-out rows absent from train and val and evaluated
    on their own, the JSONL and the architecture dump, --device_cache
    giving the streamed run's batches and losses, and an exit before
    training where it would draw and matplotlib does not import.
"""

from __future__ import annotations

import glob
import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodepth_tpu.cli import evaluate as jax_evaluate_cli
from audiodepth_tpu.cli import train as jax_train_cli
from audiodepth_tpu.configs import load_config as jax_load_config
from audiodepth_tpu.models import make_task as jax_make_task
from audiodepth_tpu.models.unet import UNetGenerator as FlaxUNet
from audiodepth_tpu.obs import MetricLogger as JaxMetricLogger
from audiodepth_tpu.train.engine import Engine as JaxEngine
from audiodepth_tpu.train.engine import TrainState as JaxTrainState

from audiodepth_tpu_torch.ckpt import CheckpointManager
from audiodepth_tpu_torch.cli import evaluate as evaluate_cli
from audiodepth_tpu_torch.cli import train as train_cli
from audiodepth_tpu_torch.configs import experiment_name, load_config
from audiodepth_tpu_torch.data.batvision import make_dataset
from audiodepth_tpu_torch.metrics import METRIC_NAMES
from audiodepth_tpu_torch.models import init_weights, make_task
from audiodepth_tpu_torch.models.unet import UNetGenerator
from audiodepth_tpu_torch.obs import MetricLogger
from audiodepth_tpu_torch.train import engine as engine_mod
from audiodepth_tpu_torch.train.engine import Engine

from tests.torch_bv_trees import write_bv2_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# unet_128 (7 downs) at ngf 2 on 128² inputs, batch 2
TINY = ["--device", "cpu", "--dataset", "batvisionv2", "--override", "model.generator=unet_128",
        "--override", "model.ngf=2", "--override", "dataset.images_size=128",
        "--batch_size", "2", "--validation_iter", "1", "--seed", "4"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


@pytest.fixture
def f64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.fixture
def tree(tmp_path):
    return write_bv2_tree(tmp_path / "bv2", locations=("Hall", "Office", "Yard"),
                          rows=(("train", 4), ("val", 2), ("test", 1)))


def _np(batch):
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the epoch shuffle stream (the repair)
# ---------------------------------------------------------------------------

def test_epoch_shuffle_stream_equals_the_jax_cli(tree, tmp_path, monkeypatch):
    """Epochs 1 and 2 of both CLIs draw the same batches. Before the repair
    the port's epoch e shuffled with seed·100003 + e, the JAX CLI's (whose
    init sample draws + 1 first) with + e + 1."""
    import audiodepth_tpu.train as jax_train_pkg

    def capture(store):
        def fit(self, state, train_batches, *args, **kwargs):
            store.extend([_np(b) for b in train_batches()] for _ in range(2))
            return state
        return fit

    want, got = [], []
    monkeypatch.setattr(jax_train_pkg.Engine, "init_state", lambda self, rng, sample: None)
    monkeypatch.setattr(jax_train_pkg.Engine, "fit", capture(want))
    monkeypatch.setattr(engine_mod.Engine, "fit", capture(got))
    flags = ["--dataset", "batvisionv2", "--dataset_dir", str(tree), "--batch_size", "2",
             "--seed", "3", "--no_visualize", "--ckpt_dir", str(tmp_path / "ck"),
             "--log_dir", str(tmp_path / "logs")]
    jax_train_cli.main(flags + ["--generator", "unet_128", "--ngf", "2"])
    train_cli.main(flags + ["--device", "cpu", "--override", "model.generator=unet_128",
                            "--override", "model.ngf=2"])
    assert len(got) == len(want) == 2 and len(got[0]) == 6
    for epoch_got, epoch_want in zip(got, want):
        for g, w in zip(epoch_got, epoch_want):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert not np.array_equal(got[0][0]["depth"], got[1][0]["depth"])


# ---------------------------------------------------------------------------
# Engine.fit against the JAX fit
# ---------------------------------------------------------------------------

def _small_unet_pair(tree, optimizer="SGD"):
    """JAX and port unet_baseline tasks holding one seeded 5-down UNet
    (ngf 8, 32², float64, the JAX tests' small UNet), the port's init
    carried to flax by the JAX package's importer."""
    from audiodepth_tpu.tools.import_torch import import_unet

    overrides = {"dataset.dataset_dir": str(tree), "dataset.images_size": 32,
                 "mode.compute_dtype": "float64", "mode.optimizer": optimizer,
                 "mode.batch_size": 2, "mode.learning_rate": 0.01, "dataset.depth_norm": True,
                 "mode.validation": True, "mode.validation_iter": 1}
    jcfg = jax_load_config("batvisionv2", "train", model_name="unet_baseline",
                           overrides=overrides)
    cfg = load_config("batvisionv2", "train", model_name="unet_baseline", overrides=overrides)
    task = make_task(cfg, device="cpu")
    task.model = UNetGenerator(input_nc=2, output_nc=1, num_downs=5, ngf=8, depth_norm=True,
                               dtype=torch.float64).double()
    init_weights(task.model, torch.Generator().manual_seed(0))
    variables = import_unet({k: v.numpy() for k, v in task.model.state_dict().items()},
                            num_downs=5)
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
    jtask = jax_make_task(jcfg)
    jtask.model = FlaxUNet(input_nc=2, output_nc=1, num_downs=5, ngf=8, depth_norm=True,
                           dtype=jnp.float64)
    return jcfg, jtask, variables, cfg, task


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_fit_with_holdout_and_logger_matches_the_jax_fit(tree, tmp_path, f64):
    jcfg, jtask, variables, cfg, task = _small_unet_pair(tree)
    kw = {"location_blacklist": ["Yard"]}

    def loaders(make):
        train, val = make(cfg, "train", **kw), make(cfg, "val", **kw)
        hold = make(cfg, "train").filter_by_audio_path("Yard")
        return ((lambda: train.batches(2, shuffle=True, seed=5)),
                (lambda: val.batches(2, shuffle=False, drop_last=False)),
                {"Yard": lambda: hold.batches(2, shuffle=False, drop_last=False)})

    from audiodepth_tpu.data.batvision import make_dataset as jax_make_dataset

    jeng = JaxEngine(jcfg, jtask, steps_per_epoch=4)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                              variables["batch_stats"]),
                           opt_state=jeng.tx.init(params))
    jtrain, jval, jhold = loaders(lambda c, s, **k: jax_make_dataset(jcfg, s, **k))
    jlog = JaxMetricLogger(str(tmp_path / "jax"), "x")
    jeng.fit(jstate, jtrain, jval, epochs=1, logger=jlog, holdout_batches=jhold)
    jlog.close()

    eng = Engine(cfg, task, steps_per_epoch=4)
    train, val, hold = loaders(make_dataset)
    log = MetricLogger(str(tmp_path / "port"), "x")
    eng.fit(eng.init_state(), train, val, epochs=1, logger=log, holdout_batches=hold)
    log.close()

    want = _read_jsonl(tmp_path / "jax" / "x.jsonl")
    got = _read_jsonl(tmp_path / "port" / "x.jsonl")
    assert [set(r) for r in got] == [set(r) for r in want]
    keys = set().union(*map(set, got))
    assert {"train/loss", "train/grad_norm", "train/lr", "train/epoch_time",
            "train/pairs_per_sec_per_chip", "val/rmse", "val/criterion_loss",
            "holdout/Yard/rmse", "holdout/Yard/delta1"} <= keys
    for g, w in zip(got, want):
        for k in w:
            if k in ("step", "train/lr"):
                assert g[k] == w[k], k
            elif k == "train/loss" or k.endswith("criterion_loss"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-8, err_msg=k)
            elif k.startswith(("val/", "holdout/")):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-6, atol=1e-7, err_msg=k)
    (record,) = eng.history
    assert set(record["holdout"]) == {"Yard"} and record["holdout"]["Yard"]["rmse"] > 0


@pytest.mark.parametrize("offset,warning", [(-50.0, "negative depth predictions"),
                                            (0.0, "predictions stuck at zero")])
def test_detectors_warn_on_the_first_val_batch(tree, capsys, offset, warning):
    cfg = load_config("batvisionv2", "train", model_name="unet_baseline", overrides={
        "dataset.dataset_dir": str(tree), "dataset.images_size": 32, "mode.batch_size": 2})
    task = make_task(cfg, device="cpu")
    task.model = UNetGenerator(input_nc=2, output_nc=1, num_downs=5, ngf=4, depth_norm=False)
    forced = {}

    def predict_raw(batch):
        n = batch["waveform"].shape[0]
        forced["n"] = forced.get("n", 0) + 1
        return torch.full((n, 32, 32, 1), offset)

    task.predict_raw = predict_raw
    eng = Engine(cfg, task)
    val = make_dataset(cfg, "val")
    seen = []
    eng._detectors(None, 3, next(val.batches(2, shuffle=False)),
                   lambda epoch, first, pred: seen.append((epoch, pred.shape)))
    assert warning in capsys.readouterr().out and forced["n"] == 1
    assert seen == [(3, (2, 32, 32, 1))]


def test_metric_logger_writes_what_the_jax_logger_writes(tmp_path, capsys):
    records = [({"train/loss": np.float32(1.5), "train/lr": 0.002, "n": 3}, 1),
               ({"val/rmse": torch.tensor(2.25), "note": "x"}, 2)]
    outs = {}
    for name, cls in (("jax", JaxMetricLogger), ("port", MetricLogger)):
        log = cls(str(tmp_path / name), "e")
        for rec, step in records:
            log.log(rec, step=step)
        log.log_image("val/visualization", "a.png", step=2)
        log.close()
        outs[name] = capsys.readouterr().out
    assert outs["port"] == outs["jax"]
    assert ((tmp_path / "port" / "e.jsonl").read_text()
            == (tmp_path / "jax" / "e.jsonl").read_text())
    from audiodepth_tpu_torch.obs import Timer

    assert Timer.throughput(32, 2.0) == {"samples_per_sec": 16.0, "pairs_per_sec_per_chip": 16.0}
    assert Timer().start().stop() >= 0.0


def test_visualizations_write_pngs(tmp_path):
    from audiodepth_tpu_torch.obs import save_batch_visualization, save_depth_comparison

    rng = np.random.default_rng(0)
    gt, pred = rng.uniform(0, 30, (3, 16, 16, 1)), rng.uniform(0, 30, (3, 16, 16, 1))
    for path in (save_batch_visualization(gt, pred, str(tmp_path / "a" / "grid.png")),
                 save_depth_comparison(gt[0], pred[0], str(tmp_path / "cmp.png"), title="t")):
        assert open(path, "rb").read(8) == b"\x89PNG\r\n\x1a\n"


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------

def _same_checkpoint(a, b):
    pa = torch.load(a, map_location="cpu", weights_only=True)
    pb = torch.load(b, map_location="cpu", weights_only=True)
    assert pa["epoch"] == pb["epoch"] and pa["step"] == pb["step"]
    assert all(torch.equal(pa["state_dict"][k], pb["state_dict"][k]) for k in pb["state_dict"])
    oa, ob = pa["optimizer"]["state"], pb["optimizer"]["state"]
    assert oa.keys() == ob.keys() and len(ob) > 0
    for i in ob:
        assert all(torch.equal(oa[i][k], ob[i][k]) for k in ob[i])


def test_sigterm_saves_the_last_completed_epoch_and_resume_continues(tree, tmp_path):
    flags = TINY + ["--dataset_dir", str(tree), "--no_visualize", "--saving_checkpoints", "1"]
    eng, _ = train_cli.main(flags + ["--epochs", "3", "--ckpt_dir", str(tmp_path / "full")])
    exp = experiment_name(eng.cfg)
    full = CheckpointManager(str(tmp_path / "full"), exp, create=False)
    steps = []

    def on_step(state, metrics):
        steps.append(state.step)
        if state.step == 6 + 2:  # the second step of epoch 2 (6 steps an epoch)
            assert signal.getsignal(signal.SIGTERM) not in (signal.SIG_DFL, None)
            signal.raise_signal(signal.SIGTERM)

    cut_root = str(tmp_path / "cut")
    eng_cut, state = train_cli.main(flags + ["--epochs", "3", "--ckpt_dir", cut_root],
                                    on_step=on_step)
    assert eng_cut.preempted and steps[-1] == 8 and len(eng_cut.history) == 1
    cut = CheckpointManager(cut_root, exp, create=False)
    assert cut.all_epochs() == [1] and state.step == 6
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL
    _same_checkpoint(cut.path(1), full.path(1))
    train_cli.main(flags + ["--epochs", "3", "--ckpt_dir", cut_root, "--resume"])
    assert cut.all_epochs() == [1, 2, 3]
    _same_checkpoint(cut.path(3), full.path(3))


# ---------------------------------------------------------------------------
# the evaluate CLI
# ---------------------------------------------------------------------------

EVAL_SHAPE = ["--generator", "unet_128", "--ngf", "4", "--override", "dataset.images_size=128"]


def _seeded_pth(path):
    cfg = load_config("batvisionv2", "test", overrides={
        "model.generator": "unet_128", "model.ngf": 4, "dataset.images_size": 128,
        "mode.compute_dtype": "float64"})
    task = make_task(cfg, device="cpu")
    init_weights(task.model, torch.Generator().manual_seed(5))
    torch.save({"state_dict": task.model.state_dict(), "epoch": 7}, path)
    return path


def test_evaluate_artifact_matches_the_jax_evaluate_cli(tree, tmp_path, f64):
    pth = _seeded_pth(str(tmp_path / "w.pth"))
    common = ["--dataset", "batvisionv2", "--dataset_dir", str(tree), "--eval_on", "val",
              "--batch_size", "4", "--torch_checkpoint", pth, "--compute_dtype", "float64",
              "--save_tensors", "--experiment_name", "e"] + EVAL_SHAPE
    want_means = jax_evaluate_cli.main(common + ["--stat_dir", str(tmp_path / "jax")])
    got_means = evaluate_cli.main(common + ["--stat_dir", str(tmp_path / "port"),
                                            "--device", "cpu"])
    name = "batvisionv2/val/stats_on_e_epochtorch.npz"
    want = np.load(tmp_path / "jax" / name)
    got = np.load(tmp_path / "port" / name)
    assert set(got.files) == set(want.files) == set(METRIC_NAMES) | {"loss", "gt", "pred"}
    assert got["rmse"].shape == (6,) and got["pred"].shape == (6, 128, 128, 1)
    np.testing.assert_allclose(got["gt"], want["gt"], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got["pred"], want["pred"], rtol=1e-10, atol=1e-12)
    for k in ("delta1", "delta2", "delta3"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("abs_rel", "rmse", "log10", "mae", "loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert got_means.keys() == want_means.keys()
    for k in want_means:
        np.testing.assert_allclose(got_means[k], want_means[k], rtol=1e-6, err_msg=k)


@pytest.fixture
def trained(tree, tmp_path):
    """Two epochs of the tiny UNet on the tree, checkpointed each epoch."""
    root = str(tmp_path / "ck")
    eng, _ = train_cli.main(TINY + ["--dataset_dir", str(tree), "--no_visualize", "--epochs",
                                    "2", "--saving_checkpoints", "1", "--ckpt_dir", root])
    exp = experiment_name(eng.cfg)
    return root, exp, eng, CheckpointManager(root, exp, create=False)


@pytest.mark.parametrize("how", ["path", "path_epoch", "ckpt_dir", "use_best"])
def test_evaluate_names_a_checkpoint_four_ways(tree, tmp_path, trained, how):
    root, exp, eng, mgr = trained
    want_epoch = {"path": 2, "path_epoch": 1, "ckpt_dir": 1, "use_best": mgr.best_epoch()}[how]
    flags = {"path": ["--checkpoint_path", os.path.join(root, exp)],
             "path_epoch": ["--checkpoint_path", os.path.join(root, exp, "1")],
             "ckpt_dir": ["--ckpt_dir", root, "--experiment_name", exp, "--checkpoints", "1"],
             "use_best": ["--checkpoint_path", os.path.join(root, exp), "--use_best"]}[how]
    stat = tmp_path / "stats"
    means = evaluate_cli.main(["--device", "cpu", "--dataset", "batvisionv2", "--dataset_dir",
                               str(tree), "--eval_on", "val", "--stat_dir", str(stat),
                               *EVAL_SHAPE[:2], "--ngf", "2", *EVAL_SHAPE[4:], *flags])
    (artifact,) = glob.glob(str(stat / "batvisionv2" / "val" / "*.npz"))
    assert artifact.endswith(f"stats_on_{exp}_epoch{want_epoch}.npz")
    assert np.load(artifact)["rmse"].shape == (6,)
    if how == "use_best":  # the val record of the best epoch, the same metrics
        val = eng.history[want_epoch - 1]["val"]
        for k in METRIC_NAMES + ("loss",):
            np.testing.assert_allclose(means[k], val[k], rtol=1e-6, err_msg=k)


def test_evaluate_refuses_a_missing_checkpoint(tree, trained):
    root, exp, _, _ = trained
    with pytest.raises(SystemExit, match=r"available epochs: \[1, 2\]"):
        evaluate_cli.main(["--device", "cpu", "--dataset_dir", str(tree),
                           "--checkpoint_path", os.path.join(root, exp, "5")])
    with pytest.raises(SystemExit, match="batvisionv1"):  # no camera images there
        evaluate_cli.main(["--device", "cpu", "--dataset", "batvisionv1", "--eval_img"])


def test_evaluate_visualize_writes_pngs(tree, tmp_path, trained):
    root, exp, _, _ = trained
    evaluate_cli.main(["--device", "cpu", "--dataset", "batvisionv2", "--dataset_dir",
                       str(tree), "--eval_on", "val", "--stat_dir", str(tmp_path / "s"),
                       "--checkpoint_path", os.path.join(root, exp), "--visualize",
                       "--vis_batch_size", "4", "--results_dir", str(tmp_path / "r"),
                       "--generator", "unet_128", "--ngf", "2",
                       "--override", "dataset.images_size=128"])
    pngs = sorted(os.listdir(tmp_path / "r" / exp / "val"))
    assert pngs == ["batch_0000_samples_0000-0003.png", "batch_0001_samples_0004-0005.png"]


# ---------------------------------------------------------------------------
# the train CLI on the corpus
# ---------------------------------------------------------------------------

def test_train_cli_holdout_logs_and_device_cache(tree, tmp_path):
    batches = {}

    def run(name, *extra):
        seen = []
        orig = Engine.train_step

        def spy(self, state, batch, epoch=0.0):
            seen.append(_np(batch))
            return orig(self, state, batch, epoch)

        Engine.train_step = spy
        try:
            out = train_cli.main(TINY + [
                "--dataset_dir", str(tree), "--epochs", "2", "--holdout_test_seq", "Yard",
                "--log_dir", str(tmp_path / name), "--results_dir", str(tmp_path / "r" / name),
                *extra])
        finally:
            Engine.train_step = orig
        batches[name] = seen
        return out

    eng, _ = run("streamed")
    exp = experiment_name(eng.cfg, "holdout_Yard")
    assert exp.endswith("_holdout_Yard_default")
    records = _read_jsonl(tmp_path / "streamed" / f"{exp}.jsonl")
    assert any("holdout/Yard/rmse" in r for r in records)
    assert sum("val/visualization" in r for r in records) == 2
    assert os.path.exists(tmp_path / "r" / "streamed" / exp / "val_epoch2.png")
    arch = (tmp_path / "streamed" / f"{exp}_architecture.txt").read_text()
    assert "UNetGenerator" in arch and "params:" in arch
    # no Yard row reached a train step; the holdout evaluated Yard's 4 rows
    yard = make_dataset(eng.cfg, "train").filter_by_audio_path("Yard")
    yard_depths = {b["depth"].tobytes() for b in yard.batches(1, shuffle=False)}
    assert len(yard_depths) == 4
    assert all(b["depth"][i:i + 1].tobytes() not in yard_depths
               for b in batches["streamed"] for i in range(2))
    assert len(batches["streamed"]) == 8
    assert eng.history[-1]["holdout"]["Yard"]["rmse"] > 0

    eng_c, _ = run("cached", "--device_cache")
    assert len(batches["cached"]) == 8
    for s, c in zip(batches["streamed"], batches["cached"]):
        for k in ("waveform", "depth"):
            np.testing.assert_array_equal(c[k], s[k], err_msg=k)
        np.testing.assert_array_equal(c["waveform_scale"], 1.0)
    for rs, rc in zip(eng.history, eng_c.history):
        np.testing.assert_allclose(rc["loss"], rs["loss"], rtol=1e-6)


@pytest.mark.parametrize("flags,want", [
    (["--holdout_test_seq", "A", "--holdout_eval_seq", "B"], ["A", "B"]),
    (["--holdout_locations", "C", "--holdout_eval_seq", "B"], ["C", "B"]),
    (["--sequence_holdout", "--holdout_locations", "C"], ["C"]),
    (["--sequence_holdout"], None),
])
def test_train_cli_folds_the_reference_holdout_flags(flags, want):
    args = train_cli.build_parser().parse_args(flags)
    if want is None:
        with pytest.raises(SystemExit, match="--holdout_test_seq"):
            train_cli.fold_holdout_args(args)
    else:
        train_cli.fold_holdout_args(args)
        assert args.holdout_locations == want


_BLOCK_MATPLOTLIB = r"""
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "matplotlib":
            raise ImportError(f"blocked import of {name}")
sys.meta_path.insert(0, Block())
from audiodepth_tpu_torch.cli import train
train.main(sys.argv[1:])
"""


def test_train_cli_exits_before_training_without_matplotlib(tree, tmp_path):
    flags = TINY + ["--dataset_dir", str(tree), "--epochs", "1",
                    "--log_dir", str(tmp_path / "logs")]
    out = subprocess.run([sys.executable, "-c", _BLOCK_MATPLOTLIB, *flags], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "--no_visualize" in out.stderr
    assert '"epoch"' not in out.stdout and not (tmp_path / "logs").exists()
    ok = subprocess.run([sys.executable, "-c", _BLOCK_MATPLOTLIB, *flags, "--no_visualize"],
                        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert ok.returncode == 0, ok.stderr
    assert '"epoch": 1' in ok.stdout
