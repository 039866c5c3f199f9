"""The port's checkpoints (`audiodepth_tpu_torch/ckpt`), on the CPU.

  * k epochs, a save, a resume (`cli.train --resume`) and j more epochs
    give the k + j uninterrupted epochs' parameters, BatchNorm statistics,
    optimizer state and losses bit for bit (the epoch's reshuffle seed
    follows the epoch number, so the resumed run sees the same batches);
    `--checkpoints N` resumes from epoch N;
  * the manager: the reference's file names, idempotent saves, best.json
    and `restore_eval`, `max_to_keep` keeping the best epoch, and a
    restore of a missing epoch raising;
  * a port checkpoint is a reference `.pth`: its `state_dict` loads with
    strict=True into the reference-keyed module, and the JAX package's own
    importer takes it leaf for leaf;
  * `serve` restores what `train` wrote (--checkpoint_path DIR, DIR/EPOCH,
    --use_best, --ckpt_dir with --experiment_name), and `--init_from_torch`
    warm-starts the model from a checkpoint at the epoch after its own;
  * a new run (no --resume) refuses a directory that holds an earlier
    run's epochs, and leaves them as they were.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from audiodepth_tpu_torch.ckpt import BestTracker, CheckpointManager
from audiodepth_tpu_torch.cli import serve as serve_mod
from audiodepth_tpu_torch.cli import train as train_cli
from audiodepth_tpu_torch.configs import experiment_name, load_config
from audiodepth_tpu_torch.models import make_task
from audiodepth_tpu_torch.tools.import_jax import load_torch_state_dict

# a small unet_baseline: unet_128 (7 downs) at ngf 2 on 128² inputs, two
# steps an epoch
TINY = ["--device", "cpu", "--dataset", "synthetic", "--model", "unet_baseline",
        "--override", "model.generator=unet_128", "--override", "model.ngf=2",
        "--override", "dataset.images_size=128", "--num_samples", "4", "--batch_size", "2",
        "--validation_iter", "1", "--saving_checkpoints", "1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small models: one intra-op thread, the cores left to other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def _train(root, *flags):
    return train_cli.main(TINY + ["--ckpt_dir", str(root), *flags])


def _exp_dir(root, eng):
    return os.path.join(str(root), experiment_name(eng.cfg))


def _same_state(a, b):
    assert a.step == b.step
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    oa, ob = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    assert oa.keys() == ob.keys()
    for i in oa:
        assert all(torch.equal(oa[i][k], ob[i][k]) for k in oa[i])


def test_resume_equals_uninterrupted_bit_for_bit(tmp_path):
    eng_full, full = _train(tmp_path / "full", "--epochs", "3")
    _train(tmp_path / "cut", "--epochs", "2")
    eng_res, resumed = _train(tmp_path / "cut", "--epochs", "3", "--resume")
    assert [r["epoch"] for r in eng_res.history] == [3]
    assert eng_res.history[0]["loss"] == eng_full.history[2]["loss"]
    assert eng_res.history[0]["val"] == eng_full.history[2]["val"]
    _same_state(resumed, full)
    # --checkpoints N restores epoch N, whatever the latest is
    eng_n, from_one = _train(tmp_path / "cut", "--epochs", "2", "--checkpoints", "1")
    assert [r["epoch"] for r in eng_n.history] == [2] and from_one.step == 4
    assert eng_n.history[0]["loss"] == eng_full.history[1]["loss"]


def test_saves_best_json_and_restore_eval(tmp_path):
    eng, state = _train(tmp_path, "--epochs", "2", "--best_metric", "mae")
    mgr = CheckpointManager(str(tmp_path), experiment_name(eng.cfg), create=False)
    assert mgr.all_epochs() == [1, 2] and mgr.latest_epoch() == 2
    assert sorted(os.listdir(mgr.directory)) == ["best.json", "checkpoint_1.pth",
                                                 "checkpoint_2.pth"]
    maes = [r["val"]["mae"] for r in eng.history]
    with open(os.path.join(mgr.directory, "best.json")) as f:
        best = json.load(f)
    assert best == {"epoch": 1 + int(np.argmin(maes)), "metric": "mae", "value": min(maes)}
    sd, aux, epoch = mgr.restore_eval()
    assert epoch == 2 and aux is None
    want = state.model.state_dict()
    assert all(torch.equal(sd[k], want[k]) for k in want)
    sd_best, _, epoch = mgr.restore_eval("best")
    assert epoch == best["epoch"]
    payload = torch.load(mgr.path(2), map_location="cpu", weights_only=True)
    assert payload["epoch"] == 2 and payload["step"] == state.step == 4
    assert set(payload) == {"epoch", "step", "state_dict", "optimizer", "aux", "metrics"}
    with pytest.raises(FileNotFoundError):
        mgr.restore_eval(7)


def test_manager_prunes_but_keeps_the_best(tmp_path):
    cfg = load_config("synthetic", "train", overrides={"model.generator": "unet_128",
                                                       "model.ngf": 2})
    task = make_task(cfg, device="cpu")

    class State:
        step = 0
        model = task.model
        optimizer = torch.optim.SGD(task.model.parameters(), lr=0.1)

    mgr = CheckpointManager(str(tmp_path), "exp", max_to_keep=2)
    mgr.save(1, State)
    mgr.mark_best(1, "rmse", 0.5)
    for epoch in (2, 3, 4):
        mgr.save(epoch, State)
    mtime = os.path.getmtime(mgr.path(4))
    mgr.save(4, State)  # idempotent
    assert os.path.getmtime(mgr.path(4)) == mtime
    assert mgr.all_epochs() == [1, 3, 4] and mgr.best_epoch() == 1
    assert not [f for f in os.listdir(mgr.directory) if f.endswith(".tmp")]
    tracker = BestTracker("delta1")
    assert tracker.update(1, {"delta1": 0.5}) and not tracker.update(2, {"delta1": 0.4})
    assert tracker.update(3, {"delta1": 0.6}) and tracker.best_epoch == 3


def test_port_checkpoint_is_a_reference_pth(tmp_path):
    import jax

    from audiodepth_tpu.configs import load_config as jax_load_config
    from audiodepth_tpu.tools import import_torch as itorch

    eng, state = _train(tmp_path, "--epochs", "1")
    path = CheckpointManager(str(tmp_path), experiment_name(eng.cfg)).path(1)
    sd = load_torch_state_dict(path)
    fresh = make_task(eng.cfg, device="cpu").model
    fresh.load_state_dict(sd, strict=True)
    want = state.model.state_dict()
    assert all(torch.equal(fresh.state_dict()[k], want[k]) for k in want)
    # the JAX package's importer reads the same file
    jcfg = jax_load_config("synthetic", "train", model_name="unet_baseline", overrides={
        "model.generator": "unet_128", "model.ngf": 2})
    jsd = itorch.load_torch_state_dict(path)
    variables = itorch.import_for_config(jcfg, jsd)
    assert itorch.load_torch_aux(path)["epoch"] == 1
    n_params = sum(np.asarray(v).size for v in jax.tree_util.tree_leaves(variables["params"]))
    assert n_params == sum(p.numel() for p in state.model.parameters())


@pytest.mark.parametrize("how", ["path", "path_epoch", "use_best", "ckpt_dir"])
def test_serve_restores_what_train_wrote(tmp_path, how):
    eng, state = _train(tmp_path, "--epochs", "2", "--experiment_name", "run")
    exp_dir = _exp_dir(tmp_path, eng)
    flags = {"path": ["--checkpoint_path", exp_dir],
             "path_epoch": ["--checkpoint_path", os.path.join(exp_dir, "1")],
             "use_best": ["--checkpoint_path", exp_dir, "--use_best"],
             "ckpt_dir": ["--ckpt_dir", str(tmp_path), "--experiment_name",
                          os.path.basename(exp_dir), "--checkpoints", "2"]}[how]
    args = serve_mod.build_parser().parse_args(
        ["--device", "cpu", "--generator", "unet_128", "--ngf", "2"] + flags)
    cfg, task, source = serve_mod.load_serving_state(args)
    mgr = CheckpointManager(str(tmp_path), os.path.basename(exp_dir), create=False)
    epoch = {"path": 2, "path_epoch": 1, "use_best": mgr.best_epoch(), "ckpt_dir": 2}[how]
    assert source == f"{os.path.basename(exp_dir)}@{epoch}"
    want, _, _ = mgr.restore_eval(epoch)
    got = task.model.state_dict()
    assert all(torch.equal(got[k], want[k].to(got[k].dtype)) for k in want)


def test_serve_refuses_a_missing_checkpoint(tmp_path):
    args = serve_mod.build_parser().parse_args(
        ["--device", "cpu", "--checkpoint_path", str(tmp_path / "nothing")])
    with pytest.raises(SystemExit, match="available epochs"):
        serve_mod.load_serving_state(args)
    assert not (tmp_path / "nothing").exists()  # restoring creates nothing


def test_init_from_torch_warm_starts(tmp_path):
    eng, state = _train(tmp_path / "a", "--epochs", "1")
    path = CheckpointManager(str(tmp_path / "a"), experiment_name(eng.cfg)).path(1)
    # the file names epoch 1, so a run of one epoch starts past its end and
    # holds the file's weights
    eng2, held = train_cli.main(TINY + ["--epochs", "1", "--init_from_torch", path])
    assert eng2.history == [] and held.step == 0
    want = state.model.state_dict()
    assert all(torch.equal(held.model.state_dict()[k], want[k]) for k in want)
    eng3, _ = train_cli.main(TINY + ["--epochs", "2", "--init_from_torch", path])
    assert [r["epoch"] for r in eng3.history] == [2] and np.isfinite(eng3.history[0]["loss"])
    with pytest.raises(SystemExit, match="conflicts"):
        train_cli.main(TINY + ["--init_from_torch", path, "--resume", "--ckpt_dir",
                               str(tmp_path)])


def test_resume_needs_a_checkpoint_directory():
    with pytest.raises(SystemExit, match="--ckpt_dir"):
        train_cli.main(TINY[:-2] + ["--resume"])


def test_new_run_refuses_a_used_directory(tmp_path):
    eng, _ = _train(tmp_path, "--epochs", "1")
    exp_dir = _exp_dir(tmp_path, eng)
    before = {n: open(os.path.join(exp_dir, n), "rb").read() for n in os.listdir(exp_dir)}
    with pytest.raises(SystemExit, match="--resume"):
        _train(tmp_path, "--epochs", "2")
    after = {n: open(os.path.join(exp_dir, n), "rb").read() for n in os.listdir(exp_dir)}
    assert after == before
