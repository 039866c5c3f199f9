"""Data parallelism of the port over several ranks (`audiodepth_tpu_torch/
parallel`), held against its own one-rank engine and the JAX package.

One spawned world of two gloo ranks (`tests/torch_dist_workers.py`) runs
every case once for the module; the test process computes the one-rank
references meanwhile, then each assertion is a case of its own:

  * `pad_batch_to`, `local_batch_slice` and `local_shard` against the JAX
    package's, refusals included (a given rank and world: JAX's process
    index and count patched);
  * for each of the seven families in float64, the 2-rank train step
    equals the one-rank step on the global batch at 1e-10 (loss, aux,
    gradient norm, every gradient and BatchNorm buffer; the cVAE's eps and
    AdaBins' masks drawn for the global batch), a 3-step AdamW + clip
    trajectory at 2e-6, and both ranks' states bit-equal;
  * the unet 2-rank SGD step against JAX `Engine(mesh=make_mesh(2))`;
  * BatchNorm's global statistics (float64 at 1e-12; bfloat16 compute at
    float32's precision), the unbiased running variance over the global
    count, one fold under `remat`;
  * ragged evaluation (13 rows at batch 4) against one rank and the JAX
    mesh, and the refusal of a padded train batch;
  * the row-sharded device cache (each gather the split's rows at its
    indices, with no index upload on the CPU); checkpoints across topology (2 → 1 and
    1 → 2 ranks); SIGTERM on one rank; the train CLI's `--num_devices`.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp

from audiodepth_tpu.configs import load_config as jax_load_config
from audiodepth_tpu.models import make_task as jax_make_task
from audiodepth_tpu.models.unet import UNetGenerator as FlaxUNet
from audiodepth_tpu.parallel import mesh as jax_mesh
from audiodepth_tpu.parallel import multihost as jax_multihost
from audiodepth_tpu.tools.import_torch import import_unet
from audiodepth_tpu.train.engine import Engine as JaxEngine

from audiodepth_tpu_torch.cli import train as train_cli
from audiodepth_tpu_torch.parallel import local_batch_slice, local_shard, pad_batch_to
from audiodepth_tpu_torch.tools.import_jax import unet_state_dict_from_jax

from tests import torch_dist_workers as W
from tests.torch_parity import assert_close_rel, f64, jax_state  # noqa: F401


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(rank-0 results, rank-1 results, one-rank results, work dir)."""
    root = str(tmp_path_factory.mktemp("dist"))
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        W.fit_unet(os.path.join(root, "save1"), 2)  # resumed at 2 ranks in the world
        ctx = mp.spawn(W.run_world, args=(W.WORLD, "file://" + os.path.join(root, "rdv"), root),
                       nprocs=W.WORLD, join=False)
        one = {"families": {f: W.run_family(f) for f in W.FAMILIES},
               "unet_sgd": W.run_family("unet_baseline", steps=1, optimizer="SGD"),
               "batchnorm": W.run_batchnorm(), "eval": W.run_ragged_eval(),
               "cache": W.run_cache()}
        _, state, _ = W.fit_unet(os.path.join(root, "ref"), 3)
        one["three_epochs"] = W._state(state)
        while not ctx.join():
            pass
        # the 2-rank save, resumed here on one rank for its third epoch
        _, state, _ = W.fit_unet(os.path.join(root, "save2"), 3, resume=True)
        one["resume1"] = W._state(state)
    finally:
        torch.set_num_threads(prev)
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
             for r in range(W.WORLD)]
    return ranks[0], ranks[1], one, root


def _np(d):
    return {k: v.numpy() for k, v in d.items()}


def _bits(t):
    # uint16 has few CPU kernels in torch: compare its bits
    return t.view(torch.int16) if t.dtype == torch.uint16 else t


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# helpers against the JAX package
# ---------------------------------------------------------------------------

def _jax_rank(monkeypatch, rank, world):
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    monkeypatch.setattr(jax, "process_count", lambda: world)


@pytest.mark.parametrize("rows,target,prior", [(3, 4, None), (3, 8, [1, 1, 1, 0]), (4, 4, None),
                                               (4, 4, [1, 1, 0, 0]), (1, 6, None)])
def test_pad_batch_to_matches_jax(rows, target, prior):
    rng = np.random.default_rng(rows * 10 + target)
    batch = {"x": rng.normal(size=(rows, 3)).astype(np.float32),
             "d": rng.integers(0, 60000, (rows, 2, 2)).astype(np.uint16)}
    if prior is not None:
        batch["_valid"] = np.asarray(prior[:rows], np.float32)
    want = jax_mesh.pad_batch_to(batch, target)
    got = pad_batch_to(batch, target)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    # tensors (the device cache's batches) pad the same way
    t = pad_batch_to({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()
                      if k != "d"}, target)
    assert np.array_equal(t["x"].numpy(), want["x"])
    assert np.array_equal(t["_valid"].numpy(), want["_valid"])


def test_pad_batch_to_refuses_a_smaller_target():
    with pytest.raises(ValueError, match="exceeds target"):
        pad_batch_to({"x": np.zeros((5, 1))}, 4)


@pytest.mark.parametrize("size,rank,world", [(8, 0, 2), (8, 1, 2), (12, 2, 4), (6, 1, 3),
                                             (4, 0, 1), (7, 1, 2), (10, 0, 4)])
def test_local_batch_slice_matches_jax(size, rank, world, monkeypatch):
    _jax_rank(monkeypatch, rank, world)
    if size % world:
        with pytest.raises(ValueError, match="not divisible"):
            jax_multihost.local_batch_slice(size)
        with pytest.raises(ValueError, match="not divisible"):
            local_batch_slice(size, rank, world)
    else:
        assert local_batch_slice(size, rank, world) == jax_multihost.local_batch_slice(size)


@pytest.mark.parametrize("rows,axis,rank,world", [(13, 2, 0, 2), (13, 2, 1, 2), (1, 2, 1, 2),
                                                  (5, 4, 3, 4), (8, 4, 2, 2), (3, 3, 1, 2)])
def test_local_shard_matches_jax(rows, axis, rank, world, monkeypatch):
    _jax_rank(monkeypatch, rank, world)
    batch = {"x": np.arange(rows * 2, dtype=np.float32).reshape(rows, 2)}
    if axis % world:
        with pytest.raises(ValueError, match="not divisible"):
            jax_multihost.local_shard(batch, axis)
        with pytest.raises(ValueError, match="not divisible"):
            local_shard(batch, axis, rank, world)
        return
    want = jax_multihost.local_shard(batch, axis)
    got = local_shard(batch, axis, rank, world)
    assert got.keys() == want.keys() == {"x", "_valid"}
    for k in want:
        assert np.array_equal(got[k], want[k]), k


# ---------------------------------------------------------------------------
# the global-batch step of every family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", W.FAMILIES)
def test_two_rank_step_equals_one_rank(world, family):
    r0, _, one, _ = world
    got, want = r0["families"][family], one["families"][family]
    assert got["aux"].keys() == want["aux"].keys()
    for k in want["aux"]:
        np.testing.assert_allclose(got["aux"][k], want["aux"][k], rtol=1e-10, err_msg=k)
    np.testing.assert_allclose(got["loss"][0], want["loss"][0], rtol=1e-10)
    np.testing.assert_allclose(got["grad_norm"][0], want["grad_norm"][0], rtol=1e-10)
    assert got["grads"].keys() == want["grads"].keys()
    assert_close_rel(_np(got["grads"]), _np(want["grads"]), 1e-10, f"{family} gradient")
    stats = [k for k in want["buffers"] if k.endswith(("running_mean", "running_var"))]
    assert stats or family == "binaural_attention" or family == "rgb_depth"
    for k in stats:
        np.testing.assert_allclose(got["buffers"][k].numpy(), want["buffers"][k].numpy(),
                                   rtol=1e-10, atol=1e-14, err_msg=k)


@pytest.mark.parametrize("family", W.FAMILIES)
def test_two_rank_adamw_trajectory_equals_one_rank(world, family):
    r0, r1, one, _ = world
    got, want = r0["families"][family], one["families"][family]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-6)
    params = [k for k in want["state"] if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))]
    assert_close_rel(_np(got["state"]), _np(want["state"]), 2e-6, f"{family} parameter",
                     keys=params)
    for k in want["state"]:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got["state"][k].numpy(), want["state"][k].numpy(),
                                       rtol=2e-6, atol=1e-12, err_msg=k)
    # the ranks hold one replicated state, bit for bit
    _same(r0["families"][family]["state"], r1["families"][family]["state"])


def test_binaural_case_runs_its_attention(world):
    """γ is seeded non-zero, so the attention shapes the loss, and its
    gates take gradient."""
    grads = world[0]["families"]["binaural_attention"]["grads"]
    gates = [k for k in grads if k.endswith("gamma")]
    assert gates and all(float(grads[k].abs().max()) > 0 for k in gates)


def _unet_jax(variables_from, cfg_over, mesh=True):
    jcfg = jax_load_config("synthetic", "train", model_name="unet_baseline", overrides=cfg_over)
    jtask = jax_make_task(jcfg)
    jtask.model = FlaxUNet(input_nc=2, output_nc=1, num_downs=5, ngf=8, depth_norm=True,
                           dtype=jnp.float64)
    variables = import_unet({k: v.numpy() for k, v in variables_from.items()}, num_downs=5)
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
    eng = JaxEngine(jcfg, jtask, mesh=jax_mesh.make_mesh(W.WORLD) if mesh else None)
    return eng, jax_state(eng, variables)


_JAX_OVER = {"dataset.images_size": 32, "mode.compute_dtype": "float64",
             "mode.grad_clip_norm": W.CLIP, "mode.batch_size": W.GLOBAL_BATCH,
             "dataset.depth_norm": True}


def test_unet_two_ranks_match_jax_mesh(world, f64):
    """The port's 2-rank SGD step against the JAX engine on a 2-device
    mesh. The JAX BatchNorm takes the one-pass variance E[x²] − E[x]²
    (the port two passes), whose cancellation puts the one-device port and
    JAX losses ~3e-10 apart on this batch already; so the loss is held to
    that one-device gap plus 1e-10, which bounds what data parallelism
    adds on either side."""
    r0, _, one, _ = world
    cfg, task = W.build("unet_baseline", "SGD")
    batch = W.global_batches(cfg, task, "unet_baseline")[0]
    over = dict(_JAX_OVER, **{"mode.optimizer": "SGD"})
    losses = {}
    for mesh in (False, True):
        jeng, jstate = _unet_jax(task.model.state_dict(), over, mesh=mesh)
        jstate, jm = jeng.train_step(jstate, batch, epoch=0.0)
        losses[mesh] = float(jm["loss"])
    got = r0["unet_sgd"]
    gap = abs(one["unet_sgd"]["loss"][0] - losses[False]) / abs(losses[False])
    assert gap < 1e-9
    assert abs(got["loss"][0] - losses[True]) / abs(losses[True]) <= gap + 1e-10
    want = unet_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params),
                                    jax.tree_util.tree_map(np.asarray, jstate.batch_stats),
                                    num_downs=5)
    params = [n for n, _ in task.model.named_parameters()]
    assert_close_rel(_np(got["state"]), {k: np.asarray(v) for k, v in want.items()}, 1e-8,
                     "unet parameter", keys=params)


# ---------------------------------------------------------------------------
# BatchNorm over the global batch
# ---------------------------------------------------------------------------

def _rows_of_both(r0, r1, case, key):
    """The global tensor of a per-row result; an input gradient comes out
    N times its share on each rank (the backward of `global_sum` sums over
    the ranks; the engine divides the parameters' by N)."""
    t = torch.cat([r0["batchnorm"][case][key], r1["batchnorm"][case][key]])
    return t / W.WORLD if key == "dx" else t


@pytest.mark.parametrize("key", ["y", "dx", "dweight", "dbias", "mean", "var"])
def test_batchnorm_global_statistics_f64(world, key):
    r0, r1, one, _ = world
    got = _rows_of_both(r0, r1, "f64", key) if key in ("y", "dx") \
        else r0["batchnorm"]["f64"][key]
    want = one["batchnorm"]["f64"][key]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)


def test_batchnorm_running_variance_is_unbiased_over_the_global_count(world):
    x = np.random.default_rng(7).normal(1.0, 2.0, (W.GLOBAL_BATCH, 6, 5, 5))
    got = world[0]["batchnorm"]["f64"]
    np.testing.assert_allclose(got["var"].numpy(),
                               0.9 + 0.1 * x.var(axis=(0, 2, 3), ddof=1), rtol=1e-12)
    np.testing.assert_allclose(got["mean"].numpy(), 0.1 * x.mean(axis=(0, 2, 3)), rtol=1e-12)


def test_batchnorm_global_statistics_bf16_compute(world):
    """bfloat16 compute: the statistics in float32 (buffers float32, the
    output bfloat16). Two float32 summation orders agree to float32's
    precision, so the output agrees to a bfloat16 rounding."""
    r0, r1, one, _ = world
    got, want = r0["batchnorm"]["bf16"], one["batchnorm"]["bf16"]
    assert got["y"].dtype == torch.bfloat16 and got["mean"].dtype == torch.float32
    xb = torch.tensor(np.random.default_rng(7).normal(1.0, 2.0, (W.GLOBAL_BATCH, 6, 5, 5)),
                      dtype=torch.bfloat16).double().numpy()
    for k, ref in (("mean", 0.1 * xb.mean(axis=(0, 2, 3))),
                   ("var", 0.9 + 0.1 * xb.var(axis=(0, 2, 3), ddof=1))):
        np.testing.assert_allclose(got[k].numpy(), ref, rtol=1e-6)
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-6)
    y = torch.cat([r0["batchnorm"]["bf16"]["y"], r1["batchnorm"]["bf16"]["y"]]).double()
    np.testing.assert_allclose(y.numpy(), want["y"].double().numpy(), rtol=2 ** -7, atol=2 ** -7)


@pytest.mark.parametrize("key", ["y", "mean", "var", "dx"])
def test_batchnorm_under_remat_folds_once(world, key):
    """A conv + BatchNorm under `remat` at 2 ranks equals the same net
    without remat at 2 ranks (a second fold would show in the buffers) and
    the remat net on one rank."""
    r0, r1, one, _ = world

    def both(case):
        if key in ("y", "dx"):
            return _rows_of_both(r0, r1, case, key).numpy()
        return r0["batchnorm"][case][key].numpy()

    for want in (both("plain"), one["batchnorm"]["remat"][key].numpy()):
        np.testing.assert_allclose(both("remat"), want, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# evaluation, the device cache, checkpoints, SIGTERM, the CLI
# ---------------------------------------------------------------------------

def test_ragged_eval_equals_one_rank(world):
    r0, r1, one, _ = world
    want = one["eval"]["metrics"]
    assert set(want) >= {"rmse", "loss", "criterion_loss"}
    for got in (r0["eval"]["metrics"], r1["eval"]["metrics"]):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)


def test_ragged_eval_matches_jax_mesh(world, f64):
    cfg, task = W.build("unet_baseline")
    jeng, jstate = _unet_jax(task.model.state_dict(), _JAX_OVER)
    want = jeng.evaluate(jstate, W.ragged_eval_batches(cfg))
    got = world[0]["eval"]["metrics"]
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def test_train_step_rejects_a_padded_batch(world):
    for res in (world[0], world[1], world[2]):
        assert res["eval"]["refused"] and "eval-only" in res["eval"]["refused"]


def test_device_cache_holds_a_row_shard_and_gathers_exact_batches(world):
    r0, r1, one, _ = world
    for r, res in enumerate((r0, r1)):
        held = res["cache"]["held"]
        assert all(v.shape[0] == 7 for v in held.values())  # ⌈13 / 2⌉
        for k, v in held.items():
            want = one["cache"]["held"][k][7 * r:7 * r + 7]
            assert torch.equal(v[:len(want)], want), k
        assert len(res["cache"]["global"]) == len(one["cache"]["global"]) == 4
        for got, want in zip(res["cache"]["global"], one["cache"]["global"]):
            _same(got, want)
        assert len(res["cache"]["local"]) == 3
        for got, want in zip(res["cache"]["local"], one["cache"]["global"]):
            _same(got, {k: v[2 * r:2 * r + 2] for k, v in want.items()})
    # the pad row of rank 1 repeats row 0
    _same({k: v[6:] for k, v in r1["cache"]["held"].items()},
          {k: v[:1] for k, v in one["cache"]["held"].items()})


@pytest.mark.parametrize("pick", range(len(W.CACHE_PICKS)))
def test_sharded_gather_returns_the_rows_at_idx(world, pick):
    """Each rank's gather of CACHE_PICKS[pick] is the split's rows at those
    indices, in their order and dtypes (the one-rank cache holds the whole
    split), and a CPU cache uploads nothing."""
    r0, r1, one, _ = world
    idx = list(W.CACHE_PICKS[pick])
    split = one["cache"]["held"]
    for res in (r0, r1, one):
        got = res["cache"]["picked"][pick]
        assert got.keys() == split.keys()
        for k, v in split.items():
            assert got[k].dtype == v.dtype, k
            assert torch.equal(_bits(got[k]), _bits(v).index_select(0, torch.tensor(idx))), k
        assert res["cache"]["uploads"] == {"queued": 0, "blocking": 0}


@pytest.mark.parametrize("case", ["saved_at_2_resumed_at_1", "saved_at_1_resumed_at_2"])
def test_resume_across_topology_continues_the_run(world, case):
    r0, r1, one, _ = world
    got = one["resume1"] if case == "saved_at_2_resumed_at_1" else r0["ckpt"]["resume2"]
    if case == "saved_at_1_resumed_at_2":
        _same(r0["ckpt"]["resume2"], r1["ckpt"]["resume2"])
        assert r0["ckpt"]["resume2_step"] == 6
    assert r0["ckpt"]["save2_step"] == 4
    assert_close_rel(_np(got), _np(one["three_epochs"]), 1e-10, "parameter")


def test_sigterm_on_one_rank_stops_both_and_resumes(world):
    r0, r1, one, root = world
    s0, s1 = r0["ckpt"]["sigterm"], r1["ckpt"]["sigterm"]
    assert s0["preempted"] and s1["preempted"]
    assert s0["steps_run"] == s1["steps_run"] == 3  # signalled in step 3: both stop after it
    assert s0["step"] == s1["step"] == 2  # the last completed epoch's state
    assert s0["epochs_saved"] == [1]
    _same(r0["ckpt"]["sigterm_resumed"], r1["ckpt"]["sigterm_resumed"])
    assert_close_rel(_np(r0["ckpt"]["sigterm_resumed"]), _np(one["three_epochs"]), 1e-10,
                     "parameter")


def _jsonl(log_dir):
    (name,) = [f for f in os.listdir(log_dir) if f.endswith(".jsonl")]
    with open(os.path.join(log_dir, name)) as f:
        return [json.loads(line) for line in f]


def test_cli_two_ranks_equal_one_rank(tmp_path, capsys):
    one_dir, two_dir = str(tmp_path / "one"), str(tmp_path / "two")
    train_cli.main(W.cli_args(one_dir))
    # 3 requested, batch 4: the JAX CLI's rule trains on 2
    assert train_cli.main(W.cli_args(two_dir, ["--num_devices", "3"])) == (None, None)
    assert ("WARNING: batch_size 4 does not divide 3 devices; training on 2 device(s)"
            in capsys.readouterr().out)
    want, got = _jsonl(one_dir), _jsonl(two_dir)
    # a train line an epoch, then the val line (and the PNG's)
    assert len(got) == len(want) >= 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k, v in w.items():
            if k in ("train/loss", "val/loss", "val/criterion_loss"):
                np.testing.assert_allclose(g[k], v, rtol=1e-10, err_msg=k)
            elif k.startswith("val/") and isinstance(v, float):  # float32 metrics
                np.testing.assert_allclose(g[k], v, rtol=1e-6, err_msg=k)
