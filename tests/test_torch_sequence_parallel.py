"""Sequence parallelism of the port (`audiodepth_tpu_torch/parallel`: the
2-D ('data', 'model') group, the binaural attention's query rows split
over its model axis, the halo-exchange sharded STFT, and
`tools/multichip_scaling.py`), held against its own one-rank engine and the
JAX package.

One spawned world of four gloo ranks (`tests/torch_sp_workers.py`) runs
every case once for the module, in the sub-layouts 2 × 2, 1 × 4 and 4 × 1
(pure DP); the test process computes the one-rank and JAX references
meanwhile, then each assertion is a case of its own:

  * the rank layout against JAX `make_mesh(4, ("data", "model"), (2, 2))`
    and `model_axes_cross_processes` against JAX's on fake devices;
  * the sharded STFT over sp 2 and sp 4 against JAX's over `make_mesh(2)`
    and `make_mesh(4)` and against the one-device STFT, every halo, the
    boundary where a chunk is exactly the halo and the refusal below it;
  * the plain-STFT front end wired by the engine under 2 × 2 (coarse lite),
    against one rank and JAX `Engine(mesh=make_mesh(4, ("data", "model"),
    (2, 2)))`, and the halo's bytes;
  * the binaural net in float64 under 2 × 2 and 1 × 4, and at 48² under
    sp 4 (level 5 holds 9 tokens), against the one-rank step at 1e-10 with
    all four ranks' states bit-equal after every step, a 3-step AdamW +
    clip trajectory at 2e-6, and an SGD step against the JAX engine on a
    2 × 2 mesh with `sp_axis="model"`;
  * ragged evaluation under 2 × 2; the 4-rank pure-DP fit with a ragged
    validation split, a holdout and SIGTERM inside the epoch-2 iterator,
    resumed to the one-rank run's end;
  * the scaling tool's report and its byte counts against their formulas.
"""

from __future__ import annotations

import dataclasses
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp

from audiodepth_tpu.configs import load_config as jax_load_config
from audiodepth_tpu.models import make_task as jax_make_task
from audiodepth_tpu.parallel import mesh as jax_mesh
from audiodepth_tpu.parallel.sharded_stft import sharded_magnitude_stft as jax_sharded_stft
from audiodepth_tpu.tools.import_torch import import_for_config
from audiodepth_tpu.train.engine import Engine as JaxEngine

from audiodepth_tpu_torch.models.layers import BatchNorm
from audiodepth_tpu_torch.ops.stft import magnitude_stft
from audiodepth_tpu_torch.parallel import model_axes_cross_processes
from audiodepth_tpu_torch.tools import multichip_scaling as scaling
from audiodepth_tpu_torch.train.engine import Engine

from tests import torch_dist_workers as W
from tests import torch_sp_workers as S
from tests.torch_parity import assert_close_rel, jax_state

STFT_CASES = [(sp, n) for sp in (2, 4) for n in S.STFT_LENGTHS + S.STFT_EDGES[sp][:1]]


def _jax_binaural_sgd(task, batch, layout=None):
    """(loss, parameter updates as the port's state_dict keys) of one SGD
    step of the JAX engine from the port task's weights (float64): on one
    device, or with sp_axis="model" on a ('data', 'model') mesh of
    `layout` (dp, sp)."""
    from audiodepth_tpu_torch.tools.import_jax import binaural_state_dict_from_jax

    over = {"dataset.images_size": 32, "mode.compute_dtype": "float64",
            "mode.optimizer": "SGD", "mode.grad_clip_norm": W.CLIP,
            "mode.batch_size": W.GLOBAL_BATCH, "model.base_channels": 8}
    jcfg = jax_load_config("synthetic", "train", model_name="binaural_attention",
                           overrides=over)
    jtask = jax_make_task(jcfg)
    mesh = None
    if layout is not None:
        jtask.model = dataclasses.replace(jtask.model, sp_axis="model")
        mesh = jax_mesh.make_mesh(4, ("data", "model"), layout)
    sd = {k: v.numpy() for k, v in task.model.state_dict().items()}
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                       import_for_config(jcfg, sd))
    jeng = JaxEngine(jcfg, jtask, mesh=mesh)
    jstate, jm = jeng.train_step(jax_state(jeng, variables), batch, epoch=0.0)
    after = binaural_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params),
                                         jax.tree_util.tree_map(np.asarray,
                                                                jstate.batch_stats))
    params = [n for n, _ in task.model.named_parameters()]
    return float(jm["loss"]), {k: np.asarray(after[k]) - sd[k] for k in params}


def _jax_lite_loss(task, batch):
    """The JAX engine's loss of one coarse lite step on a 2 × 2 mesh (its
    plain-STFT front end frame-sharded over 'model'), from the port task's
    weights."""
    jcfg = jax_load_config("batvisionv2", "train", "spstft", "coarse_depth",
                           overrides={"dataset.audio_format": "spectrogram",
                                      "model.model_type": "lite", "model.n_bins": 8,
                                      "model.base_channels": 8, "dataset.images_size": 64,
                                      "mode.batch_size": S.LITE_BATCH,
                                      "mode.compute_dtype": "float32"})
    jtask = jax_make_task(jcfg)
    sd = {k: v.numpy() for k, v in task.model.state_dict().items()}
    variables = import_for_config(jcfg, sd)
    plain = jtask._frontend
    jeng = JaxEngine(jcfg, jtask, mesh=jax_mesh.make_mesh(4, ("data", "model"), (2, 2)))
    assert jtask._frontend is not plain  # the frame-sharded STFT front end
    _, jm = jeng.train_step(jax_state(jeng, variables), batch, epoch=0.0)
    return float(jm["loss"])


def _jax_references() -> dict:
    out = {"stft": {}}
    for sp, n in STFT_CASES:
        out["stft"][(sp, n)] = np.asarray(jax_sharded_stft(
            jnp.asarray(S.stft_wave(n)), jax_mesh.make_mesh(sp), "data", 512, 64, 16))
    cfg = S.lite_config()
    task = S.lite_task(cfg)
    out["lite_loss"] = _jax_lite_loss(task, S.lite_batch(cfg, task))
    jax.config.update("jax_enable_x64", True)
    try:
        cfg, task = W.build("binaural_attention", "SGD")
        batch = W.global_batches(cfg, task, "binaural_attention")[0]
        out["binaural_sgd"] = {layout: _jax_binaural_sgd(task, batch, layout)
                               for layout in (None, (2, 2), (1, 4))}
    finally:
        jax.config.update("jax_enable_x64", False)
    return out


def _one_rank(root: str) -> dict:
    cfg = S.lite_config()
    task = S.lite_task(cfg)
    eng = Engine(cfg, task)
    _, m = eng.train_step(eng.init_state(), S.lite_batch(cfg, task))
    return {"binaural": W.run_family("binaural_attention"),
            "binaural_48": W.run_family("binaural_attention", steps=1, size=48),
            "binaural_sgd": W.run_family("binaural_attention", steps=1, optimizer="SGD"),
            "eval": S.run_binaural_eval(),
            "lite_loss": float(m["loss"]),
            "fit": S.fit_lite(os.path.join(root, "fit_one"))}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the four ranks' results, one-rank results, JAX references)."""
    root = str(tmp_path_factory.mktemp("sp"))
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ctx = mp.spawn(S.run_world, args=(S.WORLD, "file://" + os.path.join(root, "rdv"), root),
                       nprocs=S.WORLD, join=False)
        one = _one_rank(root)
        ref = _jax_references()
        while not ctx.join():
            pass
    finally:
        torch.set_num_threads(prev)
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
             for r in range(S.WORLD)]
    return ranks, one, ref


def _np(d):
    return {k: v.numpy() for k, v in d.items()}


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# the rank layout
# ---------------------------------------------------------------------------

def test_rank_layout_matches_jax_make_mesh(world):
    ranks, _, _ = world
    devices = jax_mesh.make_mesh(4, ("data", "model"), (2, 2)).devices
    want = {d.id: pos for pos, d in np.ndenumerate(devices)}
    for r, res in enumerate(ranks):
        assert tuple(res["layout"]["coords"]) == want[r]
        assert res["layout"]["devices"] == [[d.id for d in row] for row in devices]
        d, m = want[r]
        assert res["layout"]["model_ranks"] == [m, r] and res["layout"]["data_rank"] == d
        assert res["layout"]["one_axis"] == "DataGroup"  # make_global_mesh()'s default


@pytest.mark.parametrize("procs,shape", [((0, 1, 2, 3), (2, 2)), ((0, 0, 1, 1), (2, 2)),
                                         ((0, 1, 0, 1), (2, 2)), ((0, 0, 0, 0), (2, 2)),
                                         ((0, 1, 2, 3), (4, 1)), ((0, 0, 1, 1), (1, 4))])
def test_model_axes_cross_processes_matches_jax(procs, shape, monkeypatch):
    devs = np.empty(4, dtype=object)
    devs[:] = [SimpleNamespace(id=i, process_index=p) for i, p in enumerate(procs)]
    mesh = SimpleNamespace(devices=devs.reshape(shape), axis_names=("data", "model"))
    count = len(set(procs))
    monkeypatch.setattr(jax, "process_count", lambda: count)
    assert model_axes_cross_processes(mesh) == jax_mesh.model_axes_cross_processes(mesh)
    assert model_axes_cross_processes(mesh, process_count=count) == \
        jax_mesh.model_axes_cross_processes(mesh)


def test_mesh_group_model_axis_crosses_processes():
    """In the port each rank is a process: a model axis of sp > 1 ranks
    always crosses processes, and the global-batch convention applies."""
    devs = np.empty(4, dtype=object)
    devs[:] = [SimpleNamespace(id=r, process_index=r) for r in range(4)]
    for shape, crosses in (((2, 2), True), ((1, 4), True), ((4, 1), False)):
        mesh = SimpleNamespace(devices=devs.reshape(shape), axis_names=("data", "model"))
        assert model_axes_cross_processes(mesh) is crosses


# ---------------------------------------------------------------------------
# the sharded STFT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sp,length", STFT_CASES)
def test_sharded_stft_matches_jax(world, sp, length):
    ranks, _, ref = world
    got = ranks[0]["stft"][(sp, length)]["spec"].numpy()
    want = ref["stft"][(sp, length)]
    assert got.shape == want.shape == (2, 2, 257, 1 + length // 16)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    if length in S.STFT_LENGTHS:  # the one-device STFT refuses a pad of the length or more
        single = magnitude_stft(torch.from_numpy(S.stft_wave(length))).numpy()
        assert np.abs(got - single).max() <= 1e-5 * max(1.0, np.abs(single).max())
    # every rank of the group holds the whole spectrogram, bit for bit
    group = [0, 1] if sp == 2 else [0, 1, 2, 3]
    assert len({ranks[r]["stft"][(sp, length)]["sha"] for r in group}) == 1


@pytest.mark.parametrize("sp,length", STFT_CASES)
def test_sharded_stft_halo_is_the_right_neighbours_first_samples(world, sp, length):
    for res in world[0]:
        assert res["stft"][(sp, length)]["halo_ok"]


@pytest.mark.parametrize("sp", [2, 4])
def test_sharded_stft_refuses_chunks_shorter_than_the_halo(world, sp):
    for res in world[0]:
        msg = res["stft"][(sp, "refused")]
        assert msg is not None and "win-hop" in msg and "got 32" in msg


def test_sharded_stft_refusal_matches_jax():
    length = S.STFT_EDGES[4][1]
    with pytest.raises(ValueError, match="win-hop"):
        jax_sharded_stft(jnp.asarray(S.stft_wave(length)), jax_mesh.make_mesh(4), "data")


# ---------------------------------------------------------------------------
# the wired front end
# ---------------------------------------------------------------------------

def test_engine_attaches_the_sharded_frontend(world):
    for res in world[0]:
        assert res["frontend"]["attached"]
        assert res["frontend"]["rows"] == S.LITE_BATCH // 2


def test_wired_frontend_loss_matches_one_rank_and_jax(world):
    ranks, one, ref = world
    for res in ranks:
        np.testing.assert_allclose(res["frontend"]["loss"], one["lite_loss"], rtol=2e-4)
        np.testing.assert_allclose(res["frontend"]["loss"], ref["lite_loss"], rtol=2e-4)


def test_halo_bytes_formula(world):
    """(sp − 1)·(win − hop)·B·C·4 over a model group: rank m receives its
    right neighbour's halo, the last rank none."""
    ranks = world[0]
    for group in ((0, 1), (2, 3)):
        got = [ranks[r]["frontend"]["collectives"].get("collective-permute",
                                                       {"count": 0, "bytes": 0})
               for r in group]
        b, c = S.LITE_BATCH // 2, 2
        assert sum(g["bytes"] for g in got) == (2 - 1) * S.HALO * b * c * 4
        assert [g["count"] for g in got] == [1, 0]


# ---------------------------------------------------------------------------
# the binaural net, DP × SP, in float64
# ---------------------------------------------------------------------------

SP_CASES = {"2x2": ("sp22", "binaural"), "1x4": ("sp14", "binaural"),
            "1x4 at 48²": ("sp14_48", "binaural_48")}


@pytest.mark.parametrize("case", list(SP_CASES))
def test_sp_step_equals_one_rank(world, case):
    ranks, one, _ = world
    key, ref = SP_CASES[case]
    got, want = ranks[0][key], one[ref]
    for k in want["aux"]:
        np.testing.assert_allclose(got["aux"][k], want["aux"][k], rtol=1e-10, err_msg=k)
    np.testing.assert_allclose(got["loss"][0], want["loss"][0], rtol=1e-10)
    np.testing.assert_allclose(got["grad_norm"][0], want["grad_norm"][0], rtol=1e-10)
    assert got["grads"].keys() == want["grads"].keys()
    assert_close_rel(_np(got["grads"]), _np(want["grads"]), 1e-10, f"{case} gradient")
    gates = [k for k in got["grads"] if k.endswith("gamma")]
    assert gates and all(float(got["grads"][k].abs().max()) > 0 for k in gates)
    for k in want["buffers"]:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got["buffers"][k].numpy(), want["buffers"][k].numpy(),
                                       rtol=1e-10, atol=1e-14, err_msg=k)


@pytest.mark.parametrize("case", list(SP_CASES))
def test_sp_ranks_bit_equal_after_every_step(world, case):
    ranks = world[0]
    key = SP_CASES[case][0]
    for res in ranks[1:]:
        assert res[key]["digests"] == ranks[0][key]["digests"]
        assert res[key]["loss"] == ranks[0][key]["loss"]
        _same(res[key]["state"], ranks[0][key]["state"])


@pytest.mark.parametrize("case", ["2x2", "1x4"])
def test_sp_adamw_trajectory_equals_one_rank(world, case):
    ranks, one, _ = world
    key, ref = SP_CASES[case]
    got, want = ranks[0][key], one[ref]
    assert len(got["loss"]) == 3
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-6)
    params = [k for k in want["state"] if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))]
    assert_close_rel(_np(got["state"]), _np(want["state"]), 2e-6, f"{case} parameter",
                     keys=params)


def _update(res, task):
    before = {k: v.numpy() for k, v in task.model.state_dict().items()}
    return {n: res["state"][n].numpy() - before[n] for n, _ in task.model.named_parameters()}


def test_sp_sgd_step_matches_jax(world):
    """The port's 2 × 2 SGD step against the JAX engine with
    sp_axis="model": the loss against JAX's 2 × 2 mesh, the parameter
    updates (−lr × the clipped gradient) against JAX's 1 × 4 mesh.

    The JAX BatchNorm takes the one-pass variance E[x²] − E[x]² (the port
    two passes), whose cancellation puts the one-device port and JAX apart
    on these weights already (loss ~4e-10; the updates of the γ gates,
    sums over every token, a few percent of their largest entry, the others
    ~1e-7 of it): each comparison, tensor by tensor, is held to its
    one-device gap plus 1e-10, which bounds what sequence parallelism adds
    on either side. JAX's 2 × 2 mesh is not the gradients' reference: its
    updates differ from its own one-device ones by up to half a tensor's
    largest entry (on the K/V path), while its 1 × 4 and 4 × 1 meshes give
    the one-device updates."""
    ranks, one, ref = world
    jax_ref = ref["binaural_sgd"]
    _, task = W.build("binaural_attention", "SGD")
    got, mine = ranks[0]["sp22_sgd"], one["binaural_sgd"]
    loss_gap = abs(mine["loss"][0] - jax_ref[None][0]) / abs(jax_ref[None][0])
    assert loss_gap < 1e-9
    assert abs(got["loss"][0] - jax_ref[(2, 2)][0]) / abs(jax_ref[(2, 2)][0]) <= loss_gap + 1e-10
    sp, one_rank = _update(got, task), _update(mine, task)
    # each tensor's scale floored at 1e-3 of the largest (`assert_close_rel`'s)
    gmax = max(np.abs(v).max() for v in jax_ref[(1, 4)][1].values())
    for k, want in jax_ref[(1, 4)][1].items():
        gap = np.abs(one_rank[k] - jax_ref[None][1][k]).max()
        scale = max(np.abs(want).max(), 1e-3 * gmax)
        assert np.abs(sp[k] - want).max() <= gap + 1e-10 * scale, k


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("base", [16, 64, 128])
def test_kernel_plans_at_a_ranks_query_rows(base, sp, dtype):
    """B2's and B3's designs at a rank's ⌈N/sp⌉ query rows against all N
    keys, at every level of 256² (the widths `chip_smoke.py` drives): the
    design of the unsplit attention, B2's grid over the rank's q tiles,
    B3's over the keys unchanged."""
    from audiodepth_tpu_torch.ops.cuda import flash_attention as fa

    dt = getattr(torch, dtype)
    b2 = 2 * 16
    for lv in (2, 3, 4, 5):
        c = {2: 2, 3: 4, 4: 8, 5: 8}[lv] * base
        n = (256 // 2 ** (lv - 1)) ** 2
        nq = -(-n // sp)
        whole, part = fa.fwd_plan(b2, n, n, c // 8, c, dt), fa.fwd_plan(b2, nq, n, c // 8, c, dt)
        assert dataclasses.replace(part, grid=whole.grid) == whole
        assert part.grid == (-(-nq // fa.TILE) * whole.n_slices, b2, 1), (lv, part)
        assert fa.bwd_plan(b2, nq, n, c // 8, c, dt) == fa.bwd_plan(b2, n, n, c // 8, c, dt)


@pytest.mark.parametrize("workspace", [None, ":16:8"])
def test_deterministic_mode_is_scoped_to_the_steps(monkeypatch, workspace):
    """The engine's deterministic mode holds inside its scope and leaves
    torch's flags and CUBLAS_WORKSPACE_CONFIG as it found them after (a
    value set before is kept); not `on`, it changes nothing."""
    import torch.utils.deterministic as det

    from audiodepth_tpu_torch.train.engine import deterministic_kernels

    if workspace is None:
        monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    else:
        monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", workspace)
    before = (torch.are_deterministic_algorithms_enabled(), det.fill_uninitialized_memory)
    assert before == (False, True)
    with deterministic_kernels(False):
        assert not torch.are_deterministic_algorithms_enabled()
    with deterministic_kernels():
        assert torch.are_deterministic_algorithms_enabled()
        assert det.fill_uninitialized_memory is False
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == (workspace or ":4096:8")
    assert (torch.are_deterministic_algorithms_enabled(), det.fill_uninitialized_memory) == before
    assert os.environ.get("CUBLAS_WORKSPACE_CONFIG") == workspace


@pytest.mark.parametrize("shape", [(2, 3, 4, 5), (1, 2, 1, 3), (3, 1, 6, 1)])
def test_deterministic_upsample_matches_torch(shape):
    """The upsample a sequence-parallel engine runs on a card (its backward
    as products with the interpolation matrices) against torch's, in
    float64: the forward is torch's own, the gradient equal at 1e-12."""
    from audiodepth_tpu_torch.models.layers import (_align_corners_matrix,
                                                    _Upsample2xDeterministic)

    rng = np.random.default_rng(sum(shape))
    x = torch.tensor(rng.normal(size=shape), requires_grad=True)
    g = torch.tensor(rng.normal(size=shape[:2] + (2 * shape[2], 2 * shape[3])))
    want = torch.nn.functional.interpolate(x, scale_factor=2, mode="bilinear",
                                           align_corners=True)
    (want_dx,) = torch.autograd.grad(want, x, g)
    got = _Upsample2xDeterministic.apply(x)
    (got_dx,) = torch.autograd.grad(got, x, g)
    assert torch.equal(got, want)
    np.testing.assert_allclose(got_dx.numpy(), want_dx.numpy(), rtol=1e-12, atol=1e-12)
    # the matrices are torch's weights: A·x·Bᵀ is its forward
    ah, aw = (_align_corners_matrix(n, x.device, torch.float64) for n in shape[2:])
    np.testing.assert_allclose((ah @ x.detach() @ aw.t()).numpy(), want.detach().numpy(),
                               rtol=1e-12, atol=1e-12)
    x32 = x.detach().float()
    ah, aw = (_align_corners_matrix(n, x.device) for n in shape[2:])
    want32 = torch.nn.functional.interpolate(x32, scale_factor=2, mode="bilinear",
                                             align_corners=True)
    np.testing.assert_allclose((ah @ x32 @ aw.t()).numpy(), want32.numpy(), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# evaluation and fit
# ---------------------------------------------------------------------------

def test_sp_ragged_evaluation_equals_one_rank(world):
    ranks, one, _ = world
    want = one["eval"]
    for res in ranks:
        assert res["eval22"].keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(res["eval22"][k], v, rtol=1e-10, err_msg=k)


def test_four_rank_fit_preempted_inside_the_epoch2_iterator(world):
    for res in world[0]:
        fit = res["fit"]
        assert fit["preempted"] and fit["latest"] == 1 and fit["step"] == 2
        assert [r["epoch"] for r in fit["history"]] == [1]
        assert fit["history"][0]["samples"] == 2 * S.FIT_BATCH


def test_four_rank_fit_resumes_to_the_one_rank_run(world):
    ranks, one, _ = world
    want = one["fit"]
    assert not want["preempted"] and want["latest"] == S.FIT_EPOCHS
    for res in ranks:
        got = res["fit_resumed"]
        assert got["start"] == 2 and not got["preempted"]
        assert got["latest"] == S.FIT_EPOCHS and got["step"] == want["step"] == 6
        assert set(got["history"][-1]["holdout"]) == {"h"}
        # a 6-step AdamW trajectory: the conv biases ahead of a BatchNorm
        # have a gradient of rounding noise, which Adam normalizes
        assert_close_rel(_np(got["state"]), _np(want["state"]), 2e-6, "parameter")
        for split in ("val", "holdout"):
            for k, v in want[split].items():
                np.testing.assert_allclose(got[split][k], v, rtol=2e-6, err_msg=(split, k))
    for res in ranks[1:]:
        _same(res["fit_resumed"]["state"], ranks[0]["fit_resumed"]["state"])


# ---------------------------------------------------------------------------
# the scaling tool
# ---------------------------------------------------------------------------

def test_tool_report_keys_are_jax_s(world):
    assert scaling.report_keys(8) == scaling.JAX_KEYS == (
        "dp8_unet256", "dp4xsp2_binaural", "weak_scaling_unet")
    report = world[0][0]["tool"]["report"]
    assert set(report) == set(scaling.report_keys(4)) | {"setup"}
    rows = report["weak_scaling_unet"]
    assert [r["devices"] for r in rows] == [1, 2, 4]
    assert [r["time_shared"] for r in rows] == [False, True, True]
    assert all(r["step_s"] > 0 and r["vs_timeshared_ideal"] > 0 for r in rows)
    assert all(res["tool"]["report"] is None for res in world[0][1:])


def _model(family):
    sz = scaling.sizes(True)["unet" if family == "unet_baseline" else "binaural"]
    cfg = scaling._config(family, 8, sz["size"], sz["extra"])
    from audiodepth_tpu_torch.models import make_task

    return cfg, make_task(cfg, device="cpu").model


def _bn_bytes(model, itemsize=4):
    """A train-mode BatchNorm's reductions over the data group: the sums
    and the count (C + 1), then Σ(x − mean)² (C), each with a backward of
    its size."""
    return sum(2 * (2 * m.num_features + 1) * itemsize for m in model.modules()
               if isinstance(m, BatchNorm))


def _param_bytes(model):
    return sum(p.numel() * p.element_size() for p in model.parameters())


def test_tool_dp_all_reduce_bytes(world):
    """The DP step's all-reduces: the gradients (the parameters' bytes),
    BatchNorm's and the losses' reductions (each forward and backward)."""
    tool = world[0][0]["tool"]
    got = tool["report"]["dp4_unet256"]
    _, model = _model("unet_baseline")
    loss = 2 * tool["loss_bytes"][0]
    assert loss > 0
    assert got["all-reduce"]["bytes"] == _param_bytes(model) + _bn_bytes(model) + loss
    assert set(got) == {"all-reduce"}


def _levels(cfg, rows):
    """(2B, N, C) of each attention level at this config."""
    size, c = cfg.dataset.images_size, cfg.model.base_channels
    ch = {1: c, 2: c * 2, 3: c * 4, 4: c * 8, 5: c * 8}
    return [(2 * rows, (size // 2 ** (lv - 1)) ** 2, ch[lv]) for lv in cfg.model.attention_levels]


def test_tool_sp_all_gather_and_all_reduce_bytes(world):
    """dp 2 × sp 2: the attention outputs and dq gathered over the model
    axis (2B·N·C and 2B·N·C/8 a level, float32); the all-reduces are the
    gradients, BatchNorm's and the losses' reductions over the data axis,
    and dK and dV summed over the model axis in float32."""
    tool = world[0][0]["tool"]
    got = tool["report"]["dp2xsp2_binaural"]
    cfg, model = _model("binaural_attention")
    rows = 2 * 4 // 2  # 2 rows a rank, 4 ranks, over a data axis of 2
    levels = _levels(cfg, rows)
    gather = sum(b2 * n * c * 4 + b2 * n * (c // 8) * 4 for b2, n, c in levels)
    assert got["all-gather"] == {"count": 2 * len(levels), "bytes": gather}
    sums = sum(b2 * n * (c // 8) * 4 + b2 * n * c * 4 for b2, n, c in levels)
    loss = 2 * tool["loss_bytes"][1]
    assert got["all-reduce"]["bytes"] == (_param_bytes(model) + _bn_bytes(model) + loss
                                          + sums)
    assert set(got) == {"all-reduce", "all-gather"}
