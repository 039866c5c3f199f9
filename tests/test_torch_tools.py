"""The port's tools and the last pieces of its train CLI and obs/, on the CPU.

  * `tools/profile_step.py`: `categorize` on the CUDA kernel names the card's
    profiles hold (cuDNN fprop/dgrad/wgrad, BatchNorm, elementwise, AdamW's
    multi_tensor_apply, copies, softmax, upsample, cuBLAS, B1/B2/B3);
    `parse_trace` and `report` on a fabricated chrome trace (steps found
    through the launches' correlation ids, the busy union of overlapping
    events, a hand-written kernel whose records are missing reported
    DROPPED); `capture --device cpu` at a tiny size, end to end;
  * `cli/train.py --profile_dir` writes the trace of epoch 2 of 2 (the
    `obs.ProfilerHook`), and `Engine.fit` stops the hook when a step
    raises inside the profiled epoch;
  * `tools/verify_contracts.py`: the answer and the five feature shapes and
    the depth shape equal the JAX tool's (NHWC ↔ NCHW) at base 8, 64²;
  * `obs/visualize.py`: `save_distillation_panel` and `save_decomposition`
    write PNGs equal pixel for pixel to the JAX functions' on the same
    arrays;
  * wandb (a stub module): the early init gets the JAX CLI's kwargs, a sweep
    config value overrides the matching flag, `MetricLogger` adopts the
    active run, and without wandb the run goes on with the JAX message;
    `--freeze_rgb` is accepted.
"""

from __future__ import annotations

import json
import os
import re
import sys
import types

import numpy as np
import pytest

from audiodepth_tpu_torch.cli import train as train_cli
from audiodepth_tpu_torch.tools import profile_step as ps

from tests.torch_parity import one_torch_thread  # noqa: F401

_CPU_ARGS = ["--device", "cpu", "--dataset", "synthetic", "--model", "binaural_attention",
             "--base_channels", "8", "--override", "dataset.images_size=32",
             "--num_samples", "4", "--batch_size", "2", "--validation", "false"]


# ---------------------------------------------------------------------------
# tools/profile_step.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,category", [
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64_"
     "warpgroupsize1x1x1_execute_segment_k_off_kernel__5x_cudnn",
     "convolution forward (cuDNN fprop)"),
    ("sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64",
     "convolution data gradient (cuDNN dgrad)"),
    ("sm90_xmma_wgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize64x64x64",
     "convolution weight gradient (cuDNN wgrad)"),
    ("void at::native::batch_norm_collect_statistics_channels_last_kernel<at::native::Var, "
     "float, float, 4>(float const*, long, long, float*, float*, int*, double)", "BatchNorm"),
    ("void at::native::batch_norm_backward_reduce_channels_last_kernel<4, float, float, float>",
     "BatchNorm"),
    ("void cudnn::batchnorm_bwtr_nhwc_semiPersist<float, float, float, 512, 16, 3, 4, 1, 0, "
     "true, 2>(cudnn::NhwcBatchNormBwdParams<float, float>)", "BatchNorm"),
    ("void (anonymous namespace)::bn_fwd_apply_kernel<8, true>(__nv_bfloat16 const*, long long)",
     "BatchNorm"),
    ("void (anonymous namespace)::bn_bwd_finalize_kernel(float const*, int, long long, int)",
     "BatchNorm"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, "
     "std::array<char*, 3ul> >(int, at::native::CUDAFunctor_add<float>, std::array<char*, 3ul>)",
     "elementwise"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::native::(anonymous "
     "namespace)::TensorListMetadata<4>, at::native::(anonymous namespace)::FusedAdamMathFunctor"
     "<float, 4, (at::native::ADAM_MODE)1, false>, float*, double, double>",
     "optimizer (multi_tensor_apply)"),
    ("Memcpy HtoD (Pinned -> Device)", "copies and memsets"),
    ("Memset (Device)", "copies and memsets"),
    ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, float, float, float, "
     "at::native::(anonymous namespace)::SoftMaxForwardEpilogue>(float*, float const*, int)",
     "softmax"),
    ("void at::native::(anonymous namespace)::upsample_bilinear2d_out_frame<c10::BFloat16, "
     "float>(int, float, float, bool, at::GenericPackedTensorAccessor<c10::BFloat16, 4ul>)",
     "upsample"),
    ("nvjet_tst_128x64_64x8_1x1_v_bz_TNN", "matrix products (cuBLAS)"),
    ("void fused_mel_frontend_kernel(Params)", "B1 mel front end (hand-written)"),
    ("void frontend_normalize_kernel(float*, float const*, int, int, int)",
     "B1 mel front end (hand-written)"),
    ("void flash_fwd_wgmma_kernel<16, 128, 3>(CUtensorMap, CUtensorMap, CUtensorMap)",
     "B2 flash attention forward (hand-written)"),
    ("void flash_bwd_wgmma_kernel<64, 128, 1>(CUtensorMap, CUtensorMap, CUtensorMap)",
     "B3 flash attention backward (hand-written)"),
    ("void flash_bwd_prep_kernel(__nv_bfloat16 const*, __nv_bfloat16 const*, float*)",
     "B3 flash attention backward (hand-written)"),
    ("void (anonymous namespace)::soft_bin_fwd_kernel<16>(__nv_bfloat16 const*, float const*, "
     "(anonymous namespace)::Shape, float*, float*)", "AdaBins soft binning (hand-written)"),
    ("void (anonymous namespace)::soft_bin_finalize_kernel(float const*, int, int, float, float*)",
     "AdaBins soft binning (hand-written)"),
    ("void some_unknown_kernel<int>(int)", "misc"),
])
def test_categorize_cuda_kernel_names(name, category):
    assert ps.categorize(name) == category


def _event(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def _fabricated_trace(path):
    """Two steps of 100 µs; a conv launched in step 0 runs in step 1's span
    (it belongs to step 0 by its launch); B2's launch record is missing (it
    falls in step 1 by its own start) and overlaps the conv; a copy on
    another stream; B3 was counted twice by its wrapper and recorded never; a
    primer kernel before the steps is left out of every sum."""
    events = [
        _event("cuda_runtime", "cudaLaunchKernel", -60, 1, correlation=7),
        _event("kernel", "void at::native::vectorized_elementwise_kernel<4>", -50, 3,
               correlation=7, stream=7),
        _event("user_annotation", "adepth_step_0", 0, 100),
        _event("user_annotation", "adepth_step_1", 100, 100),
        _event("cuda_runtime", "cudaLaunchKernelExC", 10, 2, correlation=1),
        _event("kernel", "void fused_mel_frontend_kernel(Params)", 50, 5, correlation=1,
               stream=7),
        _event("cuda_runtime", "cudaLaunchKernel", 90, 2, correlation=2),
        _event("kernel", "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32", 120, 30,
               correlation=2, stream=7),
        _event("kernel", "void flash_fwd_wgmma_kernel<16, 128, 3>(CUtensorMap)", 130, 20,
               correlation=99, stream=7),
        _event("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 105, 4, stream=9, bytes=4096),
        {"ph": "i", "cat": "kernel", "name": "an instant, ignored", "ts": 1},
        _event("cpu_op", "aten::conv2d", 20, 40),
    ]
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)


def test_parse_trace_and_report_on_a_fabricated_trace(tmp_path):
    path = str(tmp_path / "t.json")
    _fabricated_trace(path)
    prof = ps.parse_trace(path, steps=2)
    assert prof.per_step == [35.0, 24.0] and prof.outside_steps_us == 3.0
    assert prof.busy_us == 5 + 4 + 30 and prof.window_us == 200.0
    assert prof.per_category == {"B1 mel front end (hand-written)": 5.0,
                                 "convolution forward (cuDNN fprop)": 30.0,
                                 "B2 flash attention forward (hand-written)": 20.0,
                                 "copies and memsets": 4.0}
    assert prof.total_us == 59.0 and len(prof.activity) == 5
    copy = next(a for a in prof.activity if a.cat == "gpu_memcpy")
    assert (copy.stream, copy.bytes, copy.step) == (9, 4096, 1)
    counters = {"fused_mel_frontend": 1, "flash_cross_attention_fwd": 1,
                "flash_cross_attention_bwd": 2}
    rows = ps.hand_written_rows(prof, counters)
    assert rows == [("fused_mel_frontend", 1, 1, False),
                    ("flash_cross_attention_fwd", 1, 1, False),
                    ("flash_cross_attention_bwd", 0, 2, True),
                    ("batch_norm_train_fwd", 0, 0, False),
                    ("batch_norm_train_bwd", 0, 0, False),
                    ("soft_binning_fwd", 0, 0, False),
                    ("soft_binning_bwd", 0, 0, False)]
    text = ps.report(prof, 2, top=3, counters=counters)
    lines = text.splitlines()
    assert lines[0].startswith("GPU time 0.029 ms/step over 2 steps")
    assert "per step (ms): 0.035, 0.024; outside the steps 0.003" in text
    assert re.search(r"convolution forward \(cuDNN fprop\) +0\.015  50\.8%", text)
    assert re.search(r"TOTAL \(GPU-event sum\) +0\.029", text)
    assert [ln for ln in lines if "DROPPED" in ln] == [
        "  flash_cross_attention_bwd    trace     0  counter     2  DROPPED"]
    assert "top 3 kernels:" in text and "n/a" not in text
    assert "n/a" in ps.report(prof, 2)  # a read trace has no counters


def test_span_lines_take_the_gpu_events_their_launches_started(tmp_path):
    """A kernel counts in every program span that holds its launch, wherever
    the kernel runs and whichever thread launched it (autograd's backward
    runs on a thread of its own); a launch outside every span or without a
    record counts in none; torch's own annotations get no line."""
    def ev(cat, name, ts, dur, tid, **args):
        return dict(_event(cat, name, ts, dur, **args), tid=tid)

    events = [
        ev("user_annotation", "engine.train_step", 0, 100, 1),
        ev("user_annotation", "engine.forward", 10, 30, 1),
        ev("user_annotation", "engine.backward", 40, 50, 1),
        ev("user_annotation", "Optimizer.step#AdamW.step", 92, 5, 1),
        ev("user_annotation", "engine.train_step", 100, 100, 1),
        ev("user_annotation", "engine.forward", 110, 30, 1),
        ev("user_annotation", "runner.forward", 15, 10, 2),
        ev("cuda_runtime", "cudaLaunchKernel", 20, 1, 1, correlation=1),
        ev("kernel", "k", 150, 7, 7, correlation=1),
        ev("cuda_runtime", "cudaLaunchKernel", 50, 1, 1, correlation=2),
        ev("kernel", "k", 160, 11, 7, correlation=2),
        ev("cuda_runtime", "cudaLaunchKernel", 95, 1, 1, correlation=3),
        ev("kernel", "k", 171, 2, 7, correlation=3),
        ev("cuda_runtime", "cudaLaunchKernel", 20, 1, 2, correlation=4),
        ev("kernel", "k", 30, 3, 7, correlation=4),
        ev("cuda_runtime", "cudaLaunchKernel", 60, 1, 3, correlation=7),
        ev("kernel", "k", 180, 13, 7, correlation=7),
        ev("cuda_runtime", "cudaLaunchKernel", 250, 1, 1, correlation=5),
        ev("kernel", "k", 251, 5, 7, correlation=5),
        ev("kernel", "k", 120, 4, 7, correlation=6),
    ]
    path = str(tmp_path / "t.json")
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    prof = ps.parse_trace(path, steps=2)
    assert prof.phases == {"engine.train_step": (2, 200.0, 36.0), "engine.forward": (2, 60.0, 10.0),
                           "runner.forward": (1, 10.0, 10.0), "engine.backward": (1, 50.0, 24.0)}
    text = ps.report(prof, 2)
    assert "  engine.train_step        2  host    0.100  device    0.018" in text
    assert "  engine.backward          1  host    0.050  device    0.024" in text
    assert "AdamW" not in text


@pytest.mark.parametrize("model,overrides", [
    ("unet_baseline", ["model.generator=unet_128", "model.ngf=4", "dataset.images_size=128"]),
    ("coarse_depth", ["model.base_channels=4", "model.n_bins=8", "dataset.images_size=32"]),
])
def test_capture_on_cpu_end_to_end(model, overrides, tmp_path, capsys):
    argv = ["--device", "cpu", "--model", model, "--batch_size", "2", "--steps", "2",
            "--trace_dir", str(tmp_path), "--keep_trace"]
    for o in overrides:
        argv += ["--override", o]
    prof, counters = ps.main(argv)
    assert len(prof.per_step) == 2 and prof.total_us == 0.0  # the CPU has no GPU events
    assert counters == {"fused_mel_frontend": 0, "flash_cross_attention_fwd": 0,
                        "flash_cross_attention_bwd": 0, "batch_norm_train_fwd": 0,
                        "batch_norm_train_bwd": 0, "soft_binning_fwd": 0,
                        "soft_binning_bwd": 0}
    out = capsys.readouterr().out
    assert "hand-written kernels" in out and "DROPPED" not in out
    # one line a phase of the step, from the engine's spans (no device ms here)
    for name in ("engine.train_step", "engine.decode", "engine.forward", "engine.backward",
                 "engine.optimizer"):
        assert re.search(rf"^  {re.escape(name)} +2  host +[0-9.]+  device +n/a$", out, re.M), name
    path = os.path.join(str(tmp_path), f"{model}_bs2.pt.trace.json")
    assert f"trace: {path}" in out and os.path.exists(path)
    again, _ = ps.main(["--parse_only", path, "--steps", "2"])
    assert again.per_step == prof.per_step


# ---------------------------------------------------------------------------
# --profile_dir and the fit's hook
# ---------------------------------------------------------------------------

def test_profile_dir_traces_epoch_two_of_two(tmp_path, capsys):
    out = tmp_path / "prof"
    eng, state = train_cli.main(_CPU_ARGS + ["--epochs", "2", "--profile_dir", str(out)])
    assert state.step == 4
    assert sorted(os.listdir(out)) == ["epoch_2.pt.trace.json"]
    path = str(out / "epoch_2.pt.trace.json")
    assert f"profiler trace for epoch 2: {path}" in capsys.readouterr().out
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::convolution" in names and "autograd::engine::evaluate_function: " \
        "ConvolutionBackward0" in names  # the steps' forward and backward
    assert ps.parse_trace(path, 2).total_us == 0.0  # no GPU on this host


def test_fit_stops_the_profiler_when_a_step_raises(tmp_path):
    from audiodepth_tpu_torch.obs import ProfilerHook

    hook = ProfilerHook(str(tmp_path))
    hook.stop()  # no trace: nothing
    assert hook.path is None

    def boom(state, metrics):
        if state.step == 3:  # inside epoch 2, the profiled one
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        train_cli.main(_CPU_ARGS + ["--epochs", "3", "--profile_dir", str(tmp_path / "p")],
                       on_step=boom)
    assert os.listdir(tmp_path / "p") == ["epoch_2.pt.trace.json"]


# ---------------------------------------------------------------------------
# tools/verify_contracts.py
# ---------------------------------------------------------------------------

def test_verify_contracts_matches_jax(capsys):
    import jax

    from audiodepth_tpu.tools import verify_contracts as jvc
    from audiodepth_tpu_torch.tools import verify_contracts as vc

    answer = []  # the JAX tool traced abstractly: its shapes without running its models
    jax.eval_shape(lambda: answer.append(jvc.verify_compatibility(base_channels=8, size=64)))
    assert answer == [True]
    jax_lines = capsys.readouterr().out
    want = {m.group(1): (eval(m.group(2)), eval(m.group(3))) for m in re.finditer(
        r"(\w+): teacher (\([\d, ]+\)) vs student (\([\d, ]+\)) OK", jax_lines)}
    got = vc.contract_shapes(8, 64, device="cpu")
    nhwc = {k: tuple((s[0], s[2], s[3], s[1]) for s in v) for k, v in got.items()}
    assert set(want) == set(got) == {"x1", "x2", "x3", "x4", "x5", "depth"}
    assert nhwc == want
    assert vc.verify_compatibility(8, 64, device="cpu") is True
    port_lines = capsys.readouterr().out
    assert port_lines.count("OK") == 6 and "distillation readiness: READY" in port_lines


# ---------------------------------------------------------------------------
# obs/visualize.py panels
# ---------------------------------------------------------------------------

def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0, 30, (32, 32, 1)).astype(np.float32)
    gt[:4] = 0.0
    return (gt, rng.uniform(0, 30, (32, 32)).astype(np.float32),
            rng.uniform(0, 30, (1, 32, 32)).astype(np.float32),
            np.sort(rng.uniform(0, 30, 8)).astype(np.float32),
            np.sort(rng.uniform(0, 30, 8)).astype(np.float32))


def _same_png(a, b):
    import matplotlib.image as mpimg

    x, y = mpimg.imread(a), mpimg.imread(b)
    assert x.shape == y.shape and x.size > 0
    np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("with_teacher", [True, False])
def test_distillation_panel_equals_jax(with_teacher, tmp_path):
    from audiodepth_tpu.obs import visualize as jvis
    from audiodepth_tpu_torch.obs import visualize as vis

    gt, student, teacher, sc, tc = _arrays()
    if not with_teacher:
        teacher = tc = None
    a = vis.save_distillation_panel(gt, student, teacher, sc, tc, str(tmp_path / "p.png"))
    b = jvis.save_distillation_panel(gt, student, teacher, sc, tc, str(tmp_path / "j.png"))
    _same_png(a, b)


def test_decomposition_equals_jax(tmp_path):
    from audiodepth_tpu.obs import visualize as jvis
    from audiodepth_tpu_torch.obs import visualize as vis

    gt, student, teacher, _, _ = _arrays(1)
    panels = {"base": student, "residual": student - 15.0, "final": teacher, "GT": gt}
    a = vis.save_decomposition(panels, str(tmp_path / "p.png"), max_depth=20.0)
    b = jvis.save_decomposition(panels, str(tmp_path / "j.png"), max_depth=20.0)
    _same_png(a, b)


# ---------------------------------------------------------------------------
# wandb
# ---------------------------------------------------------------------------

class _Run:
    def __init__(self):
        self.logged, self.finished, self.name = [], False, None

    def log(self, record, step=None):
        self.logged.append((step, record))

    def finish(self):
        self.finished = True


class _Config(dict):
    def update(self, other=None, allow_val_change=False, **kw):
        super().update(other or {})


def _stub_wandb(monkeypatch, sweep=None):
    stub = types.ModuleType("wandb")
    stub.run, stub.config, stub.inits = None, _Config(sweep or {}), []

    def init(**kwargs):
        stub.inits.append(kwargs)
        stub.run = _Run()
        return stub.run

    stub.init, stub.Image = init, lambda path: ("image", path)
    monkeypatch.setitem(sys.modules, "wandb", stub)
    return stub


def test_wandb_early_init_sweep_override_and_adopted_run(monkeypatch, capsys):
    stub = _stub_wandb(monkeypatch, sweep={"learning_rate": 0.005, "no_such_flag": 1,
                                           "batch_size": None})
    eng, state = train_cli.main(_CPU_ARGS + [
        "--epochs", "1", "--use_wandb", "--wandb_project", "proj", "--wandb_entity", "team",
        "--wandb_mode", "offline", "--freeze_rgb"])
    assert stub.inits == [{"project": "proj", "allow_val_change": True, "entity": "team",
                           "mode": "offline"}]  # one init: the logger adopted the run
    out = capsys.readouterr().out
    assert "[sweep] override learning_rate=0.005" in out and "no_such_flag" not in out
    assert eng.cfg.mode.learning_rate == 0.005 and eng.cfg.mode.batch_size == 2
    run = stub.run
    from audiodepth_tpu_torch.configs import experiment_name

    assert run.name == experiment_name(eng.cfg)
    assert stub.config["mode"]["learning_rate"] == 0.005  # the logger's config update
    assert any("train/loss" in rec for _, rec in run.logged) and run.finished


def test_wandb_defaults_match_the_jax_cli(monkeypatch):
    from audiodepth_tpu.cli.train import build_parser as jax_build_parser

    stub = _stub_wandb(monkeypatch)
    train_cli.main(_CPU_ARGS + ["--epochs", "1", "--use_wandb"])
    want = jax_build_parser().parse_args([])
    assert stub.inits == [{"project": want.wandb_project, "allow_val_change": True}]
    got = train_cli.build_parser().parse_args([])
    for flag in ("wandb_project", "wandb_entity", "wandb_mode", "freeze_rgb", "profile_dir"):
        assert getattr(got, flag) == getattr(want, flag), flag


def test_without_wandb_training_goes_on(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb raises ImportError
    eng, state = train_cli.main(_CPU_ARGS + ["--epochs", "1", "--use_wandb"])
    assert state.step == 2
    out = capsys.readouterr().out
    assert re.search(r"\[train\] wandb unavailable \(.+\); continuing without", out)
    assert "[obs] wandb unavailable" in out
