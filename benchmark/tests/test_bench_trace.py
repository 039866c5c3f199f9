"""Trace arithmetic on a hand-made chrome trace: the busy union, the idle
gaps, the attribution of device time to the registered ops by correlation
id, the roofline reader and its refusal where records were lost."""

import json

import pytest

from flops import PEAKS, kernel_bound_s
from harness import trace
from harness.readings import idle_share, roofline

FWD = "audiodepth::flash_cross_attention_fwd"
SHAPES = [[4, 256, 16], [4, 256, 16], [4, 256, 128], []]


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "pid": 1,
            "args": args}


def _trace(tmp_path, drop_launch=False):
    events = [
        _x(trace.WINDOW_SPAN, "user_annotation", 0, 1000),
        _x(FWD, "cpu_op", 10, 30, **{"Input Dims": SHAPES,
                                     "Input type": ["c10::BFloat16"] * 3 + ["Scalar"]}),
        # the op's dispatch recorded a second time, inside the first
        _x(FWD, "cpu_op", 12, 20, **{"Input Dims": SHAPES}),
        _x("cudaLaunchKernel", "cuda_runtime", 15, 2, correlation=7),
        _x("cudaLaunchKernel", "cuda_runtime", 25, 2, correlation=8),
        _x("aten::add", "cpu_op", 300, 400),
        _x("cudaLaunchKernel", "cuda_runtime", 310, 2, correlation=9),
        _x("flash_fwd_wgmma_kernel", "kernel", 100, 200, correlation=7),
        _x("Memset (Device)", "gpu_memset", 90, 5, correlation=8),
        _x("vectorized_elementwise_kernel", "kernel", 250, 100, correlation=9),
        # before the window: not counted
        _x("old_kernel", "kernel", -50, 20, correlation=1),
    ]
    if drop_launch:
        events = [e for e in events if e["args"].get("correlation") != 7]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return trace.parse_trace(str(path))


def test_busy_union_merges_overlaps():
    assert trace.busy_union_us([(0, 10), (5, 10), (20, 5)]) == 20
    assert trace.busy_union_us([]) == 0


def test_window_and_busy(tmp_path):
    s = _trace(tmp_path)
    assert s.window_us == 1000
    # 90-95, 100-300, 250-350 → 5 + 250
    assert s.busy_us == 255
    assert [g[1] for g in s.idle_gaps(2)] == pytest.approx([650e-6, 90e-6])
    names = [g[0] for g in s.idle_gaps(3)]
    assert names[0] == "aten::add" and "host: no traced op" in names


def test_op_attribution_by_correlation(tmp_path):
    s = _trace(tmp_path)
    calls = s.calls(FWD)
    assert len(calls) == 1
    assert sorted(e.name for e in calls[0].events) == ["Memset (Device)",
                                                       "flash_fwd_wgmma_kernel"]
    assert s.per_category()["B2 flash attention forward (hand-written)"] == 200


def _ctx(summary, launched):
    return {"trace": {"summary": summary, "steps": 1, "counters": {FWD: launched}},
            "peak": PEAKS["H100 SXM"], "cfg": {"sample_rate": 44100},
            "rank_traces": [{"busy_s": summary.busy_us / 1e6,
                             "window_s": summary.window_us / 1e6}]}


def test_roofline_reader(tmp_path):
    s = _trace(tmp_path)
    bound = kernel_bound_s(FWD, SHAPES, "c10::BFloat16", PEAKS["H100 SXM"])
    assert roofline(_ctx(s, 1), FWD) == pytest.approx(100 * bound / 205e-6)
    assert idle_share(_ctx(s, 1)) == pytest.approx(74.5)


def test_roofline_left_out_where_records_were_lost(tmp_path):
    assert roofline(_ctx(_trace(tmp_path), 2), FWD) is None          # counter says 2 calls
    # the kernel's record lost, its memset kept: no kernel for the call
    assert roofline(_ctx(_trace(tmp_path, drop_launch=True), 1), FWD) is None
    assert roofline({"trace": None, "peak": None}, FWD) is None


def test_categories_are_the_frozen_ones():
    assert trace.categorize("sm90_xmma_fprop_implicit_gemm_bf16") \
        == "convolution forward (cuDNN fprop)"
    assert trace.categorize("ncclDevKernel_AllReduce_Sum_f32") == "NCCL collectives"
    assert trace.categorize("fused_mel_frontend_kernel") == "B1 mel front end (hand-written)"
