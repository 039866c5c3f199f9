"""The spans inside the port's steps (`obs/spans.py`) on the CPU: where the
engine, the device cache and the server put them, what they record with and
without a profiler, that they change nothing a step computes, the store's
bound, and the accumulator's threads added up.

The models are small float32 UNets (5 downs, ngf 4) at 32²: a traced step
shows its spans in the profiler's chrome trace as `user_annotation` events.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from audiodepth_tpu_torch.cli import serve as serve_mod
from audiodepth_tpu_torch.configs import load_config
from audiodepth_tpu_torch.data.batvision import make_dataset
from audiodepth_tpu_torch.data.codec import depth_storage_units
from audiodepth_tpu_torch.data.device_cache import DeviceDatasetCache
from audiodepth_tpu_torch.models import init_weights, make_task
from audiodepth_tpu_torch.models.unet import UNetGenerator
from audiodepth_tpu_torch.obs import spans
from audiodepth_tpu_torch.train.engine import Engine

BATCH = 4
PHASES = ("engine.decode", "engine.forward", "engine.backward", "engine.optimizer")


def small_task():
    cfg = load_config("synthetic", "train", model_name="unet_baseline", overrides={
        "dataset.images_size": 32, "dataset.depth_norm": True, "mode.batch_size": BATCH,
        "mode.compute_dtype": "float32"})
    task = make_task(cfg, device="cpu")
    task.model = UNetGenerator(2, 1, num_downs=5, ngf=4, depth_norm=True)
    init_weights(task.model, torch.Generator().manual_seed(0))
    return cfg, task


def small_cache(cfg, rows: int = 2 * BATCH) -> DeviceDatasetCache:
    return DeviceDatasetCache(make_dataset(cfg, "train", num_samples=rows),
                              depth_storage_units(cfg), "cpu")


@pytest.fixture
def store(monkeypatch):
    """The process's store of profiled spans, emptied for the test."""
    monkeypatch.setattr(spans.SPANS, "_records", deque(maxlen=spans.STORE_CAP))
    return spans.SPANS._records


def counts() -> dict:
    return {k: v["count"] for k, v in spans.summary()["totals"].items()}


def grown(before: dict, after: dict) -> dict:
    return {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}


def test_traced_steps_nest_their_phases_in_order(tmp_path, store):
    cfg, task = small_task()
    cache = small_cache(cfg)
    eng = Engine(cfg, task, steps_per_epoch=2)
    state = eng.init_state()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for batch in cache.batches(BATCH, shuffle=True, seed=3):
            state, _ = eng.train_step(state, batch)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    mine = {"cache.gather", "engine.train_step", *PHASES}
    with open(path) as f:   # torch's own annotations (AdamW's) left out
        ann = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                     for e in json.load(f)["traceEvents"]
                     if e.get("cat") == "user_annotation" and e.get("name") in mine)
    steps = [a for a in ann if a[2] == "engine.train_step"]
    assert len(steps) == 2
    assert [a[2] for a in ann].count("cache.gather") == 2
    for s0, s1, _ in steps:
        inside = [a for a in ann if s0 <= a[0] and a[1] <= s1 and a[2] != "engine.train_step"]
        assert [a[2] for a in inside] == list(PHASES)
        assert all(a[1] <= b[0] for a, b in zip(inside, inside[1:]))   # one after another
    # the gathers run before each step, outside it
    gathers = [a for a in ann if a[2] == "cache.gather"]
    assert all(g[1] <= s[0] for g, s in zip(gathers, steps))
    # the store: each profiled span once a step, as it closed, no device time off a card
    assert spans.summary()["device_ms"] == 2 * [
        ("cache.gather", None), *((p, None) for p in PHASES), ("engine.train_step", None)]


def test_untraced_spans_only_count(store):
    cfg, task = small_task()
    cache = small_cache(cfg)
    eng = Engine(cfg, task, steps_per_epoch=2)
    state = eng.init_state()
    before = counts()
    n = 0
    for batch in cache.batches(BATCH, shuffle=False):
        state, _ = eng.train_step(state, batch)
        n += 1
    assert not store and spans.summary()["device_ms"] == []
    assert grown(before, counts()) == {"cache.gather": n, "engine.train_step": n,
                                       **{p: n for p in PHASES}}


def test_spans_change_nothing_a_step_computes():
    cfg, _ = small_task()
    batch = next(small_cache(cfg).batches(BATCH, shuffle=False))
    out = []
    for traced in (False, True):
        _, task = small_task()
        eng = Engine(cfg, task)
        state = eng.init_state()
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                state, m = eng.train_step(state, batch)
        else:
            state, m = eng.train_step(state, batch)
        out.append((m["loss"], m["grad_norm"],
                    [p.detach().clone() for p in state.model.parameters()]))
    (l0, g0, p0), (l1, g1, p1) = out
    assert torch.equal(l0, l1) and torch.equal(g0, g1)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def test_store_keeps_its_cap_dropping_the_oldest():
    assert spans.SPANS._records.maxlen == spans.STORE_CAP == 4096
    store = spans.Spans(cap=8)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(20):
            with store.span(f"x{i}"):
                pass
    s = store.summary()
    assert s["device_ms"] == [(f"x{i}", None) for i in range(12, 20)]
    assert sum(t["count"] for t in s["totals"].values()) == 20
    store.add("wait", 0.25)
    store.add("wait", 0.5)
    assert store.summary()["totals"]["wait"] == {"count": 2, "host_s": 0.75}


def test_accumulator_adds_up_the_threads():
    store = spans.Spans()

    def work(n):
        for _ in range(n):
            with store.span("w"):
                pass
        store.add("wait", 0.125 * n)

    threads = [threading.Thread(target=work, args=(n,)) for n in (1, 2, 3, 4)]
    for t in threads:
        t.start()
    work(5)
    for t in threads:
        t.join()
    totals = store.summary()["totals"]
    assert totals["w"]["count"] == 15 and totals["w"]["host_s"] > 0
    assert totals["wait"] == {"count": 5, "host_s": 1.875}
    assert store.summary()["device_ms"] == []   # no profiler, no record


def test_cache_encode_counts_once_per_cache():
    cfg, _ = small_task()
    ds = make_dataset(cfg, "train", num_samples=6)
    before = spans.summary()["totals"]
    walls = []
    for _ in range(2):
        t = time.perf_counter()
        DeviceDatasetCache(ds, depth_storage_units(cfg), "cpu")
        walls.append(time.perf_counter() - t)
    after = spans.summary()["totals"]
    assert after["cache.encode"]["count"] - before.get("cache.encode", {"count": 0})["count"] == 2
    encode = (after["cache.encode"]["host_s"]
              - before.get("cache.encode", {"host_s": 0.0})["host_s"])
    assert 0 < encode <= sum(walls)


def test_serving_spans_and_queue_wait(store):
    cfg, task = small_task()
    runner = serve_mod.InferenceRunner(cfg, task, ladder=(1, 4))
    batcher = serve_mod.MicroBatcher(runner, wait_ms=50.0)
    try:
        before = counts()
        with profile(activities=[ProfilerActivity.CPU]):
            reqs = [batcher.submit(np.zeros((2, runner.wave_len), np.float32))
                    for _ in range(3)]
            for r in reqs:
                assert r.event.wait(timeout=60) and r.error is None
            batcher.stop()   # its last batch's span closes after the answers are out
            assert not batcher._thread.is_alive()
        grew = grown(before, counts())
        batches = grew["serve.batch"]
        assert grew == {"serve.queue_wait": 3, "serve.batch": batches, "runner.h2d": batches,
                        "runner.forward": batches, "runner.d2h": batches}
        # the device thread's spans are kept beside the collector's
        recs = spans.summary()["device_ms"]
        assert sorted(recs) == sorted(batches * [(n, None) for n in (
            "runner.d2h", "runner.forward", "runner.h2d", "serve.batch")])
    finally:
        batcher.stop()
        runner.close()



def adabins_task():
    cfg = load_config("synthetic", "train", model_name="adabins_distillation", overrides={
        "dataset.images_size": 32, "mode.batch_size": BATCH, "mode.compute_dtype": "float32",
        "model.base_channels": 4, "model.n_bins": 8})
    task = make_task(cfg, device="cpu")
    init_weights(task.model, torch.Generator().manual_seed(0))
    return cfg, task


ADABINS = ("adabins.teacher", "adabins.bins", "loss.distillation")


@pytest.mark.parametrize("with_image", [True, False], ids=["paired", "audio_only"])
def test_adabins_spans_inside_the_forward(tmp_path, store, with_image):
    """A paired step enters the teacher's span once, the bins' twice (a
    branch each) and the loss's once, all inside `engine.forward`; a step
    with no frame runs no teacher, and its one branch's bins."""
    from audiodepth_tpu_torch.data.synthetic import SyntheticEchoDataset

    cfg, task = adabins_task()
    cache = DeviceDatasetCache(SyntheticEchoDataset(cfg, num_samples=BATCH, seed=0,
                                                    with_image=with_image),
                               depth_storage_units(cfg), "cpu")
    eng = Engine(cfg, task)
    state = eng.init_state()
    batch = cache.batch(np.arange(BATCH))
    assert ("image" in batch) == with_image
    before = counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, _ = eng.train_step(state, batch)
    want = {"adabins.teacher": 1, "adabins.bins": 2, "loss.distillation": 1} if with_image \
        else {"adabins.bins": 1, "loss.distillation": 1}
    assert {k: n for k, n in grown(before, counts()).items() if k in ADABINS} == want
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        ann = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
               for e in json.load(f)["traceEvents"] if e.get("cat") == "user_annotation"]
    (f0, f1, _), = [a for a in ann if a[2] == "engine.forward"]
    mine = [a for a in ann if a[2] in ADABINS]
    assert sorted(a[2] for a in mine) == sorted(k for k, n in want.items() for _ in range(n))
    assert all(f0 <= a[0] and a[1] <= f1 for a in mine)
    if with_image:   # the teacher's bins inside the teacher's span
        (t0, t1, _), = [a for a in mine if a[2] == "adabins.teacher"]
        assert sum(1 for a in mine if a[2] == "adabins.bins" and t0 <= a[0] and a[1] <= t1) == 1


def coarse_task(model_type="hybrid"):
    cfg = load_config("synthetic", "train", model_name="coarse_depth", overrides={
        "dataset.images_size": 32, "mode.batch_size": BATCH, "mode.compute_dtype": "float32",
        "model.base_channels": 4, "model.n_bins": 8, "model.model_type": model_type})
    task = make_task(cfg, device="cpu")
    init_weights(task.model, torch.Generator().manual_seed(0))
    return cfg, task


def coarse_batch(cfg, task):
    """A batch of the device cache with its bins, as `cli/train.py
    --device_cache` loads a coarse split (int32 bins beside the compact
    waveform and depth)."""
    from audiodepth_tpu_torch.cli.train import _BinnedView
    from audiodepth_tpu_torch.data.synthetic import SyntheticEchoDataset

    ds = _BinnedView(SyntheticEchoDataset(cfg, num_samples=BATCH, seed=0), task.bin_edges, cfg)
    cache = DeviceDatasetCache(ds, depth_storage_units(cfg), "cpu")
    assert cache.arrays["bins"].dtype == torch.int32
    return cache.batch(np.arange(BATCH))


COARSE = ("coarse.bins", "coarse.offset", "loss.coarse")


@pytest.mark.parametrize("model_type", ["hybrid", "unet", "lite", "dual_reg"])
def test_coarse_spans_inside_the_forward(tmp_path, store, model_type):
    """A hybrid step enters the soft binning's, the offset branch's and the
    loss's spans once each, all inside `engine.forward`; the unet and lite
    models have no offset branch, dual_reg no bins."""
    cfg, task = coarse_task(model_type)
    eng = Engine(cfg, task)
    state = eng.init_state()
    batch = coarse_batch(cfg, task)
    before = counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, _ = eng.train_step(state, batch)
    want = {"coarse.bins": model_type != "dual_reg",
            "coarse.offset": model_type in ("hybrid", "dual_reg"), "loss.coarse": True}
    want = {k: 1 for k, on in want.items() if on}
    assert {k: n for k, n in grown(before, counts()).items() if k in COARSE} == want
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        ann = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
               for e in json.load(f)["traceEvents"] if e.get("cat") == "user_annotation"]
    (f0, f1, _), = [a for a in ann if a[2] == "engine.forward"]
    mine = [a for a in ann if a[2] in COARSE]
    assert sorted(a[2] for a in mine) == sorted(want)
    assert all(f0 <= a[0] and a[1] <= f1 for a in mine)
    # the loss after the forward's branches
    (l0, _, _), = [a for a in mine if a[2] == "loss.coarse"]
    assert all(a[1] <= l0 for a in mine if a[2] != "loss.coarse")


def test_coarse_spans_change_nothing_a_step_computes():
    out = []
    for traced in (False, True):
        cfg, task = coarse_task()
        batch = coarse_batch(cfg, task)
        eng = Engine(cfg, task)
        state = eng.init_state()
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                state, m = eng.train_step(state, batch)
        else:
            state, m = eng.train_step(state, batch)
        out.append((m["loss"], m["grad_norm"],
                    [p.detach().clone() for p in state.model.parameters()],
                    [b.detach().clone() for b in state.model.buffers()]))
    (l0, g0, p0, b0), (l1, g1, p1, b1) = out
    assert torch.equal(l0, l1) and torch.equal(g0, g1)
    assert all(torch.equal(a, b) for a, b in zip(p0 + b0, p1 + b1))


@pytest.mark.parametrize("name", ["step.coarse_bins_ms.train", "step.offset_ms.train",
                                  "step.coarse_loss_ms.train"])
def test_coarse_readers_none_without_their_spans(monkeypatch, name):
    """The benchmark's readers of the three spans: None in an untraced run,
    None on a program whose store holds the step's spans but
    not theirs (the parent commit's), and their device ms a step where it
    holds them."""
    import sys
    from pathlib import Path

    bench = str(Path(__file__).resolve().parents[1] / "benchmark")
    if bench not in sys.path:
        sys.path.append(bench)   # after the repository's own packages
    from harness import spans as hs
    from harness.spec import load_reader
    from harness.trace import GpuEvent, TraceSummary

    summary = TraceSummary(window_us=100.0, gpu=[GpuEvent("k", 0.0, 50.0, None)], ops=[],
                           host=[], start_us=0.0)
    ctx = {"trace": {"summary": summary, "steps": 2, "counters": {}}}
    step = [("engine.train_step", 90.0), ("engine.forward", 40.0)] * 2
    monkeypatch.setattr(hs, "program_spans", lambda: {"device_ms": step, "totals": {}})
    read = load_reader(name)
    assert read({"trace": None, "rank_traces": [None]}) is None
    assert read(ctx) is None
    span = {"step.coarse_bins_ms.train": "coarse.bins", "step.offset_ms.train": "coarse.offset",
            "step.coarse_loss_ms.train": "loss.coarse"}[name]
    monkeypatch.setattr(hs, "program_spans", lambda: {
        "device_ms": step + [(span, 3.0), (span, 5.0)], "totals": {}})
    assert read(ctx) == pytest.approx(4.0)
