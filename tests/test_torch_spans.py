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

