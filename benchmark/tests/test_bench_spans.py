"""The span readers on hand-built readings: the device's idle time split by
the program's `engine.train_step` annotations, a gap cut at an
annotation's edge, the phases' device ms a step from the program's store,
and None where there is nothing to read (the CPU, an untraced run, a
program without the spans)."""

import pytest

from harness import spans as hs
from harness.readings import idle_share
from harness.spec import load_reader
from harness.trace import GpuEvent, TraceSummary

STEP = hs.TRAIN_STEP
NEW = ("step.input_ms.train", "step.forward_ms.train", "step.backward_ms.train",
       "step.optimizer_ms.train", "step.idle_in_ms.train", "step.idle_between_ms.train",
       "setup.cache_encode_s")
KEPT = ("serve.queue_wait_ms", "serve.copy_ms")


def _ctx(gpu, host, window=(0.0, 1000.0)):
    s = TraceSummary(window_us=window[1] - window[0],
                     gpu=[GpuEvent("k", a, b - a, None) for a, b in gpu], ops=[],
                     host=[(a, b - a, name) for a, b, name in host], start_us=window[0])
    return {"trace": {"summary": s, "steps": 2, "counters": {}},
            "rank_traces": [{"busy_s": s.busy_us / 1e6, "window_s": s.window_us / 1e6}]}


# busy 0-100, 150-400, 450-900: idle 100-150, 400-450, 900-1000 (200 µs of 1000)
GPU = [(0, 100), (150, 400), (450, 900)]
# the second gap straddles both steps' edges: 20 µs in each, 10 µs between
HOST = [(50, 420, STEP), (430, 950, STEP), (0, 1000, "bench.traced_window"),
        (40, 425, "bench.step"), (425, 960, "bench.step"), (120, 130, "engine.forward")]


def test_idle_split_sums_to_the_idle_share():
    ctx = _ctx(GPU, HOST)
    inside, between, steps = hs.idle_split(ctx)
    assert steps == 2
    assert (inside, between) == pytest.approx((0.140, 0.060))
    idle_ms = idle_share(ctx) / 100 * 1000 / 1e3
    assert (inside + between) == pytest.approx(idle_ms)
    assert load_reader("step.idle_in_ms.train")(ctx) == pytest.approx(0.070)
    assert load_reader("step.idle_between_ms.train")(ctx) == pytest.approx(0.030)


def test_a_gap_across_a_step_edge_is_cut_there():
    # one gap, 300-700; the step annotation covers 200-500 of it
    ctx = _ctx([(0, 300), (700, 1000)], [(200, 500, STEP)])
    assert hs.idle_split(ctx)[:2] == pytest.approx((0.200, 0.200))
    # annotations reaching past the window count only inside it
    ctx = _ctx([(0, 300), (700, 1000)], [(-50, 400, STEP), (600, 1200, STEP)])
    assert hs.idle_split(ctx) == pytest.approx((0.200, 0.200, 2))


def test_phases_read_the_program_store(monkeypatch):
    recs = ([("cache.gather", 0.5), (STEP, 50.0), ("engine.decode", 0.25),
             ("engine.forward", 20.0), ("engine.backward", 25.0), ("engine.optimizer", None)] * 2
            + [("runner.h2d", 0.1), ("runner.forward", 3.0), ("runner.d2h", 0.3)])
    store = {"device_ms": recs, "totals": {"cache.encode": {"count": 1, "host_s": 9.5},
                                         "serve.queue_wait": {"count": 4, "host_s": 0.01}}}
    monkeypatch.setattr(hs, "program_spans", lambda: store)
    ctx = _ctx(GPU, HOST)
    assert load_reader("step.input_ms.train")(ctx) == pytest.approx(0.75)
    assert load_reader("step.forward_ms.train")(ctx) == pytest.approx(20.0)
    assert load_reader("step.backward_ms.train")(ctx) == pytest.approx(25.0)
    assert load_reader("step.optimizer_ms.train")(ctx) is None   # not timed on a card
    assert load_reader("setup.cache_encode_s")(ctx) == pytest.approx(9.5)
    assert load_reader("serve.queue_wait_ms")(ctx) == pytest.approx(2.5)
    assert load_reader("serve.copy_ms")(ctx) == pytest.approx(0.4)
    # a program without the spans
    monkeypatch.setattr(hs, "program_spans", lambda: None)
    assert all(load_reader(n)(ctx) is None for n in NEW[:4] + ("setup.cache_encode_s",) + KEPT)


@pytest.mark.parametrize("name", NEW + KEPT)
def test_readers_give_none_off_a_card(name):
    read = load_reader(name)
    cpu = _ctx([], HOST)   # a CPU trace: no GPU event
    assert read(cpu) is None
    assert read({"trace": None, "rank_traces": [None]}) is None
    # a trace without the program's annotations (an older program)
    if name.startswith("step.idle"):
        assert read(_ctx(GPU, [(0, 1000, "bench.step")])) is None
