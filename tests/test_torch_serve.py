"""The port's serving surface on the CPU: each case of tests/test_serve.py
against the port, plus its weight-loading flags.

Runs the real ThreadingHTTPServer + collector thread with a tiny
random-init model on device="cpu"; asserts the served depth equals a direct
predict_meters call (pad rows never leak into results), the ragged
micro-batch path pads to the ladder, and the stats/health endpoints work.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from audiodepth_tpu_torch.cli import serve as serve_mod

_TINY = ["--device", "cpu", "--random_init", "--seed", "0", "--generator", "unet_128",
         "--ngf", "4", "--compute_dtype", "float32"]


def _tiny_state(extra=()):
    args = serve_mod.build_parser().parse_args(_TINY + list(extra))
    return serve_mod.load_serving_state(args)


def _tiny_runner(ladder=(1, 4)):
    cfg, task, _ = _tiny_state()
    runner = serve_mod.InferenceRunner(cfg, task, ladder=ladder)
    runner.warmup()
    return cfg, task, runner


@pytest.fixture(scope="module")
def served():
    cfg, task, runner = _tiny_runner()
    batcher = serve_mod.MicroBatcher(runner, wait_ms=5.0)
    server = serve_mod.make_server(batcher, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    yield cfg, task, runner, batcher, port
    server.shutdown()
    server.server_close()
    batcher.stop()
    runner.close()


def _post_predict(port: int, wave: np.ndarray):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict",
        data=wave.astype(np.float32).tobytes(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        shape = tuple(int(s) for s in resp.headers["X-Shape"].split(","))
        return np.frombuffer(resp.read(), np.float32).reshape(shape)


def _direct(task, cfg, waves):
    out = task.predict_meters({"waveform": waves})
    return torch.clamp(out, 0, cfg.dataset.max_depth).numpy()[..., 0]


def test_served_depth_matches_direct_predict(served):
    cfg, task, runner, batcher, port = served
    rng = np.random.default_rng(0)
    wave = (rng.standard_normal((2, runner.wave_len)) * 0.1).astype(np.float32)

    got = _post_predict(port, wave)
    assert got.shape == (256, 256)
    direct = _direct(task, cfg, wave[None])[0]
    np.testing.assert_allclose(got, direct, rtol=1e-5, atol=1e-5)
    assert np.all(got >= 0) and np.all(got <= cfg.dataset.max_depth)


def test_short_waveform_padded_like_dataset(served):
    cfg, task, runner, batcher, port = served
    rng = np.random.default_rng(1)
    short = (rng.standard_normal((2, runner.wave_len // 2)) * 0.1).astype(np.float32)
    got = _post_predict(port, short)

    fixed = np.zeros((1, 2, runner.wave_len), np.float32)
    fixed[0, :, : short.shape[1]] = short
    np.testing.assert_allclose(got, _direct(task, cfg, fixed)[0], rtol=1e-5, atol=1e-5)


def test_concurrent_requests_microbatch_and_match(served):
    cfg, task, runner, batcher, port = served
    rng = np.random.default_rng(2)
    # 3 concurrent requests with ladder (1,4): the collector pads 3 → 4;
    # every caller must get ITS OWN depth back (no pad-row leakage)
    waves = [(rng.standard_normal((2, runner.wave_len)) * 0.1).astype(np.float32)
             for _ in range(3)]
    results = [None] * 3

    def call(i):
        results[i] = _post_predict(port, waves[i])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()

    direct = _direct(task, cfg, np.stack(waves))
    for i in range(3):
        np.testing.assert_allclose(results[i], direct[i], rtol=1e-5, atol=1e-5)


def test_health_stats_and_bad_request(served):
    cfg, task, runner, batcher, port = served
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as r:
        assert r.read() == b"ok"
    _post_predict(port, np.zeros((2, 100), np.float32))
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats") as r:
        stats = json.loads(r.read())
    assert stats["served"] >= 1 and stats["batches"] >= 1
    assert stats["ladder"] == list(runner.ladder)
    assert stats["p50_ms"] > 0
    # non-multiple-of-8 body → 400, not a server crash
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict", data=b"abc", method="POST")
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req)
    assert err.value.code == 400
    # the server still answers afterwards
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as r:
        assert r.read() == b"ok"


def test_loadtest_inprocess(served):
    cfg, task, runner, batcher, port = served
    res = serve_mod.run_loadtest(port, runner, n_requests=12, concurrency=4)
    assert res["requests"] == res["answered"] == 12
    assert res["bad_responses"] == 0
    assert res["throughput_rps"] > 0
    assert res["p99_ms"] >= res["p50_ms"] > 0


def test_run_rejects_non_ladder_batch():
    _, _, runner = _tiny_runner(ladder=(1, 4))
    try:
        with pytest.raises(ValueError):
            runner.run(np.zeros((3, 2, runner.wave_len), np.float32))
    finally:
        runner.close()


def test_random_init_is_seeded():
    _, a, _ = _tiny_state()
    _, b, _ = _tiny_state()
    _, c, _ = _tiny_state(["--seed", "1"])
    sa, sb, sc = (t.model.state_dict() for t in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not all(torch.equal(sa[k], sc[k]) for k in sa)


def test_torch_checkpoint_round_trip(tmp_path):
    cfg, task, _ = _tiny_state(["--seed", "3"])
    path = tmp_path / "ref.pth"
    # the reference's wrapper, with DataParallel prefixes
    torch.save({"epoch": 7, "state_dict": {f"module.{k}": v for k, v in
                                           task.model.state_dict().items()}}, path)
    args = serve_mod.build_parser().parse_args(
        ["--device", "cpu", "--torch_checkpoint", str(path), "--generator", "unet_128",
         "--ngf", "4"])
    _, loaded, source = serve_mod.load_serving_state(args)
    assert source == f"torch:{path}"
    want = task.model.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in loaded.model.state_dict().items())


@pytest.mark.parametrize("flags", [["--use_best"], ["--checkpoint_path", "x/5"],
                                   ["--checkpoints", "5"], []])
def test_orbax_flags_rejected(flags):
    args = serve_mod.build_parser().parse_args(["--device", "cpu"] + flags)
    with pytest.raises(SystemExit):
        serve_mod.load_serving_state(args)
