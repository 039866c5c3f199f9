"""The open-loop generator: every seed gets the same gaps in another order,
and requests leave on their schedule whatever the server answers."""

import asyncio
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from harness.client import _run, stratified_gaps


def test_same_gaps_any_seed():
    a, b = stratified_gaps(500, 200.0, 1), stratified_gaps(500, 200.0, 2 ** 31 + 5)
    assert np.allclose(np.sort(a), np.sort(b)) and not np.allclose(a, b)
    assert abs(a.sum() - 500 / 200.0) < 1e-9
    # the exponential's mean and a heavy tail
    assert abs(a.mean() - 1 / 200.0) < 1e-12 and a.max() > 5 / 200.0


class _Slow(BaseHTTPRequestHandler):
    delay = 0.3

    def log_message(self, *a):
        pass

    def do_POST(self):
        self.rfile.read(int(self.headers["Content-Length"]))
        time.sleep(self.delay)
        body = b"\0" * 16
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def test_schedule_independent_of_completions():
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Slow)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        gaps = stratified_gaps(20, 50.0, 3)
        due = np.cumsum(gaps) - gaps[0]
        t0 = time.perf_counter() + 0.2
        rec = asyncio.run(_run(server.server_address[1], [b"\0" * 64], due, t0, {0, 5}))
    finally:
        server.shutdown()
        server.server_close()
    late = rec["sent"] - rec["due"]
    # all 20 sent on time although each answer takes 0.3 s
    assert np.all(late < 0.05), late
    assert np.all(rec["status"] == 200)
    lat = rec["done"] - rec["due"]
    assert np.all(lat >= 0.3)
    assert set(rec["answers"]) == {0, 5} and rec["answers"][0] == b"\0" * 16
