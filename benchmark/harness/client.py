"""The open-loop load generator: a process of its own (it shares no
interpreter lock with the server), numpy and the standard library only.

It sends each request at its due time, whatever the server has answered,
over a new HTTP connection (`POST /predict`, the body a float32 [2, L]
recording), and times it from when it was due to when its whole answer was
read. It keeps the answers of the sampled requests for the correctness
check. A request not answered `GRACE_S` after the schedule's end counts as
failed.
"""

from __future__ import annotations

import asyncio
import time
from typing import Dict, List, Optional

import numpy as np

GRACE_S = 60.0


def stratified_gaps(n: int, rate: float, seed: int) -> np.ndarray:
    """n inter-arrival gaps of a Poisson process of `rate` per second: the
    exponential's quantiles at (i + ½)/n, in an order drawn from the seed.
    Every seed gets the same set of gaps, so the same total and the same
    tail of bursts, in another order."""
    u = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-u) / rate
    gaps *= (n / rate) / gaps.sum()
    return gaps[np.random.default_rng(seed).permutation(n)]


async def _one(port: int, body: bytes, keep: bool) -> tuple:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(b"POST /predict HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                     b"Content-Type: application/octet-stream\r\n"
                     + f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n".encode()
                     + body)
        await writer.drain()
        data = await reader.read(-1)
    finally:
        writer.close()
    head, _, payload = data.partition(b"\r\n\r\n")
    status = int(head.split(b" ", 2)[1]) if head else 0
    return status, (payload if keep else None), len(payload)


async def _run(port: int, bodies: List[bytes], due: np.ndarray, t0: float,
               keep: set) -> Dict[str, object]:
    loop = asyncio.get_running_loop()
    n = len(due)
    sent = np.full(n, np.nan)
    done = np.full(n, np.nan)
    status = np.zeros(n, np.int32)
    answers: Dict[int, bytes] = {}

    async def fire(i: int):
        delay = t0 + due[i] - time.perf_counter()
        if delay > 0:
            await asyncio.sleep(delay)
        sent[i] = time.perf_counter() - t0
        try:
            code, payload, _ = await _one(port, bodies[i % len(bodies)], i in keep)
        except OSError:
            return
        done[i] = time.perf_counter() - t0
        status[i] = code
        if payload is not None:
            answers[i] = payload

    tasks = [loop.create_task(fire(i)) for i in range(n)]
    end = t0 + float(due[-1]) + GRACE_S if n else t0
    pending = set(tasks)
    while pending:
        timeout = end - time.perf_counter()
        if timeout <= 0:
            break
        _, pending = await asyncio.wait(pending, timeout=timeout)
    for t in pending:
        t.cancel()
    for t in tasks:
        if not t.cancelled() and t.done():
            t.result()
    return {"due": due, "sent": sent, "done": done, "status": status, "answers": answers}


def client_main(conn) -> None:
    """The client process: receives (port, the path of the recordings as
    int16 PCM [n, 2, L]) once, then for each phase (due times from a start,
    the indices to keep) runs it and sends back its record; None ends it.
    Each body is the recording as float32, k / 32768 for each sample k."""
    port, path = conn.recv()
    pcm = np.load(path)
    bodies = [(b.astype(np.float32) / 32768.0).tobytes() for b in pcm]
    del pcm
    conn.send("ready")
    while True:
        phase: Optional[dict] = conn.recv()
        if phase is None:
            break
        t0 = phase["t0"]
        record = asyncio.run(_run(port, bodies, np.asarray(phase["due"]), t0,
                                  set(phase.get("keep", ()))))
        conn.send(record)
    conn.close()
