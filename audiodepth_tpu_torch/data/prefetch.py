"""Device prefetch: overlap the host→device copy with compute (port of
`data/prefetch.py`).

`device_prefetch` keeps `size` batches in flight. On a CUDA device each host
batch is encoded to the compact transport dtypes (when `encode_units` is
set), written into a pinned host buffer and copied with
`copy_(non_blocking=True)` on a dedicated side stream; an event recorded
after the copy is what the consumer's stream waits on before it reads the
batch. A copy from pageable memory would be synchronous whatever
`non_blocking` says, so the pinned buffers are what make the copy overlap
the previous step's compute. Two rules keep the buffers safe:
  * every device tensor is allocated on the side stream and then
    `record_stream`-ed on the consumer's stream, so the caching allocator
    does not hand its memory out again before the consumer's work on it
    has run;
  * a pinned buffer is refilled only after the event of the copy that read
    it has completed (a host wait on that event), so a batch in flight is
    never overwritten.
`copies` counts the host→device batch copies issued and the events
recorded after them (reset and read like the kernels' launch counters), so
a caller can tell every copy ran without a trace, which may drop records.
A batch whose values are all tensors on the device already (from
`DeviceDatasetCache`) passes through. On a CPU device, which a caller asks
for, it is a plain generator: each batch is encoded and wrapped as tensors,
with no streams.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from .codec import encode_batch


class CopyCounts:
    """The batch copies `device_prefetch` issued to a card (one a tensor)
    and the events it recorded after them (one a batch), since `reset`."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.copies = self.events = 0

    def read(self) -> Dict[str, int]:
        return {"copies": self.copies, "events": self.events}


copies = CopyCounts()


def _on_device(batch, device: torch.device) -> bool:
    return all(isinstance(v, torch.Tensor) and v.device == device for v in batch.values())


def _host_arrays(batch, encode_units: Optional[float]) -> Dict[str, np.ndarray]:
    if encode_units is not None:
        batch = encode_batch(batch, encode_units)
    return {k: np.ascontiguousarray(v) for k, v in batch.items()}


class _PinnedSlot:
    """One set of pinned host buffers and the event of the copy that last
    read them."""

    def __init__(self):
        self.buffers: Dict[str, torch.Tensor] = {}
        self.event: Optional[torch.cuda.Event] = None

    def fill(self, arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        if self.event is not None:
            self.event.synchronize()  # the previous copy out of these buffers is done
        for k, a in arrays.items():
            src = torch.from_numpy(a)
            buf = self.buffers.get(k)
            if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
                buf = self.buffers[k] = torch.empty(src.shape, dtype=src.dtype,
                                                    pin_memory=True)
            buf.copy_(src)
        return {k: self.buffers[k] for k in arrays}


def device_prefetch(
    batches: Iterable,
    device,
    size: int = 2,
    encode_units: Optional[float] = None,
) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield the batches as tensors on `device`, keeping `size` copies in
    flight. With `encode_units`, float32 batches are packed with the compact
    codec (int16 waveform, uint16 depth: data/codec.py) on the host first;
    the step decodes on the device."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in batches:
            if not _on_device(batch, device):
                batch = {k: torch.as_tensor(v, device=device)
                         for k, v in _host_arrays(batch, encode_units).items()}
            yield batch
        return

    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    copy_stream = torch.cuda.Stream(device)
    slots = [_PinnedSlot() for _ in range(size)]
    turn = [0]

    def put(batch):
        if _on_device(batch, device):
            return batch, None
        slot = slots[turn[0] % size]
        turn[0] += 1
        host = slot.fill(_host_arrays(batch, encode_units))
        with torch.cuda.stream(copy_stream):
            dev = {k: torch.empty(h.shape, dtype=h.dtype, device=device)
                   for k, h in host.items()}
            for k, h in host.items():
                dev[k].copy_(h, non_blocking=True)
                copies.copies += 1
            slot.event = torch.cuda.Event()
            slot.event.record(copy_stream)
            copies.events += 1
        return dev, slot.event

    queue: collections.deque = collections.deque()
    it = iter(batches)
    for batch in it:
        queue.append(put(batch))
        if len(queue) == size:
            break
    while queue:
        out, event = queue.popleft()
        nxt = next(it, None)
        if nxt is not None:
            queue.append(put(nxt))
        if event is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(event)
            for t in out.values():
                t.record_stream(consumer)
        yield out
