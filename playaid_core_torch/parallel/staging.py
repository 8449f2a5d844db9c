"""Host-to-device staging, for training and for the VOD path.

Counterpart of ``playaid_core_tpu/parallel/staging.py``:
:class:`PinnedStager` copies arrays to the device through pinned host
slots and a copy stream, with ``record_stream`` onto the compute stream,
so a copy overlaps the work before it (the VOD path's dispatcher stages
each chunk through one); :func:`device_prefetch` keeps ``size`` batches in
flight to the device through one; and :class:`BackgroundIterator`
assembles batches on the host in a thread while the device computes.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Iterable, Iterator, Optional

import torch

from playaid_core_torch import profiling
from playaid_core_torch.device import resolve_device


class PinnedStager:
    """Host-to-device copies of chunks through a ring of pinned host
    buffers and a copy stream.

    :meth:`to_device` copies a chunk's arrays (the crops; or the windows
    and their origins) into the next slot's pinned buffers (after waiting
    for that slot's previous copies to finish), starts the slot's copies
    on the copy stream, makes the caller's current stream wait for them,
    and marks each device tensor as used by that stream so the caching
    allocator does not hand its memory out again before the stream is done
    with it.  On the CPU it returns the arrays as tensors.  One analysis at
    a time uses a stager.  Each call is a span ``playaid.stage`` counting
    ``staged_bytes``, its wait for the slot a span ``playaid.stage_slot_wait``.
    """

    SLOTS = 3

    def __init__(self, device):
        self.device = torch.device(device)
        self._host = [[] for _ in range(self.SLOTS)]
        self._copied = [None] * self.SLOTS
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._next = 0

    def to_device(self, *arrays):
        """The arrays as tensors on the device, in order (a list)."""
        with profiling.span("playaid.stage", staged_bytes=sum(a.nbytes for a in arrays)):
            return self._stage(arrays)

    def _stage(self, arrays):
        if self._stream is None:
            return [torch.from_numpy(a) for a in arrays]
        k = self._next
        self._next = (k + 1) % self.SLOTS
        if self._copied[k] is not None:
            with profiling.span("playaid.stage_slot_wait"):
                self._copied[k].synchronize()
        tensors = [torch.from_numpy(a) for a in arrays]
        hosts = self._host[k]
        if [(h.shape, h.dtype) for h in hosts] != [(t.shape, t.dtype) for t in tensors]:
            hosts[:] = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
        for host, array in zip(hosts, arrays):
            host.numpy()[...] = array
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._stream):
            outs = [host.to(self.device, non_blocking=True) for host in hosts]
            copied = torch.cuda.Event()
            copied.record(self._stream)
        self._copied[k] = copied
        compute.wait_stream(self._stream)
        for out in outs:
            out.record_stream(compute)
        return outs


def device_prefetch(iterable: Iterable, size: int = 2, device=None, sharding=None) -> Iterator:
    """Yield the items of ``iterable`` (tuples of numpy arrays) as tuples of
    tensors on ``device``, keeping ``size`` copies ahead of the consumer.

    ``device=None`` means the CUDA device (and raises without one).  On
    CUDA each array goes through a pinned slot of a ``PinnedStager`` and
    is copied on its copy stream; the compute stream waits for the copy.
    On the CPU the arrays are wrapped without a copy.  ``sharding`` (e.g.
    ``parallel.mesh.batch_sharding(mesh)``) picks what of each array this
    rank takes, before the copy: only those bytes reach the device.
    """
    stager = PinnedStager(resolve_device(device))
    it = iter(iterable)
    buf = collections.deque()

    def put(item):
        if sharding is not None:
            item = [sharding(a) for a in item]
        return tuple(stager.to_device(*item))

    try:
        for _ in range(size):
            buf.append(put(next(it)))
    except StopIteration:
        pass

    while buf:
        out = buf.popleft()
        try:
            buf.append(put(next(it)))
        except StopIteration:
            pass
        yield out


class BackgroundIterator:
    """Run a (host-heavy) iterator in a background thread with a bounded
    queue, overlapping host batch assembly with device compute.

    Single-shot.  ``close()`` (also called when iteration finishes or the
    consumer abandons it via ``with``/GC) unblocks and stops the producer
    so early-exiting training loops don't leak a thread pinning prefetched
    batches.
    """

    _SENTINEL = object()

    def __init__(self, iterable: Iterable, maxsize: int = 4):
        self._queue: queue.Queue = queue.Queue(maxsize=maxsize)
        self._error: Optional[BaseException] = None
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(iterable,), daemon=True)
        self._thread.start()

    def _run(self, iterable):
        try:
            for item in iterable:
                if self._stopped.is_set():
                    return
                while not self._stopped.is_set():
                    try:
                        self._queue.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # propagate into the consumer
            self._error = e
        finally:
            # The sentinel must reach the consumer even when the queue is
            # still full of pending batches (fast producer, slow device):
            # block-put with the same stopped-poll the item path uses.
            while not self._stopped.is_set():
                try:
                    self._queue.put(self._SENTINEL, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def close(self):
        self._stopped.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self._stopped.set()

    def __iter__(self):
        while True:
            item = self._queue.get()
            if item is self._SENTINEL:
                if self._error is not None:
                    raise self._error
                return
            yield item
