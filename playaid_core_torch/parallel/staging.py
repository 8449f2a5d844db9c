"""Host-to-device staging for training.

Counterpart of ``playaid_core_tpu/parallel/staging.py``:
:func:`device_prefetch` keeps ``size`` batches in flight to the device
(through ``PinnedStager``: pinned host slots, a copy stream, and
``record_stream`` onto the compute stream, so a copy overlaps the step
before it), and :class:`BackgroundIterator` assembles batches on the host
in a thread while the device computes.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Iterable, Iterator, Optional

from playaid_core_torch.device import resolve_device
from playaid_core_torch.infer.vod_pipeline import PinnedStager


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
