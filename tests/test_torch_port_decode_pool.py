"""The VOD path's one chunk producer (``vod_pipeline._DecodePool``) over
each of its three routes (native, cv2, window), with one worker and with
three: every chunk reaches the sink once, a worker's or the sink's error
reaches the waiter, and ``close()`` ends the run early.

Crops and frames come from stand-ins behind the routes' seams
(``native_decoder.acquire/release`` and ``video/reader.open_capture``):
100 frames of 72x128 in chunks of 16, the last of 4 frames.
"""

import functools
import sys
import threading

import numpy as np
import pytest
import torch

from playaid_core_torch.infer import vod_pipeline
from playaid_core_torch.infer.pipeline import BatchedActionPipeline
from playaid_core_torch.video import native_decoder, reader

torch.set_num_threads(2)

FRAMES, CHUNK, CROP, HEIGHT, WIDTH, WINDOW, PADDING = 100, 16, 32, 72, 128, 48, 4
STARTS = list(range(0, FRAMES, CHUNK))
FAIL_AT = 3 * CHUNK
ROUTES = {
    "native": dict(decode_backend="native", transfer_format="yuv420", stride=2),
    "cv2": dict(decode_backend="cv2", stride=2),
    "window": dict(host_resize=False, window=WINDOW),
}
JOIN_S = 10.0


class _Crops:
    """The native decoder's stand-in: dense packed YUV420 crops, each
    chunk's filled with its start; the chunk at ``fail_at`` raises."""

    def __init__(self, fail_at):
        self.fail_at = fail_at

    def decode_crops(self, start, boxes, out_size, padding, stride=1, out=None, fmt="bgr",
                     dense=False):
        if start == self.fail_at:
            raise RuntimeError(f"decode failed at {start}")
        rows = -(-boxes.shape[0] // stride)
        crops = np.full((rows, boxes.shape[1], out_size * out_size * 3 // 2), start % 256,
                        np.uint8)
        return max(0, min(boxes.shape[0], FRAMES - start)), crops


class _Frames:
    """The capture's stand-in: frame i filled with i; frame ``fail_at``
    raises."""

    def __init__(self, fail_at):
        self.fail_at = fail_at
        self.pos = 0

    def seek(self, index):
        self.pos = index

    def read(self):
        if self.pos >= FRAMES:
            return False, None
        if self.pos == self.fail_at:
            raise RuntimeError(f"decode failed at {self.pos}")
        frame = np.full((HEIGHT, WIDTH, 3), self.pos % 256, np.uint8)
        self.pos += 1
        return True, frame

    def release(self):
        pass


@pytest.fixture(scope="module")
def pipe():
    return BatchedActionPipeline(crop_size=CROP, device="cpu").init(0)


def _route(monkeypatch, pipe, name, fail_at=None):
    """The route's per-worker context, its sources replaced by stand-ins."""
    monkeypatch.setattr(native_decoder, "acquire", lambda path, lowres=0, fast=False:
                        _Crops(fail_at))
    monkeypatch.setattr(native_decoder, "release", lambda dec: None)
    monkeypatch.setattr(reader, "open_capture", lambda path: _Frames(fail_at))
    analyzer = vod_pipeline.VodAnalyzer(pipe, chunk=CHUNK, padding=PADDING, **ROUTES[name])
    boxes = np.tile(np.array([[0.3, 0.5, 0.2, 0.3], [0.7, 0.45, 0.25, 0.3]], np.float32),
                    (FRAMES, 1, 1))
    if name == "native":
        return functools.partial(analyzer._native_route, "clip.mp4", boxes, PADDING, 0,
                                 "yuv420")
    if name == "cv2":
        return functools.partial(analyzer._crop_route, "clip.mp4", boxes, PADDING)
    return functools.partial(analyzer._window_route, "clip.mp4", boxes, PADDING)


def _joined(pool):
    for t in pool._threads:
        t.join(JOIN_S)
    return not any(t.is_alive() for t in pool._threads)


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_pool_hands_every_chunk_to_the_sink_once(pipe, monkeypatch, route, workers):
    """Each chunk's start once, its frames counted once, on the workers'
    threads (not the caller's); the native and cv2 routes' arrays have the
    full chunk's rows, the window route's the frames read.  The switch
    interval is shortened so that the workers interleave often."""
    seen = []
    lock = threading.Lock()

    def sink(start, n, *arrays):
        with lock:
            seen.append((start, n, [a.shape for a in arrays], threading.get_ident()))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = vod_pipeline._DecodePool(FRAMES, CHUNK, _route(monkeypatch, pipe, route), sink,
                                        workers)
        pool.wait()
    finally:
        sys.setswitchinterval(interval)
    assert _joined(pool)
    assert sorted(s for s, *_ in seen) == STARTS
    assert sum(n for _, n, *_ in seen) == FRAMES
    threads = {t for *_, t in seen}
    assert threading.get_ident() not in threads and 1 <= len(threads) <= workers
    for start, n, shapes, _ in seen:
        assert n == min(CHUNK, FRAMES - start)
        if route == "window":
            assert shapes == [(n, 2, WINDOW, WINDOW, 3), (n, 2, 3)]
        elif route == "cv2":
            assert shapes == [(CHUNK // 2, 2, CROP, CROP, 3)]
        else:
            assert shapes == [(CHUNK // 2, 2, CROP * CROP * 3 // 2)]


@pytest.mark.parametrize("where", ["source", "sink"])
@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_pool_reraises_the_first_error(pipe, monkeypatch, route, workers, where):
    """An error in a worker's source or in the sink, at the fourth chunk,
    reaches ``wait()``; that chunk is never counted as through the sink,
    and every worker ends."""
    seen = []

    def sink(start, n, *arrays):
        if where == "sink" and start == FAIL_AT:
            raise RuntimeError(f"sink failed at {start}")
        seen.append(start)

    fail_at = FAIL_AT if where == "source" else None
    pool = vod_pipeline._DecodePool(FRAMES, CHUNK, _route(monkeypatch, pipe, route, fail_at),
                                    sink, workers)
    try:
        failed = "sink" if where == "sink" else "decode"
        with pytest.raises(RuntimeError, match=f"{failed} failed at {FAIL_AT}"):
            pool.wait()
    finally:
        pool.close()
    assert _joined(pool)
    assert FAIL_AT not in seen


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_pool_returns_after_close(pipe, monkeypatch, route, workers):
    """``close()`` from another thread, while a worker is held in the sink,
    wakes ``wait()``; the chunks not yet taken never reach the sink,
    and the workers end once the sink lets them go."""
    seen = []
    entered, gate = threading.Event(), threading.Event()

    def sink(start, n, *arrays):
        seen.append(start)
        entered.set()
        gate.wait(JOIN_S)

    pool = vod_pipeline._DecodePool(FRAMES, CHUNK, _route(monkeypatch, pipe, route), sink,
                                    workers)

    def close():
        entered.wait(JOIN_S)
        pool.close()

    closer = threading.Thread(target=close)
    closer.start()
    try:
        pool.wait()
        closer.join(JOIN_S)
        assert not closer.is_alive()
    finally:
        gate.set()
    assert _joined(pool)
    assert 1 <= len(seen) <= workers < len(STARTS)
