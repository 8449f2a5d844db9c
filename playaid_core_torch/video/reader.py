"""The port's frame source, and sequential-first frame reading through it.

Counterpart of ``VideoReader`` in ``playaid_core_tpu/video/reader.py``.
:func:`open_capture` is the one seam for frames: it gives a
:class:`Cv2Capture` (cv2 where it is installed), and a caller may replace
it, as a module attribute, with any source that has ``seek``, ``read``,
``release``, ``fps``, ``width``, ``height`` and ``frame_count`` and whose
``read`` returns a frame the caller may keep.  Every reader of frames looks
it up at call time: ``VideoReader`` here, and the VOD path's cv2 and window
routes; so the pixels-only path needs no cv2 of its own.
``PrefetchingReader`` decodes on a background thread into a bounded queue,
as the JAX package's does.
"""

from __future__ import annotations

import queue
import threading


class Cv2Capture:
    """Frames of a video file through ``cv2.VideoCapture``: ``seek(index)``,
    ``read() -> (ok, BGR frame)``, ``release()``, and the stream's ``fps``,
    ``width``, ``height`` and ``frame_count`` (not positive when the file
    does not open)."""

    def __init__(self, path):
        import cv2

        self._cv2 = cv2
        self._cap = cv2.VideoCapture(path)
        self.fps = self._cap.get(cv2.CAP_PROP_FPS)
        self.width = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self.frame_count = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))

    def seek(self, index):
        self._cap.set(self._cv2.CAP_PROP_POS_FRAMES, index)

    def read(self):
        return self._cap.read()

    def release(self):
        self._cap.release()


def open_capture(path):
    """The frame source of ``path``: a :class:`Cv2Capture`."""
    return Cv2Capture(path)


class VideoReader:
    """``read_at(i)`` returns frame i, reading forward without a seek when
    i is at or up to ``MAX_FORWARD_DECODE`` frames after the current
    position, and seeking otherwise; ``iter_frames`` reads in order."""

    # Reading forward this many frames is cheaper than a container seek.
    MAX_FORWARD_DECODE = 64

    def __init__(self, path):
        self.path = path
        self.cap = open_capture(path)
        self.fps = self.cap.fps
        self.width = int(self.cap.width)
        self.height = int(self.cap.height)
        self.frame_count = int(self.cap.frame_count)
        if self.width <= 0 or self.height <= 0:
            self.cap.release()
            raise IOError(f"Could not open video: {path}")
        self._pos = 0

    def read_at(self, index):
        """Return (ok, BGR frame) for frame ``index``."""
        if index < self._pos or index > self._pos + self.MAX_FORWARD_DECODE:
            self.cap.seek(index)
            self._pos = index
        while self._pos < index:
            ok, _ = self.cap.read()
            if not ok:
                return False, None
            self._pos += 1
        ok, frame = self.cap.read()
        if ok:
            self._pos += 1
        return ok, frame

    def __iter__(self):
        return self.iter_frames()

    def iter_frames(self, start=0, stop=None):
        """Yield (index, BGR frame) in order."""
        if start != self._pos:
            self.cap.seek(start)
            self._pos = start
        i = start
        while stop is None or i < stop:
            ok, frame = self.cap.read()
            if not ok:
                return
            self._pos = i + 1
            yield i, frame
            i += 1

    def release(self):
        self.cap.release()


class PrefetchingReader:
    """Background-thread decode with a bounded frame queue, so the consumer
    (annotation / device staging) overlaps with decode."""

    def __init__(self, path, start=0, stop=None, queue_size=32, transform=None):
        self.reader = VideoReader(path)
        self.fps = self.reader.fps
        self.width = self.reader.width
        self.height = self.reader.height
        self.frame_count = self.reader.frame_count
        self._queue: queue.Queue = queue.Queue(maxsize=queue_size)
        self._transform = transform
        self._start = start
        self._stop = stop
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        try:
            for i, frame in self.reader.iter_frames(self._start, self._stop):
                if self._stopped.is_set():
                    return
                if self._transform is not None:
                    frame = self._transform(frame)
                # Bounded put with a timeout so a consumer that stopped
                # early never leaves this thread blocked forever.
                while not self._stopped.is_set():
                    try:
                        self._queue.put((i, frame), timeout=0.2)
                        break
                    except queue.Full:
                        continue
        finally:
            try:
                self._queue.put_nowait(None)
            except queue.Full:
                pass

    def __iter__(self):
        while True:
            item = self._queue.get()
            if item is None:
                return
            yield item

    def release(self):
        """Signal the producer, wait for it to exit, then close the
        capture (closing it mid-read is undefined behaviour)."""
        self._stopped.set()
        # Drain so a blocked put can complete.
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
        self.reader.release()
