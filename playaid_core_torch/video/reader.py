"""Sequential-first frame reading through the port's capture seam.

Counterpart of ``VideoReader`` in ``playaid_core_tpu/video/reader.py``.
Frames come from ``BoundedSegmentDecoder.open_capture(path)`` (cv2 where
it is installed; a caller may put any source with ``seek``, ``read``,
``release``, ``fps``, ``width``, ``height`` and ``frame_count`` behind
it, whose ``read`` returns a frame the caller may keep), so the
pixels-only path needs no cv2 of its own.
"""

from __future__ import annotations


class VideoReader:
    """``read_at(i)`` returns frame i, reading forward without a seek when
    i is at or up to ``MAX_FORWARD_DECODE`` frames after the current
    position, and seeking otherwise; ``iter_frames`` reads in order."""

    # Reading forward this many frames is cheaper than a container seek.
    MAX_FORWARD_DECODE = 64

    def __init__(self, path):
        from playaid_core_torch.infer.vod_pipeline import BoundedSegmentDecoder

        self.path = path
        self.cap = BoundedSegmentDecoder.open_capture(path)
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
