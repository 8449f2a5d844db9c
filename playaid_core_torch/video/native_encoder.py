"""ctypes binding for the native (libavcodec) video encoder.

The port's copy of ``playaid_core_tpu/video/native_encoder.py``.  It wraps
``native/video_encoder.cpp`` (built by :mod:`._native` into
``build/native/``) and writes BGR24 or RGBA frames to an MP4 with any
encoder that libavcodec has (libx264, or mpeg4, which every FFmpeg build
carries).  The port writes the annotated video through it
(``video/writer.py``), and test clips where cv2 is absent; ``transcode``
re-encodes a file.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from playaid_core_torch.video import _native

_SIGNATURES = {
    "ve_open": (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_double,
                                  ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int]),
    "ve_write_fmt": (ctypes.c_int, [ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte),
                                    ctypes.c_int]),
    "ve_close": (ctypes.c_int, [ctypes.c_void_p]),
}

_lib = None
_lock = threading.Lock()


def get_library() -> ctypes.CDLL:
    """The encoder library with its entry points' types declared; built at
    the first call, raising if it cannot be."""
    global _lib
    with _lock:
        if _lib is None:
            lib = _native.load("video_encoder")
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
    return _lib


class NativeVideoWriter:
    """``cv2.VideoWriter``-shaped writer over the libavcodec encoder.

    For codecs without a crf option (mpeg4) the C layer maps ``crf`` onto a
    constant quantiser (1 best .. 31 worst); ``preset=None`` skips the
    x264-only preset.  ``threads=0`` lets the encoder pick.
    """

    def __init__(self, path, fps, size, codec="libx264", preset="veryfast", crf=23,
                 threads=0):
        self._lib = get_library()
        w, h = int(size[0]), int(size[1])
        if w % 2 or h % 2:
            raise ValueError("width and height must be even for yuv420p")
        self._h = self._lib.ve_open(
            os.fsencode(path), w, h, float(fps), codec.encode(),
            preset.encode() if preset else b"", int(crf) if crf is not None else -1,
            int(threads))
        if not self._h:
            raise RuntimeError(f"could not open encoder {codec} for {path}")
        self._size = (w, h)

    def isOpened(self):
        return bool(self._h)

    def write(self, frame):
        """Encode one frame: ``[h, w, 3]`` BGR or ``[h, w, 4]`` RGBA uint8."""
        frame = np.ascontiguousarray(frame, dtype=np.uint8)
        h, w = frame.shape[:2]
        if (w, h) != self._size:
            raise ValueError(f"frame size {(w, h)} != {self._size}")
        fmt = 1 if frame.ndim == 3 and frame.shape[2] == 4 else 0
        rc = self._lib.ve_write_fmt(self._h, frame.ctypes.data_as(
            ctypes.POINTER(ctypes.c_ubyte)), fmt)
        if rc != 0:
            raise RuntimeError(f"encode error: {rc}")

    def release(self):
        """Flush the encoder and close the file."""
        if self._h:
            rc = self._lib.ve_close(self._h)
            self._h = None
            if rc != 0:
                raise RuntimeError(f"encoder close error: {rc}")

    def __del__(self):
        try:
            self.release()
        except Exception:  # noqa: BLE001 - interpreter shutdown may have unloaded ctypes
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()
        return False


def transcode(src, dst, codec="libx264", preset="veryfast", crf=23, threads=0, max_frames=None):
    """Re-encode a video file with the native encoder (h264 bench fixtures
    from mp4v sources).  Frames are read through the port's ``VideoReader``
    (its capture seam, ``BoundedSegmentDecoder.open_capture``)."""
    from playaid_core_torch.video.reader import VideoReader

    reader = VideoReader(src)
    writer = NativeVideoWriter(dst, reader.fps or 60.0, (reader.width, reader.height),
                               codec=codec, preset=preset, crf=crf, threads=threads)
    n = 0
    try:
        for _, frame in reader.iter_frames(0, max_frames):
            writer.write(frame)
            n += 1
    finally:
        reader.release()
        writer.release()
    return n
