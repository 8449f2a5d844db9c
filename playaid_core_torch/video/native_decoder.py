"""ctypes binding for the native crop-extracting VOD decoder.

The port's copy of ``playaid_core_tpu/video/native_decoder.py``.  It wraps
``native/video_decoder.cpp`` (built by :mod:`._native` into
``build/native/``): one C call decodes a whole chunk of frames and fills a
``[n, K, S, S, 3]`` BGR or ``[n, K, S*S*3//2]`` packed YUV420 uint8 crop
buffer, converting only the crop regions out of the decoded pictures.  The
call releases the interpreter lock for its whole length.

``lowres`` decodes at 1/2^n resolution on codecs that support it (mpeg4
yes, h264 no: the library clamps to the codec's ``max_lowres``).  When
the library cannot be built, the first use raises with the compiler's
error output.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from playaid_core_torch.video import _native

_LONG_ARGS = [
    ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.POINTER(ctypes.c_float),
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.POINTER(ctypes.c_ubyte),
]
_SIGNATURES = {
    "vd_open_ex": (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]),
    "vd_full_width": (ctypes.c_int, [ctypes.c_void_p]),
    "vd_full_height": (ctypes.c_int, [ctypes.c_void_p]),
    "vd_lowres": (ctypes.c_int, [ctypes.c_void_p]),
    "vd_max_lowres": (ctypes.c_int, [ctypes.c_void_p]),
    "vd_fast": (ctypes.c_int, [ctypes.c_void_p]),
    "vd_fps": (ctypes.c_double, [ctypes.c_void_p]),
    "vd_num_frames": (ctypes.c_long, [ctypes.c_void_p]),
    "vd_decode_crops_fmt": (ctypes.c_long, _LONG_ARGS),
    "vd_decode_crops_dense": (ctypes.c_long, _LONG_ARGS),
    "vd_close": (None, [ctypes.c_void_p]),
    "vd_set_stride_skip": (None, [ctypes.c_void_p, ctypes.c_int]),
}


_lib = None
_lib_lock = threading.Lock()


def get_library() -> ctypes.CDLL:
    """The decoder library with every entry point's types declared; built
    at the first call, raising if it cannot be."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = _native.load("video_decoder")
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
    return _lib


def _fast_flag(fast):
    return 2 if fast == "auto" else int(bool(fast))


class NativeVideoDecoder:
    """Sequential/seekable decoder producing letterboxed crops.

    ``fast`` skips the codec's in-loop deblocking filter; ``"auto"``
    applies it only on codecs that have one (h264/hevc/vp8/vp9/av1), and
    the ``fast`` property reports the effective mode.  ``stride_skip``
    decodes packets on frames that a strided call does not extract with
    skip_frame=NONREF, which leaves the extracted frames bit-identical.
    """

    def __init__(self, path, lowres=0, fast=False, stride_skip=True):
        self._lib = get_library()
        self._h = self._lib.vd_open_ex(os.fsencode(path), int(lowres), _fast_flag(fast))
        if not self._h:
            raise RuntimeError(f"could not open video: {path}")
        if stride_skip:
            self._lib.vd_set_stride_skip(self._h, 1)

    @property
    def width(self):
        return self._lib.vd_full_width(self._h)

    @property
    def height(self):
        return self._lib.vd_full_height(self._h)

    @property
    def lowres(self):
        return self._lib.vd_lowres(self._h)

    @property
    def max_lowres(self):
        """The codec's fractional-decode capability (0 = none, e.g. h264;
        3 = 1/8 decode, e.g. mpeg4)."""
        return self._lib.vd_max_lowres(self._h)

    @property
    def fast(self):
        """Effective fast mode after "auto" resolution (1 = fast flags
        applied to this stream's codec, 0 = spec-exact decode)."""
        return self._lib.vd_fast(self._h)

    @property
    def fps(self):
        return self._lib.vd_fps(self._h)

    @property
    def num_frames(self):
        return self._lib.vd_num_frames(self._h)

    def decode_crops(self, start, boxes, out_size=128, padding=30, stride=1,
                     out=None, fmt="bgr", dense=False):
        """Decode ``boxes.shape[0]`` frames from ``start`` and extract
        ``boxes.shape[1]`` crops per (strided) frame.

        boxes: ``[n, K, 4]`` float32 normalised (cx, cy, w, h).  fmt "bgr"
        returns (decoded_count, crops ``[n, K, S, S, 3]`` uint8 BGR); fmt
        "yuv420" returns (decoded_count, crops ``[n, K, S*S*3//2]`` uint8,
        planar Y then U then V, BT.601 limited range).  Skipped and
        out-of-frame regions are black in both.  ``dense=True`` packs the
        extracted frames: the first axis is ``ceil(n / stride)`` and frame
        i lands in row i // stride.  ``decoded_count`` counts frames; a
        start past the end of the stream gives ``(0, zeros)``.
        """
        boxes = np.ascontiguousarray(boxes, dtype=np.float32)
        n, k = boxes.shape[0], boxes.shape[1]
        if float(padding) != int(padding):
            raise ValueError(f"native decode_crops needs an integer pixel padding, got "
                             f"{padding!r}; use vod_pipeline.resolve_padding for fractional "
                             f"padding")
        fmt_i = {"bgr": 0, "yuv420": 1}[fmt]
        rows = (n + stride - 1) // stride if dense else n
        shape = ((rows, k, out_size, out_size, 3) if fmt_i == 0
                 else (rows, k, out_size * out_size * 3 // 2))
        if out is None:
            out = np.zeros(shape, np.uint8)
        else:
            if out.shape != shape or out.dtype != np.uint8 or not out.flags.c_contiguous:
                raise ValueError(f"out must be C-contiguous uint8 {shape}, got "
                                 f"{out.dtype} {out.shape}")
            out[:] = 0
        call = self._lib.vd_decode_crops_dense if dense else self._lib.vd_decode_crops_fmt
        decoded = call(
            self._h, int(start), int(n),
            boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), int(k),
            int(padding), int(out_size), int(stride), fmt_i,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        )
        if decoded == -2:  # seek past the end of the stream: an empty chunk
            return 0, out
        if decoded < 0:
            raise RuntimeError(f"decode error at frame {start}: {decoded}")
        return int(decoded), out

    def close(self):
        if self._h:
            self._lib.vd_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter shutdown may have unloaded ctypes
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# Probe cache and handle pool.  Opening a container probes the stream (an
# h264 open decodes real packets), so a probe's handle is parked and reused
# as the decode worker's decoder, and repeated analyses of the same VOD pay
# no open.  decode_crops seeks on its own, so a pooled handle's position
# never leaks between uses.

_pool_lock = threading.Lock()
_handle_pool: dict = {}   # (file identity, lowres, fast flag) -> [NativeVideoDecoder, ...]
_probe_cache: dict = {}   # (file identity, fast flag) -> probe dict
_POOL_MAX_PER_KEY = 4     # analyze_many can hold a few at once


def _file_identity(path):
    st = os.stat(path)
    return (os.path.realpath(path), st.st_mtime_ns, st.st_size)


def probe(path, fast="auto"):
    """Cached stream probe: dims, fps, frame count, the codec's lowres
    capability and the effective fast mode for ``fast``.  The probe's
    handle parks in the pool for a following full-resolution
    :func:`acquire`."""
    key = (_file_identity(path), _fast_flag(fast))
    with _pool_lock:
        info = _probe_cache.get(key)
    if info is not None:
        return info
    dec = acquire(path, lowres=0, fast=fast)
    info = {"width": dec.width, "height": dec.height, "fps": dec.fps,
            "num_frames": dec.num_frames, "max_lowres": dec.max_lowres, "fast": dec.fast}
    release(dec)
    with _pool_lock:
        _probe_cache[key] = info
    return info


def acquire(path, lowres=0, fast=False):
    """A decoder for ``path``: a pooled one if one is warm, else a new one."""
    key = (_file_identity(path), int(lowres), _fast_flag(fast))
    with _pool_lock:
        handles = _handle_pool.get(key)
        if handles:
            return handles.pop()
    dec = NativeVideoDecoder(path, lowres=lowres, fast=fast)
    dec._pool_key = key
    return dec


def release(dec):
    """Return a decoder from :func:`acquire` to the pool, or close it when
    the pool for its key is full."""
    key = getattr(dec, "_pool_key", None)
    if key is None or dec._h is None:
        dec.close()
        return
    with _pool_lock:
        handles = _handle_pool.setdefault(key, [])
        if len(handles) < _POOL_MAX_PER_KEY:
            handles.append(dec)
            return
    dec.close()


def clear_pool():
    """Close every pooled handle and drop the probe cache."""
    with _pool_lock:
        handles = [d for hs in _handle_pool.values() for d in hs]
        _handle_pool.clear()
        _probe_cache.clear()
    for d in handles:
        d.close()
