"""ctypes bindings for the native (libavformat) audio remuxer.

The port's own copy of ``playaid_core_tpu/video/native_remux.py``.  It
wraps ``native/audio_remux.cpp``, built by :mod:`._native` into
``build/native/`` at first use.  The reference remuxes the source VOD's
audio into the rendered annotated video by shelling out to the ffmpeg
binary (reference: manuscript.py:249-279); ``video.writer.add_audio`` uses
this in-process path when there is no binary.

Also exposes ``add_tone`` — stream-copy a video while encoding a mono AAC
sine track of the same duration — which is how tests author an
audio-bearing MP4 fixture.
"""

from __future__ import annotations

import ctypes
import os
import threading

from playaid_core_torch.video import _native

_SIGNATURES = {
    "ar_count_audio": (ctypes.c_int, [ctypes.c_char_p]),
    "ar_remux": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p]),
    "ar_add_tone": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_double,
                                   ctypes.c_int]),
}

_lib = None
_lock = threading.Lock()


def get_library() -> ctypes.CDLL:
    """The remuxer library with its entry points' types declared; built at
    the first call, raising with g++'s errors if it cannot be."""
    global _lib
    with _lock:
        if _lib is None:
            lib = _native.load("audio_remux")
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
    return _lib


def available() -> bool:
    """Whether the remuxer builds and loads on this machine."""
    try:
        get_library()
    except (RuntimeError, OSError):
        return False
    return True


def count_audio_streams(path) -> int:
    """Number of audio streams in the container, or <0 on open failure."""
    return get_library().ar_count_audio(os.fspath(path).encode())


def remux(video_path, audio_src_path, out_path) -> bool:
    """Stream-copy video from ``video_path`` + the best audio stream from
    ``audio_src_path`` into ``out_path`` (ffmpeg ``-shortest`` semantics:
    stops at the first input to end).  Returns False — leaving no output
    file — when the audio source has no audio stream or the mux fails."""
    lib = get_library()
    # Only clean up a failure artifact this call created: some failures
    # return before the native code opens out_path, and a file the caller
    # had there must survive.
    preexisting = os.path.exists(out_path)
    rc = lib.ar_remux(os.fspath(video_path).encode(), os.fspath(audio_src_path).encode(),
                      os.fspath(out_path).encode())
    if rc != 0 and not preexisting and os.path.exists(out_path):
        os.unlink(out_path)
    return rc == 0


def add_tone(in_path, out_path, freq=440.0, sample_rate=44100) -> bool:
    """Copy the video of ``in_path`` and add a mono AAC sine-tone track of
    the same duration (test fixtures; the muxer holds the whole video in
    memory until the tone pass starts)."""
    lib = get_library()
    preexisting = os.path.exists(out_path)
    rc = lib.ar_add_tone(os.fspath(in_path).encode(), os.fspath(out_path).encode(),
                         float(freq), int(sample_rate))
    if rc != 0 and not preexisting and os.path.exists(out_path):
        os.unlink(out_path)
    return rc == 0
