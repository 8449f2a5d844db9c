"""Build and load the repository's native libraries.

``native/<name>.cpp`` (the libavcodec decoder and encoder, and the
ult_logger log parser, which the JAX package also builds) is compiled in
place by ``g++`` into ``build/native/lib<name>.so`` at the root of the
checkout at its first use, and again whenever the source is newer than
the library.  Each source links only the libraries it needs: the decoder
and encoder link FFmpeg's, the log parser none.  A failed build raises
with ``g++``'s error output: the port has no silent fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
NATIVE_SRC = ROOT / "native"
BUILD_DIR = ROOT / "build" / "native"
FFMPEG_LINK = ["-lavformat", "-lavcodec", "-lavutil", "-lswscale"]
LINK = {"video_decoder": FFMPEG_LINK, "video_encoder": FFMPEG_LINK, "log_parser": []}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def command(name: str, out: Path) -> list[str]:
    """The ``g++`` command that builds ``native/<name>.cpp`` into ``out``."""
    return ["g++", "-O3", "-shared", "-fPIC", "-o", str(out),
            str(NATIVE_SRC / f"{name}.cpp"), *LINK[name]]


def build(name: str) -> Path:
    """Compile ``native/<name>.cpp`` if its library is missing or older."""
    src = NATIVE_SRC / f"{name}.cpp"
    lib = BUILD_DIR / f"lib{name}.so"
    if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
    try:
        proc = subprocess.run(command(name, tmp), capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ is needed to build native/{name}.cpp: {e}") from e
    if proc.returncode != 0:
        needs = (" (it needs the FFmpeg development headers and libraries)"
                 if LINK[name] else "")
        raise RuntimeError(f"g++ could not build native/{name}.cpp{needs}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``native/<name>.cpp``, built first if needed."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(build(name)))
        return _loaded[name]
