"""Build and load the repository's native video libraries.

``native/<name>.cpp`` (the libavcodec decoder and encoder that the JAX
package also builds) is compiled in place by ``g++`` into
``build/native/lib<name>.so`` at the root of the checkout at its first
use, and again whenever the source is newer than the library.  A failed
build raises with ``g++``'s error output: the port has no silent
fallback to another decoder.
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
LINK = ["-lavformat", "-lavcodec", "-lavutil", "-lswscale"]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def build(name: str) -> Path:
    """Compile ``native/<name>.cpp`` if its library is missing or older."""
    src = NATIVE_SRC / f"{name}.cpp"
    lib = BUILD_DIR / f"lib{name}.so"
    if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(src), *LINK]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ is needed to build native/{name}.cpp: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ could not build native/{name}.cpp (it needs the FFmpeg "
                           f"development headers and libraries):\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``native/<name>.cpp``, built first if needed."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(build(name)))
        return _loaded[name]
