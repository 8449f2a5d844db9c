"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/kernels/lib<name>.so`` at the root of
the checkout, then loaded with ctypes.  A library is built at its first
use and again whenever its source is newer than it.  ``build`` starts one
``nvcc`` per source, all at once, and waits for all of them.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from playaid_core_torch import profiling

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
KERNELS = ("conv1x1_gemm", "crop_resize", "residual_block", "ssd_scan", "viterbi",
           "yuv420_unpack")

_loaded: dict[str, ctypes.CDLL] = {}
_launch_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "toolkit is needed to build the port's kernels")


def _library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _library_path(name)
    return not lib.exists() or lib.stat().st_mtime < (CSRC / f"{name}.cu").stat().st_mtime


def build(names=KERNELS) -> dict[str, str]:
    """Compile the named kernels in parallel; return each one's compiler
    output (registers, shared memory and spills from ``-Xptxas -v``), or
    an empty string for a library that was already up to date."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if not _stale(name):
            continue
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {name: "" for name in names}
    failed = []
    for name, (tmp, t0, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, _library_path(name))
        logs[name] = f"built in {time.perf_counter() - t0:.1f} s\n{out}"
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        if _stale(name):
            build((name,))
        _loaded[name] = ctypes.CDLL(str(_library_path(name)))
    return _loaded[name]


def current_stream(device: torch.device) -> int:
    """The handle of PyTorch's current stream on a CUDA device, read at each
    launch: what ``torch.cuda.current_stream(device).cuda_stream`` gives,
    without the ``Stream`` object it builds (3-6 us a call on the card:
    PERF.md section 6, K1's rows)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")


def count_launch(wrapper, n: int = 1) -> None:
    """Add ``n`` to ``wrapper.launches``, under a lock: wrappers launch from
    the VOD pipeline's dispatcher threads, several at once.  While a
    ``profiling.tally`` is open on this thread, add them to it instead,
    under ``wrapper``: a launch captured into a CUDA graph is counted at
    each replay."""
    held = profiling.tallying()
    if held is not None:
        held[wrapper] += n
        return
    with _launch_lock:
        wrapper.launches += n


def recount(counts) -> None:
    """Add the counts a ``profiling.tally`` held where they would have gone:
    a name's to ``profiling.count``, a wrapper's launches to
    :func:`count_launch`."""
    for name, n in counts.items():
        if isinstance(name, str):
            profiling.count(name, n)
        else:
            count_launch(name, n)
