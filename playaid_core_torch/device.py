"""Device resolution and numeric settings for the port's entry points."""

from __future__ import annotations

import contextlib
import threading

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device; raise when there is none.

    The CPU is used only when the caller asks for it by name, so a
    machine without a card never runs the plain versions by accident.
    """
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "playaid_core_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU"
        )
    return device


class _Float32Scope:
    """Process-wide count of the threads inside :func:`full_float32`.

    The TF32 flags are global to the process, so saving and restoring them
    per caller races: a thread that leaves would turn TF32 back on under a
    thread still inside, and the last to leave would write back flags the
    first had already cleared.  Instead the first thread in saves and
    clears the flags, and the last thread out restores them.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._depth = 0
        self._saved = None

    def enter(self):
        with self._lock:
            if self._depth == 0:
                self._saved = (torch.backends.cuda.matmul.allow_tf32,
                               torch.backends.cudnn.allow_tf32)
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False
            self._depth += 1

    def exit(self):
        with self._lock:
            self._depth -= 1
            if self._depth == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = self._saved
                self._saved = None


_FLOAT32_SCOPE = _Float32Scope()


@contextlib.contextmanager
def full_float32():
    """Run float32 matmuls and convolutions in full float32 inside the
    block, and give the caller's TF32 flags back when the last thread
    inside leaves.

    cuDNN convolutions default to TF32 (about three decimal digits), and
    the port is held against the JAX reference in float32, so the entry
    points that run convolutions and products (the embeds, the temporal
    heads, the plain residual block) enter this context themselves.  It is
    safe across threads: the flags stay off while any thread is inside.
    """
    _FLOAT32_SCOPE.enter()
    try:
        yield
    finally:
        _FLOAT32_SCOPE.exit()


def disable_tf32() -> None:
    """Turn TF32 off globally, for callers that run their own float32
    convolutions or matmuls.  The port's entry points do not need it: they
    run in full float32 through :func:`full_float32` and never change the
    global flags for good."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
