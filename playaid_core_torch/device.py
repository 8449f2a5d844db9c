"""Device resolution and numeric settings for the port's entry points."""

from __future__ import annotations

import contextlib

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


@contextlib.contextmanager
def full_float32():
    """Run float32 matmuls and convolutions in full float32 inside the
    block, and give the caller's TF32 flags back afterwards.

    cuDNN convolutions default to TF32 (about three decimal digits), and
    the port is held against the JAX reference in float32, so the entry
    points that run convolutions (``CNNEmbed``, the temporal head, the
    plain residual block) enter this context themselves.
    """
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def disable_tf32() -> None:
    """Turn TF32 off globally, for callers that run their own float32
    convolutions or matmuls.  The port's entry points do not need it: they
    run in full float32 through :func:`full_float32` and never change the
    global flags for good."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
