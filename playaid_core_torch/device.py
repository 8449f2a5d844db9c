"""Device resolution and numeric settings for the port's entry points."""

from __future__ import annotations

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


def disable_tf32() -> None:
    """Run float32 matmuls and convolutions in full float32.

    cuDNN convolutions default to TF32 (about three decimal digits); the
    port is held against the JAX reference in float32, so callers that
    compare numbers (tests, chip_smoke.py) call this first.  The library
    itself never changes these global flags.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
