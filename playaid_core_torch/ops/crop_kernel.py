"""Batched square crop/resize: the CUDA kernel ``csrc/crop_resize.cu`` and
its three wrappers.

Counterpart of ``playaid_core_tpu/ops/pallas_kernels.py``.  For a CUDA
tensor each wrapper launches the kernel (or raises); for a CPU tensor it
runs the plain version: :func:`square_crop_resize` takes frames and boxes
(plain version :func:`~playaid_core_torch.ops.preprocess.batched_square_crop_resize`),
:func:`window_resize` takes windows cut out on the host and their origins
(plain version :func:`~playaid_core_torch.ops.preprocess.batched_window_resize`),
:func:`bank_resize` takes a device-resident image bank, the rows to gather,
their origins and mirrors (plain version
:func:`~playaid_core_torch.ops.preprocess.batched_bank_resize`).
Each counts its launches in ``.launches``.  On the card the frames and
window entries write channels-first storage and return its channels-last
view, so the stem's ``permute(0, 3, 1, 2)`` gives cuDNN a contiguous NCHW
tensor; the bank entry's output is channels last, as ``synth_composite``
computes on it.
"""

from __future__ import annotations

import ctypes

import torch

from playaid_core_torch.ops import _build
from playaid_core_torch.ops.preprocess import (
    batched_bank_resize,
    batched_square_crop_resize,
    batched_window_resize,
)

_ARGTYPES = {
    "crop_resize": ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_float]
                    + [ctypes.c_int] * 2 + [ctypes.c_void_p]),
    "window_resize": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "bank_resize": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
}


def _library(entry="crop_resize"):
    fn = getattr(_build.load("crop_resize"), entry)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[entry]
        fn.restype = ctypes.c_int
    return fn


def _channels_first(lead, size, device):
    """Float32 storage ``lead + (3, S, S)`` seen as ``lead + (S, S, 3)``, made
    in one call (``torch.empty(...).movedim(-3, -1)`` in one allocation)."""
    stride = [3 * size * size]
    for d in reversed(lead[1:]):
        stride.insert(0, stride[0] * d)
    return torch.empty_strided(tuple(lead) + (size, size, 3), stride + [size, 1, size * size],
                               dtype=torch.float32, device=device)


def square_crop_resize(frames_u8, boxes, out_size=128, padding=0,
                       bgr_to_rgb=False, normalize=True):
    """Letterboxed square crops ``boxes.shape[:-1] + (S, S, 3)`` float32.

    frames_u8 ``[N, H, W, 3]`` uint8 (BGR when ``bgr_to_rgb``); boxes
    float ``[N, 4]`` (one crop per frame) or ``[N, K, 4]`` (K crops per
    frame, each frame read once for all K), normalised yolo (cx, cy, w, h).
    On the card the result is a view of ``boxes.shape[:-1] + (3, S, S)``
    storage.
    """
    if frames_u8.dim() != 4 or frames_u8.shape[-1] != 3:
        raise ValueError(f"frames must be [N, H, W, 3], got {tuple(frames_u8.shape)}")
    if boxes.dim() not in (2, 3) or boxes.shape[0] != frames_u8.shape[0] or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be [N, 4] or [N, K, 4] for N={frames_u8.shape[0]} "
                         f"frames, got {tuple(boxes.shape)}")
    dev = frames_u8.device
    if dev.type == "cpu":
        return batched_square_crop_resize(frames_u8, boxes, out_size, padding,
                                          bgr_to_rgb, normalize)
    if dev.type != "cuda" or boxes.device != dev:
        raise ValueError("frames and boxes must lie on the same CUDA device")
    if frames_u8.dtype != torch.uint8:
        raise TypeError(f"the kernel takes uint8 frames, got {frames_u8.dtype}")

    n, h, w = frames_u8.shape[:3]
    per_frame = 1 if boxes.dim() == 2 else boxes.shape[1]
    # No-ops for the main path's contiguous frames and float32 boxes.
    frames_u8 = frames_u8.contiguous()
    boxes_f = boxes.float().contiguous()
    out = _channels_first(boxes.shape[:-1], out_size, dev)
    status = _library()(
        frames_u8.data_ptr(), boxes_f.data_ptr(), out.data_ptr(), n, per_frame,
        h, w, out_size, float(padding), int(bgr_to_rgb), int(normalize),
        _build.current_stream(dev),
    )
    _build.check(status, "crop_resize launch")
    _build.count_launch(square_crop_resize)
    return out


square_crop_resize.launches = 0


def window_resize(windows_u8, origins, out_size=128, bgr_to_rgb=False, normalize=True):
    """Square crops ``[M, S, S, 3]`` float32 resampled from windows.

    windows_u8 ``[M, W, W, 3]`` uint8 (BGR when ``bgr_to_rgb``), cut out
    on the host, black where out of frame; origins ``[M, 3]`` float
    window-relative (y0, x0, side), side clamped to at least 1.  On the
    card the windows must be contiguous, as the staging ring delivers
    them: the wrapper raises rather than copy.  The result there is a view
    of ``[M, 3, S, S]`` storage.
    """
    if windows_u8.dim() != 4 or windows_u8.shape[-1] != 3:
        raise ValueError(f"windows must be [M, W, W, 3], got {tuple(windows_u8.shape)}")
    if tuple(origins.shape) != (windows_u8.shape[0], 3):
        raise ValueError(f"origins must be [M, 3] for M={windows_u8.shape[0]} windows, "
                         f"got {tuple(origins.shape)}")
    dev = windows_u8.device
    if dev.type == "cpu":
        if bgr_to_rgb:
            windows_u8 = windows_u8.flip(-1)
        return batched_window_resize(windows_u8, origins[:, 0], origins[:, 1], origins[:, 2],
                                     out_size, normalize)
    if dev.type != "cuda" or origins.device != dev:
        raise ValueError("windows and origins must lie on the same CUDA device")
    if windows_u8.dtype != torch.uint8:
        raise TypeError(f"the kernel takes uint8 windows, got {windows_u8.dtype}")
    if not windows_u8.is_contiguous():
        raise ValueError("the kernel takes contiguous windows")
    m, h, w = windows_u8.shape[:3]
    origins_f = origins.float().contiguous()
    out = _channels_first((m,), out_size, dev)
    status = _library("window_resize")(
        windows_u8.data_ptr(), origins_f.data_ptr(), out.data_ptr(), m, h, w, out_size,
        int(bgr_to_rgb), int(normalize), _build.current_stream(dev),
    )
    _build.check(status, "window_resize launch")
    _build.count_launch(window_resize)
    return out


window_resize.launches = 0


def bank_resize(bank_u8, rows, origins, out_size, flip=None):
    """Resampled rows of an image bank, ``[N, S, S, C]`` float32 on the 0-255
    scale.

    bank_u8 ``[M, H, W, C]`` uint8, C = 3 or 4; rows ``[N]`` int indices
    into it; origins ``[N, 3]`` float (y0, x0, side) in the row's pixels,
    side clamped to at least 1; flip ``[N]`` (non-zero mirrors the row left
    to right) or None.  Taps outside the row count as zero (a sprite's
    transparent border, a window that hangs off the row).  On the card the
    bank must be contiguous, as a bank made once and kept there is: the
    wrapper raises rather than copy it.  A row index
    outside ``[0, M)`` reads nothing, so its crop is zeros, on the card and
    on the CPU alike (checking the rows on the card would wait for it).
    """
    if bank_u8.dim() != 4 or bank_u8.shape[-1] not in (3, 4):
        raise ValueError(f"bank must be [M, H, W, 3 or 4], got {tuple(bank_u8.shape)}")
    n = rows.shape[0]
    if rows.dim() != 1 or tuple(origins.shape) != (n, 3):
        raise ValueError(f"rows must be [N] and origins [N, 3], got {tuple(rows.shape)} and "
                         f"{tuple(origins.shape)}")
    if flip is not None and tuple(flip.shape) != (n,):
        raise ValueError(f"flip must be [N] for N={n} rows, got {tuple(flip.shape)}")
    if bank_u8.device.type == "cpu":
        return batched_bank_resize(bank_u8, rows, origins, out_size, flip)
    dev = bank_u8.device
    if dev.type != "cuda" or any(t is not None and t.device != dev for t in (rows, origins, flip)):
        raise ValueError("bank, rows, origins and flip must lie on the same CUDA device")
    if bank_u8.dtype != torch.uint8:
        raise TypeError(f"the kernel takes a uint8 bank, got {bank_u8.dtype}")
    if not bank_u8.is_contiguous():
        raise ValueError("the kernel takes a contiguous bank")
    m, h, w, c = bank_u8.shape
    rows_i = rows.to(torch.int32).contiguous()
    origins_f = origins.float().contiguous()
    flip_i = None if flip is None else flip.to(torch.int32).contiguous()
    out = torch.empty((n, out_size, out_size, c), dtype=torch.float32, device=dev)
    status = _library("bank_resize")(
        bank_u8.data_ptr(), rows_i.data_ptr(), origins_f.data_ptr(),
        None if flip_i is None else flip_i.data_ptr(), out.data_ptr(), m, n, h, w, c, out_size,
        _build.current_stream(dev),
    )
    _build.check(status, "bank_resize launch")
    _build.count_launch(bank_resize)
    return out


bank_resize.launches = 0
