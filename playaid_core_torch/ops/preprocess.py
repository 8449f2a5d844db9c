"""Batched frame preprocessing: crop geometry, the plain crop resampler and
the middle-out window sampler.

The port's own copy of ``playaid_core_tpu/ops/preprocess.py``.  Frames
``[N, H, W, 3]`` uint8 and normalised yolo boxes become letterboxed square
crops ``[.., S, S, 3]`` float32: each output pixel samples the source
bilinearly at ``origin + (i + 0.5) * side / S - 0.5``, and taps outside
the frame count as zero, which gives the black letterbox.

:func:`batched_square_crop_resize`, :func:`batched_window_resize` and
:func:`batched_bank_resize` write the resample as two products with dense
weight matrices per crop, exactly as the JAX functions do (``_crop_one``:
rows first, then columns).  They are the plain versions of the CUDA
kernel's three entries in ``ops/crop_kernel.py``.
"""

from __future__ import annotations

import torch


def square_window_params(boxes, frame_h, frame_w, padding=0):
    """Normalised yolo boxes ``[..., 4]`` (cx, cy, w, h) -> square windows.

    Returns float32 ``(y0, x0, side)``, each of shape ``boxes.shape[:-1]``:
    the top-left corner and side in pixels of the (possibly out-of-frame)
    source window, side = 2 * (floor(max(w_px, h_px) / 2) + padding),
    centred on the integer centre pixel.
    """
    boxes = boxes.float()
    cx = torch.floor(boxes[..., 0] * frame_w)
    cy = torch.floor(boxes[..., 1] * frame_h)
    w_px = torch.floor(boxes[..., 2] * frame_w)
    h_px = torch.floor(boxes[..., 3] * frame_h)
    half = torch.floor(torch.maximum(w_px, h_px) / 2)
    side = 2 * (half + padding)
    return cy - half - padding, cx - half - padding, side


def _axis_weights(origin, side, src_len, out_size):
    """``[..., out_size, src_len]`` bilinear weights along one axis: two
    non-zeros per row, and an all-zero row where the source coordinate
    lies outside ``[-1, src_len]``."""
    i = torch.arange(out_size, dtype=torch.float32, device=origin.device)
    src = origin[..., None] + (i + 0.5) * side[..., None] / out_size - 0.5
    lo = torch.floor(src)
    frac = src - lo
    k = torch.arange(src_len, dtype=torch.float32, device=origin.device)
    lo, frac = lo[..., None], frac[..., None]
    w = torch.where(k == lo, 1.0 - frac, 0.0) + torch.where(k == lo + 1.0, frac, 0.0)
    outside = (src < -1.0) | (src > src_len)
    return torch.where(outside[..., None], 0.0, w)


def batched_square_crop_resize(frames, boxes, out_size=128, padding=0,
                               bgr_to_rgb=False, normalize=True):
    """Crop + square letterbox + bilinear resize + colour flip + /255.

    frames ``[N, H, W, 3]`` (uint8 or float); boxes ``[N, 4]`` gives one
    crop per frame and ``[N, K, 4]`` gives K crops per frame.  Returns
    float32 ``boxes.shape[:-1] + (out_size, out_size, 3)``.
    """
    h, w = frames.shape[1], frames.shape[2]
    one_per_frame = boxes.dim() == 2
    if one_per_frame:
        boxes = boxes[:, None]
    y0, x0, side = square_window_params(boxes, h, w, padding)
    side = torch.clamp(side, min=1.0)
    wy = _axis_weights(y0, side, h, out_size)  # [N, K, S, H]
    wx = _axis_weights(x0, side, w, out_size)  # [N, K, S, W]
    frames_f = frames.float()
    if bgr_to_rgb:
        frames_f = frames_f.flip(-1)
    tmp = torch.einsum("nksh,nhwc->nkswc", wy, frames_f)
    out = torch.einsum("nkswc,nktw->nkstc", tmp, wx)
    if normalize:
        out = out / 255.0
    return out[:, 0] if one_per_frame else out


def batched_window_resize(windows, y0, x0, side, out_size=128, normalize=True):
    """Resample windows cut out on the host to square crops.

    windows ``[M, H, W, C]`` (uint8 or float; black where out of frame);
    y0, x0, side ``[M]`` float window-relative crop geometry, side
    clamped to at least 1.  The resample of
    :func:`batched_square_crop_resize` with the window given instead of
    computed from a box.  Returns float32 ``[M, out_size, out_size, C]``.
    """
    side = torch.clamp(side.float(), min=1.0)
    wy = _axis_weights(y0.float(), side, windows.shape[1], out_size)  # [M, S, W]
    wx = _axis_weights(x0.float(), side, windows.shape[2], out_size)  # [M, S, W]
    tmp = torch.einsum("msh,mhwc->mswc", wy, windows.float())
    out = torch.einsum("mswc,mtw->mstc", tmp, wx)
    if normalize:
        out = out / 255.0
    return out


def batched_bank_resize(bank, rows, origins, out_size, flip=None):
    """Resample gathered rows of an image bank, unnormalised.

    bank ``[M, H, W, C]`` (uint8 or float, C = 3 or 4); rows ``[N]`` int
    indices into it; origins ``[N, 3]`` float (y0, x0, side) in the row's
    pixels, side clamped to at least 1; flip ``[N]`` (non-zero mirrors the
    row left to right before the resample) or None.  What the JAX
    device-side synthesis computes with ``jnp.take(bank, rows)``, an
    optional ``[:, :, ::-1]`` and ``vmap(_crop_one)``
    (``playaid_core_tpu/train/device_synth.py:223-232, :265-268``).  A row
    index outside ``[0, M)`` reads nothing: its crop is zeros, as in K1's
    bank entry.  Returns float32 ``[N, out_size, out_size, C]`` on the 0-255
    scale.
    """
    rows = rows.long()
    inside = (rows >= 0) & (rows < bank.shape[0])
    src = bank.index_select(0, torch.where(inside, rows, 0)).float()
    src = src * inside[:, None, None, None]
    if flip is not None:
        src = torch.where(flip.bool()[:, None, None, None], src.flip(2), src)
    return batched_window_resize(src, origins[:, 0], origins[:, 1], origins[:, 2], out_size,
                                 normalize=False)


def middle_out_frame_indices(middle_frame, num_frames_per_sample, frame_delta,
                             max_frames, min_frame=0):
    """Middle-out window sampler: frame offsets ``delta * (mid - i)^2``
    around each middle frame, clamped to ``[min_frame, max_frames - 1]``.

    The centre frame (offset 0) takes the lower branch, so it is clamped
    to ``min_frame`` too, as the sampler this reproduces does.
    ``middle_frame`` is an int or an int tensor ``[...]``; returns int64
    ``[..., T]``.
    """
    middle = torch.as_tensor(middle_frame)
    t = num_frames_per_sample
    mid = t // 2
    i = torch.arange(t, device=middle.device)
    offset = (frame_delta * (mid - i) ** 2).abs()
    below = torch.clamp(middle[..., None] - offset, min=min_frame)
    upper = torch.as_tensor(max_frames, device=middle.device) - 1
    above = torch.minimum(middle[..., None] + offset, upper)
    return torch.where(i <= mid, below, above).long()
