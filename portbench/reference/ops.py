"""Reference image and decode operations: YUV420 unpack, middle-out window
indices and the Viterbi decode.

Each follows the semantics the pipeline documents:

* YUV420: packed planar crops ``[N, S*S*3//2]`` (Y, then U, then V),
  BT.601 limited range, chroma upsampled 2x by nearest neighbour, RGB
  clamped to [0, 255] and divided by 255;
* middle-out windows: offsets ``delta * (mid - i)^2`` around each frame,
  the lower half (the centre included) clamped to ``min_frame``, the upper
  half to the last true frame;
* Viterbi under a Potts prior of ``switch_cost`` nats, in float32: each
  step switches from the first index of the maximum, staying wins ties.
"""

from __future__ import annotations

import numpy as np
import torch


def yuv420_to_rgb(crops, size):
    """uint8 ``[N, S*S*3//2]`` -> float32 ``[N, 3, S, S]`` RGB in [0, 1]."""
    n, s = crops.shape[0], size
    yb, cb = s * s, (s // 2) * (s // 2)
    y = crops[:, :yb].reshape(n, s, s).float()
    u = crops[:, yb:yb + cb].reshape(n, s // 2, s // 2).float()
    v = crops[:, yb + cb:].reshape(n, s // 2, s // 2).float()
    up = lambda c: c.repeat_interleave(2, 1).repeat_interleave(2, 2)  # noqa: E731
    u, v = up(u) - 128.0, up(v) - 128.0
    luma = 1.164383 * (y - 16.0)
    rgb = torch.stack([luma + 1.596027 * v,
                       luma - 0.391762 * u - 0.812968 * v,
                       luma + 2.017232 * u], dim=1)
    return torch.clamp(rgb, 0.0, 255.0) / 255.0


def middle_out_indices(num_frames, length, delta, min_frame=0):
    """int64 ``[num_frames, length]`` frame indices of each frame's window."""
    mid = length // 2
    i = np.arange(length)
    offset = np.abs(delta * (mid - i) ** 2)
    f = np.arange(num_frames)[:, None]
    below = np.maximum(f - offset, min_frame)
    above = np.minimum(f + offset, num_frames - 1)
    return np.where(i <= mid, below, above).astype(np.int64)


def viterbi(log_probs, switch_cost):
    """MAP label paths ``[B, F]`` (int64) of float32 log-probs ``[B, F,
    A]`` (numpy), every row valid."""
    lp = np.asarray(log_probs, np.float32)
    b, f, a = lp.shape
    cost = np.float32(switch_cost)
    idx = np.arange(a)[None, :]
    rows = np.arange(b)
    carry = lp[:, 0].copy()
    ptrs = np.empty((max(f - 1, 0), b, a), np.int64)
    for t in range(1, f):
        switch_from = np.argmax(carry, axis=1)
        switch_score = carry[rows, switch_from] - cost
        stay = carry >= switch_score[:, None]
        ptrs[t - 1] = np.where(stay, idx, switch_from[:, None])
        carry = lp[:, t] + np.where(stay, carry, switch_score[:, None])
    labels = np.empty((b, f), np.int64)
    cur = np.argmax(carry, axis=1)
    for t in range(f - 1, 0, -1):
        labels[:, t] = cur
        cur = ptrs[t - 1][rows, cur]
    labels[:, 0] = cur
    return labels
