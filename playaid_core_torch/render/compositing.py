"""Host-side image compositing helpers.

The port's own copy of ``playaid_core_tpu/render/compositing.py``: numpy
only; ``figure_to_rgba`` (the ``mpl`` chart backend) imports cv2 when it
has to resize.  Rebuild of the reference graph utils (reference: graphs/utils.py:1-67).
``paste_on_top`` reproduces the alpha-over blend exactly; chart
rasterisation goes through matplotlib-Agg instead of the reference's
bokeh + selenium + headless-browser stack (reference: graphs/utils.py:6-7),
which was its single most expensive render dependency.
"""

from __future__ import annotations

import re

import numpy as np


def is_ascii(s="") -> bool:
    s = str(s)
    return len(s.encode().decode("ascii", "ignore")) == len(s)


def split_text_emoji(text):
    pattern = re.compile(r"([☺-\U0001f645])|(\w+)|(\s+)|([0-9])")
    return [match.group() for match in pattern.finditer(text)]


def paste_on_top(src, dst, x, y):
    """Alpha-blend RGBA ``src`` onto RGBA ``dst`` at (x, y) in place
    (reference: graphs/utils.py:17-63)."""
    if x < 0 or y < 0:
        return dst

    h_src, w_src = src.shape[:2]
    h_dst, w_dst = dst.shape[:2]
    if x >= w_dst or y >= h_dst:
        return dst

    h_paste = min(h_src, h_dst - y)
    w_paste = min(w_src, w_dst - x)

    src_cropped = src[:h_paste, :w_paste].astype(np.float32)
    dst_region = dst[y : y + h_paste, x : x + w_paste].astype(np.float32)

    src_rgb = src_cropped[..., :3]
    src_alpha = src_cropped[..., 3:4] / 255.0
    dst_rgb = dst_region[..., :3]
    dst_alpha = dst_region[..., 3:4] / 255.0

    out_alpha = src_alpha + dst_alpha * (1 - src_alpha)
    out_rgb = (src_rgb * src_alpha + dst_rgb * dst_alpha * (1 - src_alpha)) / np.where(
        out_alpha == 0, 1, out_alpha
    )
    out_rgb = np.where(out_alpha == 0, dst_rgb, out_rgb)

    out = np.concatenate([out_rgb, out_alpha * 255], axis=-1)
    dst[y : y + h_paste, x : x + w_paste] = out.astype(np.uint8)
    return dst


def make_white_transparent(img):
    """Zero out near-white pixels (reference: graphs/onscreen.py:29-34)."""
    white = np.all(img[:, :, :3] > 200, axis=2)
    img[white] = 0
    return img


def figure_to_rgba(fig, width, height):
    """Rasterise a matplotlib figure to an RGBA uint8 array of exactly
    (height, width)."""
    dpi = fig.get_dpi()
    fig.set_size_inches(width / dpi, height / dpi)
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())
    if buf.shape[0] != height or buf.shape[1] != width:
        import cv2

        buf = cv2.resize(buf, (width, height), interpolation=cv2.INTER_AREA)
    return buf.copy()
