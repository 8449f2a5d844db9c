"""Array-native chart rasterizers for the per-frame GT hot path.

The matplotlib backend (:mod:`playaid_core_torch.render.charts`) renders a
court-accurate chart in ~2-4 ms — fine for post-game cards, fatal for the
every-frame side panels (4 panels/frame put the GT annotated-render path
at ~34 fps on a 1-core host; the reference semantics re-render charts
every frame, annotator.py:217-276).  These renderers draw the SAME chart
semantics (colors, stacking order, labels, titles, legends — the data
contract the reference established in graphs/bar_charts.py and
graphs/onscreen.py) directly with rectangle fills and text:

* the static "chrome" of a chart (background, title, tick labels,
  legend) depends only on the label set and geometry — it is rendered
  once per chart type and cached;
* a frame's render is chrome.copy() + filled bar rectangles + one
  y-scale number: ~0.2-0.4 ms per panel, ~10-30x under matplotlib.

Pixel output intentionally differs from matplotlib (it is a different
rasterizer); chart-semantics parity is covered by the same golden-hash
discipline with a separate golden set per backend
(tests/test_chart_goldens.py).

The port's own copy of ``playaid_core_torch/render/fastcharts.py``, without
cv2 or PIL: the cv2 calls go through :mod:`playaid_core_torch.draw` and
Pillow's text through :mod:`playaid_core_torch.text`, which draw the same
pixels, so every chart is the JAX package's array bit for bit
(tests/test_torch_port_charts.py; the arrays hash to
tests/fixtures/chart_hashes_fast.json).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from playaid_core_torch import draw, text
from playaid_core_torch.constants import TEXT_FONT_PATH

# Matplotlib's default color wheel equivalents used by the mpl backend.
_COLORS = {
    "blue": (31, 119, 255),
    "red": (214, 39, 40),
    "gray": (127, 127, 127),
    "white": (255, 255, 255),
    "black": (0, 0, 0),
}


def _rgb(name_or_rgb):
    if isinstance(name_or_rgb, str):
        return _COLORS[name_or_rgb]
    return name_or_rgb


@lru_cache(maxsize=4)
def _font(size):
    return text.truetype(TEXT_FONT_PATH, size)


@lru_cache(maxsize=512)
def _text_image(string, size=11, color=(0, 0, 0), rotate=0):
    """Rendered text as a small RGBA array (cached: tick labels and
    titles recur every frame)."""
    img = text.text_image(string, _font(size), color)
    if rotate:
        img = text.rotate(img, rotate, expand=True)
    return img


def _paste_text(canvas, text_img, x, y):
    """Alpha-blend a cached text image onto an RGB(A) canvas at (x, y),
    clipping at the borders."""
    h = min(text_img.shape[0], canvas.shape[0] - y)
    w = min(text_img.shape[1], canvas.shape[1] - x)
    if h <= 0 or w <= 0 or x < 0 or y < 0:
        return
    region = canvas[y:y + h, x:x + w, :3]
    ti = text_img[:h, :w]
    alpha = ti[:, :, 3:4].astype(np.uint16)
    region[:] = ((ti[:, :, :3].astype(np.uint16) * alpha
                  + region.astype(np.uint16) * (255 - alpha)) // 255
                 ).astype(np.uint8)


# ---------------------------------------------------------------------------
# chrome (cached static layer per chart)
# ---------------------------------------------------------------------------

_MARGIN_L, _MARGIN_R, _MARGIN_T = 46, 10, 28


def _bottom_margin(labels, rotated):
    if not labels:
        return 24
    longest = max(len(s) for s in labels)
    return (16 + int(longest * 5.2) if rotated else 24)


@lru_cache(maxsize=64)
def _chart_chrome(labels, title, width, height, rotated, legend):
    """Static chart layer: white background, title, x tick labels,
    legend swatches.  ``legend`` is a tuple of (name, color) pairs."""
    canvas = np.full((height, width, 4), 255, np.uint8)
    _paste_text(canvas, _text_image(title, size=12), 8, 6)
    n = max(len(labels), 1)
    mb = _bottom_margin(labels, rotated)
    plot_w = width - _MARGIN_L - _MARGIN_R
    plot_h = height - _MARGIN_T - mb
    # Axis lines.
    draw.line8(canvas, (_MARGIN_L, _MARGIN_T), (_MARGIN_L, _MARGIN_T + plot_h),
               (0, 0, 0, 255))
    draw.line8(canvas, (_MARGIN_L, _MARGIN_T + plot_h),
               (_MARGIN_L + plot_w, _MARGIN_T + plot_h), (0, 0, 0, 255))
    for i, label in enumerate(labels):
        cx = _MARGIN_L + int((i + 0.5) * plot_w / n)
        if rotated:
            ti = _text_image(label, size=10, rotate=45)
            _paste_text(canvas, ti, cx - ti.shape[1] + 4, _MARGIN_T + plot_h + 4)
        else:
            ti = _text_image(label, size=10)
            _paste_text(canvas, ti, cx - ti.shape[1] // 2, _MARGIN_T + plot_h + 6)
    lx = width - _MARGIN_R - 110
    ly = _MARGIN_T + 4
    for name, color in legend:
        c = _rgb(color)
        draw.rectangle8(canvas, (lx, ly), (lx + 12, ly + 10), c + (255,))
        _paste_text(canvas, _text_image(name, size=10), lx + 16, ly - 1)
        ly += 14
    return canvas, (_MARGIN_L, _MARGIN_T, plot_w, plot_h)


def _nice_ceil(v):
    """Round up to a 1/2/5 x 10^k gridline value (stable y-scales avoid
    per-frame jitter in bar heights)."""
    if v <= 0:
        return 1.0
    exp = np.floor(np.log10(v))
    base = v / 10 ** exp
    for m in (1.0, 2.0, 5.0, 10.0):
        if base <= m:
            return m * 10 ** exp
    return 10 ** (exp + 1)


def _draw_stacked_bars(canvas, rect, series):
    """series: list of (values, color) stacked bottom-up; draws bars and
    the y-max gridline label.  Returns nothing (draws in place)."""
    x0, y0, pw, ph = rect
    n = len(series[0][0])
    if n == 0:
        return
    totals = np.zeros(n, np.float64)
    for values, _c in series:
        totals += np.asarray(values, np.float64)
    ymax = _nice_ceil(float(totals.max()) if n else 1.0)
    bar_w = max(int(pw / n * 0.82), 1)
    base = np.full(n, y0 + ph, np.int32)
    for values, color in series:
        c = _rgb(color)
        vals = np.asarray(values, np.float64)
        heights = np.round(vals / ymax * ph).astype(np.int32)
        for i in range(n):
            if heights[i] <= 0:
                continue
            cx = x0 + int((i + 0.5) * pw / n)
            top = base[i] - heights[i]
            draw.rectangle8(canvas, (cx - bar_w // 2, top),
                            (cx + bar_w // 2, base[i] - 1), c + (255,))
            base[i] = top
    # y-scale: max gridline value at the top of the axis.
    ylab = f"{ymax:g}"
    ti = _text_image(ylab, size=10)
    _paste_text(canvas, ti, x0 - ti.shape[1] - 4, y0 - 4)


# ---------------------------------------------------------------------------
# public renderers (same signatures/returns as the mpl backend)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=32)
def bar_graph_image(labels, counts, width=400, height=360, title="actions",
                    rotated=False, palette=None):
    chrome, rect = _chart_chrome(labels, title, width, height, rotated, ())
    canvas = chrome.copy()
    x0, y0, pw, ph = rect
    n = max(len(labels), 1)
    ymax = _nice_ceil(float(max(counts)) if counts else 1.0)
    bar_w = max(int(pw / n * 0.82), 1)
    for i, v in enumerate(counts):
        h = int(round(v / ymax * ph))
        if h <= 0:
            continue
        cx = x0 + int((i + 0.5) * pw / n)
        color = _rgb(palette[i % len(palette)]) if palette else (78, 121, 167)
        draw.rectangle8(canvas, (cx - bar_w // 2, y0 + ph - h),
                        (cx + bar_w // 2, y0 + ph - 1), tuple(color) + (255,))
    ti = _text_image(f"{ymax:g}", size=10)
    _paste_text(canvas, ti, x0 - ti.shape[1] - 4, y0 - 4)
    return canvas


@lru_cache(maxsize=32)
def success_vs_punished_image(labels, success, punished, title, width=400,
                              height=240, punished_label="punished",
                              success_label="success"):
    legend = ((punished_label, "red"), (success_label, "blue"))
    chrome, rect = _chart_chrome(labels, title, width, height, True, legend)
    canvas = chrome.copy()
    _draw_stacked_bars(canvas, rect, [(punished, "red"), (success, "blue")])
    return canvas


@lru_cache(maxsize=32)
def success_punished_missed_image(labels, success, punished, missed, title,
                                  width=720, height=400, rotated=True):
    legend = (("missed", "gray"), ("punished", "red"), ("success", "blue"))
    chrome, rect = _chart_chrome(labels, title, width, height, rotated, legend)
    canvas = chrome.copy()
    _draw_stacked_bars(
        canvas, rect,
        [(missed, "gray"), (punished, "red"), (success, "blue")],
    )
    return canvas


@lru_cache(maxsize=20)
def move_pie_image(success, punished, missed, size):
    """Blue/red/gray outcome pie on a transparent background (same data
    contract as the mpl backend's _move_pie_chart)."""
    canvas = np.zeros((size, size, 4), np.uint8)
    values = [success, punished, missed]
    colors = ["blue", "red", "gray"]
    if sum(values) == 0:
        values = [1, 0, 0]
    total = float(sum(values))
    center = (size // 2, size // 2)
    radius = size // 2 - 1
    # matplotlib pies start at 0 deg (east) and go counter-clockwise.
    start = 0.0
    for v, cname in zip(values, colors):
        if v <= 0:
            continue
        sweep = 360.0 * v / total
        c = _rgb(cname)
        draw.ellipse(canvas, center, (radius, radius), 0.0, -start,
                     -(start + sweep), c + (255,), -1)
        start += sweep
    # White wedge edges, matching the mpl backend's wedgeprops.
    start = 0.0
    if any(v > 0 for v in values[1:]):
        for v in values:
            if v <= 0:
                continue
            ang = np.deg2rad(-start)
            draw.line(canvas, center,
                      (int(center[0] + radius * np.cos(ang)),
                       int(center[1] + radius * np.sin(ang))),
                      (255, 255, 255, 255), 1)
            start += 360.0 * v / total
    return canvas
