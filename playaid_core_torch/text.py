"""Pillow's text drawing, and the few ``ImageDraw`` shapes and the
``Image.rotate`` that the charts and the annotator use, without Pillow.

The card's machine has neither Pillow nor a font file, and the charts of
``render/fastcharts.py`` and ``render/charts.py`` and the annotator's
non-ASCII labels draw through ``ImageDraw.text`` (DejaVuSans at sizes 10-15,
and ``ImageFont.load_default()``).  FreeType renders each glyph hinted, at a
whole-pixel pen position, so a glyph's coverage mask does not depend on where
it lands; this module draws from an atlas of those masks,
``assets/text_atlas.npz``, which ``tools/torch_port_text_atlas.py`` renders
with Pillow and checks against it.  Per font the atlas holds, for every
unit (a printable ASCII character, the font's ligatures, the few non-ASCII
characters the annotator writes):

* the advance in 26.6 fixed point, as raqm lays it out, and the pair
  kerning between units;
* the unit's mask as ``font.getmask2`` renders it alone, with its offset,
  its box (``font.getbbox``) and the right edge of its ink box.

The layout is Pillow's (``_imagingft.c``): units are taken greedily,
longest first (the ligatures); the pen advances by each unit's advance plus
its kerning with the next; a unit is placed at ``PIXEL(pen) = (pen + 32) >>
6``; masks that overlap combine as ``a + b - a * b / 255`` in their order;
the box spans the pen line, each ``PIXEL`` of the pen after a unit, and the
units' boxes.  Drawing blends the mask into the image as Pillow's
``fill_mask_L`` does.  ``tests/test_torch_port_text.py`` holds every
function against Pillow.
"""

from __future__ import annotations

import math
import os
import threading

import numpy as np

ATLAS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                          "text_atlas.npz")
DEFAULT_FONT = "pil_default"

_lock = threading.Lock()
_atlas = None
_fonts: dict = {}


def _load_atlas():
    global _atlas
    with _lock:
        if _atlas is None:
            with np.load(ATLAS_PATH) as data:
                _atlas = {k: data[k] for k in data.files}
    return _atlas


def _pixel(v):
    return (v + 32) >> 6


def _div255(v):
    v = v + 128
    return ((v >> 8) + v) >> 8


class Font:
    """One font at one size, read from the atlas (``truetype`` /
    ``load_default`` make these)."""

    def __init__(self, key):
        atlas = _load_atlas()
        if f"{key}/units" not in atlas:
            raise ValueError(f"the text atlas has no font {key!r}; render it with "
                             "tools/torch_port_text_atlas.py")
        self.key = key
        units = [str(u) for u in atlas[f"{key}/units"]]
        self.index = {u: i for i, u in enumerate(units)}
        self.longest = max(len(u) for u in units)
        metrics = atlas[f"{key}/metrics"].astype(np.int64)
        (self.adv, self.off_x, self.off_y, self.left, self.top, self.right, self.bottom,
         self.ink_right) = (metrics[:, i].tolist() for i in range(8))
        self.ascender = int(atlas[f"{key}/ascender"])
        shapes = atlas[f"{key}/shapes"].astype(np.int64)
        flat = atlas[f"{key}/masks"]
        starts = np.concatenate([[0], np.cumsum(shapes[:, 0] * shapes[:, 1])])
        self.masks = [flat[starts[i]:starts[i + 1]].reshape(shapes[i]) for i in range(len(units))]
        self.kern = {(int(a), int(b)): int(v) for a, b, v in atlas[f"{key}/kern"]}

    def _units(self, text):
        ids, i = [], 0
        while i < len(text):
            for n in range(min(self.longest, len(text) - i), 0, -1):
                unit = self.index.get(text[i:i + n])
                if unit is not None:
                    ids.append(unit)
                    i += n
                    break
            else:
                raise ValueError(f"the text atlas has no glyph for {text[i]!r} in {self.key}; "
                                 "add it with tools/torch_port_text_atlas.py")
        return ids

    def _layout(self, text):
        """The units, the 26.6 pen position of each and after each."""
        ids = self._units(text)
        pens = [0]
        for j, u in enumerate(ids):
            kern = self.kern.get((u, ids[j + 1]), 0) if j + 1 < len(ids) else 0
            pens.append(pens[-1] + self.adv[u] + kern)
        return ids, pens

    def getlength(self, text):
        return self._layout(text)[1][-1] / 64.0

    def getbbox(self, text):
        """``FreeTypeFont.getbbox(text)`` (anchor "la")."""
        ids, pens = self._layout(text)
        x_min = x_max = 0
        top = bottom = self.ascender
        for j, u in enumerate(ids):
            px = _pixel(pens[j])
            x_min = min(x_min, px + self.left[u])
            x_max = max(x_max, _pixel(pens[j + 1]), px + self.ink_right[u])
            top, bottom = min(top, self.top[u]), max(bottom, self.bottom[u])
        return x_min, top, x_max, bottom

    def getmask(self, text):
        """The coverage mask of ``text`` (uint8 ``[h, w]``) and its offset
        from the origin, as ``font.getmask2(text)`` gives them."""
        ids, pens = self._layout(text)
        x_min, top, x_max, bottom = self.getbbox(text)
        out = np.zeros((bottom - top, x_max - x_min), np.int64)
        for j, u in enumerate(ids):
            m = self.masks[u]
            if not m.size:
                continue
            x0 = _pixel(pens[j]) + self.off_x[u] - x_min
            y0 = self.off_y[u] - top
            region = out[y0:y0 + m.shape[0], x0:x0 + m.shape[1]]
            src = m[:region.shape[0], :region.shape[1]].astype(np.int64)
            region[:] = region + src - _div255(region * src)
        return out.astype(np.uint8), (x_min, top)


def truetype(path, size):
    """``ImageFont.truetype(path, size)`` for a font in the atlas, found by
    the file's name (the file itself is not read)."""
    name = os.path.splitext(os.path.basename(str(path)))[0]
    return _font(f"{name}_{int(size)}")


def load_default():
    """``ImageFont.load_default()``: Pillow's built-in font at size 10."""
    return _font(f"{DEFAULT_FONT}_10")


def _font(key):
    with _lock:
        font = _fonts.get(key)
    if font is None:
        font = Font(key)
        with _lock:
            _fonts[key] = font
    return font


def _origin(xy):
    x, y = xy
    if x != int(x) or y != int(y):
        raise ValueError("text is drawn at whole-pixel origins only")
    return int(x), int(y)


def textbbox(xy, text, font):
    """``ImageDraw.textbbox(xy, text, font=font)``."""
    x, y = _origin(xy)
    left, top, right, bottom = font.getbbox(text)
    return left + x, top + y, right + x, bottom + y


def _ink(img, fill):
    c = img.shape[2]
    ink = list(fill)[:c]
    if len(ink) < c:
        ink += [255] * (c - len(ink))  # alpha 255, as Pillow's getink gives
    return np.array(ink, np.int64)


def _blend(img, y, x, mask, ink):
    """Pillow's ``fill_mask_L``: each channel moves toward the ink by the
    mask, ``DIV255(v * (255 - m) + ink * m)``; on an RGBA image a colour
    channel of a fully transparent pixel takes the ink wherever the mask
    is not 0."""
    h, w = img.shape[:2]
    y0, x0 = max(y, 0), max(x, 0)
    y1, x1 = min(y + mask.shape[0], h), min(x + mask.shape[1], w)
    if y1 <= y0 or x1 <= x0:
        return
    m = mask[y0 - y:y1 - y, x0 - x:x1 - x].astype(np.int64)[..., None]
    out = img[y0:y1, x0:x1].astype(np.int64)
    m = np.broadcast_to(m, out.shape).copy()
    if img.shape[2] == 4:
        colour = m[..., :3]
        m[..., :3] = np.where((colour != 0) & (out[..., 3:4] == 0), 255, colour)
    img[y0:y1, x0:x1] = _div255(out * (255 - m) + ink * m)


def text(img, xy, string, font, fill):
    """``ImageDraw.Draw(im).text(xy, string, font=font, fill=fill)`` on an
    RGB or RGBA uint8 array, in place."""
    x, y = _origin(xy)
    mask, (ox, oy) = font.getmask(string)
    _blend(img, y + oy, x + ox, mask, _ink(img, fill))
    return img


def text_image(string, font, fill):
    """The text on a transparent white RGBA canvas one pixel larger than its
    box on every side (the charts' cached label images)."""
    left, top, right, bottom = font.getbbox(string)
    w, h = max(right - left, 1), max(bottom - top, 1)
    img = np.empty((h + 2, w + 2, 4), np.uint8)
    img[:] = (255, 255, 255, 0)
    return text(img, (1 - left, 1 - top), string, font, tuple(fill) + (255,))


# ---------------------------------------------------------------------------
# ImageDraw's rectangles and axis-aligned lines
# ---------------------------------------------------------------------------


def _hline(img, x0, y, x1, ink):
    h, w = img.shape[:2]
    if not 0 <= y < h:
        return
    if x0 > x1:
        x0, x1 = x1, x0
    x0, x1 = max(x0, 0), min(x1, w - 1)
    if x0 <= x1:
        img[y, x0:x1 + 1] = ink


def _vline(img, x, y0, y1, ink):
    h, w = img.shape[:2]
    if not 0 <= x < w:
        return
    if y0 > y1:
        y0, y1 = y1, y0
    y0, y1 = max(y0, 0), min(y1, h - 1)
    if y0 <= y1:
        img[y0:y1 + 1, x] = ink


def rectangle(img, xy, fill=None, outline=None, width=1):
    """``ImageDraw.rectangle(xy, fill=fill, outline=outline, width=width)``
    on an RGB or RGBA uint8 array, in place."""
    (x0, y0), (x1, y1) = (xy[0], xy[1]) if len(xy) == 2 else ((xy[0], xy[1]), (xy[2], xy[3]))
    if x1 < x0:
        raise ValueError("x1 must be greater than or equal to x0")
    if y1 < y0:
        raise ValueError("y1 must be greater than or equal to y0")
    x0, y0, x1, y1 = int(x0), int(y0), int(x1), int(y1)
    fill_ink = None if fill is None else _ink(img, fill)
    if fill_ink is not None:
        for y in range(max(y0, 0), min(y1, img.shape[0] - 1) + 1):
            _hline(img, x0, y, x1, fill_ink)
    if outline is not None and width != 0:
        ink = _ink(img, outline)
        if fill_ink is not None and np.array_equal(ink, fill_ink):
            return img
        for i in range(width):
            _hline(img, x0, y0 + i, x1, ink)
            _hline(img, x0, y1 - i, x1, ink)
            _vline(img, x1 - i, y0 + width, y1 - width + 1, ink)
            _vline(img, x0 + i, y0 + width, y1 - width + 1, ink)
    return img


def _round_up(f):
    return int(math.floor(f + 0.5)) if f >= 0 else -int(math.floor(abs(f) + 0.5))


def _round_down(f):
    return int(math.ceil(f - 0.5)) if f >= 0 else -int(math.ceil(abs(f) - 0.5))


def line(img, xy, fill, width=1):
    """``ImageDraw.line(xy, fill=fill, width=width)`` of one vertical or
    horizontal segment: Pillow's wide line is the polygon around it,
    ``(width - 1) / 2`` rounded down on one side and up on the other."""
    (x0, y0), (x1, y1) = [(int(x), int(y)) for x, y in xy]
    if x0 != x1 and y0 != y1:
        raise ValueError("only vertical and horizontal lines are drawn")
    ink = _ink(img, fill)
    if width <= 1:
        lo, hi = 0, 0
    else:
        half = (width - 1) / 2.0
        lo, hi = _round_down(half), _round_up(half)
    if x0 == x1:
        sign = 1 if y1 >= y0 else -1
        a, b = x0 - sign * lo, x0 + sign * hi
        for x in range(min(a, b), max(a, b) + 1):
            _vline(img, x, y0, y1, ink)
    else:
        sign = 1 if x1 >= x0 else -1
        a, b = y0 + sign * hi, y0 - sign * lo
        for y in range(min(a, b), max(a, b) + 1):
            _hline(img, x0, y, x1, ink)
    return img


# ---------------------------------------------------------------------------
# Image.rotate (nearest neighbour)
# ---------------------------------------------------------------------------


def rotate(img, angle, expand=False):
    """``Image.fromarray(img).rotate(angle, expand=expand)`` (nearest
    neighbour, zero fill) for angles off the right angles: Pillow's matrix
    in double precision, then its 16.16 fixed-point affine walk."""
    h, w = img.shape[:2]
    angle = angle % 360.0
    if angle in (0, 90, 180, 270):
        raise ValueError("right-angle rotations take Pillow's transpose path")
    cx, cy = w / 2, h / 2
    rad = -math.radians(angle)
    m = [round(math.cos(rad), 15), round(math.sin(rad), 15), 0.0,
         round(-math.sin(rad), 15), round(math.cos(rad), 15), 0.0]

    def transform(x, y):
        return m[0] * x + m[1] * y + m[2], m[3] * x + m[4] * y + m[5]

    m[2], m[5] = transform(-cx, -cy)
    m[2] += cx
    m[5] += cy
    nw, nh = w, h
    if expand:
        corners = [transform(x, y) for x, y in ((0, 0), (w, 0), (w, h), (0, h))]
        xs, ys = [p[0] for p in corners], [p[1] for p in corners]
        nw = math.ceil(max(xs)) - math.floor(min(xs))
        nh = math.ceil(max(ys)) - math.floor(min(ys))
        m[2], m[5] = transform(-(nw - w) / 2.0, -(nh - h) / 2.0)
    for x, y in ((0, 0), (nw, nh), (0, nh), (nw, 0)):
        if not (abs(x * m[0] + y * m[1] + m[2]) < 32768.0
                and abs(x * m[3] + y * m[4] + m[5]) < 32768.0):
            raise ValueError("the image is too large for Pillow's fixed-point rotation")

    def fix(v):
        return math.floor(v * 65536.0 + 0.5)

    a0, a1, a3, a4 = fix(m[0]), fix(m[1]), fix(m[3]), fix(m[4])
    a2 = fix(m[2] + m[1] * 0.5 + m[0] * 0.5)
    a5 = fix(m[5] + m[4] * 0.5 + m[3] * 0.5)
    ys, xs = np.mgrid[0:nh, 0:nw].astype(np.int64)
    xin = (a2 + ys * a1 + xs * a0) >> 16
    yin = (a5 + ys * a4 + xs * a3) >> 16
    inside = (xin >= 0) & (xin < w) & (yin >= 0) & (yin < h)
    out = np.zeros((nh, nw) + img.shape[2:], img.dtype)
    out[inside] = img[yin[inside], xin[inside]]
    return out
