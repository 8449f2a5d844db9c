"""The antialiased drawing of OpenCV that the sprite renderer uses, without
OpenCV.

The card's machine has no cv2, and ``datagen/skeletal_sprites.py`` draws
its fighters with ``cv2.line``, ``cv2.circle``, ``cv2.ellipse``,
``cv2.fillPoly`` and a filled ``cv2.rectangle``, all with ``LINE_AA`` on
uint8 images.  This module is that subset of OpenCV's ``drawing.cpp``,
rewritten step for step so that it draws the same pixels:

* points in 16-bit fixed point (``XY_SHIFT``), C's truncating division and
  arithmetic shifts, ``cvRound``'s half-to-even;
* ``LineAA``: three pixels a step across the line, weights from OpenCV's
  ``FilterTable`` scaled by its slope correction and the end-point table,
  each channel moved toward the colour twice by ``((c - v) * a + 127) >>
  8``, the alpha channel of a 4-channel image too;
* ``ThickLine``: a 4-point polygon around the segment and a filled circle
  of half the thickness at each end (round caps);
* ``FillConvexPoly`` (filled circles, ellipses, the filled rectangle and
  the line bodies): antialiased edges, then the scanline fill overwrites the inside
  with the colour;
* ``CollectPolyEdges``/``FillEdgeCollection`` (``fillPoly``): antialiased
  edges, then an even-odd scanline fill;
* ``ellipse2Poly`` with OpenCV's ``SinTable`` (the sines of whole degrees
  rounded to 7 places, in float32) and its step of 5-90 degrees by size.

Coordinates off the canvas are clipped as OpenCV clips them.  Only
``LINE_AA`` and ``shift=0`` arguments are offered; images are uint8 with 3
or 4 channels, drawn in place.  ``tests/test_torch_port_draw.py`` holds
every function against cv2 pixel for pixel.
"""

from __future__ import annotations

import math
import sys

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT

_SLOPE_CORR = (
    181, 181, 181, 182, 182, 183, 184, 185, 187, 188, 190, 192, 194, 196, 198, 201,
    203, 206, 209, 211, 214, 218, 221, 224, 227, 231, 235, 238, 242, 246, 250, 254,
)
_FILTER = np.array((
    168, 177, 185, 194, 202, 210, 218, 224, 231, 236, 241, 246, 249, 252, 254, 254,
    254, 254, 252, 249, 246, 241, 236, 231, 224, 218, 210, 202, 194, 185, 177, 168,
    158, 149, 140, 131, 122, 114, 105, 97, 89, 82, 75, 68, 62, 56, 50, 45,
    40, 36, 32, 28, 25, 22, 19, 16, 14, 12, 11, 9, 8, 7, 5, 5,
), np.int64)
_TAP_SIGN = np.array([1, 1, -1], np.int64)
_TAP_OFF = np.array([32, 0, 63], np.int64)
_TAP_STEP = np.arange(3, dtype=np.int64)
# OpenCV's SinTable: sin of 0..450 degrees as written to 7 places, float32,
# read back as float64 where it is multiplied.
_SIN = np.float32(np.round(np.sin(np.radians(np.arange(451))), 7)).astype(np.float64).tolist()


def _tdiv(a, b):
    """C's integer division, truncating toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _color(img, color):
    """``scalarToRawData`` for uint8: the first ``channels`` values,
    rounded and saturated, missing ones 0."""
    vals = list(color)[: img.shape[2]] + [0] * max(0, img.shape[2] - len(color))
    return np.array([min(255, max(0, round(float(v)))) for v in vals], np.int64)


def _check(img):
    if not (isinstance(img, np.ndarray) and img.dtype == np.uint8 and img.ndim == 3
            and img.shape[2] in (3, 4)):
        raise TypeError("draw takes uint8 images [H, W, 3] or [H, W, 4]")


# ---------------------------------------------------------------------------
# Lines
# ---------------------------------------------------------------------------


def _clip_line(width, height, x1, y1, x2, y2):
    """``clipLine`` on a ``width`` x ``height`` area: (inside?, clipped
    points).  Later steps use the points earlier steps moved, as in C."""
    if width <= 0 or height <= 0:
        return False, x1, y1, x2, y2
    right, bottom = width - 1, height - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line_setup(h, w, x1, y1, x2, y2):
    """``LineAA``'s set-up of one fixed-point segment, clipped: (x-major?,
    first pixel along, fixed-point position across, step across, last step
    index, the 9 end-point corrections), or None when it is off the image."""
    ok, x1, y1, x2, y2 = _clip_line(w << XY_SHIFT, h << XY_SHIFT, x1, y1, x2, y2)
    if not ok:
        return None
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    x_major = ax > ay
    if x_major:
        if dx < 0:
            dy = -dy
            x1, x2, y1, y2 = x2, x1, y2, y1
        step = _tdiv(dy << XY_SHIFT, ax | 1)
        x2 += XY_ONE
        ecount = (x2 >> XY_SHIFT) - (x1 >> XY_SHIFT)
        y1 += ((step * -(x1 & (XY_ONE - 1))) >> XY_SHIFT) + (XY_ONE >> 1)
        start, across = x1, y1
        i, j = (x1 >> (XY_SHIFT - 7)) & 0x78, (x2 >> (XY_SHIFT - 7)) & 0x78
    else:
        if dy < 0:
            dx = -dx
            x1, x2, y1, y2 = x2, x1, y2, y1
        step = _tdiv(dx << XY_SHIFT, ay | 1)
        y2 += XY_ONE
        ecount = (y2 >> XY_SHIFT) - (y1 >> XY_SHIFT)
        x1 += ((step * -(y1 & (XY_ONE - 1))) >> XY_SHIFT) + (XY_ONE >> 1)
        start, across = y1, x1
        i, j = (y1 >> (XY_SHIFT - 7)) & 0x78, (y2 >> (XY_SHIFT - 7)) & 0x78
    slope = (step >> (XY_SHIFT - 5)) & 0x3F
    slope ^= 0x3F if step < 0 else 0
    slope = 0x100 if slope & 0x20 else _SLOPE_CORR[slope]
    t0 = slope << 7
    t1 = ((0x78 - i) | 4) * slope
    t2 = (j | 4) * slope
    ep13 = ((((j - i) & 0x78) | 4) * slope >> 8) & 0x1FF
    return (x_major, start >> XY_SHIFT, across, step, ecount,
            0, ep13, (t1 >> 8) & 0x1FF, ep13, ((((j - i) + 0x80) | 4) * slope >> 8) & 0x1FF,
            ((t1 + t0) >> 8) & 0x1FF, (t2 >> 8) & 0x1FF, ((t2 + t0) >> 8) & 0x1FF, slope)


def _lines_aa(img, segs, color):
    """``LineAA`` of each fixed-point segment ``(x1, y1, x2, y2)`` in turn.

    Each step of a segment blends three pixels across it, and no two steps
    of one segment share a pixel, so a segment is one vector operation.
    Segments that share pixels (a polygon's edges at its corners) blend
    them in their order: the updates of all segments are applied in rounds,
    round r taking each pixel's r-th update."""
    h, w = img.shape[:2]
    rows = [r for r in (_line_setup(h, w, *seg) for seg in segs) if r is not None]
    if not rows:
        return
    table = np.array(rows, np.int64)
    n = table[:, 4] + 1
    seg = np.repeat(np.arange(len(rows)), n)
    k = np.arange(int(n.sum()), dtype=np.int64) - np.repeat(np.cumsum(n) - n, n)
    x_major = table[seg, 0].astype(bool)[:, None]
    # Step k's end-point correction: ep[3 * min(k, 2) + min(ecount - k, 2)].
    corr = table[seg, 5 + 3 * np.minimum(k, 2) + np.minimum(table[seg, 4] - k, 2)]
    pos = table[seg, 2] + k * table[seg, 3]
    dist = (pos >> (XY_SHIFT - 5)) & 31
    # The three pixels across: FilterTable[dist + 32], [dist], [63 - dist].
    weights = (corr[:, None] * _FILTER[dist[:, None] * _TAP_SIGN + _TAP_OFF] >> 8) & 0xFF
    cross = ((pos >> XY_SHIFT) - 1)[:, None] + _TAP_STEP
    along = np.broadcast_to((table[seg, 1] + k)[:, None], cross.shape)
    ys = np.where(x_major, cross, along)
    xs = np.where(x_major, along, cross)
    keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    ys, xs, a = ys[keep], xs[keep], weights[keep][:, None]
    if len(rows) == 1:
        rounds = [slice(None)]
    else:
        at = ys * w + xs
        order = np.argsort(at, kind="stable")
        ranked = at[order]
        first = np.r_[True, ranked[1:] != ranked[:-1]]
        idx = np.arange(len(at))
        rank = np.empty_like(idx)
        rank[order] = idx - np.maximum.accumulate(np.where(first, idx, 0))
        rounds = [rank == r for r in range(int(rank.max()) + 1)] if len(at) else []
    for r in rounds:
        y, x, ar = ys[r], xs[r], a[r]
        v = img[y, x].astype(np.int64)
        v += ((color - v) * ar + 127) >> 8
        v += ((color - v) * ar + 127) >> 8
        img[y, x] = v


def _thick_line(img, p0, p1, color, thickness, flags):
    """``ThickLine`` (``LINE_AA``) between fixed-point points; ``flags``
    bit 1 caps the start, bit 2 the end."""
    if thickness <= 1:
        _lines_aa(img, [(p0[0], p0[1], p1[0], p1[1])], color)
        return
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thickness <<= XY_SHIFT - 1
    if abs(r) > sys.float_info.epsilon:
        r = (thickness + odd * XY_ONE * 0.5) / math.sqrt(r)
        ddx, ddy = round(dy * r), round(dx * r)
        _fill_convex_poly(img, [(p0[0] + ddx, p0[1] + ddy), (p0[0] - ddx, p0[1] - ddy),
                                (p1[0] - ddx, p1[1] - ddy), (p1[0] + ddx, p1[1] + ddy)],
                          color, XY_SHIFT)
    for i in range(2):
        if flags & (i + 1):
            _ellipse_ex(img, p0, (thickness, thickness), 0, 0, 360, color, -1)
        p0 = p1


def _poly_line(img, pts, color, thickness):
    """``PolyLine`` of fixed-point points, open: the first segment capped
    at both ends, the others at their end."""
    flags = 3
    for p0, p1 in zip(pts, pts[1:]):
        _thick_line(img, p0, p1, color, thickness, flags)
        flags = 2


# ---------------------------------------------------------------------------
# Fills
# ---------------------------------------------------------------------------


def _fill_convex_poly(img, v, color, shift):
    """``FillConvexPoly`` (``LINE_AA``) of points in ``shift``-bit fixed
    point."""
    h, w = img.shape[:2]
    npts = len(v)
    delta = (1 << shift) >> 1
    up = XY_SHIFT - shift
    px, py = v[-1][0] << up, v[-1][1] << up
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    segs = []
    for i, (x, y) in enumerate(v):
        if y < ymin:
            ymin, imin = y, i
        ymax, xmax, xmin = max(ymax, y), max(xmax, x), min(xmin, x)
        segs.append((px, py, x << up, y << up))
        px, py = x << up, y << up
    _lines_aa(img, segs, color)
    xmin, xmax = (xmin + delta) >> shift, (xmax + delta) >> shift
    ymin, ymax = (ymin + delta) >> shift, (ymax + delta) >> shift
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    # Per edge: [idx, di, x, dx, ye]
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, npts - 1, -XY_ONE, 0, ymin]]
    edges = npts
    y = ymin
    while True:
        if y < ymax or y == ymin:
            for e in edge:
                if y < e[4]:
                    continue
                idx0, di = e[0], e[1]
                idx = idx0 + di
                if idx >= npts:
                    idx -= npts
                while True:  # for (; edges-- > 0; )
                    edges -= 1
                    if edges + 1 <= 0:
                        break
                    ty = (v[idx][1] + delta) >> shift
                    if ty > y:
                        xs, xe = v[idx0][0] << up, v[idx][0] << up
                        e[4] = ty
                        e[3] = _tdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e[2] = xs
                        e[0] = idx
                        break
                    idx0 = idx
                    idx += di
                    if idx >= npts:
                        idx -= npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (edge[1], edge[0]) if edge[0][2] > edge[1][2] else (edge[0], edge[1])
            x1 = (left[2] + XY_ONE - 1) >> XY_SHIFT
            x2 = right[2] >> XY_SHIFT
            if x2 >= 0 and x1 < w:
                img[y, max(x1, 0):min(x2, w - 1) + 1] = color
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break


def _collect_poly_edges(v, segs, edges, shift):
    """``CollectPolyEdges`` (``LINE_AA``, no offset) of points in
    ``shift``-bit fixed point: appends the antialiased outline's segments
    to ``segs`` (the caller draws them) and (y0, y1, x, dx) per
    non-horizontal edge to ``edges``, rows being the points' y rounded to
    whole pixels and x in 16-bit fixed point."""
    half = (1 << shift) >> 1
    up = XY_SHIFT - shift
    p0 = (v[-1][0] << up, (v[-1][1] + half) >> shift)
    for x, y in v:
        p1 = (x << up, (y + half) >> shift)
        segs.append((p0[0], p0[1] << XY_SHIFT, p1[0], p1[1] << XY_SHIFT))
        if p0[1] != p1[1]:
            dx = _tdiv(p1[0] - p0[0], p1[1] - p0[1])
            top = p0 if p0[1] < p1[1] else p1
            edges.append((top[1], max(p0[1], p1[1]), top[0], dx))
        p0 = p1


def _fill_edge_collection(img, edges, color):
    """``FillEdgeCollection`` (``LINE_AA``): on each row the active edges
    (y0 <= y < y1) sorted by x, filled between pairs from ceil(x) to
    floor(x)."""
    if len(edges) < 2:
        return
    h, w = img.shape[:2]
    e = np.array(edges, np.int64)
    y0, y1, x0, dx = e.T
    x_end = x0 + (y1 - y0) * dx
    if (y1.max() < 0 or y0.min() >= h or max(x0.max(), x_end.max()) < 0
            or min(x0.min(), x_end.min()) >= (w << XY_SHIFT)):
        return
    for y in range(max(int(y0.min()), 0), min(int(y1.max()), h)):
        act = (y0 <= y) & (y < y1)
        xs = np.sort(x0[act] + (y - y0[act]) * dx[act])
        for a, b in zip(xs[0::2].tolist(), xs[1::2].tolist()):
            xa, xb = (a + XY_ONE - 1) >> XY_SHIFT, b >> XY_SHIFT
            if xa < w and xb >= 0:
                img[y, max(xa, 0):min(xb, w - 1) + 1] = color


# ---------------------------------------------------------------------------
# Ellipses
# ---------------------------------------------------------------------------


def ellipse2poly(center, axes, angle, arc_start, arc_end, delta):
    """OpenCV's float ``ellipse2Poly``: the arc's points as floats."""
    if not 0 < delta <= 180:
        raise ValueError("delta must be in (0, 180]")
    while angle < 0:
        angle += 360
    while angle > 360:
        angle -= 360
    if arc_start > arc_end:
        arc_start, arc_end = arc_end, arc_start
    while arc_start < 0:
        arc_start += 360
        arc_end += 360
    while arc_end > 360:
        arc_end -= 360
        arc_start -= 360
    if arc_end - arc_start > 360:
        arc_start, arc_end = 0, 360
    a = angle + (360 if angle < 0 else 0)
    alpha, beta = _SIN[450 - a], _SIN[a]
    pts = []
    for i in range(arc_start, arc_end + delta, delta):
        ang = min(i, arc_end)
        if ang < 0:
            ang += 360
        x = axes[0] * _SIN[450 - ang]
        y = axes[1] * _SIN[ang]
        pts.append((center[0] + x * alpha - y * beta, center[1] + x * beta + y * alpha))
    if len(pts) == 1:
        pts = [tuple(map(float, center))] * 2
    return pts


def _ellipse_ex(img, center, axes, angle, arc_start, arc_end, color, thickness):
    """``EllipseEx`` with fixed-point centre and axes."""
    axes = (abs(axes[0]), abs(axes[1]))
    delta = (max(axes) + (XY_ONE >> 1)) >> XY_SHIFT
    delta = 90 if delta < 3 else 30 if delta < 10 else 18 if delta < 15 else 5
    v = []
    prev = None
    for fx, fy in ellipse2poly((float(center[0]), float(center[1])),
                               (float(axes[0]), float(axes[1])), angle, arc_start, arc_end,
                               delta):
        x = round(fx / XY_ONE) << XY_SHIFT
        y = round(fy / XY_ONE) << XY_SHIFT
        pt = (x + round(fx - x), y + round(fy - y))
        if pt != prev:
            v.append(pt)
            prev = pt
    if len(v) == 1:
        v = [tuple(center)] * 2
    if thickness >= 0:
        _poly_line(img, v, color, thickness)
    elif arc_end - arc_start >= 360:
        _fill_convex_poly(img, v, color, XY_SHIFT)
    else:
        v.append(tuple(center))
        segs, edges = [], []
        _collect_poly_edges(v, segs, edges, XY_SHIFT)
        _lines_aa(img, segs, color)
        _fill_edge_collection(img, edges, color)


# ---------------------------------------------------------------------------
# The cv2 entry points (LINE_AA, shift 0)
# ---------------------------------------------------------------------------


def _fixed(pt):
    return (int(pt[0]) << XY_SHIFT, int(pt[1]) << XY_SHIFT)


def line(img, pt1, pt2, color, thickness=1):
    """``cv2.line(img, pt1, pt2, color, thickness, cv2.LINE_AA)``."""
    _check(img)
    t = int(thickness)
    if not 0 < t <= 32767:
        raise ValueError("thickness must be in [1, 32767]")
    (x1, y1), (x2, y2) = (int(pt1[0]), int(pt1[1])), (int(pt2[0]), int(pt2[1]))
    if t > 1:
        # A thick line is first clipped, in whole pixels, to the image grown
        # by its thickness on every side.
        h, w = img.shape[:2]
        ok, x1, y1, x2, y2 = _clip_line(w + 2 * t, h + 2 * t, x1 + t, y1 + t, x2 + t, y2 + t)
        if not ok:
            return img
        x1, y1, x2, y2 = x1 - t, y1 - t, x2 - t, y2 - t
    _thick_line(img, _fixed((x1, y1)), _fixed((x2, y2)), _color(img, color), t, 3)
    return img


def circle(img, center, radius, color, thickness=1):
    """``cv2.circle(img, center, radius, color, thickness, cv2.LINE_AA)``;
    ``thickness < 0`` fills."""
    _check(img)
    if radius < 0:
        raise ValueError("radius must be >= 0")
    r = int(radius) << XY_SHIFT
    _ellipse_ex(img, _fixed(center), (r, r), 0, 0, 360, _color(img, color), int(thickness))
    return img


def ellipse(img, center, axes, angle, start_angle, end_angle, color, thickness=1):
    """``cv2.ellipse(img, center, axes, angle, start_angle, end_angle,
    color, thickness, cv2.LINE_AA)``; ``thickness < 0`` fills."""
    _check(img)
    if axes[0] < 0 or axes[1] < 0:
        raise ValueError("axes must be >= 0")
    _ellipse_ex(img, _fixed(center), _fixed(axes), round(angle), round(start_angle),
                round(end_angle), _color(img, color), int(thickness))
    return img


def fill_poly(img, polys, color):
    """``cv2.fillPoly(img, polys, color, cv2.LINE_AA)``: each polygon an
    integer array ``[N, 2]``; the polygons fill together, even-odd."""
    _check(img)
    c = _color(img, color)
    segs, edges = [], []
    for poly in polys:
        pts = [(int(x), int(y)) for x, y in np.asarray(poly).reshape(-1, 2)]
        if pts:
            _collect_poly_edges(pts, segs, edges, 0)
    _lines_aa(img, segs, c)
    _fill_edge_collection(img, edges, c)
    return img


def rectangle(img, pt1, pt2, color):
    """``cv2.rectangle(img, pt1, pt2, color, -1, cv2.LINE_AA)``: filled."""
    _check(img)
    (x1, y1), (x2, y2) = (int(pt1[0]), int(pt1[1])), (int(pt2[0]), int(pt2[1]))
    _fill_convex_poly(img, [(x1, y1), (x2, y1), (x2, y2), (x1, y2)], _color(img, color), 0)
    return img
