"""The image operations of OpenCV and PIL that the pixels-only path uses,
written with numpy and torch so that the card's machine, which has
neither library, computes the same pixels.

* :func:`resize` is ``cv2.resize`` with ``INTER_LINEAR`` or
  ``INTER_AREA`` on uint8 (1, 3 or 4 channels) and float32 images, bit for
  bit: OpenCV's 11-bit fixed-point bilinear weights and the rounding of its
  vectorised vertical pass (``((r0 >> 4) * b0 >> 16) + ((r1 >> 4) * b1 >>
  16) + 2 >> 2``), its area tables for shrinking, its block averages for
  integer shrink factors (``+ 2 >> 2`` for 2x2), and the area variant of
  bilinear for enlarging.  Columns outside the source are clamped with a
  zero weight, rows by repeating the edge row.
* :func:`resize_linear_u8` is the same ``INTER_LINEAR`` on a torch uint8
  tensor ``[..., H, W, C]`` on any device: the detector resizes its frames
  on the card with it.
* :func:`pad` is ``PIL.ImageOps.pad(image, size, color="black")``: PIL's
  antialiased bicubic resize (a = -0.5, 22-bit fixed point, horizontal
  pass first, uint8 in between) to fit the size, pasted centred at
  ``round((size - w) / 2)`` (Python's rounding, half to even).  A
  4-channel image is RGBA to PIL, which resizes it premultiplied by its
  alpha (:func:`resize_bicubic`).
* :func:`resize_nearest` is ``cv2.resize`` with ``INTER_NEAREST``.
* :func:`blur` is ``cv2.blur``: the normalised box filter with
  ``BORDER_REFLECT_101``, rounded as OpenCV rounds 8-bit sums.
* :func:`rgb_to_hsv` and :func:`hsv_to_rgb` are ``cv2.cvtColor`` with
  ``COLOR_RGB2HSV``/``COLOR_HSV2RGB`` (or the BGR orders) on uint8: H in
  [0, 180), OpenCV's fixed-point division tables one way and its float32
  sectors (with its fused multiply-adds, truncated in its vector loop and
  rounded in its scalar tail) the other.
* :func:`crop` is ``Image.crop``: a window that may hang off the image,
  filled with zeros there.
* :func:`paste` is ``Image.paste(im, box, mask)`` of an RGBA image by its
  own alpha: Pillow's ``BLEND`` with ``DIV255`` rounding, clipped at the
  edges.

The CPU tests hold each against OpenCV and PIL on random images (the
colour conversions and the blend on every input value).
"""

from __future__ import annotations

import functools
import math

import numpy as np

_COEF_BITS = 11  # OpenCV's INTER_RESIZE_COEF_BITS
_PIL_BITS = 22   # PIL's PRECISION_BITS for 8-bit images


def _linear_taps(src, dst, area_mode=False, clamp=True):
    """OpenCV's bilinear source indices and float32 weights along one axis.

    ``area_mode``: the ``INTER_AREA`` variant used when enlarging.
    ``clamp``: the horizontal rule (taps past an edge take the edge pixel
    with weight 0); rows are not clamped, their index is.
    """
    inv = dst / src
    scale = 1.0 / inv
    d = np.arange(dst)
    if area_mode:
        s = np.floor(d * scale).astype(np.int64)
        f = ((d + 1) - (s + 1) * inv).astype(np.float32)
        f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(np.float32)
    else:
        pos = ((d + 0.5) * scale - 0.5).astype(np.float32)
        s = np.floor(pos).astype(np.int64)
        f = (pos - s.astype(np.float32)).astype(np.float32)
    if clamp:
        f[(s < 0) | (s >= src - 1)] = 0
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), np.float32(1) - f, f


def _fixed(w):
    return np.rint(w * np.float32(1 << _COEF_BITS)).astype(np.int64)


def linear_u8_tables(src_hw, size, area_mode=False, device="cpu"):
    """The taps and fixed-point weights of :func:`resize_linear_u8` from
    ``src_hw = (height, width)`` to ``size = (height, width)``, as tensors
    on ``device``: column indices (int64) and weights (int32) ``[w, 1]``,
    row indices ``[h]`` and weights ``[h, 1, 1]``.  24 bytes per output
    row and column; a caller that resizes many frames of one size builds
    them once."""
    import torch

    (sh, sw), (h, w) = src_hw, size
    x0, x1, a0, a1 = _linear_taps(sw, w, area_mode, clamp=True)
    y0, y1, b0, b1 = _linear_taps(sh, h, area_mode, clamp=False)
    t = lambda v: torch.from_numpy(v).to(device)  # noqa: E731
    return (t(x0), t(x1), t(_fixed(a0).astype(np.int32))[:, None],
            t(_fixed(a1).astype(np.int32))[:, None], t(y0), t(y1),
            t(_fixed(b0).astype(np.int32))[:, None, None],
            t(_fixed(b1).astype(np.int32))[:, None, None])


def resize_linear_u8(x: "torch.Tensor", size, area_mode=False, tables=None) -> "torch.Tensor":
    """``cv2.resize`` bilinear (or the area variant when enlarging) of uint8
    images ``[..., H, W, C]`` to ``size = (height, width)``, on x's device.
    ``tables``: :func:`linear_u8_tables` for x's size on x's device (built
    here when not given)."""
    import torch

    if tables is None:
        tables = linear_u8_tables(x.shape[-3:-1], size, area_mode, x.device)
    x0, x1, a0, a1, y0, y1, b0, b1 = tables
    s = x.to(torch.int32)
    hor = s.index_select(-2, x0) * a0 + s.index_select(-2, x1) * a1  # [..., sh, w, C]
    r0 = hor.index_select(-3, y0) >> 4
    r1 = hor.index_select(-3, y1) >> 4
    out = (((r0 * b0) >> 16) + ((r1 * b1) >> 16) + 2) >> 2
    return out.clamp_(0, 255).to(torch.uint8)


def _linear_f32(img, h, w, area_mode):
    sh, sw = img.shape[:2]
    x0, x1, a0, a1 = _linear_taps(sw, w, area_mode, clamp=True)
    y0, y1, b0, b1 = _linear_taps(sh, h, area_mode, clamp=False)
    s = img.reshape(sh, sw, -1)
    hor = s[:, x0] * a0[:, None] + s[:, x1] * a1[:, None]
    out = hor[y0] * b0[:, None, None] + hor[y1] * b1[:, None, None]
    return out.astype(np.float32).reshape((h, w) + img.shape[2:])


@functools.lru_cache(maxsize=256)
def _area_table(ssize, dsize):
    """OpenCV's computeResizeAreaTab: (destination, source, float32 weight)
    entries in order, and each entry's slot (its place among its
    destination's entries).  Cached: crops repeat their sizes; the arrays
    are not written to."""
    scale = 1.0 / (dsize / ssize)
    di, si, alpha = [], [], []
    for dx in range(dsize):
        fs1 = dx * scale
        fs2 = fs1 + scale
        cell = min(scale, ssize - fs1)
        s1, s2 = int(np.ceil(fs1)), int(np.floor(fs2))
        s2 = min(s2, ssize - 1)
        s1 = min(s1, s2)
        if s1 - fs1 > 1e-3:
            di.append(dx), si.append(s1 - 1), alpha.append((s1 - fs1) / cell)
        for sx in range(s1, s2):
            di.append(dx), si.append(sx), alpha.append(1.0 / cell)
        if fs2 - s2 > 1e-3:
            di.append(dx), si.append(s2), alpha.append(min(min(fs2 - s2, 1.0), cell) / cell)
    di = np.array(di)
    slot = np.zeros(len(di), np.int64)
    for k in range(1, len(di)):
        slot[k] = slot[k - 1] + 1 if di[k] == di[k - 1] else 0
    return di, np.array(si), np.array(alpha, np.float32), slot


def _area_accumulate(src, dsize):
    """Weighted sums along axis 0 in the table's order, in float32."""
    di, si, alpha, slot = _area_table(src.shape[0], dsize)
    out = np.zeros((dsize,) + src.shape[1:], np.float32)
    for j in range(int(slot.max()) + 1):
        m = slot == j
        out[di[m]] += src[si[m]] * alpha[m].reshape((-1,) + (1,) * (src.ndim - 1))
    return out


def _area_shrink(img, h, w):
    sh, sw = img.shape[:2]
    kx, ky = sw / w, sh / h
    if kx.is_integer() and ky.is_integer():
        kx, ky = int(kx), int(ky)
        cells = img.reshape((h, ky, w, kx) + img.shape[2:])
        if img.dtype == np.uint8:
            total = cells.astype(np.int64).sum(axis=(1, 3))
            if kx == ky == 2:
                return ((total + 2) >> 2).astype(np.uint8)
            return np.rint(total.astype(np.float32) * np.float32(1.0 / (kx * ky))).astype(np.uint8)
        terms = [cells[:, a, :, b] for a in range(ky) for b in range(kx)]
        total = np.zeros_like(terms[0])
        k = 0
        while k + 4 <= len(terms):  # OpenCV adds the cell four at a time
            total = total + (((terms[k] + terms[k + 1]) + terms[k + 2]) + terms[k + 3])
            k += 4
        for term in terms[k:]:
            total = total + term
        if kx == ky == 2:  # its vector loop, four columns at a time, adds rows first
            simd = (w // 4) * 4
            total[:, :simd] = (terms[0] + terms[1])[:, :simd] + (terms[2] + terms[3])[:, :simd]
        return total * np.float32(1.0 / (kx * ky))
    src = img.astype(np.float32)
    out = _area_accumulate(_area_accumulate(np.moveaxis(src, 1, 0), w).swapaxes(0, 1), h)
    return np.rint(out).astype(np.uint8) if img.dtype == np.uint8 else out


def resize(img, dsize, interpolation="linear"):
    """``cv2.resize(img, dsize, interpolation=INTER_LINEAR | INTER_AREA)``.

    img: uint8 ``[H, W]`` or ``[H, W, C]``, or float32 ``[H, W]``;
    ``dsize = (width, height)`` as in OpenCV.  Returns the same dtype.
    """
    img = np.asarray(img)
    w, h = dsize
    sh, sw = img.shape[:2]
    if (h, w) == (sh, sw):
        return img.copy()
    if interpolation not in ("linear", "area"):
        raise ValueError(f"interpolation must be 'linear' or 'area', got {interpolation!r}")
    if img.dtype not in (np.uint8, np.float32):
        raise TypeError(f"resize takes uint8 or float32 images, got {img.dtype}")
    sx, sy = 1.0 / (w / sw), 1.0 / (h / sh)
    if interpolation == "linear" and sx == sy == 2.0:
        interpolation = "area"  # OpenCV's own switch for an exact halving
    if interpolation == "area" and sx >= 1 and sy >= 1:
        return _area_shrink(img, h, w)
    area_mode = interpolation == "area"
    if img.dtype == np.float32:
        return _linear_f32(img, h, w, area_mode)
    import torch

    x = torch.from_numpy(np.ascontiguousarray(img).reshape(sh, sw, -1))
    return resize_linear_u8(x, (h, w), area_mode).numpy().reshape((h, w) + img.shape[2:])


def _bicubic(x):
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _pil_pass(img, out_size, axis):
    """One pass of PIL's bicubic resample of a uint8 array along ``axis``."""
    a = np.moveaxis(img, axis, 0)
    in_size = a.shape[0]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    lo = np.maximum((center - support + 0.5).astype(np.int64), 0)
    count = np.minimum((center + support + 0.5).astype(np.int64), in_size) - lo
    k = np.arange(ksize)
    wt = _bicubic((k[None, :] + lo[:, None] - center[:, None] + 0.5) / filterscale)
    wt = np.where(k[None, :] < count[:, None], wt, 0.0)
    total = wt.sum(axis=1, keepdims=True)
    wt = np.where(total != 0, wt / np.where(total != 0, total, 1.0), wt)
    fixed = np.where(wt < 0, -0.5 + wt * (1 << _PIL_BITS), 0.5 + wt * (1 << _PIL_BITS))
    fixed = fixed.astype(np.int64)  # C's (int): toward zero
    # The taps as one [out, in] matrix, multiplied in float64: every product
    # and partial sum is an integer below 2**53, so the sums are exact.
    dense = np.zeros((out_size, in_size))
    np.add.at(dense, (np.arange(out_size)[:, None], np.minimum(lo[:, None] + k, in_size - 1)),
              fixed)
    acc = (dense @ a.reshape(in_size, -1).astype(np.float64)).astype(np.int64)
    acc = (acc + (1 << (_PIL_BITS - 1))).reshape((out_size,) + a.shape[1:])
    return np.moveaxis(np.clip(acc >> _PIL_BITS, 0, 255).astype(np.uint8), 0, axis)


def _muldiv255(a, b):
    t = a * b + 128
    return ((t >> 8) + t) >> 8


def resize_bicubic(img, dsize):
    """``Image.fromarray(img).resize(dsize, BICUBIC)`` for uint8 images.  A
    4-channel image is RGBA: PIL resizes it premultiplied (``RGBa``) and
    divides the colour by the new alpha after."""
    w, h = dsize
    if (h, w) == img.shape[:2]:
        return img.copy()
    rgba = img.ndim == 3 and img.shape[2] == 4
    out = img
    if rgba:
        src = img.astype(np.int64)
        out = np.concatenate([_muldiv255(src[..., :3], src[..., 3:]), src[..., 3:]], 2)
        out = out.astype(np.uint8)
    if w != img.shape[1]:
        out = _pil_pass(out, w, 1)
    if h != img.shape[0]:
        out = _pil_pass(out, h, 0)
    if rgba:
        a = out[..., 3:].astype(np.int64)
        c = out[..., :3].astype(np.int64)
        div = np.minimum(255 * c // np.maximum(a, 1), 255)
        c = np.where((a == 0) | (a == 255), c, div)
        out = np.concatenate([c, a], 2).astype(np.uint8)
    return out


def pad(img, size):
    """``ImageOps.pad(Image.fromarray(img), size, color="black")`` as an
    array: fit inside ``size = (width, height)`` keeping the aspect ratio,
    then centre on black.  ValueError for an empty image or an empty fit,
    as PIL."""
    h, w = img.shape[:2]
    if h == 0 or w == 0:
        raise ValueError("cannot pad an empty image")
    tw, th = size
    fit = (tw, th)
    if w / h != tw / th:
        if w / h > tw / th:
            nh = round(h / w * tw)
            fit = (tw, nh) if nh != th else fit
        else:
            nw = round(w / h * th)
            fit = (nw, th) if nw != tw else fit
    if min(fit) <= 0:
        raise ValueError("height and width must be > 0")
    resized = resize_bicubic(img, fit) if fit != (w, h) else img.copy()
    if fit == (tw, th):
        return resized
    out = np.zeros((th, tw) + img.shape[2:], img.dtype)
    if fit[0] != tw:
        x = round((tw - fit[0]) * 0.5)
        out[:, x:x + fit[0]] = resized
    else:
        y = round((th - fit[1]) * 0.5)
        out[y:y + fit[1]] = resized
    return out


def resize_nearest(img, dsize):
    """``cv2.resize(img, dsize, interpolation=cv2.INTER_NEAREST)``: source
    index ``floor(x / (dw / sw))``, clamped to the last pixel."""
    w, h = dsize
    sh, sw = img.shape[:2]
    xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / sw))).astype(np.int64), sw - 1)
    ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / sh))).astype(np.int64), sh - 1)
    return np.ascontiguousarray(img[ys[:, None], xs[None, :]])


def _reflect101(n, lo, hi):
    """Indices ``lo..hi-1`` of an axis of length ``n``, reflected at the
    edges without repeating them (``BORDER_REFLECT_101``)."""
    i = np.arange(lo, hi)
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    i = np.mod(i, period)
    return np.where(i < n, i, period - i)


def blur(img, ksize):
    """``cv2.blur(img, ksize)`` for uint8 images: the mean over a
    ``ksize = (kw, kh)`` window anchored at its centre (``k // 2``), the
    border reflected (101), the integer sum scaled in 16-bit fixed point
    as OpenCV does for small 8-bit windows."""
    kw, kh = ksize
    h, w = img.shape[:2]
    src = img.astype(np.int64)
    cols = _reflect101(w, -(kw // 2), w + kw - 1 - kw // 2)
    rows = _reflect101(h, -(kh // 2), h + kh - 1 - kh // 2)
    padded = src[rows][:, cols]
    acc = np.zeros((h + kh - 1, w) + img.shape[2:], np.int64)
    for k in range(kw):
        acc += padded[:, k:k + w]
    total = np.zeros((h, w) + img.shape[2:], np.int64)
    for k in range(kh):
        total += acc[k:k + h]
    d = kw * kh
    if d == 1:
        return img.copy()
    scale = float(1 << 16) / d
    div_scale = math.floor(scale)
    div_delta = d // 2
    if scale - div_scale < 0.5:
        div_delta += 1
    else:
        div_scale += 1
    return ((total + div_delta) * div_scale >> 16).astype(np.uint8)


_HSV_SHIFT = 12


@functools.lru_cache(maxsize=1)
def _hsv_tables():
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.concatenate([[0], np.rint((255 << _HSV_SHIFT) / i)]).astype(np.int64)
    hdiv = np.concatenate([[0], np.rint((180 << _HSV_SHIFT) / (6.0 * i))]).astype(np.int64)
    return sdiv, hdiv


def rgb_to_hsv(img, bgr=False):
    """``cv2.cvtColor(img, COLOR_RGB2HSV)`` (``COLOR_BGR2HSV`` when
    ``bgr``) for uint8 ``[..., 3]``: H in [0, 180), S and V in [0, 255]."""
    sdiv, hdiv = _hsv_tables()
    src = img.astype(np.int64)
    r, g, b = (src[..., 2], src[..., 1], src[..., 0]) if bgr else (
        src[..., 0], src[..., 1], src[..., 2])
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * sdiv[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def hsv_to_rgb(img, bgr=False):
    """``cv2.cvtColor(img, COLOR_HSV2RGB)`` (``COLOR_HSV2BGR`` when
    ``bgr``) for uint8 ``[H, W, 3]`` with H in [0, 180): float32 sectors of
    V / 255 and S / 255, with OpenCV's fused multiply-adds, times 255.
    The rounding is that of the AVX2 code (with FMA3) of OpenCV 5.0.0's
    x86-64 ``opencv-python`` build, which dispatches it on any CPU with
    AVX2 (AVX512-SKX gives the same pixels): each row 32 pixels at a time
    with vector code, which truncates, and the last ``W % 32`` pixels of a
    row one by one, which round half to even (``saturate_cast``).  The
    32-pixel block is that code's, not OpenCV's contract: the same build
    with its dispatch cut below AVX2 (``OPENCV_CPU_DISABLE=AVX512-SKX,
    AVX2``) rounds other pixels, rows of one pixel included, and so may a
    build for another vector width."""
    f32, f64 = np.float32, np.float64
    src = img.astype(f32)
    h = src[..., 0] * f32(6.0 / 180)
    s = src[..., 1] * f32(1.0 / 255)
    v = src[..., 2] * f32(1.0 / 255)
    h = np.fmod(h, f32(6.0))
    sector = np.floor(h).astype(np.int64)
    h = (h - sector.astype(f32)).astype(f32)
    bad = (sector < 0) | (sector >= 6)
    sector = np.where(bad, 0, sector)
    h = np.where(bad, f32(0), h)
    one = f32(1.0)
    # 1 - s * x as one multiply-add, rounded once: the product of two
    # float32 values is exact in float64.
    fused = lambda x: (1.0 - s.astype(f64) * x.astype(f64)).astype(f32)  # noqa: E731
    tab = np.stack([v, v * (one - s), v * fused(h), v * fused(one - h)], -1)
    bgr_f = np.take_along_axis(tab, _SECTORS[sector], -1)
    bgr_f = np.where((s == 0)[..., None], v[..., None], bgr_f).astype(f32) * f32(255.0)
    width = img.shape[-2]
    vector = (np.arange(width) < width // 32 * 32)[:, None]
    out = np.clip(np.where(vector, np.trunc(bgr_f), np.rint(bgr_f)), 0, 255).astype(np.uint8)
    return out if bgr else out[..., ::-1].copy()


def crop(img, box):
    """``Image.crop(box)`` of an array: ``box = (x0, y0, x1, y1)``; the part
    of the window off the image is zeros."""
    x0, y0, x1, y1 = (int(v) for v in box)
    out = np.zeros((max(y1 - y0, 0), max(x1 - x0, 0)) + img.shape[2:], img.dtype)
    h, w = img.shape[:2]
    sy0, sy1, sx0, sx1 = max(y0, 0), min(y1, h), max(x0, 0), min(x1, w)
    if sy1 > sy0 and sx1 > sx0:
        out[sy0 - y0:sy1 - y0, sx0 - x0:sx1 - x0] = img[sy0:sy1, sx0:sx1]
    return out


def paste(dst, src, box):
    """``Image.paste(src, box, src)`` in place: an RGBA ``src`` blended into
    a 3- or 4-channel ``dst`` at ``box = (x, y)`` by its alpha,
    ``(d * (255 - a) + s * a + 128)`` divided by 255 as Pillow's ``DIV255``;
    every channel of ``dst`` takes the blend (its 4th channel with the
    source's 4th)."""
    x, y = int(box[0]), int(box[1])
    sh, sw = src.shape[:2]
    h, w = dst.shape[:2]
    sx0, sy0 = max(-x, 0), max(-y, 0)
    dx0, dy0 = max(x, 0), max(y, 0)
    cw, ch = min(sw - sx0, w - dx0), min(sh - sy0, h - dy0)
    if cw <= 0 or ch <= 0:
        return dst
    region = dst[dy0:dy0 + ch, dx0:dx0 + cw]
    patch = src[sy0:sy0 + ch, sx0:sx0 + cw].astype(np.int64)
    a = patch[..., 3:]
    t = region.astype(np.int64) * (255 - a) + patch[..., :region.shape[2]] * a + 128
    region[...] = ((t >> 8) + t) >> 8
    return dst
