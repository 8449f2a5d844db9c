"""The one image-codec seam of the port.

The port keeps the images it makes without loss (``.npy``: crops, sprites
and stage textures, each holding what ``cv2.imread`` gives for the image
file it stands for); image files pass through here.  PNG has a codec of
its own in numpy and ``zlib`` (:func:`decode_png`, :func:`encode_png`), so
PNG sprite trees and raw animation dumps read and write on a machine
without cv2; any other image file (an external YOLOv5's jpg crops) needs
cv2, and where cv2 is not installed (the card's machine) this raises an
``ImportError`` that says so.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# cv2.imread's flags that the PNG reader takes.
IMREAD_UNCHANGED = -1
IMREAD_COLOR = 1

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Colour type -> samples a pixel: grey, RGB, palette, grey + alpha, RGBA.
PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
PNG_COMPRESSION = 6  # zlib's level; cv2.imwrite's default is 1


def _cv2(path):
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"reading or writing the image file {path} needs cv2, which is not "
                          "installed; the port's own images are .npy or .png files") from e
    return cv2


def _chunks(data, where):
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{where} is not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{where}: the PNG ends inside its {kind!r} chunk")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{where}: bad CRC in the PNG's {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{where}: the PNG has no IEND chunk")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw, height, width, bpp):
    """The scanlines' bytes ``[H, 1 + W * bpp]`` -> the image's samples
    ``[H, W, bpp]`` (uint8), undoing each row's filter (PNG spec 9.2)."""
    filters = raw[:, 0]
    data = raw[:, 1:].reshape(height, width, bpp)
    if filters.max(initial=0) > 4:
        raise ValueError(f"PNG row filter {int(filters.max())} is not one of 0-4")
    if not np.isin(filters, (3, 4)).any():
        # None, Sub and Up: sums mod 256 along a row or down the rows.
        out = np.empty((height, width, bpp), np.uint8)
        prior = np.zeros((width, bpp), np.uint8)
        for r in range(height):
            row = data[r]
            if filters[r] == 1:
                row = np.cumsum(row, axis=0, dtype=np.uint8)
            elif filters[r] == 2:
                row = row + prior
            out[r] = prior = row
        return out
    # Average and Paeth read the left, upper and upper-left samples: each
    # anti-diagonal of pixels depends only on the ones before it.
    recon = np.zeros((height + 1, width + 1, bpp), np.int32)  # a zero row and column
    f = filters.astype(np.int32)
    for k in range(height + width - 1):
        r = np.arange(max(0, k - width + 1), min(height, k + 1))
        x = k - r
        a, b, c = recon[r + 1, x], recon[r, x + 1], recon[r, x]
        kind = f[r][:, None]
        pred = np.select([kind == 1, kind == 2, kind == 3, kind == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        recon[r + 1, x + 1] = (data[r, x].astype(np.int32) + pred) & 0xFF
    return recon[1:, 1:].astype(np.uint8)


def decode_png(data, flags=IMREAD_COLOR, where="<bytes>"):
    """A PNG file's bytes -> what ``cv2.imread`` gives for it with
    ``flags``: ``IMREAD_COLOR`` BGR (alpha stripped, palette and grey
    expanded), ``IMREAD_UNCHANGED`` BGR, BGRA or grey ``[H, W]`` (grey
    with alpha as BGRA, grey with a transparent value as grey; a palette
    or RGB with transparency as BGRA).  8-bit non-interlaced images of colour types
    0, 2, 3, 4 and 6; anything else raises a ``ValueError`` that names it."""
    if flags not in (IMREAD_COLOR, IMREAD_UNCHANGED):
        raise ValueError(f"decode_png takes IMREAD_COLOR or IMREAD_UNCHANGED, not {flags}")
    header, palette, trns, idat = None, None, None, []
    for kind, body in _chunks(data, where):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{where}: the PNG has no IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if colour not in PNG_CHANNELS:
        raise ValueError(f"{where}: PNG colour type {colour} is not supported")
    if depth != 8:
        raise ValueError(f"{where}: {depth}-bit PNG is not supported (8-bit only)")
    if interlace:
        raise ValueError(f"{where}: interlaced (Adam7) PNG is not supported")
    bpp = PNG_CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (1 + width * bpp):
        raise ValueError(f"{where}: the PNG's image data holds {raw.size} bytes, not "
                         f"{height * (1 + width * bpp)}")
    px = _unfilter(raw.reshape(height, 1 + width * bpp), height, width, bpp)

    alpha = None
    if colour == 3:
        if palette is None:
            raise ValueError(f"{where}: palette PNG without a PLTE chunk")
        index = px[..., 0]
        if trns is not None:
            table = np.full(len(palette), 255, np.uint8)
            table[:len(trns)] = np.frombuffer(trns, np.uint8)[:len(palette)]
            alpha = table[index]
        rgb = palette[index]
    elif colour in (0, 4):
        grey = px[..., 0]
        if colour == 4:  # cv2 keeps no transparent grey of a tRNS chunk
            alpha = px[..., 1]
        if flags == IMREAD_UNCHANGED and alpha is None:
            return grey.copy()
        rgb = np.repeat(grey[..., None], 3, axis=2)
    else:
        rgb = px[..., :3]
        if colour == 6:
            alpha = px[..., 3]
        elif trns is not None:
            key = np.array(struct.unpack(">HHH", trns[:6]))
            alpha = np.where((rgb == key).all(axis=2), 0, 255).astype(np.uint8)
    bgr = rgb[..., ::-1]
    if flags == IMREAD_UNCHANGED and alpha is not None:
        return np.ascontiguousarray(np.concatenate([bgr, alpha[..., None]], axis=2))
    return np.ascontiguousarray(bgr)


def encode_png(img):
    """A uint8 image as ``cv2.imwrite`` takes one (grey ``[H, W]``, BGR or
    BGRA) -> the bytes of an 8-bit PNG of it (every row filtered Up), which
    :func:`decode_png` and ``cv2.imread(IMREAD_UNCHANGED)`` read back
    equal."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8 images, not {img.dtype}")
    if img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 1):
        colour, px = 0, img.reshape(img.shape[0], img.shape[1], 1)
    elif img.ndim == 3 and img.shape[2] in (3, 4):
        colour = 2 if img.shape[2] == 3 else 6
        px = np.concatenate([img[..., 2::-1], img[..., 3:]], axis=2)
    else:
        raise ValueError(f"encode_png takes grey, BGR or BGRA images, not {img.shape}")
    height, width = px.shape[:2]
    rows = px.reshape(height, -1)
    up = rows.copy()
    up[1:] -= rows[:-1]
    raw = np.concatenate([np.full((height, 1), 2, np.uint8), up], axis=1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", width, height, 8, colour, 0, 0, 0)
    return (PNG_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), PNG_COMPRESSION))
            + chunk(b"IEND", b""))


def write_image(path, img):
    """Write ``img`` as ``path``'s suffix says: ``.npy`` with ``np.save``,
    ``.png`` through :func:`encode_png`, any other image file through
    ``cv2.imwrite`` (which needs cv2)."""
    if path.endswith(".npy"):
        np.save(path, img)
    elif path.lower().endswith(".png"):
        with open(path, "wb") as f:
            f.write(encode_png(img))
    elif not _cv2(path).imwrite(path, img):
        raise IOError(f"cv2.imwrite could not write {path}")


def read_image(path, flags=IMREAD_COLOR):
    """``cv2.imread(path, flags)``: a PNG through :func:`decode_png`, any
    other image file through cv2 (None when cv2 cannot decode it, as
    cv2.imread)."""
    if path.lower().endswith(".png"):
        with open(path, "rb") as f:
            return decode_png(f.read(), flags, path)
    return _cv2(path).imread(path, flags)


def read_crop(path):
    """A crop or stage texture as a BGR uint8 array: ``.npy`` directly, an
    image file as ``cv2.imread`` gives it (:func:`read_image`)."""
    if path.endswith(".npy"):
        return np.load(path)
    return read_image(path)


def read_sprite(path):
    """A sprite as BGRA uint8: ``.npy`` directly, an image file as
    ``cv2.imread(path, IMREAD_UNCHANGED)`` gives it (:func:`read_image`), a
    3-channel image made opaque as ``cv2.COLOR_BGR2BGRA`` makes it.  None
    when cv2 cannot decode the file."""
    img = np.load(path) if path.endswith(".npy") else read_image(path, IMREAD_UNCHANGED)
    if img is not None and img.shape[2] == 3:
        img = np.concatenate([img, np.full(img.shape[:2] + (1,), 255, np.uint8)], 2)
    return img
