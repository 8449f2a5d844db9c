"""HUD damage OCR: the segmentation and reading shared by the digit readers.

Counterpart of ``playaid_core_tpu/infer/ocr.py`` without cv2: the HUD
crop's value channel is resized to 256 wide with OpenCV's bilinear rule
(``imgproc.resize``, bit for bit), thresholded, closed with a 3x3 square
(the border neutral, as OpenCV's ``morphologyEx``), labelled into
8-connected components (``scipy.ndimage``), filtered by area, sorted left
to right and merged where x-extents overlap (fragments of one glyph).
The reader is the conv digit classifier of :mod:`.ocr_conv`; the template
reader, which renders its templates with PIL, is not ported (ROADMAP.md).
"""

from __future__ import annotations

import re

import numpy as np
from scipy import ndimage

from playaid_core_torch import imgproc

# Fixed HUD damage locations for a 1280x720 canvas
# (reference: ai_runner.py:553-569).
PLAYER_DAMAGE_CROPS = {
    0: dict(center_x=402 / 1280, center_y=637 / 720, crop_width=133 / 1280,
            crop_height=60 / 720),
    1: dict(center_x=898 / 1280, center_y=637 / 720, crop_width=133 / 1280,
            crop_height=60 / 720),
}

_SQUARE = np.ones((3, 3), bool)


def extract_numbers(text: str) -> str:
    return "".join(re.findall(r"\d+", text))


def segment_digit_components(bgr_crop, threshold=128, min_area=12):
    """Threshold + connected components of a HUD crop, left to right.

    Returns (components, gray): each component is a dict with ``x, y, w,
    h``, ``mask`` (float 0/1) and ``patch`` (grayscale, background zeroed).
    """
    # The value channel (per-pixel max), not luma: the counter's fill turns
    # from white to saturated red as damage grows, and red's luma falls
    # below a mid-grey threshold while its max channel stays near 255.
    gray = bgr_crop.max(axis=2).astype(np.uint8)
    gray = imgproc.resize(gray, (256, int(256 * gray.shape[0] / max(gray.shape[1], 1))))
    binary = gray > threshold
    # A close re-bridges 1-2 px stroke gaps that codecs cut into thin
    # glyphs, so one glyph stays one component.
    binary = ndimage.binary_erosion(ndimage.binary_dilation(binary, _SQUARE, border_value=0),
                                    _SQUARE, border_value=1)
    labels, num = ndimage.label(binary, structure=_SQUARE)
    areas = np.bincount(labels.ravel(), minlength=num + 1)
    raw = []
    for i, (ys, xs) in enumerate(ndimage.find_objects(labels), start=1):
        if areas[i] < min_area:
            continue
        raw.append({"x": xs.start, "y": ys.start, "w": xs.stop - xs.start,
                    "h": ys.stop - ys.start, "id": i})
    raw.sort(key=lambda c: c["x"])
    # Merge fragments whose x-extents overlap a neighbour's: digits are laid
    # out left to right without horizontal overlap.
    merged = []
    for c in raw:
        if merged:
            m = merged[-1]
            overlap = min(m["x"] + m["w"], c["x"] + c["w"]) - max(m["x"], c["x"])
            if overlap >= 2 or overlap > 0.3 * min(m["w"], c["w"]):
                x0 = min(m["x"], c["x"])
                y0 = min(m["y"], c["y"])
                x1 = max(m["x"] + m["w"], c["x"] + c["w"])
                y1 = max(m["y"] + m["h"], c["y"] + c["h"])
                m.update(x=x0, y=y0, w=x1 - x0, h=y1 - y0)
                m["ids"] = m.get("ids", [m["id"]]) + [c["id"]]
                continue
        merged.append(c)
    comps = []
    for c in merged:
        x, y, w, h = c["x"], c["y"], c["w"], c["h"]
        mask = np.isin(labels[y:y + h, x:x + w], c.get("ids", [c["id"]])).astype(np.float32)
        patch = gray[y:y + h, x:x + w].astype(np.float32) * mask
        comps.append({"x": x, "y": y, "w": w, "h": h, "mask": mask, "patch": patch})
    return comps, gray


def assemble_reading(comps, digits, scores):
    """Decimal-point inference and value parse: the decimal digits render
    smaller, so a sharp height drop marks the fractional part."""
    heights = [c["h"] for c in comps]
    main_height = max(heights)
    out = []
    decimal_inserted = False
    for c, digit in zip(comps, digits):
        if not decimal_inserted and c["h"] < 0.72 * main_height and out:
            out.append(".")
            decimal_inserted = True
        out.append(digit or "?")
    raw = "".join(out)
    confidence = float(np.mean(scores)) if scores else 0.0
    try:
        value = float(raw)
    except ValueError:
        cleaned = extract_numbers(raw)
        if not cleaned:
            return False, (-1, raw, confidence, {"components": len(comps)})
        value = float(cleaned)
    return True, (value, raw, confidence, {"components": len(comps)})
