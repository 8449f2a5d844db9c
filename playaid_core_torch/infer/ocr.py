"""HUD damage OCR: the segmentation and reading shared by the digit readers,
the template reader and the default reader.

Counterpart of ``playaid_core_tpu/infer/ocr.py`` without cv2: the HUD
crop's value channel is resized to 256 wide with OpenCV's bilinear rule
(``imgproc.resize``, bit for bit), thresholded, closed with a 3x3 square
(the border neutral, as OpenCV's ``morphologyEx``), labelled into
8-connected components (``scipy.ndimage``), filtered by area, sorted left
to right and merged where x-extents overlap (fragments of one glyph).  The
learned reader is the conv digit classifier of :mod:`.ocr_conv`; the
template reader matches each component against digit glyphs rendered with
PIL (imported inside :func:`render_digit_templates`, so the module imports
on the card's machine, which has no PIL).
"""

from __future__ import annotations

import re

import numpy as np
from scipy import ndimage

from playaid_core_torch import imgproc
from playaid_core_torch.constants import TEXT_FONT_PATH

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


def render_digit_templates(height=40, font_path=TEXT_FONT_PATH):
    """Glyph templates of 0-9 rendered with PIL: ``{digit: float32 0/1
    array}``, each cut to its ink's bounding box.  PIL's default font
    stands in when ``font_path`` cannot be opened."""
    from PIL import Image, ImageDraw, ImageFont

    try:
        font = ImageFont.truetype(font_path, height)
    except OSError:
        font = ImageFont.load_default()
    templates = {}
    for d in "0123456789":
        img = Image.new("L", (height, int(height * 1.4)), 0)
        ImageDraw.Draw(img).text((2, 2), d, font=font, fill=255)
        arr = np.array(img)
        ys, xs = np.nonzero(arr > 32)
        if len(ys) == 0:
            continue
        tight = arr[ys.min():ys.max() + 1, xs.min():xs.max() + 1]
        templates[d] = (tight > 32).astype(np.float32)
    return templates


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


class TemplateDigitOCR:
    """Digit reader over the thresholded components: each component's mask
    is resized to each template's size (``INTER_AREA``) and read as the
    template of the highest normalised correlation."""

    def __init__(self, templates=None, threshold=128, min_area=12):
        self.templates = templates or render_digit_templates()
        self.threshold = threshold
        self.min_area = min_area

    def _classify_component(self, comp):
        best_digit, best_score = None, -1.0
        for digit, tmpl in self.templates.items():
            resized = imgproc.resize(comp.astype(np.float32), (tmpl.shape[1], tmpl.shape[0]),
                                     "area")
            denom = np.linalg.norm(resized) * np.linalg.norm(tmpl)
            score = float((resized * tmpl).sum() / denom) if denom else 0.0
            if score > best_score:
                best_digit, best_score = digit, score
        return best_digit, best_score

    def __call__(self, bgr_crop):
        """``(ok, (value, raw_string, confidence, details))``, the shape of the
        reference's damage_crop_to_percent (ai_runner.py:109-133)."""
        comps, _ = segment_digit_components(bgr_crop, self.threshold, self.min_area)
        if not comps:
            return False, (-1, "", 0.0, {"components": 0})
        digits, scores = zip(*(self._classify_component(c["mask"]) for c in comps))
        return assemble_reading(comps, list(digits), list(scores))


def damage_crop_to_percent(damage_crop, reader):
    """Reference-shaped wrapper (reference: ai_runner.py:109-133)."""
    return reader(damage_crop)


def default_reader(device=None):
    """The default damage reader: the conv digit classifier on ``device``
    (``None``: the CUDA device) with the committed weights, or the template
    reader when the weights file is missing.  Nothing else falls back: no
    CUDA device, or a broken weights file, raises (the JAX package falls
    back to the template reader on any error)."""
    from playaid_core_torch.infer.ocr_conv import ConvDigitOCR

    try:
        return ConvDigitOCR(device=device)
    except FileNotFoundError:
        return TemplateDigitOCR()
