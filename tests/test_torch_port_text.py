"""The port's text module against Pillow: ``textbbox``, ``text``,
``text_image`` and ``rotate`` on the strings the charts draw for the
scripted match and on seeded strings, the rectangles and lines of the
history strips, and the atlas as tools/torch_port_text_atlas.py checks it.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image, ImageDraw, ImageFont

from playaid_core_torch import text

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import torch_port_text_atlas as atlas_tool  # noqa: E402

CHART_STRINGS = atlas_tool.CHART_STRINGS
DEJAVU = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"
ASCII = [chr(c) for c in range(32, 127)]
FONTS = [("DejaVuSans", 10), ("DejaVuSans", 11), ("DejaVuSans", 12), ("DejaVuSans", 15),
         ("default", 10)]


def _fonts(name, size):
    if name == "default":
        return text.load_default(), ImageFont.load_default()
    return text.truetype(DEJAVU, size), ImageFont.truetype(DEJAVU, size)


def _strings(seed, alphabet=ASCII, n=60):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(alphabet, int(rng.integers(1, 40)))) for _ in range(n)]


@pytest.mark.parametrize("name,size", FONTS)
def test_textbbox_and_mask_equal_pillow(name, size):
    """Every chart string, every character alone and seeded strings: the
    box, the mask and its offset, and the length are Pillow's."""
    port, ref = _fonts(name, size)
    draw = ImageDraw.Draw(Image.new("RGB", (1, 1)))
    extras = ["✅❌⭕️ é", "1✅, 0❌, 0⭕️, 1"] if name == "default" else ["office fifty fl ffl"]
    for s in CHART_STRINGS + ASCII + extras + _strings(size):
        for xy in ((0, 0), (7, -3)):
            assert text.textbbox(xy, s, port) == draw.textbbox(xy, s, font=ref), s
        mask, offset = ref.getmask2(s, mode="L")
        got, got_offset = port.getmask(s)
        assert got.shape == (mask.size[1], mask.size[0]), s
        np.testing.assert_array_equal(
            got, np.array(mask, np.uint8).reshape(got.shape), err_msg=s)
        assert got_offset == tuple(offset) and port.getlength(s) == ref.getlength(s), s


@pytest.mark.parametrize("name,size", FONTS)
@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_text_on_a_canvas_equals_pillow(name, size, mode):
    """ImageDraw.text on seeded canvases (alpha too), colours and origins,
    some hanging off the canvas."""
    port, ref = _fonts(name, size)
    rng = np.random.default_rng(size + len(mode))
    for s in CHART_STRINGS[::7] + _strings(size + 1, n=20):
        canvas = rng.integers(0, 256, (40, 90, len(mode)), dtype=np.uint8)
        xy = (int(rng.integers(-30, 80)), int(rng.integers(-12, 35)))
        fill = tuple(int(v) for v in rng.integers(0, 256, 3))
        img = Image.fromarray(canvas.copy(), mode)
        ImageDraw.Draw(img).text(xy, s, font=ref, fill=fill)
        got = text.text(canvas.copy(), xy, s, port, fill)
        np.testing.assert_array_equal(got, np.asarray(img), err_msg=s)


@pytest.mark.parametrize("size", [10, 12])
@pytest.mark.parametrize("angle", [45, 30, 300])
def test_text_image_and_rotate_equal_pillow(size, angle):
    """fastcharts' label image (a transparent RGBA canvas, the text one
    pixel in) and Image.rotate(angle, expand=True)."""
    port, ref = _fonts("DejaVuSans", size)
    for s in CHART_STRINGS[::3]:
        bbox = ImageDraw.Draw(Image.new("RGBA", (1, 1))).textbbox((0, 0), s, font=ref)
        w, h = max(bbox[2] - bbox[0], 1), max(bbox[3] - bbox[1], 1)
        img = Image.new("RGBA", (w + 2, h + 2), (255, 255, 255, 0))
        ImageDraw.Draw(img).text((1 - bbox[0], 1 - bbox[1]), s, font=ref, fill=(0, 0, 0, 255))
        got = text.text_image(s, port, (0, 0, 0))
        np.testing.assert_array_equal(got, np.asarray(img), err_msg=s)
        np.testing.assert_array_equal(text.rotate(got, angle, expand=True),
                                      np.asarray(img.rotate(angle, expand=True)), err_msg=s)
    noise = np.random.default_rng(angle).integers(0, 256, (37, 51, 3), dtype=np.uint8)
    for expand in (False, True):
        np.testing.assert_array_equal(
            text.rotate(noise, angle, expand=expand),
            np.asarray(Image.fromarray(noise).rotate(angle, expand=expand)))


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_rectangles_and_lines_equal_pillow(mode):
    """ImageDraw.rectangle (fill, outline of width 1-4, both) and vertical
    and horizontal lines of width 1-4, corners off the canvas too."""
    rng = np.random.default_rng(len(mode))
    for _ in range(80):
        canvas = rng.integers(0, 256, (30, 40, len(mode)), dtype=np.uint8)
        x0, y0 = (int(v) for v in rng.integers(-8, 40, 2))
        x1, y1 = x0 + int(rng.integers(0, 30)), y0 + int(rng.integers(0, 25))
        colour = tuple(int(v) for v in rng.integers(0, 256, 3))
        width = int(rng.integers(1, 5))
        kind = int(rng.integers(0, 4))
        img = Image.fromarray(canvas.copy(), mode)
        d = ImageDraw.Draw(img)
        got = canvas.copy()
        if kind == 0:
            d.rectangle((x0, y0, x1, y1), fill=colour)
            text.rectangle(got, (x0, y0, x1, y1), fill=colour)
        elif kind == 1:
            d.rectangle([(x0, y0), (x1, y1)], outline=colour, width=width)
            text.rectangle(got, [(x0, y0), (x1, y1)], outline=colour, width=width)
        elif kind == 2:
            end = (x0, y1) if rng.integers(2) else (x1, y0)
            d.line([(x0, y0), end], fill=colour, width=width)
            text.line(got, [(x0, y0), end], fill=colour, width=width)
        else:
            d.line([end := (x1, y1), (x1, y0)], fill=colour, width=width)
            text.line(got, [end, (x1, y0)], fill=colour, width=width)
        np.testing.assert_array_equal(got, np.asarray(img), err_msg=str((kind, x0, y0, x1, y1)))


def test_atlas_tool_check_passes():
    """tools/torch_port_text_atlas.py --check: the committed atlas against
    Pillow on the chart strings and 400 seeded strings of every font."""
    assert atlas_tool.check() == []


def test_unknown_glyphs_and_fonts_are_refused():
    with pytest.raises(ValueError, match="no glyph"):
        text.truetype(DEJAVU, 10).getbbox("naïve")
    with pytest.raises(ValueError, match="no font"):
        text.truetype(DEJAVU, 13)
    with pytest.raises(ValueError, match="whole-pixel"):
        text.textbbox((0.5, 0), "a", text.load_default())
