"""The drawing that the charts and the annotator add to
``playaid_core_torch.draw``, against cv2 pixel for pixel on seeded grids:
``cv2.line`` with ``LINE_8``, the default filled ``cv2.rectangle``, the
outlined ``LINE_AA`` rectangle, and ``cv2.getTextSize`` / ``cv2.putText``
(font 0, ``LINE_AA``) on every printable ASCII character and on seeded
strings at the scale and thickness the annotator's line width gives for
320x180, 720p and 1080p frames and for the manuscript's fixed width 4.
"""

import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from playaid_core_torch import draw

ROOT = Path(__file__).resolve().parents[1]
ASCII = [chr(c) for c in range(32, 127)]


def _lw(shape):
    """The annotator's default line width for a frame of this shape."""
    return max(round(sum(shape) / 2 * 0.003), 2)


# 320x180 (RGBA), 720p, 1080p by the annotator's default; 4, the manuscript's.
STYLES = sorted({(lw / 5, max(lw - 2, 1)) for lw in (
    _lw((180, 320, 4)), _lw((720, 1280, 4)), _lw((1080, 1920, 4)), 4)})


def test_styles_cover_the_annotators_frames():
    assert STYLES == [(0.4, 1), (0.6, 1), (0.8, 2), (1.0, 3)]


@pytest.mark.parametrize("scale,thickness", STYLES)
def test_every_character_alone(scale, thickness):
    for c in ASCII:
        assert draw.get_text_size(c, 0, scale, thickness) == \
            tuple(cv2.getTextSize(c, 0, scale, thickness)), c
        for channels in (3, 4):
            canvas = np.random.default_rng(ord(c)).integers(0, 256, (50, 40, channels),
                                                            dtype=np.uint8)
            a, b = canvas.copy(), canvas.copy()
            cv2.putText(a, c, (6, 33), 0, scale, (250, 20, 90), thickness, cv2.LINE_AA)
            draw.put_text(b, c, (6, 33), 0, scale, (250, 20, 90), thickness)
            np.testing.assert_array_equal(b, a, err_msg=repr(c))


@pytest.mark.parametrize("scale,thickness", STYLES)
@pytest.mark.parametrize("channels", [3, 4])
def test_seeded_strings(scale, thickness, channels):
    """Labels as the manuscript writes them and seeded strings, at origins
    on and off the canvas, colours of 3 and 4 values."""
    rng = np.random.default_rng(int(scale * 10) + channels)
    strings = ["Wait | #12 | startup", "ForwardSmash | #3 | active", "Frame #479",
               "DashAttack | #1 | end lag", ""]
    strings += ["".join(rng.choice(ASCII, int(rng.integers(1, 30)))) for _ in range(40)]
    for s in strings:
        assert draw.get_text_size(s, 0, scale, thickness) == \
            tuple(cv2.getTextSize(s, 0, scale, thickness)), s
        canvas = rng.integers(0, 256, (60, 120, channels), dtype=np.uint8)
        org = (int(rng.integers(-80, 130)), int(rng.integers(-10, 75)))
        colour = tuple(int(v) for v in rng.integers(0, 256, int(rng.integers(3, 5))))
        a, b = canvas.copy(), canvas.copy()
        cv2.putText(a, s, org, 0, scale, colour, thickness, cv2.LINE_AA)
        draw.put_text(b, s, org, 0, scale, colour, thickness)
        np.testing.assert_array_equal(b, a, err_msg=repr((s, org)))


def test_text_outside_the_atlas_is_refused():
    with pytest.raises(ValueError, match="no scale"):
        draw.get_text_size("a", 0, 0.5, 1)
    with pytest.raises(ValueError, match="ASCII"):
        draw.put_text(np.zeros((9, 9, 3), np.uint8), "é", (0, 5), 0, 0.8, (1, 2, 3), 2)
    with pytest.raises(ValueError, match="font 0"):
        draw.get_text_size("a", 1, 0.8, 2)


def test_cv2_atlas_tool_check_passes():
    sys.path.insert(0, str(ROOT / "tools"))
    import torch_port_cv2_text_atlas as tool

    assert tool.check(cv2, seed=1) == []


def _point(rng, lo=-40, hi=110):
    return tuple(int(v) for v in rng.integers(lo, hi, 2))


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("kind", ["line8", "rectangle8", "rectangle_outline"])
def test_primitives_equal_cv2(kind, channels):
    rng = np.random.default_rng(len(kind) * channels)
    for _ in range(60):
        canvas = rng.integers(0, 256, (60, 70, channels), dtype=np.uint8)
        p1, p2 = _point(rng), _point(rng)
        colour = tuple(int(v) for v in rng.integers(0, 256, int(rng.integers(3, 5))))
        a, b = canvas.copy(), canvas.copy()
        if kind == "line8":
            cv2.line(a, p1, p2, colour, 1)
            draw.line8(b, p1, p2, colour)
        elif kind == "rectangle8":
            cv2.rectangle(a, p1, p2, colour, -1)
            draw.rectangle8(b, p1, p2, colour)
        else:
            t = int(rng.integers(1, 7))
            cv2.rectangle(a, p1, p2, colour, t, cv2.LINE_AA)
            draw.rectangle_outline(b, p1, p2, colour, t)
        np.testing.assert_array_equal(b, a, err_msg=repr((p1, p2)))
