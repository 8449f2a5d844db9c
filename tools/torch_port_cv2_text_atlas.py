#!/usr/bin/env python3
"""Write playaid_core_torch/assets/cv2_text_atlas.npz, the glyph atlas that
playaid_core_torch/draw.py's put_text and get_text_size draw from, and
check it against cv2.

    python3 tools/torch_port_cv2_text_atlas.py [--check]

OpenCV 5 draws ``cv2.putText(img, text, org, 0, scale, colour, thickness,
cv2.LINE_AA)`` (``FONT_HERSHEY_SIMPLEX``) with its built-in outline font
rather than Hershey strokes: each character is an antialiased coverage
mask, at the same place relative to the pen wherever the pen stands, and
the pen moves on by a whole number of pixels a character.  For each (scale,
thickness) the annotator draws labels at (``lw / 5`` and ``max(lw - 2, 1)``
for its line widths 2-5) the tool records every printable ASCII
character's mask (drawn alone in white on black), its offset from the
origin, its advance (``getTextSize(c)`` width less 1) and its baseline, and
the text height.  Then it holds draw.put_text and draw.get_text_size
against cv2 on seeded strings, origins (off the canvas too), colours and
canvases of 3 and 4 channels, and exits non-zero on any difference.
``--check`` only checks the committed atlas.  Needs cv2; rerun it when cv2
changes.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "playaid_core_torch", "assets", "cv2_text_atlas.npz")
# (font scale, thickness) for the annotator's line widths 2, 3, 4 and 5.
STYLES = tuple((lw / 5, max(lw - 2, 1)) for lw in (2, 3, 4, 5))
ASCII = [chr(c) for c in range(32, 127)]
CHECK_CASES = 300


def key(scale, thickness):
    return f"s{scale:g}_t{thickness}"


def glyph(cv2, c, scale, thickness):
    """The mask of c drawn alone, and its offset from the origin."""
    size = 400
    org = (size // 4, size // 2)
    img = np.zeros((size, size), np.uint8)
    cv2.putText(img, c, org, 0, scale, 255, thickness, cv2.LINE_AA)
    ys, xs = np.nonzero(img)
    if not len(ys):
        return np.zeros((0, 0), np.uint8), (0, 0)
    y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
    return img[y0:y1, x0:x1].copy(), (int(x0 - org[0]), int(y0 - org[1]))


def build(cv2):
    arrays = {}
    for scale, thickness in STYLES:
        k = key(scale, thickness)
        metrics, masks = [], []
        for c in ASCII:
            mask, (dx, dy) = glyph(cv2, c, scale, thickness)
            (w, _), baseline = cv2.getTextSize(c, 0, scale, thickness)
            metrics.append((w - 1, dx, dy, baseline))
            masks.append(mask)
        arrays[f"{k}/metrics"] = np.array(metrics, np.int32)
        arrays[f"{k}/shapes"] = np.array([m.shape for m in masks], np.int32)
        arrays[f"{k}/masks"] = np.concatenate([m.ravel() for m in masks]).astype(np.uint8)
        arrays[f"{k}/height"] = np.array(cv2.getTextSize("H", 0, scale, thickness)[0][1], np.int32)
    return arrays


def check(cv2, seed=0):
    """draw.put_text / get_text_size against cv2; returns the mismatches."""
    from playaid_core_torch import draw

    draw._cv2_atlas = None
    rng = np.random.default_rng(seed)
    bad = []
    for scale, thickness in STYLES:
        strings = list(ASCII) + ["".join(rng.choice(ASCII, int(rng.integers(1, 25))))
                                 for _ in range(CHECK_CASES)]
        for i, s in enumerate(strings):
            want = cv2.getTextSize(s, 0, scale, thickness)
            got = draw.get_text_size(s, 0, scale, thickness)
            if (tuple(want[0]), want[1]) != (tuple(got[0]), got[1]):
                bad.append(("size", scale, thickness, s, want, got))
            channels = 3 if i % 2 else 4
            canvas = rng.integers(0, 256, (60, 90, channels), dtype=np.uint8)
            org = (int(rng.integers(-60, 100)), int(rng.integers(-10, 80)))
            colour = tuple(int(v) for v in rng.integers(0, 256, int(rng.integers(3, 5))))
            a, b = canvas.copy(), canvas.copy()
            cv2.putText(a, s, org, 0, scale, colour, thickness, cv2.LINE_AA)
            draw.put_text(b, s, org, 0, scale, colour, thickness)
            if not np.array_equal(a, b):
                bad.append(("pixels", scale, thickness, s, org, int((a != b).sum())))
    return bad


def main():
    import cv2

    if "--check" not in sys.argv[1:]:
        np.savez_compressed(OUT, **build(cv2))
        print(f"wrote {os.path.relpath(OUT, ROOT)} ({os.path.getsize(OUT)} bytes), "
              f"cv2 {cv2.__version__}")
    bad = check(cv2)
    for case in bad[:20]:
        print("differs from cv2:", case)
    print(f"{len(bad)} cases differ from cv2")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
