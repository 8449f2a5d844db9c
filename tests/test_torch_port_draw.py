"""The port's cv2-free drawer and skeletal sprites against OpenCV and the
JAX package.

``playaid_core_torch.draw`` must draw what OpenCV's ``LINE_AA`` lines,
circles, ellipse arcs, ``fillPoly`` and filled rectangles draw, pixel for
pixel:
each primitive is held against cv2 on a seeded grid (thickness 1-8, radii
0-60, arcs, concave and self-crossing polygons, coordinates off the
canvas, 3 and 4 channels, black and noisy canvases).  Then the sprite
module built on it: ``style_variant``, ``render_sprite`` for every fighter
and move, and ``generate_sprite_set(fmt="npy")`` against the JAX module's
PNG tree read back with ``cv2.imread(..., IMREAD_UNCHANGED)``.
"""

import os
import subprocess
import sys
import zlib
from dataclasses import asdict
from pathlib import Path

import cv2
import numpy as np
import pytest

from playaid_core_torch import draw
from playaid_core_torch.datagen import skeletal_sprites as sk
from playaid_core_tpu.datagen import skeletal_sprites as jax_sk

ROOT = Path(__file__).resolve().parents[1]
H, W = 60, 70
CASES = 60


def _point(rng, lo=-40, hi=110):
    return tuple(int(v) for v in rng.integers(lo, hi, 2))


def _colour(rng):
    return tuple(int(v) for v in rng.integers(0, 256, 4))


def _calls(kind, rng):
    """(cv2 call, port call) on an image, for one seeded draw of ``kind``."""
    col, p1, p2 = _colour(rng), _point(rng), _point(rng)
    t = int(rng.integers(1, 9))
    r = int(rng.integers(0, 61))
    axes = (int(rng.integers(0, 45)), int(rng.integers(0, 45)))
    a0, a1 = int(rng.integers(-200, 400)), int(rng.integers(-200, 400))
    if kind == "line":
        return (lambda im: cv2.line(im, p1, p2, col, t, cv2.LINE_AA),
                lambda im: draw.line(im, p1, p2, col, t))
    if kind == "circle_filled":
        return (lambda im: cv2.circle(im, p1, r, col, -1, cv2.LINE_AA),
                lambda im: draw.circle(im, p1, r, col, -1))
    if kind == "circle_ring":
        return (lambda im: cv2.circle(im, p1, r, col, t, cv2.LINE_AA),
                lambda im: draw.circle(im, p1, r, col, t))
    if kind == "arc":
        return (lambda im: cv2.ellipse(im, p1, axes, 0, a0, a1, col, t, cv2.LINE_AA),
                lambda im: draw.ellipse(im, p1, axes, 0, a0, a1, col, t))
    if kind == "ellipse_filled":
        return (lambda im: cv2.ellipse(im, p1, axes, 0, 0, 360, col, -1, cv2.LINE_AA),
                lambda im: draw.ellipse(im, p1, axes, 0, 0, 360, col, -1))
    if kind == "arc_filled":
        return (lambda im: cv2.ellipse(im, p1, axes, 0, a0, a1, col, -1, cv2.LINE_AA),
                lambda im: draw.ellipse(im, p1, axes, 0, a0, a1, col, -1))
    if kind == "fill_poly":
        polys = [rng.integers(-30, 100, (int(rng.integers(3, 9)), 2)).astype(np.int32)
                 for _ in range(int(rng.integers(1, 3)))]
        return (lambda im: cv2.fillPoly(im, polys, col, cv2.LINE_AA),
                lambda im: draw.fill_poly(im, polys, col))
    if kind == "rectangle_filled":
        return (lambda im: cv2.rectangle(im, p1, p2, col, -1, cv2.LINE_AA),
                lambda im: draw.rectangle(im, p1, p2, col))
    raise ValueError(kind)


PRIMITIVES = ["line", "circle_filled", "circle_ring", "arc", "ellipse_filled", "arc_filled",
              "fill_poly", "rectangle_filled"]


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("kind", PRIMITIVES)
def test_primitive_matches_cv2(kind, channels):
    rng = np.random.default_rng(zlib.crc32(f"{kind}{channels}".encode()))
    for case in range(CASES):
        base = (rng.integers(0, 256, (H, W, channels), dtype=np.uint8) if case % 2
                else np.zeros((H, W, channels), np.uint8))
        ref, out = base.copy(), base.copy()
        cv_call, port_call = _calls(kind, rng)
        cv_call(ref)
        port_call(out)
        assert np.array_equal(out, ref), (kind, channels, case)


@pytest.mark.parametrize("channels", [3, 4])
def test_edge_cases_match_cv2(channels):
    """Far off-canvas and degenerate geometry: lines through and beside the
    canvas from thousands of pixels away, zero-length thick lines, radius 0
    and 1, a polygon of one repeated point, a 3-value colour on 4
    channels, and drawing on a strided view of a larger image."""
    calls = [
        (cv2.line, draw.line, ((-5000, 20), (6000, 41), (10, 200, 30, 90), 3)),
        (cv2.line, draw.line, ((-5000, -300), (8000, 400), (255, 255, 255, 255), 1)),
        (cv2.line, draw.line, ((-50, -50), (-10, 200), (99, 0, 7, 5), 6)),
        (cv2.line, draw.line, ((30, 30), (30, 30), (200, 100, 50, 255), 7)),
        (cv2.line, draw.line, ((69, 0), (0, 59), (1, 2, 3), 2)),
        (cv2.circle, draw.circle, ((35, 30), 0, (255, 0, 0, 255), -1)),
        (cv2.circle, draw.circle, ((35, 30), 1, (255, 0, 0, 255), 2)),
        (cv2.circle, draw.circle, ((-3000, 30), 3010, (12, 34, 56, 78), -1)),
        (cv2.ellipse, draw.ellipse, ((35, 30), (20, 8), 0, 30, 30, (9, 9, 9, 9), 3)),
        (cv2.ellipse, draw.ellipse, ((35, 30), (0, 0), 0, 0, 360, (9, 9, 9, 9), -1)),
        (cv2.fillPoly, draw.fill_poly, ([np.array([[20, 20]] * 4, np.int32)], (5, 6, 7, 8))),
    ]
    for cv_fn, port_fn, args in calls:
        ref = np.full((H, W, channels), 17, np.uint8)
        out = ref.copy()
        cv_fn(ref, *args, cv2.LINE_AA)
        port_fn(out, *args)
        assert np.array_equal(out, ref), (cv_fn.__name__, args)
    for corner in ((10, 10), (-30, 70), (90, -5)):
        ref = np.full((H, W, channels), 17, np.uint8)
        out = ref.copy()
        cv2.rectangle(ref, (10, 10), corner, (80, 90, 100, 110), -1, cv2.LINE_AA)
        draw.rectangle(out, (10, 10), corner, (80, 90, 100, 110))
        assert np.array_equal(out, ref), corner
    # On a strided view (cv2 refuses one): the view's pixels as cv2 draws a
    # copy of it, the pixels between untouched.
    big = np.zeros((H, 2 * W, channels), np.uint8)
    ref = np.ascontiguousarray(big[:, ::2])
    cv2.line(ref, (3, 4), (60, 50), (255, 128, 64, 32), 3, cv2.LINE_AA)
    draw.line(big[:, ::2], (3, 4), (60, 50), (255, 128, 64, 32), 3)
    assert np.array_equal(big[:, ::2], ref) and not big[:, 1::2].any()


def test_ellipse2poly_matches_cv2():
    """OpenCV's SinTable (sines to 7 places, float32) and its arc
    normalisation, through cv2.ellipse2Poly's points."""
    rng = np.random.default_rng(5)
    for _ in range(200):
        centre, axes = _point(rng, -50, 50), (int(rng.integers(0, 300)), int(rng.integers(0, 300)))
        angle, a0, a1 = (int(v) for v in rng.integers(-400, 400, 3))
        delta = int(rng.choice([1, 5, 18, 30, 90]))
        ref = cv2.ellipse2Poly(centre, axes, angle, a0, a1, delta)
        pts = [(round(x), round(y)) for x, y in draw.ellipse2poly(
            centre, axes, angle, a0, a1, delta)]
        dedup = [p for i, p in enumerate(pts) if i == 0 or p != pts[i - 1]]
        assert np.array_equal(np.array(dedup).reshape(-1, 2), ref.reshape(-1, 2))


@pytest.mark.parametrize("fighter", list(sk.FIGHTER_STYLES))
def test_style_variant_matches_jax(fighter):
    for variant in range(5):
        assert (asdict(sk.style_variant(sk.FIGHTER_STYLES[fighter], variant))
                == asdict(jax_sk.style_variant(jax_sk.FIGHTER_STYLES[fighter], variant)))


@pytest.mark.parametrize("facing", [1, -1])
@pytest.mark.parametrize("fighter", list(sk.FIGHTER_STYLES))
def test_render_sprite_is_cv2s(fighter, facing):
    """Every move of MOVES + EXTRA_MOVES at 2 phases and variants 0 and 3,
    without and with the noise generator: identical to the JAX (cv2)
    renderer."""
    for move in sk.MOVES + sk.EXTRA_MOVES:
        for phase in (0.13, 0.62):
            for variant in (0, 3):
                kw = dict(facing=facing, variant_seed=variant)
                out = sk.render_sprite(fighter, move, phase, **kw)
                ref = jax_sk.render_sprite(fighter, move, phase, **kw)
                assert np.array_equal(out, ref), (move, phase, variant)
                out = sk.render_sprite(fighter, move, phase, noise_rng=np.random.default_rng(7),
                                       **kw)
                ref = jax_sk.render_sprite(fighter, move, phase,
                                           noise_rng=np.random.default_rng(7), **kw)
                assert np.array_equal(out, ref), (move, phase, variant, "noise")


TREE = dict(fighters=["Joker", "Pikachu"], moves=["Jab", "Shield", "Roll"], frames_per_move=3,
            variant_seeds=(0, 1), phase_offsets={1: 0.5}, seed=4)


@pytest.fixture(scope="module")
def jax_png_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_sprites")
    n = jax_sk.generate_sprite_set(str(root), **TREE)
    return root, n


def _relative_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_generate_sprite_set_npy_is_the_png_tree(jax_png_tree, tmp_path):
    png_root, n = jax_png_tree
    assert sk.generate_sprite_set(str(tmp_path), fmt="npy", **TREE) == n
    names = _relative_files(png_root)
    assert [p[:-4] + ".npy" for p in names] == _relative_files(tmp_path)
    for name in names:
        ref = cv2.imread(str(png_root / name), cv2.IMREAD_UNCHANGED)
        assert np.array_equal(np.load(tmp_path / (name[:-4] + ".npy")), ref), name


_POOL = """
import os
import sys
from playaid_core_torch.datagen import skeletal_sprites as sk
tree = dict(fighters=["Joker", "Pikachu"], moves=["Jab", "Shield", "Roll"], frames_per_move=3,
            variant_seeds=(0, 1), phase_offsets={1: 0.5}, seed=4)
os.cpu_count = lambda: 3  # 72 sprites at 24 a process: three processes
sk.SPRITES_A_PROCESS = 24
print(sk.generate_sprite_set(sys.argv[1], fmt="npy", **tree))
"""


def test_generate_sprite_set_processes_draw_the_same_tree(jax_png_tree, tmp_path):
    """Three spawned processes draw the tree that one draws: the noise is
    added in order in the parent.  Run in a subprocess, whose main module
    spawn can start."""
    png_root, n = jax_png_tree
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _POOL, str(tmp_path)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0 and proc.stdout.strip() == str(n), proc.stderr
    for name in _relative_files(png_root):
        ref = cv2.imread(str(png_root / name), cv2.IMREAD_UNCHANGED)
        assert np.array_equal(np.load(tmp_path / (name[:-4] + ".npy")), ref), name


def test_generate_sprite_set_png_needs_cv2_and_npy_does_not(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        sk.generate_sprite_set(str(tmp_path / "png"), fighters=["Joker"], moves=["Jab"],
                               frames_per_move=1, fmt="png")
    assert sk.generate_sprite_set(str(tmp_path / "npy"), fighters=["Joker"], moves=["Jab"],
                                  frames_per_move=1, fmt="npy") == 2
    with pytest.raises(ValueError, match="fmt"):
        sk.generate_sprite_set(str(tmp_path), fmt="jpg")


def test_sprite_digests_file_is_cv2s(tmp_path):
    """assets/sprite_digests.json holds, for the settings and subset its
    tool names, the digests of the JAX (cv2) renderer as it draws today:
    the tree is drawn again here with cv2 and every digest recomputed."""
    import json

    sys.path.insert(0, str(ROOT / "tools"))
    import torch_port_sprite_digests as tool

    with open(ROOT / "playaid_core_torch" / "assets" / "sprite_digests.json") as f:
        spec = json.load(f)
    cfg = spec["settings"]
    assert cfg == tool.SETTINGS and list(spec["digests"]) == tool.subset(cfg)
    assert len(spec["digests"]) >= 48
    n = jax_sk.generate_sprite_set(str(tmp_path), fighters=cfg["fighters"], moves=cfg["moves"],
                                   frames_per_move=cfg["frames_per_move"],
                                   variant_seeds=tuple(cfg["variant_seeds"]), seed=cfg["seed"])
    assert n == spec["sprites"]
    for name, digest in spec["digests"].items():
        img = cv2.imread(str(tmp_path / (name + ".png")), cv2.IMREAD_UNCHANGED)
        assert sk.sprite_digest(img) == digest, name
