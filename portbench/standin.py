"""Inputs of the VOD cells: a pool of rendered scenes, the schedule of held
moves that makes a VOD of them, and the crop source that stands in for
decoding (the card's machine has no libavcodec and no cv2).

A scene is a 1080p BGR frame of noise (drawn from the seed) with two
fighters drawn as discs, as the disc clip of the port's smoke test draws
them, and each fighter's box.  The pool holds ``moves`` moves of
``phases`` animation phases each; a fighter's disc bobs inside its box as
the phase advances, and the two walk across the frame from move to move.
A VOD is a seeded schedule of held moves, one per segment of
``segment_frames`` video frames; inside a segment the phase advances every
``phase_frames`` frames.  Every VOD of a cell has the same length, so every
seed gives the same work in another order.

:class:`CropSource` stands behind the native decoder
(``native_decoder.acquire/release/probe``): each chunk's packed YUV420
crops are gathered from the pool's crops made in set-up, one ``take``.
"""

from __future__ import annotations

import numpy as np

PALETTE = np.array([(0, 200, 255), (255, 80, 0), (60, 220, 60), (200, 60, 220),
                    (240, 240, 240), (30, 120, 255), (255, 200, 40), (120, 80, 40)], np.uint8)


class Pool:
    """The scenes of one seed: ``boxes [Q, 2, 4]`` (normalised yolo, Q =
    moves x phases), and on request their crops."""

    def __init__(self, traffic, seed):
        self.t = traffic
        self.h, self.w = traffic["height"], traffic["width"]
        self.moves, self.phases = traffic["moves"], traffic["phases"]
        rng = np.random.default_rng([seed % 2**64, 1])
        self.background = rng.integers(0, 60, (self.h, self.w, 3), dtype=np.uint8)
        self.colours = PALETTE[rng.integers(0, len(PALETTE), (self.moves, 2))]
        q = self.moves * self.phases
        self.boxes = np.zeros((q, 2, 4), np.float32)
        self.discs = np.zeros((q, 2, 2), np.int64)  # disc centre (x, y) in pixels
        box = traffic["box_px"]
        bob = traffic["bob_px"]
        for m in range(self.moves):
            for p in range(self.phases):
                i = m * self.phases + p
                x = 0.2 + 0.6 * (m + p / self.phases) / self.moves
                centres = ((x, 0.5), (1.0 - x, 0.5 + 60 / 1080))
                angle = 2 * np.pi * p / self.phases
                for k, (cx, cy) in enumerate(centres):
                    self.boxes[i, k] = (cx, cy, box / self.w, box / self.h)
                    self.discs[i, k] = (int(cx * self.w) + int(round(bob * np.cos(angle))),
                                        int(cy * self.h) + int(round(bob * np.sin(angle))))

    def render(self, i, out):
        """Scene i's BGR frame into ``out`` ``[H, W, 3]``."""
        r = self.t["disc_radius"]
        yy, xx = np.ogrid[-r:r + 1, -r:r + 1]
        disc = yy ** 2 + xx ** 2 <= r * r
        out[:] = self.background
        m = i // self.phases
        for k in range(2):
            cx, cy = self.discs[i, k]
            out[cy - r:cy + r + 1, cx - r:cx + r + 1][disc] = self.colours[m, k]
        return out

    def crops(self, size, padding):
        """Every scene's two packed YUV420 crops ``[Q, 2, S*S*3//2]``."""
        frame = np.empty((self.h, self.w, 3), np.uint8)
        out = np.empty((len(self.boxes), 2, size * size * 3 // 2), np.uint8)
        for i in range(len(self.boxes)):
            self.render(i, frame)
            for k in range(2):
                out[i, k] = yuv420_crop(frame, self.boxes[i, k], size, padding)
        return out


def bgr_crop(frame, box, size, padding):
    """A letterboxed square BGR crop sampled at the nearest pixel, in the
    native extractor's window: side ``2 * (max(w, h) // 2 + padding)``
    around the integer centre; black outside the frame."""
    h, w = frame.shape[:2]
    half = int(max(int(box[2] * w), int(box[3] * h)) / 2)
    side = 2 * (half + padding)
    pos = ((np.arange(size) + 0.5) * side / size).astype(np.int64)
    ys = int(box[1] * h) - half - padding + pos
    xs = int(box[0] * w) - half - padding + pos
    crop = frame[np.clip(ys, 0, h - 1)][:, np.clip(xs, 0, w - 1)]
    inside = ((ys >= 0) & (ys < h))[:, None] & ((xs >= 0) & (xs < w))[None, :]
    crop[~inside] = 0
    return crop


def yuv420_crop(frame, box, size, padding):
    """:func:`bgr_crop` as packed planar YUV420 (BT.601 limited range)."""
    bgr = bgr_crop(frame, box, size, padding).astype(np.float32)
    b, g, r = bgr[..., 0], bgr[..., 1], bgr[..., 2]
    y = 16 + 0.257 * r + 0.504 * g + 0.098 * b
    u = 128 - 0.148 * r - 0.291 * g + 0.439 * b
    v = 128 + 0.439 * r - 0.368 * g - 0.071 * b

    def pool(c):
        return c.reshape(size // 2, 2, size // 2, 2).mean(axis=(1, 3))

    planes = [y.ravel(), pool(u).ravel(), pool(v).ravel()]
    return np.clip(np.rint(np.concatenate(planes)), 0, 255).astype(np.uint8)


class Schedule:
    """Which scene each frame of each VOD shows: VOD v holds moves
    ``table[v * segments : (v + 1) * segments]`` (cyclically), a move a
    segment, and frame f of a segment shows phase ``(f // phase_frames) %
    phases`` of its move."""

    TABLE = 1 << 16

    def __init__(self, traffic, seed):
        self.t = traffic
        self.frames = traffic["frames_per_vod"]
        self.segments = -(-self.frames // traffic["segment_frames"])
        rng = np.random.default_rng([seed % 2**64, 2])
        self.table = rng.integers(0, traffic["moves"], self.TABLE).astype(np.int64)

    def scenes(self, vod, frame_idx):
        """Scene index of each frame in ``frame_idx`` (int array) of VOD v."""
        t = self.t
        seg = frame_idx // t["segment_frames"]
        move = self.table[(vod * self.segments + seg) % self.TABLE]
        return move * t["phases"] + (frame_idx // t["phase_frames"]) % t["phases"]


class CropSource:
    """The native decoder of one VOD: ``decode_crops`` gives each chunk's
    dense packed YUV420 crops ``[ceil(len(boxes) / stride), 2, S*S*3//2]``
    gathered from the pool's crops; rows past the VOD's end are zero."""

    def __init__(self, crops, schedule, vod, size, padding):
        self.pool, self.schedule, self.vod = crops, schedule, vod
        self.size, self.padding = size, padding
        self.num_frames = schedule.frames
        self.info = {"width": schedule.t["width"], "height": schedule.t["height"],
                     "fps": 60.0, "num_frames": self.num_frames, "max_lowres": 0, "fast": 0}

    def decode_crops(self, start, boxes, out_size=128, padding=30, stride=1, out=None,
                     fmt="bgr", dense=False):
        if fmt != "yuv420" or not dense or out is not None:
            raise ValueError("the stand-in gives dense yuv420 crops only")
        if (out_size, padding) != (self.size, self.padding):
            raise ValueError(f"the pool holds {self.size}-px crops at padding {self.padding}")
        rows = -(-boxes.shape[0] // stride)
        n = max(0, min(boxes.shape[0], self.num_frames - start))
        frame_idx = start + stride * np.arange(rows)
        crops = self.pool.take(self.schedule.scenes(self.vod, frame_idx), axis=0)
        crops[-(-n // stride):] = 0
        return n, crops


def vod_boxes(pool, schedule, vod):
    """The boxes ``[F, 2, 4]`` of every frame of VOD v."""
    return pool.boxes[schedule.scenes(vod, np.arange(schedule.frames))]


class Registry:
    """VOD name -> its source, and the hooks that put the sources behind the
    port's decoder pool in this process."""

    def __init__(self):
        self.sources = {}

    def install_native(self, native_decoder):
        native_decoder.acquire = lambda path, lowres=0, fast=False: self.sources[path]
        native_decoder.release = lambda dec: None
        native_decoder.probe = lambda path, fast="auto": self.sources[path].info

