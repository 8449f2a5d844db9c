"""Timeline ingest: ult_logger log parsing, gap repair, batched projection.

The port's own copy of ``playaid_core_tpu/timeline.py`` (reference:
timeline.py:1-322):

* ``load_ground_truth_from_path`` — one JSON line per fighter per frame
  (2 lines/frame), grouped per frame, with gap repair: if
  ``num_frames_left`` skips by d>1 the previous frame is repeated d-1 times;
  negative log offsets duplicate the starting lines, positive offsets skip
  lines; fighter ids are renumbered to 0/1.
* ``precompute_timeline_projection`` — one vectorized numpy pass that
  projects every fighter's bbox for the whole timeline at once and stores
  the result in each record under ``_pixel_crop`` for
  :class:`playaid_core_torch.fighter.Fighter` to consume.
* ``update_fighters_from_timeline``, the streaming generators
  ``yield_fighters_and_stats`` / ``yield_interval_fighters_and_stats``, the
  pairings CSV and ``GTVideo`` (frames through the port's ``VideoReader``).
* ``load_timeline_from_ai_output`` — log-like records from the
  ``ai_output.yaml`` that the port's ``AIRunner`` writes, read by
  :mod:`playaid_core_torch.infer.ai_output` without a YAML package.
* ``cache_dataset`` — the index of a ``gt_action_detection`` tree that the
  training dataset samples from (its ``*.jpg`` crops, and the port's
  lossless ``*.npy`` crops).

Nothing here imports yaml or cv2, so it runs where neither is installed.
"""

from __future__ import annotations

import csv
import glob
import json
import os

import numpy as np

from playaid_core_torch.fighter import BBOX_WORLD_OFFSETS, Fighter
from playaid_core_torch.geometry import (
    invert_pose_batch,
    lookat_matrices_batch,
    project_points_batch,
)
from playaid_core_torch.infer import ai_output as ai_output_file
from playaid_core_torch.ontology import FIGHTER_NAME_TO_ENUM, STAGE_ENUM_TO_DATA
from playaid_core_torch.video.reader import VideoReader

PARSERS = ("auto", "native", "python")


def _iter_log_records(label_path: str, parser: str = "auto"):
    """Yield one record dict per log line.  ``parser``: "native" (the C++
    scanner of native/log_parser.cpp, built on first use; a failed build
    raises), "auto" (the same), or "python" (``json.loads`` per line)."""
    if parser not in PARSERS:
        raise ValueError(f"parser must be one of {PARSERS}, got {parser!r}")
    if parser == "python":
        with open(label_path, "r") as f:
            for line in f:
                if line.strip():
                    yield json.loads(line)
        return
    from playaid_core_torch.native import parse_log_records

    yield from parse_log_records(label_path)


def load_ground_truth_from_path(
    label_path: str, validate: bool = True, log_offset: int = 0, max_lines: int = 0,
    parser: str = "auto",
):
    """Parse an ult_logger log into ``ground_truth[frame] -> [rec_p0, rec_p1]``
    (reference: timeline.py:204-280)."""
    ground_truth = []
    prev_num_frames_left = -1
    index = 0
    offset_count = 0

    record_iter = _iter_log_records(label_path, parser)

    if log_offset < 0:
        # Duplicate initial state (reference: timeline.py:219-228).
        # Materialise once so the file isn't parsed twice.
        records = list(record_iter)
        ground_truth = [records[:2]] * abs(log_offset)
        index += 2 * abs(log_offset)
        log_offset = 0
        record_iter = iter(records)

    for json_data in record_iter:
        if max_lines and index > max_lines:
            break
        # Each record is half a frame (one per fighter), so a log_offset of
        # N frames skips 2N records.
        if offset_count < (2 * log_offset):
            offset_count += 1
            continue

        frame_number = index // 2
        if frame_number >= len(ground_truth):
            ground_truth.append([])

        # Gap repair: the logger occasionally drops frames; detect via
        # num_frames_left jumps and repeat the latest frame.
        diff = prev_num_frames_left - json_data["num_frames_left"]
        if prev_num_frames_left > 0 and diff > 1:
            repeated_logs = [ground_truth[-1]] * (diff - 1)
            ground_truth += repeated_logs
            index += (diff - 1) * 2

        ground_truth[frame_number].append(json_data)
        index += 1
        prev_num_frames_left = json_data["num_frames_left"]

    # Renumber fighter ids to 0/1 in on-screen order (ids in the raw log can
    # be e.g. 0 and 4).
    for i, frame_data in enumerate(ground_truth):
        frame_data = sorted(frame_data, key=lambda x: x["fighter_id"])
        for j, fighter_data in enumerate(frame_data):
            fighter_data["fighter_id"] = j
        ground_truth[i] = frame_data

    if validate:
        for i, gt in enumerate(ground_truth):
            if len(gt) != 2:
                raise ValueError("there should be the ground truth for 2 players for every "
                                 f"frame, found {len(gt)} for frame #{i}")
    return ground_truth


def precompute_timeline_projection(timeline, image_width=1280, image_height=720):
    """Vectorized world->screen projection for every record in a timeline.

    Stamps each record with ``_pixel_crop`` (8 bbox-corner pixel coords in
    the order top_left, top_right, bottom_left, bottom_right, flattened) and
    ``_point_in_pixel``.  Records that already carry an AI ``crop`` are left
    untouched.  Deduplicates repeated record objects (gap repair reuses the
    same dicts).  Returns the timeline for chaining.
    """
    records, seen = [], set()
    for frame in timeline:
        for rec in frame:
            if id(rec) in seen or "crop" in rec:
                continue
            seen.add(id(rec))
            records.append(rec)
    if not records:
        return timeline

    n = len(records)
    cam = np.empty((n, 3))
    tgt = np.empty((n, 3))
    pos = np.empty((n, 3))
    fov = np.empty((n,))
    for i, rec in enumerate(records):
        cp = rec["camera_position"]
        tp = rec["camera_target_position"]
        cam[i] = (cp["x"], cp["y"], cp["z"])
        tgt[i] = (tp["x"], tp["y"], tp["z"])
        pos[i] = (rec["pos_x"], rec["pos_y"], 0.0)
        stage_id = rec.get("stage_id", 0)
        if stage_id not in STAGE_ENUM_TO_DATA:
            stage_id = 0
        fov[i] = STAGE_ENUM_TO_DATA[stage_id]["fov"]

    pose_inv = invert_pose_batch(lookat_matrices_batch(cam, tgt))
    # Intrinsics differ only through per-record FOV.
    f = image_width / (2.0 * np.tan(np.deg2rad(fov) / 2.0))
    intr = np.zeros((n, 3, 3))
    intr[:, 0, 0] = f
    intr[:, 1, 1] = f
    intr[:, 0, 2] = image_width / 2
    intr[:, 1, 2] = image_height / 2
    intr[:, 2, 2] = 1.0

    centers = project_points_batch(pos, intr, pose_inv, image_height=image_height)

    # Project all 4 bbox corners: tile records x offsets.
    k = BBOX_WORLD_OFFSETS.shape[0]
    pts = (pos[:, None, :] + BBOX_WORLD_OFFSETS[None, :, :]).reshape(n * k, 3)
    intr_rep = np.repeat(intr, k, axis=0)
    pose_rep = np.repeat(pose_inv, k, axis=0)
    corners = project_points_batch(pts, intr_rep, pose_rep, image_height=image_height)
    corners = corners.reshape(n, k, 2)

    for i, rec in enumerate(records):
        rec["_point_in_pixel"] = centers[i]
        rec["_pixel_crop"] = tuple(int(v) for v in corners[i].reshape(-1))
    return timeline


def update_fighters_from_timeline(frame_number: int, ground_truth, fighters):
    """Create (frame 0 / empty list) or update the Fighter list from one
    frame of ground truth (reference: timeline.py:186-201).

    At frame 0 an already-populated list is returned unchanged (the
    reference appended duplicates there, reference: timeline.py:191-194).
    """
    ground_truth = sorted(ground_truth, key=lambda x: x["fighter_id"])
    if not fighters:
        for json_data in ground_truth:
            fighters.append(Fighter(frame_num=frame_number, data=json_data))
    elif frame_number == 0:
        pass
    else:
        for i, json_data in enumerate(ground_truth):
            fighters[i].update(frame_number, json_data)
    return fighters


def yield_fighters_and_stats(stats, video_path: str, label_path: str, log_offset=0):
    """Streaming (fighters, stats, frame) generator (reference: timeline.py:19-29)."""
    timeline = load_ground_truth_from_path(label_path, log_offset=log_offset)
    precompute_timeline_projection(timeline)
    fighters = [Fighter(frame_num=0, data=json_data) for json_data in timeline[0]]
    for i in range(len(timeline)):
        fighters = update_fighters_from_timeline(i, timeline[i], fighters)
        stats.record_frame(fighters)
        yield (fighters, stats, i)


def yield_interval_fighters_and_stats(stats, interval: int, video_path, label_path, log_offset=0):
    """Interval-sampled variant (reference: timeline.py:32-49)."""
    for fighters, stats, i in yield_fighters_and_stats(stats, video_path, label_path, log_offset):
        if i % interval != 0 or i == 0:
            continue
        yield (fighters, stats, i)


def load_timeline_from_ai_output(
    file_path,
    max_frames: int | None = None,
    fighter_to_player_id=None,
):
    """Synthesise log-like records from an ``ai_output.yaml`` cache, read
    without a YAML package by :func:`playaid_core_torch.infer.ai_output.read`
    (reference: timeline.py:52-105).  The reference hardcoded
    Joker/Pikachu and 600 frames; here the fighters and frame count are
    inferred from the cache when not given.
    """
    ai_output = ai_output_file.read(file_path)

    if fighter_to_player_id is None:
        names = sorted(ai_output.keys())[:2]
        if set(names) == {"Joker", "Pikachu"}:
            fighter_to_player_id = {"Pikachu": 0, "Joker": 1}
        else:
            fighter_to_player_id = {name: i for i, name in enumerate(names)}
    fighters = sorted(fighter_to_player_id, key=fighter_to_player_id.get, reverse=True)
    if max_frames is None:
        max_frames = min(len(ai_output[f]) for f in fighters)

    timeline = []
    for i in range(max_frames):
        frame_data = []
        for fighter in fighters:
            fighter_data = ai_output[fighter][i]
            base = {
                "raw_animation_frame_num": 0,
                "attack_connected": False,
                "camera_fov": 30.0,
                "camera_position": {
                    "x": 0.0002484553260728717,
                    "y": 15.847139358520508,
                    "z": 148.460693359375,
                },
                "camera_target_position": {
                    "x": 0.0002776149194687605,
                    "y": 11.162917137145996,
                    "z": 0.0,
                },
                "can_act": True,
                "damage": 0.0,
                "facing": 1.0,
                "fighter_id": fighter_to_player_id[fighter],
                "fighter_name": FIGHTER_NAME_TO_ENUM[fighter],
                "hitstun_left": 0.0,
                "motion_kind": 19292652517,
                "num_frames_left": 54000,
                "pos_x": -50.0,
                "pos_y": 0.21623137593269348,
                "shield_size": 50.0,
                "stage_id": 86,
                "status_kind": 0,
                "stock_count": 20,
            }
            base.update(fighter_data)
            frame_data.append(base)
        timeline.append(frame_data)
    return timeline


def load_ground_truth_pairings_from_file(file_path):
    """Parse a (dir, video, log, offset) pairings CSV with '#'-comment rows
    (reference: timeline.py:166-183)."""
    pairings = []
    with open(file_path, "r") as f:
        reader = csv.reader(f)
        next(reader)  # skip the header
        for row in reader:
            if any(cell.startswith("#") for cell in row):
                continue
            pairings.append((row[0], row[1], row[2], int(row[3])))
    return pairings


def cache_dataset(root_dir, char_subset=()):
    """Index a gt_action_detection tree
    ``<root>/<video>/<id>_<fighter>/{images,labels}`` (reference:
    timeline.py:108-163).

    Returns (video_to_sample, move_to_frames):
      video_to_sample[video][fighter] = [(image_path, label_path), ...]
      move_to_frames[fighter][move]   = [(video, frame_num), ...]

    Images are the ``*.jpg`` files, as in the JAX package, and the
    ``*.npy`` crops (BGR uint8, as ``imgcodec.read_crop`` reads them), in
    sorted order.
    """
    video_to_sample = {}
    move_to_frames = {}
    if not os.path.isdir(root_dir):
        return video_to_sample, move_to_frames

    for video_dir in os.scandir(root_dir):
        if not video_dir.is_dir():
            continue
        video_name = video_dir.name
        video_to_sample[video_name] = {}

        for fighter_dir in os.scandir(video_dir.path):
            if not fighter_dir.is_dir():
                continue
            # Directory structure is <fighter_id>_<fighter_name>.
            fighter_name = " ".join(fighter_dir.name.split("_")[1:]).title()
            if char_subset and fighter_name not in char_subset:
                continue
            video_to_sample[video_name][fighter_name] = []

            image_dir = os.path.join(fighter_dir.path, "images")
            label_dir = os.path.join(fighter_dir.path, "labels")
            image_files = sorted(glob.glob(os.path.join(image_dir, "*.jpg"))
                                 + glob.glob(os.path.join(image_dir, "*.npy")))
            label_files = sorted(glob.glob(os.path.join(label_dir, "*.txt")))
            video_to_sample[video_name][fighter_name].extend(list(zip(image_files, label_files)))

            for frame_num, label_file in enumerate(label_files):
                with open(label_file) as f:
                    action = f.read()
                move_to_frames.setdefault(fighter_name, {}).setdefault(action, []).append(
                    (video_name, frame_num)
                )

        if not video_to_sample[video_name]:
            del video_to_sample[video_name]

    return video_to_sample, move_to_frames


class GTVideo:
    """Random access over a (video, log) pair (reference: timeline.py:283-322),
    reading frames through the port's ``VideoReader``."""

    def __init__(self, video_path, label_path):
        self.video_path = video_path
        self.label_path = label_path
        self.fps = None
        self.ground_truth = []

    def get_fps(self):
        if self.fps is None:
            video = VideoReader(self.video_path)
            self.fps = video.fps
            video.release()
        return self.fps

    def get_frame(self, frame_number):
        video = VideoReader(self.video_path)
        ret, frame = video.read_at(frame_number)
        video.release()
        return frame

    def get_frames(self, start_frame, num_frames):
        return [self.get_frame(i) for i in range(start_frame, start_frame + num_frames)]

    def load_ground_truth(self):
        self.ground_truth = load_ground_truth_from_path(self.label_path)

    def get_ground_truth(self, start_frame, num_frames):
        """``num_frames`` is a count, matching get_frames (the reference
        treated it as an exclusive end frame here, returning mismatched
        windows for any start_frame > 0 — reference: timeline.py:313-317)."""
        if not self.ground_truth:
            self.load_ground_truth()
        return [self.ground_truth[i] for i in range(start_frame, start_frame + num_frames)]

    def get_frames_and_labels(self, start_frame, num_frames):
        return (
            self.get_frames(start_frame, num_frames),
            self.get_ground_truth(start_frame, num_frames),
        )
