"""AI inference from pixels alone: detection cleanup, batched action
recognition and damage OCR for one VOD.

Counterpart of ``AIRunner`` in ``playaid_core_tpu/infer/runner.py``
(reference: ai_runner.py:136-620), with the same behaviour and the same
cache layout under ``<AI_CACHE>/<parent>/<video>/``: YOLOv5 label files
(1-indexed), crops per fighter, ``ai_output.yaml``.  What differs is what
the card's machine lacks (no cv2, PIL, yaml or click):

* crops made by the port (its detector, gap interpolation, head and tail
  fill) are kept without loss as ``crops/<fighter>/<video>_<n>.npy``; jpg
  crops of an external YOLOv5 are read through ``imgcodec`` (cv2);
* frames come through the capture seam (``video/reader.py``);
* ``ai_output.yaml`` is written by ``infer/ai_output.py``;
* the colour signature is a 4x4x4 histogram by ``np.bincount``.

Recognition embeds every crop once on the device (``embed_crops_u8``,
ResNet-18 with the fused residual-block kernel on the card) and labels all
frames with ``classify_sequence`` (argmax or Viterbi); OCR reads the HUD
with the conv digit net on the device.  Weights go to the device once,
when the runner is made.

Command line (the card unless ``--device cpu``)::

    python -m playaid_core_torch.infer.runner --video V [--checkpoint C] [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import sys
from collections import defaultdict
from datetime import datetime

import numpy as np
import torch

from playaid_core_torch import constants, imgcodec, imgproc
from playaid_core_torch.adict import Dict
from playaid_core_torch.geometry import YoloCrop, aspect_resize
from playaid_core_torch.infer import ai_output
from playaid_core_torch.infer.detection import (
    ExternalYoloDetector,
    extract_number_from_filename,
    read_fighter_yolo_crop,
    read_yolo_crops,
)
from playaid_core_torch.infer.ocr import PLAYER_DAMAGE_CROPS
from playaid_core_torch.infer.ocr_conv import ConvDigitOCR
from playaid_core_torch.infer.pipeline import BatchedActionPipeline
from playaid_core_torch.ontology import MOVE_TO_CLASS_ID
from playaid_core_torch.video.reader import VideoReader

CROP_EXTENSIONS = (".npy", ".jpg")


class AIRunner:
    """Runs tracking cleanup, action recognition and damage OCR for one VOD.

    ``pipeline`` defaults to the CNN family on ``device`` (the CUDA device
    unless ``device="cpu"``; it raises without one).  ``variables`` (a JAX
    numpy tree or the port's state dicts) are loaded into the pipeline's
    modules here, once.  The cleanup options are the JAX runner's.
    """

    def __init__(
        self,
        input_video_path: str,
        debug: bool = False,
        detector=None,
        pipeline: BatchedActionPipeline | None = None,
        variables=None,
        fighters=None,
        crop_padding=30,
        max_center_jump=0.08,
        fix_swaps=False,
        appearance_check=True,
        smooth_radius=0,
        decode="argmax",
        switch_cost=4.0,
        device=None,
        **dataset_args,
    ):
        self.input_video_path = input_video_path
        self.src_folder, self.file_name = os.path.split(input_video_path)
        self.video_name, _ = os.path.splitext(self.file_name)
        parent_folder = os.path.basename(self.src_folder)
        self.exp_name = os.path.join(parent_folder, self.video_name)
        self.yolo_output_dir = os.path.join(constants.AI_CACHE, self.exp_name)
        self.ai_output_file = os.path.join(self.yolo_output_dir, "ai_output.yaml")
        self.crops_dir = os.path.join(self.yolo_output_dir, "crops")
        self.labels_dir = os.path.join(self.yolo_output_dir, "labels")
        self.dataset_args = dataset_args

        self.actions = list(MOVE_TO_CLASS_ID.keys())
        self.pipeline = pipeline or BatchedActionPipeline(
            family="cnn",
            num_actions=len(self.actions),
            sequence_length=dataset_args.get("num_frames_per_sample", 7),
            frame_delta=dataset_args.get("frame_delta", 3),
            device=device,
        )
        if variables is not None:
            self.pipeline.load_variables(variables)
        self.device = self.pipeline.device

        # crop_padding: square_crop padding of re-cropped (interpolated)
        # frames, the detector's framing; max_center_jump: per-frame
        # normalised centre-distance budget of the continuity filter (None
        # or 0 turns it off); fix_swaps: joint identity-swap rewriting
        # (opt-in); appearance_check: the colour-signature identity filter;
        # smooth_radius, decode, switch_cost: the label decode.
        self.crop_padding = crop_padding
        self.max_center_jump = max_center_jump
        self.fix_swaps = fix_swaps
        self.appearance_check = appearance_check
        self.smooth_radius = smooth_radius
        self.decode = decode
        self.switch_cost = switch_cost
        self.detector = detector or ExternalYoloDetector()
        res, self.ai_output_data = self.load_ai_output()

        self.debug = debug
        date_time_str = datetime.now().strftime("%Y-%m-%d-%H:%M:%S")
        self.debug_path = os.path.join(self.yolo_output_dir, f"debug-{date_time_str}")
        if self.debug and not os.path.exists(self.debug_path):
            os.makedirs(self.debug_path)

        self.reader = VideoReader(input_video_path)
        self._forced_fighters = fighters
        self.fighters = []
        self.max_frames = 0

    # ------------------------------------------------------------------
    # Detection + crop cleanup (reference: ai_runner.py:181-424)
    # ------------------------------------------------------------------

    def run_detection_setup(self):
        self.detector.run(self.input_video_path, self.exp_name)
        self.fighters = self._forced_fighters or [
            f for f in os.listdir(self.crops_dir)
            if os.path.isdir(os.path.join(self.crops_dir, f))
        ]
        self.clean_yolo_crops()

    def clean_yolo_crops(self):
        num_fighters = len(
            [f for f in os.listdir(self.crops_dir)
             if os.path.isdir(os.path.join(self.crops_dir, f))]
        )
        if num_fighters != 2:
            raise RuntimeError(
                f"Detected {num_fighters} characters; exactly 2 are required"
            )

        last_frame_path = self.get_label_paths()[-1]
        self.max_frames = extract_number_from_filename(last_frame_path)

        # Remove spurious high-numbered crops left by double detections
        # (reference: ai_runner.py:246-257).
        for fighter in self.fighters:
            for crop_path in reversed(self.get_crop_paths(fighter)):
                if extract_number_from_filename(crop_path) <= self.max_frames:
                    break
                os.unlink(crop_path)

        # A label file for every frame (reference: :259-265).
        for i in range(1, self.max_frames):
            path = self.get_label_path(i)
            if not os.path.exists(path):
                with open(path, "w"):
                    pass

        if self.appearance_check and len(self.fighters) == 2:
            self.appearance_identity_filter()
        if self.fix_swaps and self.max_center_jump and len(self.fighters) == 2:
            self.fix_identity_swaps()
        for fighter in self.fighters:
            if self.max_center_jump:
                self.suppress_center_jumps(fighter)
            self.clean_yolo_crops_for_fighter(fighter)

        # Tail fill: repeat the last crop up to the last frame recognition
        # reads (reference: :271-289).  The JAX runner stops at the last
        # crop of either fighter, so when the filters above clear both
        # fighters' last frames, recognition reads a crop that is not there
        # (ROADMAP.md, queue 3).
        fighter_to_max = {
            fighter: extract_number_from_filename(self.get_crop_paths(fighter)[-1])
            for fighter in self.fighters
        }
        max_frames = max(max(fighter_to_max.values()), self.max_frames)
        for fighter, last_frame_num in fighter_to_max.items():
            num_remaining = max_frames - last_frame_num
            if not num_remaining:
                continue
            last_frame = imgcodec.read_crop(self.get_crop_paths(fighter)[-1])
            for i in range(last_frame_num, last_frame_num + num_remaining):
                self.write_crop(fighter, i, last_frame)

        # Head fill: a fighter first detected at frame k > 1 gets its first
        # crop repeated over frames 1..k-1 (recognition reads every frame).
        for fighter in self.fighters:
            first_path = self.get_crop_paths(fighter)[0]
            first_frame_num = extract_number_from_filename(first_path)
            if first_frame_num <= 1:
                continue
            first_frame = imgcodec.read_crop(first_path)
            for i in range(1, first_frame_num):
                self.write_crop(fighter, i, first_frame)

    def get_label_path(self, frame_num):
        return os.path.join(self.labels_dir, f"{self.video_name}_{frame_num}.txt")

    def get_crop_path(self, fighter, frame_num):
        """The frame's crop file: the one that exists (``.npy`` of the
        port, or ``.jpg`` of an external YOLOv5), else the ``.npy`` path a
        new crop is written to."""
        stem = os.path.join(self.crops_dir, fighter, f"{self.video_name}_{frame_num}")
        for ext in CROP_EXTENSIONS:
            if os.path.exists(stem + ext):
                return stem + ext
        return stem + CROP_EXTENSIONS[0]

    def get_label_paths(self):
        label_paths = glob.glob(os.path.join(self.labels_dir, "*.txt"))
        return sorted(label_paths, key=extract_number_from_filename)

    def get_crop_paths(self, fighter):
        crop_paths = [p for ext in CROP_EXTENSIONS
                      for p in glob.glob(os.path.join(self.crops_dir, fighter, "*" + ext))]
        return sorted(crop_paths, key=extract_number_from_filename)

    def write_crop(self, fighter, frame_num, crop):
        """Keep a crop the port made, without loss, replacing any other
        file of that frame."""
        path = self.get_crop_path(fighter, frame_num)
        if not path.endswith(".npy"):
            os.unlink(path)
            path = os.path.splitext(path)[0] + ".npy"
        np.save(path, crop)

    def _crop_signature(self, path):
        """Coarse colour signature (4x4x4 histogram of the crop's centre)
        for appearance-based identity checks."""
        img = imgcodec.read_crop(path)
        if img is None:
            return None
        h, w = img.shape[:2]
        center = img[h // 4: 3 * h // 4, w // 4: 3 * w // 4]
        bins = (center.reshape(-1, 3) // 64).astype(np.int64)
        hist = np.bincount(bins[:, 0] * 16 + bins[:, 1] * 4 + bins[:, 2],
                           minlength=64).astype(np.float32)
        total = hist.sum()
        return hist / total if total else None

    def appearance_identity_filter(self, margin=0.25):
        """A detection whose crop looks decisively like the OTHER fighter
        (closer to the other's median signature by ``margin``, L1 on
        normalised histograms) is removed, so gap interpolation refills it;
        the filter stands down when the medians are within ``margin``."""
        f0, f1 = self.fighters
        sigs = {f0: [], f1: []}
        per_frame = {f0: {}, f1: {}}
        for f in (f0, f1):
            for crop_path in self.get_crop_paths(f):
                frame = extract_number_from_filename(crop_path)
                s = self._crop_signature(crop_path)
                if s is not None:
                    sigs[f].append(s)
                    per_frame[f][frame] = s
        if len(sigs[f0]) < 8 or len(sigs[f1]) < 8:
            return
        med = {}
        for f in (f0, f1):
            m = np.median(np.stack(sigs[f]), axis=0)
            t = m.sum()
            med[f] = m / t if t else m

        def dist(a, b):
            return float(np.abs(a - b).sum())

        if dist(med[f0], med[f1]) < margin:
            return  # appearances not separable; appearance says nothing
        removed = {f0: 0, f1: 0}
        for f, other in ((f0, f1), (f1, f0)):
            for frame, s in per_frame[f].items():
                if dist(s, med[other]) + margin < dist(s, med[f]):
                    label_path = self.get_label_path(frame)
                    if os.path.exists(label_path):
                        self._remove_fighter_line(label_path, f)
                    crop_path = self.get_crop_path(f, frame)
                    if os.path.exists(crop_path):
                        os.unlink(crop_path)
                    removed[f] += 1
                    # Never strip a fighter's track entirely.
                    if removed[f] >= len(per_frame[f]) - 8:
                        break

    def _remove_fighter_line(self, label_path, fighter):
        class_id = constants.CHAR_LIST.index(fighter)
        crops = [c for c in read_yolo_crops(label_path) if c.class_id != class_id]
        with open(label_path, "w") as f:
            f.write("\n".join(str(c) for c in crops) + ("\n" if crops else ""))

    def _swap_frame_labels(self, label_path, frame):
        """Exchange the two fighters' class ids in one frame's labels and
        swap their crop files."""
        f0, f1 = self.fighters
        id0 = constants.CHAR_LIST.index(f0)
        id1 = constants.CHAR_LIST.index(f1)
        crops = read_yolo_crops(label_path)
        for c in crops:
            if c.class_id == id0:
                c.class_id = id1
            elif c.class_id == id1:
                c.class_id = id0
        with open(label_path, "w") as f:
            f.write("\n".join(str(c) for c in crops) + "\n")
        p0 = self.get_crop_path(f0, frame)
        p1 = self.get_crop_path(f1, frame)
        # Each file keeps its own extension when it changes fighter.
        q0 = os.path.join(os.path.dirname(p1), os.path.basename(p0))
        q1 = os.path.join(os.path.dirname(p0), os.path.basename(p1))
        if os.path.exists(p0) and os.path.exists(p1):
            tmp = p0 + ".swap"
            os.rename(p0, tmp)
            os.rename(p1, q1)
            os.rename(tmp, q0)
        elif os.path.exists(p0):
            os.rename(p0, q0)
        elif os.path.exists(p1):
            os.rename(p1, q1)

    def fix_identity_swaps(self, margin=0.05, max_run=20):
        """Joint two-fighter identity assignment by track continuity: a
        short run of frames where both detections jump onto the other's
        track (a detector flip) is swapped back; a persistent run
        (> ``max_run``) re-anchors the tracks instead.  Frames with
        duplicates or both detections on one fighter never update the
        tracks."""
        f0, f1 = self.fighters
        id0 = constants.CHAR_LIST.index(f0)
        id1 = constants.CHAR_LIST.index(f1)

        def dist(a, b):
            return abs(a.center_x - b.center_x) + abs(a.center_y - b.center_y)

        last = {f0: None, f1: None}
        last_frame = None
        run = []  # [(label_path, frame)] of buffered crossed frames

        def flush_run(apply):
            if apply:
                for path, fr in run:
                    self._swap_frame_labels(path, fr)
            run.clear()

        for label_path in self.get_label_paths():
            frame = extract_number_from_filename(label_path)
            all_crops = read_yolo_crops(label_path)
            per_class = {id0: [], id1: []}
            for c in all_crops:
                if c.class_id in per_class:
                    per_class[c.class_id].append(c)
            if len(per_class[id0]) != 1 or len(per_class[id1]) != 1:
                continue
            c0, c1 = per_class[id0][0], per_class[id1][0]
            if dist(c0, c1) < 0.1:
                continue
            if last[f0] and last[f1]:
                gap = max(frame - last_frame, 1)
                budget = self.max_center_jump * gap + 0.02
                direct = dist(c0, last[f0]) + dist(c1, last[f1])
                swapped = dist(c0, last[f1]) + dist(c1, last[f0])
                crossed = (
                    direct > 0.2
                    and swapped < 0.5 * direct
                    and swapped + margin < direct
                    # Both tracks jump (a label swap, not a pass-through);
                    # only run entry is gated, `last` is frozen in a run.
                    and (run or (dist(c0, last[f0]) > budget
                                 and dist(c1, last[f1]) > budget))
                )
                if crossed:
                    run.append((label_path, frame))
                    if len(run) > max_run:
                        # Persistent: the track is wrong, not the frames.
                        flush_run(apply=False)
                        last[f0], last[f1] = c0, c1
                        last_frame = frame
                    continue  # crossed frames never update the track
                flush_run(apply=True)  # a transient flip ended: rewrite it
            last[f0], last[f1] = c0, c1
            last_frame = frame
        flush_run(apply=len(run) <= max_run)

    def suppress_center_jumps(self, fighter, stable_n=8):
        """Identity-continuity filter: a detection whose centre jumps
        implausibly far from the last accepted one is cleared (gap
        interpolation refills it), unless it sits alone and ``stable_n``
        consistent rejected positions form a new track (a respawn); one on
        top of another class's detection is always rejected."""
        class_id = constants.CHAR_LIST.index(fighter)
        last = None
        last_frame = None
        pending = None  # (crop, frame) of the last rejected detection
        pending_run = 0
        for label_path in self.get_label_paths():
            frame = extract_number_from_filename(label_path)
            mine = [c for c in read_yolo_crops(label_path)
                    if c.class_id == class_id]
            if not mine:
                continue
            if len(mine) > 1:
                continue  # a duplicate: the dedup pass resolves it
            crop = mine[0]
            if last is not None:
                gap = max(frame - last_frame, 1)
                allowed = self.max_center_jump * gap + 0.02
                dist = abs(crop.center_x - last.center_x) + abs(
                    crop.center_y - last.center_y
                )
                if dist > allowed:
                    on_other = any(
                        abs(crop.center_x - o.center_x)
                        + abs(crop.center_y - o.center_y) < 0.04
                        for o in read_yolo_crops(label_path)
                        if o.class_id != crop.class_id
                    )
                    if on_other:
                        pending, pending_run = None, 0
                    else:
                        consistent = pending is not None and (
                            abs(crop.center_x - pending[0].center_x)
                            + abs(crop.center_y - pending[0].center_y)
                            <= self.max_center_jump
                            * max(frame - pending[1], 1) + 0.02
                        )
                        pending_run = pending_run + 1 if consistent else 1
                        pending = (crop, frame)
                        if pending_run >= stable_n:
                            # A stable new track: accept it (teleport).
                            last, last_frame = crop, frame
                            pending, pending_run = None, 0
                            continue
                    self._remove_fighter_line(label_path, fighter)
                    crop_path = self.get_crop_path(fighter, frame)
                    if os.path.exists(crop_path):
                        os.unlink(crop_path)
                    continue
            last, last_frame = crop, frame
            pending, pending_run = None, 0

    def clean_yolo_crops_for_fighter(self, fighter):
        """Duplicate suppression + gap interpolation
        (reference: ai_runner.py:306-424)."""
        crop_paths = self.get_crop_paths(fighter)
        label_paths = self.get_label_paths()

        # Nearest-to-previous-centre duplicate suppression.
        previous_class_id_to_crop = {}
        for label_path in label_paths:
            class_id_to_crop = defaultdict(list)
            for crop in read_yolo_crops(label_path):
                class_id_to_crop[crop.class_id].append(crop)

            found_duplicate = False
            for class_id, crops in class_id_to_crop.items():
                if len(crops) > 1 and class_id in previous_class_id_to_crop:
                    found_duplicate = True
                    prev = previous_class_id_to_crop[class_id]
                    nearest = min(
                        crops,
                        key=lambda c: abs(c.center_x - prev.center_x)
                        + abs(c.center_y - prev.center_y),
                    )
                    class_id_to_crop[class_id] = [nearest]

            new_yolo_strings = []
            for class_id, crops in class_id_to_crop.items():
                if len(crops) > 1:
                    crops = crops[:1]  # no previous reference: keep the first
                    class_id_to_crop[class_id] = crops
                new_yolo_strings.append(str(crops[0]))
                previous_class_id_to_crop[class_id] = crops[0]

            if not found_duplicate:
                continue
            with open(label_path, "w") as f:
                f.write("\n".join(new_yolo_strings) + "\n")

        # Interpolate missed detections, re-cropping from the frames.
        latest_seen_frame = extract_number_from_filename(label_paths[0])
        for crop_path in crop_paths:
            current_frame = extract_number_from_filename(crop_path)
            if current_frame - latest_seen_frame > 1:
                latest_label = self.get_label_path(latest_seen_frame)
                current_label = self.get_label_path(current_frame)
                start_crop = read_fighter_yolo_crop(latest_label, fighter)
                end_crop = read_fighter_yolo_crop(current_label, fighter)
                assert end_crop, f"missing end crop {current_label} for {fighter}"
                if start_crop is None:
                    # A leading gap: backfill from the first detection.
                    start_crop = end_crop

                for j in range(latest_seen_frame + 1, current_frame):
                    if read_fighter_yolo_crop(self.get_label_path(j), fighter):
                        continue
                    interp_percent = (current_frame - j) / (current_frame - latest_seen_frame)
                    interp_crop = start_crop.interp(end_crop, percent=interp_percent)

                    with open(self.get_label_path(j), "a") as f:
                        f.write(str(interp_crop) + "\n")

                    ok, input_frame = self.reader.read_at(j)
                    if not ok:
                        previous = self.get_crop_path(fighter, j - 1)
                        shutil.copy(previous, os.path.splitext(self.get_crop_path(fighter, j))[0]
                                    + os.path.splitext(previous)[1])
                        continue
                    ok, crop = interp_crop.square_crop(
                        input_frame, self.pipeline.crop_size, padding=self.crop_padding,
                    )
                    assert ok, f"Failed to get square crop from frame {j}"
                    self.write_crop(fighter, j, crop)

            latest_seen_frame = current_frame

    # ------------------------------------------------------------------
    # Batched action recognition (replaces reference: ai_runner.py:426-520)
    # ------------------------------------------------------------------

    def _load_crop(self, path, output_size=None):
        """A cached crop, BGR, at the model's input size."""
        if output_size is None:
            output_size = self.pipeline.crop_size
        frame = imgcodec.read_crop(path)
        assert frame is not None, f"Failed to read crop {path}"
        frame = aspect_resize(frame, width=output_size)
        if frame.shape[0] != output_size or frame.shape[1] != output_size:
            frame = imgproc.pad(frame, (output_size, output_size))
        return frame

    def ensure_variables(self, rng_seed=0):
        if not self.pipeline.initialized:
            print(
                "WARNING: no trained weights provided; using random "
                "initialization (predicted actions will be meaningless). "
                "Pass variables= or a --checkpoint.",
                file=sys.stderr,
            )
            self.pipeline.init(rng_seed)

    def run_action_recognition(self, overwrite=False, embed_batch=256):
        """Classify every frame of every fighter: crops go to the device in
        ``embed_batch``-sized uint8 slices (BGR flip and /255 there), are
        embedded once, and every frame's window is classified at once."""
        self.ensure_variables()
        for fighter in self.fighters:
            if not overwrite and self.ai_output_data[fighter][0].action:
                continue

            frame_nums = list(range(1, self.max_frames))
            embeddings = []
            for start in range(0, len(frame_nums), embed_batch):
                batch_nums = frame_nums[start:start + embed_batch]
                crops_u8 = np.stack([self._load_crop(self.get_crop_path(fighter, i))
                                     for i in batch_nums])
                embeddings.append(self.pipeline.embed_crops_u8(
                    torch.from_numpy(crops_u8).to(self.device)))
            embeddings = torch.cat(embeddings)

            # min_frame=0: crop file 1 is row 0 of the sequence.
            labels, conf, raw = self.pipeline.classify_sequence(
                embeddings, min_frame=0, smooth_radius=self.smooth_radius,
                decode=self.decode, switch_cost=self.switch_cost, return_raw=True,
            )
            labels = labels.cpu().numpy()
            conf = conf.cpu().numpy()
            raw_labels = (raw.cpu().numpy()
                          if self.smooth_radius or self.decode != "argmax" else None)

            last_crop = None
            for pos, frame_num in enumerate(frame_nums):
                crop = read_fighter_yolo_crop(self.get_label_path(frame_num), fighter)
                # Tail-filled frames have crops but no label entry: carry
                # the last known crop forward.
                crop = crop or last_crop
                last_crop = crop
                frame_data = self.ai_output_data[fighter][frame_num - 1]
                if crop is not None:
                    frame_data.crop = str(crop)
                frame_data.action = self.actions[int(labels[pos])]
                frame_data.predicted_action_confidence = float(conf[pos])
                if raw_labels is not None:
                    frame_data.action_raw = self.actions[int(raw_labels[pos])]

    # ------------------------------------------------------------------
    # Damage OCR (reference: ai_runner.py:522-590)
    # ------------------------------------------------------------------

    def determine_player_id_to_fighter(self):
        """The left-most detection in the first frame with two is player 0
        (reference: ai_runner.py:522-535, generalised)."""
        self.player_id_to_fighter = {}
        for path in self.get_label_paths():
            crops = read_yolo_crops(path)
            if len(crops) == 2:
                ordered = sorted(crops, key=lambda c: c.center_x)
                for pid, crop in enumerate(ordered):
                    if 0 <= crop.class_id < len(constants.CHAR_LIST):
                        self.player_id_to_fighter[pid] = constants.CHAR_LIST[crop.class_id]
                if len(self.player_id_to_fighter) == 2:
                    return self.player_id_to_fighter
        for pid, fighter in enumerate(self.fighters[:2]):
            self.player_id_to_fighter[pid] = fighter
        return self.player_id_to_fighter

    def run_damage_detection(self, ocr=None, smooth=5):
        """Read both players' HUD damage on every frame: ``ocr`` is any
        ``(bgr_crop) -> (ok, (value, raw, confidence, details))``, the conv
        digit reader on the runner's device by default.  Returns the number
        of confident readings."""
        self.determine_player_id_to_fighter()
        ocr = ocr or ConvDigitOCR(device=self.device)
        num_confident = 0
        for i, input_frame in self.reader.iter_frames(0, self.max_frames):
            for player_id, params in PLAYER_DAMAGE_CROPS.items():
                damage_img = YoloCrop(**params).crop_img(input_frame)
                res, (damage, raw, confidence, details) = ocr(damage_img)
                num_confident += int(res)
                if self.debug:
                    np.save(os.path.join(
                        self.debug_path,
                        f"{i}_p{player_id}_{'_' if res else 'FAIL_'}{damage}_{raw}.npy"),
                        damage_img)
                fighter = self.player_id_to_fighter[player_id]
                self.ai_output_data[fighter][i].damage = damage
        if smooth and smooth > 1:
            self.smooth_damage(window=smooth)
        return num_confident

    def smooth_damage(self, window=5):
        """Temporal median over each fighter's damage track: exact at step
        boundaries of a step function, and it erases isolated misreads."""
        half = window // 2
        for fighter, per_frame in self.ai_output_data.items():
            frames = sorted(k for k, v in per_frame.items()
                            if isinstance(v, dict) and "damage" in v)
            vals = {i: per_frame[i].damage for i in frames}
            usable = [i for i in frames if vals[i] is not None]
            if len(usable) < window:
                continue
            smoothed = {}
            for i in frames:
                neigh = [vals[j] for j in range(i - half, i + half + 1)
                         if j in vals and vals[j] is not None]
                if neigh:
                    smoothed[i] = float(np.median(neigh))
            for i, v in smoothed.items():
                per_frame[i].damage = v

    # ------------------------------------------------------------------
    # ai_output.yaml cache (reference: ai_runner.py:592-608)
    # ------------------------------------------------------------------

    def load_ai_output(self):
        if not os.path.exists(self.ai_output_file):
            return False, Dict()
        try:
            return True, Dict(ai_output.read(self.ai_output_file))
        except Exception:  # noqa: BLE001 - an unreadable cache is recomputed, as in the JAX runner
            return False, Dict()

    def write_output(self):
        os.makedirs(self.yolo_output_dir, exist_ok=True)
        ai_output.write(self.ai_output_file, self.ai_output_data.to_dict())


def main(argv=None):
    """``ai-runner``: detection cleanup, action recognition and damage OCR
    for one VOD (reference: ai_runner.py:611-622), on the card unless
    ``--device cpu``."""
    parser = argparse.ArgumentParser(
        prog="python -m playaid_core_torch.infer.runner",
        description="Per-frame actions and damage of both fighters, from pixels alone.")
    parser.add_argument("--video", "-v", required=True, help="Path to video")
    parser.add_argument("--checkpoint", "-c", default=None,
                        help="reference Lightning .ckpt, or a state-dict file of "
                             "BatchedActionPipeline.save_checkpoint")
    parser.add_argument("--family", default="cnn", choices=["cnn", "resformer", "rnn"])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device; 'cpu' runs the plain "
                             "PyTorch versions)")
    args = parser.parse_args(argv)
    pipeline = BatchedActionPipeline(family=args.family, num_actions=len(MOVE_TO_CLASS_ID),
                                     device=args.device)
    if args.checkpoint:
        pipeline.load_checkpoint(args.checkpoint)
    runner = AIRunner(input_video_path=args.video, debug=True, pipeline=pipeline)
    runner.run_detection_setup()
    runner.run_action_recognition()
    runner.write_output()
    runner.run_damage_detection()
    runner.write_output()
    print("COMPLETED")


if __name__ == "__main__":
    main()
