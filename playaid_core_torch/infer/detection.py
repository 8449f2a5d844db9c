"""Character detection for the pixels-only path, and the YOLO label files.

Counterpart of ``playaid_core_tpu/infer/detection.py``:

* the label helpers, byte for byte (reference: ai_runner.py:37-94);
* :class:`ExternalYoloDetector`, the subprocess seam to a YOLOv5 checkout
  (its crops are jpg files; the runner reads them through
  :mod:`playaid_core_torch.imgcodec`, which needs cv2);
* :class:`CharacterDetector`, the counterpart of ``JaxCharacterDetector``:
  the port's CenterNet (``train/detector_train.py``) over frames read
  through the capture seam in batches of 16, with the class restriction,
  the opt-in tracking prior, 1-indexed label files and the
  label-implies-crop invariant.  Its crops are kept without loss, as
  ``.npy`` files beside where the jpg files of the YOLOv5 layout go;
* :class:`ProjectionDetector`, crops from an ult_logger log with no
  detector at all.
"""

from __future__ import annotations

import os
import re
import subprocess

import numpy as np

from playaid_core_torch import constants
from playaid_core_torch.geometry import YoloCrop


def extract_number_from_filename(filename: str) -> int:
    """Trailing number before the extension (reference: ai_runner.py:37-50)."""
    match = re.search(r"(\d+)(?=\.\w+$)", filename)
    if match:
        return int(match.group(1))
    raise ValueError(f"Cannot get number from filename {filename}")


def read_fighter_yolo_crop(label_path, fighter):
    """First crop in a label file whose class id matches ``fighter``
    (reference: ai_runner.py:53-71)."""
    class_id = constants.CHAR_LIST.index(fighter)
    return next((c for c in read_yolo_crops(label_path) if c.class_id == class_id), None)


def read_yolo_crops(label_path):
    """Every crop of a label file, one ``class cx cy w h confidence`` line
    each (reference: ai_runner.py:74-94)."""
    with open(label_path) as file:
        lines = file.readlines()
    for line in lines:
        assert len(line.split(" ")) == 6, f"Too much data for line: {line} in label {label_path}"
    return [YoloCrop.from_string(line) for line in lines]


class ExternalYoloDetector:
    """Subprocess seam to an external detector (reference: ai_runner.py:191-224).

    Produces crops/labels under ``<ai_cache>/<exp_name>/`` in YOLOv5
    --save-crop/--save-txt layout.  Idempotent: skipped when the crops dir
    already exists.
    """

    def __init__(self, weights=None, yolo_dir=None, classes=(2, 3), max_det=2):
        self.weights = weights or os.path.join(
            constants.SAVED_YOLO_MODELS, "byleth-diddy-pikachu-joker-july-31-2023.pt"
        )
        self.yolo_dir = yolo_dir or constants.YOLO_DIR
        self.classes = classes
        self.max_det = max_det

    def run(self, input_video_path, exp_name):
        crops_dir = os.path.join(constants.AI_CACHE, exp_name, "crops")
        if os.path.exists(crops_dir):
            return exp_name
        command = [
            "python",
            os.path.join(self.yolo_dir, "detect.py"),
            "--weights", self.weights,
            "--source", input_video_path,
            "--project", constants.AI_CACHE,
            "--name", exp_name,
            "--max-det", str(self.max_det),
            "--save-crop", "--save-txt", "--save-conf", "--exist-ok",
            "--classes", *[str(c) for c in self.classes],
        ]
        subprocess.run(command, check=True)
        return exp_name


class CharacterDetector:
    """The port's CenterNet detector writing the ``crops/`` + ``labels/``
    cache of the YOLOv5 layout, with lossless ``.npy`` crops.

    ``trainer``: a :class:`playaid_core_torch.train.detector_train.DetectorTrainer`
    holding weights.  ``classes``: the allowed class ids (the reference's
    YOLO ``classes={2, 3}``); ``track_weight`` > 0 turns on the tracking
    prior (off by default, as in the JAX package: a prior seeded by one
    wrong peak locks onto it).
    """

    def __init__(self, trainer, char_list=None, score_threshold=0.3, max_det=4,
                 crop_size=128, crop_padding=30, batch_size=16, classes=None,
                 track_weight=0.0, track_slack=0.08):
        self.trainer = trainer
        self.char_list = char_list or constants.CHAR_LIST
        self.score_threshold = score_threshold
        self.max_det = max_det
        self.crop_size = crop_size
        self.crop_padding = crop_padding
        self.batch_size = batch_size
        self.track_weight = track_weight
        self.track_slack = track_slack
        self._last_center = {}
        self.classes = set(classes) if classes is not None else None

    def run(self, input_video_path, exp_name):
        from playaid_core_torch.video.reader import VideoReader

        base = os.path.join(constants.AI_CACHE, exp_name)
        crops_dir = os.path.join(base, "crops")
        labels_dir = os.path.join(base, "labels")
        if os.path.exists(crops_dir):
            return exp_name
        os.makedirs(labels_dir, exist_ok=True)
        video_name = os.path.splitext(os.path.basename(input_video_path))[0]
        self._last_center = {}  # per-video tracking state

        reader = VideoReader(input_video_path)
        frames, indices = [], []

        def flush():
            if not frames:
                return
            batch = np.stack(frames)
            results = self.trainer.detect(
                batch[..., ::-1], max_det=self.max_det, score_threshold=self.score_threshold,
                classes=sorted(self.classes) if self.classes is not None else None,
            )
            for img, frame_idx, dets in zip(batch, indices, results):
                # YOLO numbering is 1-indexed.
                label_path = os.path.join(labels_dir, f"{video_name}_{frame_idx + 1}.txt")
                lines = []
                by_class = {}
                for class_id, score, box in dets:
                    if not (0 <= class_id < len(self.char_list)):
                        continue
                    if self.classes is not None and class_id not in self.classes:
                        continue
                    by_class.setdefault(class_id, []).append((score, box))
                for class_id, cands in by_class.items():
                    # Tracking prior: score less a penalty for the distance
                    # to the class's last confirmed centre.
                    last = self._last_center.get(class_id)

                    def penalized(sb, _last=last):
                        score, box = sb
                        if _last is None:
                            return score
                        d = abs(box[0] - _last[0]) + abs(box[1] - _last[1])
                        return score - max(0.0, d - self.track_slack) * self.track_weight

                    for score, box in sorted(cands, key=penalized, reverse=True):
                        crop = YoloCrop(*box, confidence=score, class_id=class_id)
                        ok, crop_img = crop.square_crop(
                            img, self.crop_size, padding=self.crop_padding
                        )
                        if not ok:
                            # Keep the label-implies-crop invariant the
                            # runner's cleanup relies on.
                            continue
                        self._last_center[class_id] = (box[0], box[1])
                        lines.append(str(crop))
                        fdir = os.path.join(crops_dir, self.char_list[class_id])
                        os.makedirs(fdir, exist_ok=True)
                        np.save(os.path.join(fdir, f"{video_name}_{frame_idx + 1}.npy"), crop_img)
                        break
                if lines:
                    with open(label_path, "w") as f:
                        f.write("\n".join(lines) + "\n")
            frames.clear()
            indices.clear()

        try:
            for i, frame in reader.iter_frames():
                frames.append(frame)
                indices.append(i)
                if len(frames) >= self.batch_size:
                    flush()
            flush()
        finally:
            reader.release()
        return exp_name


class ProjectionDetector:
    """Detection-free crops from an ult_logger log via batched camera
    projection.  Returns per-frame {fighter_name: YoloCrop}."""

    def __init__(self, label_path, log_offset=0):
        from playaid_core_torch.timeline import (
            load_ground_truth_from_path,
            precompute_timeline_projection,
            update_fighters_from_timeline,
        )

        self.timeline = load_ground_truth_from_path(label_path, log_offset=log_offset)
        precompute_timeline_projection(self.timeline)
        self._update = update_fighters_from_timeline
        self.fighters = []

    def __len__(self):
        return len(self.timeline)

    def crops_for_frame(self, frame_number):
        self.fighters = self._update(frame_number, self.timeline[frame_number], self.fighters)
        return {f.fighter_name: f.crop for f in self.fighters}
