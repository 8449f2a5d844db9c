"""Action-recognition dataset.

The port's copy of ``playaid_core_tpu/train/dataset.py`` (reference:
ult_action_dataset.py:139-689) for the ground-truth splits:

* ``split="train"/"validation"/"test"`` — crop sequences from a
  ``gt_action_detection`` tree indexed by
  :func:`playaid_core_torch.timeline.cache_dataset` (``*.jpg`` crops, or
  the port's lossless ``*.npy`` crops, which need no cv2): random fighter
  -> move -> (video, frame), middle-out window with a random frame delta,
  difficulty-staged augmentation, labels per frame with an "Unknown"
  fallback;
* the curriculum hooks ``make_synth_more_challenging`` /
  ``switch_num_frames_per_sample`` (reference: :561-567);
* ``batches()``, assembling ``[B, T, H, W, 3]`` uint8 arrays for the
  trainer's staging (uint8 is the wire format: the train step normalises
  on the device);
* :func:`get_character_actions_animations_dict`, the walk of a clean-char
  sprite tree that ``train/device_synth.py`` builds its sprite bank from,
  and :func:`get_stage_paths`, the stage screenshots that
  ``datagen/gen_synth_char_detection.py`` composites onto.

Every draw comes from the dataset's ``numpy.random.Generator`` (``seed``)
in the JAX package's order, and images are read and resized with the same
arithmetic (``imgcodec.read_crop``, ``geometry.aspect_resize`` and
``imgproc``'s ``INTER_LINEAR`` reproduce OpenCV's), so a seed gives the
JAX dataset's batches bit for bit (its float32 frames are this dataset's
uint8 frames / 255).  Augmentation (``synth_difficulty`` 1
and 2) still calls cv2 for some ops (``train/augment.py``).  The sprite
splits ``synth``, ``simple`` and ``manual`` composite with PIL and cv2 and
are not ported: they raise ``NotImplementedError``, and the constructor
takes none of their options (stage and sprite directories, the manual
CSV, sprite fill, jitter, window geometry).

Samples are (frames ``[T, H, W, 3]`` uint8 RGB, char_id, action_ids ``[T]``,
meta).
"""

from __future__ import annotations

import os

import numpy as np

from playaid_core_torch import constants, imgcodec, imgproc
from playaid_core_torch.geometry import aspect_resize
from playaid_core_torch.ops.preprocess import middle_out_frame_indices
from playaid_core_torch.timeline import cache_dataset
from playaid_core_torch.train.augment import SYNTH_DIFFICULTY_REAL, augment_char_crop

UNPORTED_SPLITS = ("synth", "simple", "manual")


def middle_out_sample(middle_frame, num_frames_per_sample, frame_delta, max_frames,
                      min_frame=0):
    """Host-side scalar middle-out sampler (the same math as the vectorised
    :func:`playaid_core_torch.ops.preprocess.middle_out_frame_indices`)."""
    return [int(v) for v in np.asarray(
        middle_out_frame_indices(middle_frame, num_frames_per_sample, frame_delta,
                                 max_frames, min_frame)
    )]


def get_stage_paths(stages_dir=None):
    """Every ``*.jpg`` under ``stages_dir`` (default
    ``constants.ULT_STAGES_DIR``), recursively, in glob's order (reference:
    dataset_utils.py:402-407)."""
    import glob

    stages_dir = stages_dir or constants.ULT_STAGES_DIR
    return glob.glob(os.path.join(stages_dir, "**/*.jpg"), recursive=True)


def get_character_actions_animations_dict(clean_char_dir=None):
    """char -> move -> body -> raw_anim -> cam -> frame paths sorted by frame
    number (reference: dataset_utils.py:429-506), from file names
    ``{char}_{body}_{anim_name}_frame_{cam}_{frame_num}``.

    Sprites are ``*.png`` files (read through cv2) or ``*.npy`` files, which
    hold what ``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` returns for the
    PNG (BGRA) and need no cv2.
    """
    from glob import glob
    from pathlib import Path

    clean_char_dir = clean_char_dir or constants.ULT_DATASET_CLEAN_CHAR_DIR
    character_animations = {}
    if not os.path.isdir(clean_char_dir):
        return character_animations

    for fighter in os.listdir(clean_char_dir):
        fighter_dir = os.path.join(clean_char_dir, fighter)
        if not os.path.isdir(fighter_dir):
            continue
        character_animations.setdefault(fighter, {})
        for move in os.listdir(fighter_dir):
            move_dir = os.path.join(fighter_dir, move)
            if not os.path.isdir(move_dir):
                continue
            character_animations[fighter].setdefault(move, {})
            for animation_file in (glob(os.path.join(move_dir, "*.png"))
                                   + glob(os.path.join(move_dir, "*.npy"))):
                attrs = Path(animation_file).stem.split("_")
                node = (
                    character_animations[fighter][move]
                    .setdefault(attrs[1], {})                   # body type
                    .setdefault("_".join(attrs[2:-2]), {})      # animation name
                    .setdefault(attrs[-2], [])                  # camera
                )
                node.append(animation_file)
            for body_type in character_animations[fighter][move].values():
                for anim_name in body_type.values():
                    for cam in anim_name:
                        anim_name[cam] = sorted(
                            anim_name[cam], key=lambda p: int(Path(p).stem.split("_")[-1]))
    return character_animations


class UltActionRecogDataset:
    def __init__(
        self,
        split,
        num_samples,
        img_dimension,
        anim_subset,
        num_frames_per_sample=constants.ACTION_RECOG_NUM_FRAMES_PER_SAMPLE,
        frame_delta=constants.ACTION_RECOG_FRAME_DELTA,
        char_subset=(),
        synth_difficulty=0,
        num_preceding_actions=8,
        crop_size=128,
        seed=None,
        gt_root_train=None,
        gt_root_val=None,
        gt_root_test=None,
    ):
        if split in UNPORTED_SPLITS:
            raise NotImplementedError(
                f"the {split!r} split composites sprites with PIL and cv2 and is not ported "
                "(ROADMAP queue 1, what is left of action-model training: the dataset's "
                "synth/simple/manual splits)")
        self.split = split
        self.num_samples = num_samples
        self.crop_size = crop_size
        self.img_dimension = img_dimension
        self.animations = list(anim_subset)
        self.characters = list(char_subset) if char_subset else list(constants.CHAR_LIST)
        self.synth_difficulty = synth_difficulty
        self.num_preceding_actions = num_preceding_actions
        self.rng = np.random.default_rng(seed)

        self.num_frames_per_sample_options = (
            [num_frames_per_sample]
            if isinstance(num_frames_per_sample, int)
            else list(num_frames_per_sample)
        )
        self.num_frames_per_sample = (
            num_frames_per_sample
            if isinstance(num_frames_per_sample, int)
            else int(self.rng.choice(self.num_frames_per_sample_options))
        )
        self.frame_deltas = frame_delta if isinstance(frame_delta, list) else [frame_delta]

        self.training_video_to_sample, self.training_move_to_frame = cache_dataset(
            gt_root_train or constants.ACTION_GROUND_TRUTH_TRAIN, self.characters
        )
        self.val_video_to_sample, self.val_move_to_frame = cache_dataset(
            gt_root_val or constants.ACTION_GROUND_TRUTH_VAL, self.characters
        )
        self.test_video_to_sample, self.test_move_to_frame = cache_dataset(
            gt_root_test or constants.ACTION_GROUND_TRUTH_TEST, self.characters
        )

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        if self.split == "train":
            return self.ground_truth(self.training_video_to_sample, self.training_move_to_frame)
        elif self.split == "validation":
            return self.ground_truth(self.val_video_to_sample, self.val_move_to_frame)
        else:
            return self.ground_truth(self.test_video_to_sample, self.test_move_to_frame)

    # ------------------------------------------------------------------
    def _label_id(self, action: str) -> int:
        if action in self.animations:
            return self.animations.index(action)
        return self.animations.index("Unknown")

    def ground_truth(self, video_to_sample, move_to_frame):
        """(reference: ult_action_dataset.py:249-371)"""
        if not move_to_frame:
            raise RuntimeError(
                "ground-truth dataset index is empty; generate gt_action_detection data first"
            )
        rng = self.rng
        fighter_name = rng.choice(sorted(move_to_frame.keys()))
        action_name = rng.choice(sorted(move_to_frame[fighter_name].keys()))
        pairs = move_to_frame[fighter_name][action_name]
        video_name, selected_frame = pairs[int(rng.integers(0, len(pairs)))]

        frame_delta = int(rng.choice(self.frame_deltas))
        samples = video_to_sample[video_name][fighter_name]
        max_frames = len(samples)

        frame_nums = middle_out_sample(
            selected_frame, self.num_frames_per_sample, frame_delta,
            max_frames=max_frames, min_frame=0,
        )

        # Preceding-action context for models that consume it (pass
        # num_preceding_actions=0 to skip these label reads).
        preceding = []
        for i in range(selected_frame - self.num_preceding_actions, selected_frame):
            _, label_path = samples[max(i, 0)]
            with open(label_path) as f:
                preceding.append(f.read())
        preceding_ids = [self._label_id(a) for a in preceding]

        frames, actions, frame_paths = [], [], []
        for frame_num in frame_nums:
            frame_path, label_path = samples[frame_num]
            frame = imgcodec.read_crop(frame_path)
            if frame is None:
                raise IOError(f"cannot read the crop {frame_path}")
            frame = np.ascontiguousarray(frame[..., ::-1])  # BGR -> RGB
            frame = aspect_resize(frame, width=self.crop_size)
            if self.synth_difficulty:
                frame = augment_char_crop(
                    frame, rng=rng, output_size=self.crop_size,
                    **SYNTH_DIFFICULTY_REAL[self.synth_difficulty],
                )
            if frame.shape[:2] != (self.crop_size, self.crop_size):
                frame = imgproc.resize(frame, (self.crop_size, self.crop_size), "linear")
            with open(label_path) as f:
                action = f.read()
            frames.append(frame)
            actions.append(action)
            frame_paths.append(frame_path)

        input_frames = np.asarray(frames, dtype=np.uint8)
        anim_label = np.asarray([self._label_id(a) for a in actions], dtype=np.int32)
        char_id = np.int32(self.characters.index(fighter_name))
        meta = {
            "char": fighter_name,
            "frame_paths": [os.path.basename(p) for p in frame_paths],
            "actions": actions,
            "frame_delta": frame_delta,
            "preceding_actions": preceding,
            "preceding_actions_ids": np.asarray(preceding_ids, dtype=np.int32),
        }
        return input_frames, char_id, anim_label, meta

    # ---------------- curriculum hooks (reference: :561-567) ----------------

    def make_synth_more_challenging(self):
        if self.synth_difficulty < 2:
            self.synth_difficulty += 1

    def switch_num_frames_per_sample(self):
        self.num_frames_per_sample = int(self.rng.choice(self.num_frames_per_sample_options))

    # ---------------- batch assembly ----------------

    def batches(self, batch_size, num_batches=None):
        """Yield (frames [B,T,H,W,3], char_ids [B], labels [B,T]) host arrays."""
        count = 0
        idx = 0
        total = num_batches if num_batches is not None else max(self.num_samples // batch_size, 1)
        while count < total:
            frames, chars, labels = [], [], []
            for _ in range(batch_size):
                f, c, a, _meta = self[idx]
                idx += 1
                frames.append(f)
                chars.append(c)
                labels.append(a)
            yield (
                np.stack(frames),
                np.asarray(chars, dtype=np.int32),
                np.stack(labels),
            )
            count += 1
