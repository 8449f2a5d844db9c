"""Action-recognition dataset.

The port's copy of ``playaid_core_tpu/train/dataset.py`` (reference:
ult_action_dataset.py:139-689):

* ``split="train"/"validation"/"test"`` — crop sequences from a
  ``gt_action_detection`` tree indexed by
  :func:`playaid_core_torch.timeline.cache_dataset` (``*.jpg`` crops, or
  the port's lossless ``*.npy`` crops, which need no cv2): random fighter
  -> move -> (video, frame), middle-out window with a random frame delta,
  difficulty-staged augmentation, labels per frame with an "Unknown"
  fallback;
* ``split="synth"`` — synthetic composites: random animation clips of a
  clean-char sprite tree (:func:`get_character_actions_animations_dict`)
  concatenated into a mini-timeline, a consecutive or middle-out window of
  it pasted over a random crop of a stage texture (:func:`get_stage_paths`)
  with the sprite fill, centre jitter, per-clip augmentation and moving or
  re-drawn backgrounds of the JAX split (reference:
  ult_action_dataset.py:569-689);
* ``split="simple"`` — the two-class sanity set, and ``split="manual"`` —
  crops cut from a manually annotated video through ``video.reader`` and
  ``geometry.YoloCrop`` (the video needs a decoder: cv2 or the native one;
  the card's machine has neither);
* the curriculum hooks ``make_synth_more_challenging`` /
  ``switch_num_frames_per_sample`` (reference: :561-567);
* ``batches()``, assembling ``[B, T, H, W, 3]`` uint8 arrays for the
  trainer's staging (uint8 is the wire format: the train step normalises
  on the device).

Sprites are ``*.png`` (read through cv2) or ``*.npy`` (BGRA, what
``cv2.imread(..., IMREAD_UNCHANGED)`` gives for the PNG); stages are
``*.jpg`` (read through PIL) or ``*.npy`` (BGR, what ``cv2.imread`` gives).
Every draw comes from the dataset's ``numpy.random.Generator`` (``seed``)
in the JAX package's order, and images are cropped, resized, augmented and
pasted with the same arithmetic (``imgproc`` reproduces the OpenCV and PIL
calls), so a seed gives the JAX dataset's samples bit for bit: its float32
frames are this dataset's uint8 frames / 255.  Only the synth split's JPEG
degrade (``synth_frame_degrade > 0``) calls a codec, cv2's, and raises an
``ImportError`` naming cv2 where it is not installed.

Samples are (frames ``[T, H, W, 3]`` uint8 RGB, char_id, action_ids ``[T]``,
meta).
"""

from __future__ import annotations

import functools
import os

import numpy as np

from playaid_core_torch import constants, imgcodec, imgproc
from playaid_core_torch.geometry import aspect_resize
from playaid_core_torch.ops.preprocess import middle_out_frame_indices
from playaid_core_torch.timeline import cache_dataset
from playaid_core_torch.train.augment import (
    SYNTH_DIFFICULTY_REAL,
    SYNTH_DIFFICULTY_SPRITE,
    augment_char_crop,
    augment_synth_char_crop,
)


def middle_out_sample(middle_frame, num_frames_per_sample, frame_delta, max_frames,
                      min_frame=0):
    """Host-side scalar middle-out sampler (the same math as the vectorised
    :func:`playaid_core_torch.ops.preprocess.middle_out_frame_indices`)."""
    return [int(v) for v in np.asarray(
        middle_out_frame_indices(middle_frame, num_frames_per_sample, frame_delta,
                                 max_frames, min_frame)
    )]


def random_crop_pil_image(img, x, y, rng):
    """A random ``x`` x ``y`` window of an image array, as PIL's ``crop``
    cuts it (zeros off the image), and its upper-left corner."""
    height, width = img.shape[:2]
    x1 = int(rng.integers(0, max(width - x, 1)))
    y1 = int(rng.integers(0, max(height - y, 1)))
    return imgproc.crop(img, (x1, y1, x1 + x, y1 + y)), (x1, y1)


def slightly_move_crop_pil_image(img, x, y, upper_left, move_range, rng):
    """The window at ``upper_left`` moved by up to ``move_range`` pixels."""
    height, width = img.shape[:2]
    x_off = int(rng.integers(-move_range, move_range))
    y_off = int(rng.integers(-move_range, move_range))
    x1 = max(0, min(upper_left[0] + x_off, width - x))
    y1 = max(0, min(upper_left[1] + y_off, height - y))
    return imgproc.crop(img, (x1, y1, x1 + x, y1 + y)), (x1, y1)


def get_stage_paths(stages_dir=None):
    """Every ``*.jpg`` under ``stages_dir`` (default
    ``constants.ULT_STAGES_DIR``), recursively, in glob's order (reference:
    dataset_utils.py:402-407), then every ``*.npy`` (a stage texture as
    ``cv2.imread`` gives it, BGR)."""
    import glob

    stages_dir = stages_dir or constants.ULT_STAGES_DIR
    return (glob.glob(os.path.join(stages_dir, "**/*.jpg"), recursive=True)
            + glob.glob(os.path.join(stages_dir, "**/*.npy"), recursive=True))


def load_stage(stage_path):
    """A stage texture as an RGB uint8 array: a ``.npy`` (BGR) flipped, an
    image file as ``Image.open(path).convert("RGB")`` gives it (an
    ``ImportError`` naming PIL where PIL is not installed)."""
    if stage_path.endswith(".npy"):
        return np.ascontiguousarray(np.load(stage_path)[..., ::-1])
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"reading the stage image {stage_path} needs PIL, which is not "
                          "installed; give stages as .npy files") from e
    with Image.open(stage_path) as im:
        return np.array(im.convert("RGB"))


@functools.lru_cache(maxsize=64)
def _load_stage_cached(stage_path):
    """Decoded-stage cache: synth sampling re-draws from a handful of
    stage textures.  Callers must not write to the array (crop first)."""
    return load_stage(stage_path)


@functools.lru_cache(maxsize=None)
def _load_sprite_rgba_cached(frame_path):
    sprite = imgcodec.read_sprite(frame_path)
    if sprite is None:
        raise IOError(f"cannot read the sprite {frame_path}")
    return sprite


def _load_sprite_rgba(frame_path):
    """Decoded-sprite cache, unbounded as the JAX one (a sprite set fits in
    memory, and a bounded cache smaller than it misses under random
    sampling).  Returns a copy (augments write to it)."""
    return _load_sprite_rgba_cached(frame_path).copy()


def load_and_composite_sprite(frame_path, stage_crop, synth_difficulty, rng,
                              fill=1.0, center_jitter=0, aug_rng=None,
                              extra_shift=(0, 0)):
    """Paste an (augmented) sprite mostly centred onto a copy of an RGB
    stage crop (reference: ult_action_dataset.py:97-136), as the JAX
    function pastes it with PIL: the sprite is scaled so its long side is
    ``fill`` of the crop's, placed at the centre plus a per-clip offset
    (``center_jitter``, or +/-40 px at a non-zero difficulty without one)
    and ``extra_shift``, and blended by its alpha.  ``aug_rng``: the
    difficulty pipeline's generator, re-seeded identically for every frame
    of a clip so its draws agree across the window."""
    out = np.array(stage_crop, copy=True)
    height, width = out.shape[:2]
    char_frame = _load_sprite_rgba(frame_path)
    draw = aug_rng if aug_rng is not None else rng
    if synth_difficulty:
        char_frame = augment_synth_char_crop(
            char_frame, rng=draw, **SYNTH_DIFFICULTY_SPRITE[synth_difficulty]
        )
    if char_frame.shape[0] > char_frame.shape[1]:
        char_frame = aspect_resize(char_frame, height=max(int(height * fill), 1))
    else:
        char_frame = aspect_resize(char_frame, width=max(int(width * fill), 1))
    char_frame = char_frame[..., [2, 1, 0, 3]]  # BGRA -> RGBA
    paste_x = (width - char_frame.shape[1]) // 2
    paste_y = (height - char_frame.shape[0]) // 2
    if synth_difficulty:
        lim = center_jitter if center_jitter else 40
        paste_x += int(draw.integers(-lim, lim + 1))
        paste_y += int(draw.integers(-lim, lim + 1))
    elif center_jitter:
        paste_x += int(draw.integers(-center_jitter, center_jitter + 1))
        paste_y += int(draw.integers(-center_jitter, center_jitter + 1))
    return imgproc.paste(out, char_frame, (paste_x + extra_shift[0],
                                           paste_y + extra_shift[1]))


def jpeg_degrade(frame, quality):
    """An RGB frame through cv2's JPEG encoder at ``quality`` and back (the
    original frame when encoding fails); an ``ImportError`` naming cv2 where
    it is not installed."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("the synth split's JPEG degrade (synth_frame_degrade > 0) needs "
                          "cv2's codec, which is not installed") from e
    ok, buf = cv2.imencode(".jpg", frame[:, :, ::-1], [cv2.IMWRITE_JPEG_QUALITY, quality])
    return cv2.imdecode(buf, cv2.IMREAD_COLOR)[:, :, ::-1] if ok else frame


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
        randomize_stage_background=False,
        move_stage_background=False,
        synth_difficulty=0,
        num_preceding_actions=8,
        crop_size=128,
        seed=None,
        gt_root_train=None,
        gt_root_val=None,
        gt_root_test=None,
        stages_dir=None,
        clean_char_dir=None,
        manual_ground_truth_csv=None,
        manual_ground_truth_video=None,
        manual_split="train",
        synth_sprite_fill=(1.0, 1.0),
        synth_center_jitter=0,
        synth_frame_degrade=0.0,
        synth_window="consecutive",
        synth_window_delta=1,
        synth_cycle_repeats=(1, 2),
    ):
        self.split = split
        self.num_samples = num_samples
        self.crop_size = crop_size
        self.img_dimension = img_dimension
        self.animations = list(anim_subset)
        self.characters = list(char_subset) if char_subset else list(constants.CHAR_LIST)
        self.randomize_stage_background = randomize_stage_background
        self.move_stage_background = move_stage_background
        self.synth_difficulty = synth_difficulty
        self.num_preceding_actions = num_preceding_actions
        self.synth_sprite_fill = synth_sprite_fill
        self.synth_center_jitter = synth_center_jitter
        self.synth_frame_degrade = synth_frame_degrade
        # synth_window: how a T-frame window is drawn from the mini-timeline:
        # "consecutive" (the reference's T consecutive animation frames) or
        # "middleout" (the inference geometry, offsets
        # synth_window_delta * (mid - i)^2 around an interior centre);
        # synth_cycle_repeats repeats each move's cycle 1-2x in a middle-out
        # mini-timeline, as a move persists over several cycles in play.
        self.synth_window = synth_window
        self.synth_window_delta = synth_window_delta
        self.synth_cycle_repeats = synth_cycle_repeats
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

        self.stage_paths = get_stage_paths(stages_dir)
        self.char_anim_dict = get_character_actions_animations_dict(clean_char_dir)

        self.training_video_to_sample, self.training_move_to_frame = cache_dataset(
            gt_root_train or constants.ACTION_GROUND_TRUTH_TRAIN, self.characters
        )
        self.val_video_to_sample, self.val_move_to_frame = cache_dataset(
            gt_root_val or constants.ACTION_GROUND_TRUTH_VAL, self.characters
        )
        self.test_video_to_sample, self.test_move_to_frame = cache_dataset(
            gt_root_test or constants.ACTION_GROUND_TRUTH_TEST, self.characters
        )

        # Manually annotated clip labels (reference:
        # ult_action_dataset.py:207-225, :512-559): a CSV of (frame, fighter,
        # action, cx, cy, w, h) rows over one video, split into thirds by
        # line number.
        self.manual_ground_truth_video = (
            manual_ground_truth_video or constants.GROUND_TRUTH_VIDEO
        )
        self.manual_labels, self.manual_action_to_frames = ({}, {})
        if manual_ground_truth_csv and os.path.exists(manual_ground_truth_csv):
            with open(manual_ground_truth_csv) as f:
                num_lines = len(f.readlines())
            thirds = {
                "train": range(2, num_lines // 3 + 1),
                "validation": range(num_lines // 3 + 1, num_lines // 3 * 2 + 1),
                "test": range(num_lines // 3 * 2 + 1, num_lines + 1),
            }
            self.manual_labels, self.manual_action_to_frames = (
                self.load_ground_truth_labels(
                    manual_ground_truth_csv, set(thirds[manual_split])
                )
            )

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        if self.split == "synth":
            return self.get_synth(idx)
        if self.split == "simple":
            return self.simple_dataset(idx)
        if self.split == "manual":
            return self.manual_ground_truth(idx)
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

    def get_synth(self, idx):
        """Synthetic mini-timeline composites (reference:
        ult_action_dataset.py:569-689)."""
        rng = self.rng
        available = [c for c in self.characters if c in self.char_anim_dict]
        if not available or not self.stage_paths:
            raise RuntimeError("synthetic assets (clean char dir / stages) not available")
        char = rng.choice(available)
        char_label = self.characters.index(char)

        body_types = set()
        for move in self.char_anim_dict[char].values():
            body_types.update(move.keys())
        body_type = rng.choice(sorted(body_types))

        t = self.num_frames_per_sample
        mid = t // 2
        max_off = self.synth_window_delta * mid * mid
        # middleout windows span +/-max_off around an interior centre.
        min_len = (2 * max_off + 1) if self.synth_window == "middleout" else t

        mini_frames, mini_actions = [], []
        i = 0
        while i < 2 or len(mini_frames) < min_len:
            action = None
            while not action:
                selected_action = rng.choice(self.animations)
                if selected_action == "Unknown":
                    extra = sorted(set(self.char_anim_dict[char].keys()) - set(self.animations))
                    if extra:
                        action = rng.choice(extra)
                elif selected_action in self.char_anim_dict[char]:
                    action = selected_action
            node = self.char_anim_dict[char][action]
            if body_type not in node:
                body_type = rng.choice(sorted(node.keys()))
            raw_anim = rng.choice(sorted(node[body_type].keys()))
            cam = rng.choice(sorted(node[body_type][raw_anim].keys()))
            animation_frames = node[body_type][raw_anim][cam]
            lo, hi = self.synth_cycle_repeats
            repeats = (int(rng.integers(lo, hi + 1))
                       if self.synth_window == "middleout" and hi > lo else 1)
            label = action if action in self.animations else "Unknown"
            for _ in range(repeats):
                mini_frames.extend(animation_frames)
                mini_actions.extend([label] * len(animation_frames))
            i += 1

        num_frames = len(mini_frames)
        if self.synth_window == "middleout":
            center = int(rng.integers(max_off, num_frames - max_off))
            offs = [self.synth_window_delta * (mid - j) ** 2 for j in range(t)]
            idx = [center - offs[j] if j <= mid else center + offs[j] for j in range(t)]
            clip_paths = [mini_frames[j] for j in idx]
            clip_actions = [mini_actions[j] for j in idx]
        else:
            # high inclusive: a mini-timeline of exactly T frames is valid.
            last_frame = int(rng.integers(t, num_frames + 1))
            clip_paths = mini_frames[last_frame - t : last_frame]
            clip_actions = mini_actions[last_frame - t : last_frame]

        stage_path = rng.choice(self.stage_paths)
        stage = _load_stage_cached(stage_path)
        stage_cropped, ul = random_crop_pil_image(
            stage, self.img_dimension, self.img_dimension, rng
        )

        frames = []
        # One fill per clip (+/- a small per-frame jitter), one JPEG quality
        # per clip, and one augmentation seed per clip: every frame re-seeds
        # an identical generator, so the window has one appearance.
        fill_base = float(rng.uniform(*self.synth_sprite_fill))
        fill_lo, fill_hi = self.synth_sprite_fill
        degrade_clip = self.synth_frame_degrade and rng.random() < self.synth_frame_degrade
        jpeg_q = int(rng.integers(40, 92)) if degrade_clip else None
        aug_seed = int(rng.integers(2**31))
        for frame_path in clip_paths:
            if self.randomize_stage_background:
                stage_path = rng.choice(self.stage_paths)
                stage = _load_stage_cached(stage_path)
                stage_cropped, ul = random_crop_pil_image(
                    stage, self.img_dimension, self.img_dimension, rng
                )
            elif self.move_stage_background:
                stage_cropped, ul = slightly_move_crop_pil_image(
                    _load_stage_cached(stage_path),
                    self.img_dimension, self.img_dimension, ul, 10, rng,
                )
            fill = float(np.clip(fill_base + rng.uniform(-0.04, 0.04),
                                 fill_lo, fill_hi)) if fill_hi > fill_lo else fill_base
            frame = load_and_composite_sprite(
                frame_path, stage_cropped, self.synth_difficulty, rng, fill=fill,
                center_jitter=self.synth_center_jitter,
                aug_rng=np.random.default_rng(aug_seed),
                extra_shift=(int(rng.integers(-3, 4)), int(rng.integers(-3, 4))),
            )
            if degrade_clip:
                frame = jpeg_degrade(frame, jpeg_q)
            frames.append(frame)

        input_frames = np.asarray(frames, dtype=np.uint8)
        anim_label = np.asarray([self._label_id(a) for a in clip_actions], dtype=np.int32)
        meta = {"char": char, "frame_paths": clip_paths, "actions": clip_actions}
        return input_frames, np.int32(char_label), anim_label, meta

    def simple_dataset(self, idx):
        """Two-class RNN sanity set (reference: ult_action_dataset.py:373-427):
        alternating windows of two moves with a stray centre frame, so a
        temporal model must use context to classify the middle frame."""
        char = next(iter(self.char_anim_dict))
        moves = sorted(self.char_anim_dict[char].keys())
        if len(moves) < 2:
            raise RuntimeError("simple mode needs >= 2 moves of sprite assets")

        def frames_for(move):
            body = self.char_anim_dict[char][move]
            bt = sorted(body.keys())[0]
            anim = sorted(body[bt].keys())[0]
            cam = sorted(body[bt][anim].keys())[0]
            return body[bt][anim][cam]

        a_frames, b_frames = frames_for(moves[0]), frames_for(moves[1])
        center = a_frames[len(a_frames) // 2]
        picked_move = moves[0] if idx % 2 else moves[1]
        source = a_frames if idx % 2 else b_frames
        batch = [source[0], center, source[-1]]
        actions = [picked_move] * 3

        stage = load_stage(self.stage_paths[0])
        stage_cropped = imgproc.crop(stage, (0, 0, self.img_dimension, self.img_dimension))
        frames = [load_and_composite_sprite(p, stage_cropped, 0, self.rng) for p in batch]
        input_frames = np.asarray(frames, dtype=np.uint8)
        anim_label = np.asarray([self._label_id(a) for a in actions], dtype=np.int32)
        char_id = np.int32(self.characters.index(char) if char in self.characters else 0)
        return input_frames, char_id, anim_label, {"char": char, "actions": actions}

    @staticmethod
    def load_ground_truth_labels(csv_path, line_numbers):
        """Parse the manual-annotation CSV rows whose 1-based line numbers
        are in ``line_numbers`` (reference: ult_action_dataset.py:512-559)."""
        import csv as _csv
        from collections import defaultdict

        labels = defaultdict(dict)
        action_to_frames = {}
        with open(csv_path) as f:
            reader = _csv.reader(f)
            for row in reader:
                if reader.line_num == 1 or reader.line_num not in line_numbers:
                    continue
                frame_num = int(row[0])
                fighter_name = row[1]
                action = row[2]
                cx, cy, w, h = (float(v) for v in row[3:7])
                labels[fighter_name][frame_num] = (
                    frame_num, fighter_name, action, cx, cy, w, h,
                )
                action_to_frames.setdefault(fighter_name, defaultdict(list))[
                    action
                ].append(frame_num)
        return dict(labels), {k: dict(v) for k, v in action_to_frames.items()}

    def manual_ground_truth(self, idx):
        """Samples from the manually annotated clip (reference:
        ult_action_dataset.py:429-510): trailing-window frame sampling,
        crops cut live from the source video."""
        if not self.manual_action_to_frames:
            raise RuntimeError("manual mode needs manual_ground_truth_csv")
        from playaid_core_torch.geometry import YoloCrop
        from playaid_core_torch.video.reader import VideoReader

        rng = self.rng
        fighter_name = rng.choice(sorted(self.manual_action_to_frames.keys()))
        candidates = [
            a for a, frames in self.manual_action_to_frames[fighter_name].items()
            if a != "Unknown" and frames
        ]
        selected_action = rng.choice(sorted(candidates))
        frames_for_action = self.manual_action_to_frames[fighter_name][selected_action]
        last_frame = frames_for_action[int(rng.integers(0, len(frames_for_action)))]

        valid = sorted(self.manual_labels[fighter_name].keys())
        # Trailing-window sampler (reference: dataset_utils.py:76-106).
        frame_nums = []
        delta = int(rng.choice(self.frame_deltas))
        for i in range(0, self.num_frames_per_sample * delta, delta):
            cand = last_frame - i
            frame_nums.append(cand if cand in valid else frame_nums[-1] if frame_nums
                              else last_frame)
        frame_nums.reverse()

        reader = VideoReader(self.manual_ground_truth_video)
        frames, actions = [], []
        try:
            for fn in frame_nums:
                ok, frame = reader.read_at(fn)
                if not ok:
                    raise IOError(f"requested invalid frame {fn} from ground truth")
                frame = np.ascontiguousarray(frame[..., ::-1])  # BGR -> RGB
                _, _, action, cx, cy, w, h = self.manual_labels[fighter_name][fn]
                ok, crop = YoloCrop(cx, cy, w, h).square_crop(frame, self.crop_size)
                frames.append(crop)
                actions.append(action)
        finally:
            reader.release()

        input_frames = np.asarray(frames, dtype=np.uint8)
        anim_label = np.asarray([self._label_id(a) for a in actions], dtype=np.int32)
        char_id = np.int32(
            self.characters.index(fighter_name) if fighter_name in self.characters else 0
        )
        return input_frames, char_id, anim_label, {
            "char": fighter_name,
            "actions": actions,
            "frame_nums": frame_nums,
        }

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
