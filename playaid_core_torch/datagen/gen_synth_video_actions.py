"""Generate synthetic gameplay videos with AVA-format action annotations.

The port's copy of ``playaid_core_tpu/datagen/gen_synth_video_actions.py``
(reference: data_gen_scripts/gen_synth_video_actions.py:1-371): two
characters tick through animation sequences over a stage background;
frames plus AVA-style annotations are written:

  annotations/{split}.csv        video,frame,x1,y1,x2,y2,class,player rows
  frames/{split}.txt             header 'original_vido_id video_id frame_id
                                 path labels' (misspelling preserved — it is
                                 part of the AVA format the SlowFast loaders
                                 expect)
  annotations/label_map_file.pbtxt / excluded.csv

Sprites are ``*.png`` or ``*.npy`` (BGRA) files read through
``imgcodec.read_sprite``; stages are ``*.jpg`` or ``*.npy`` files read
through ``train.dataset.load_stage`` and resized with PIL's bicubic filter
(``imgproc.resize_bicubic``).  The same seed gives the JAX module's
annotations and frames.  Frames are written as jpg files through cv2,
which is imported there: the module imports on a machine without cv2 (the
card's), where writing a frame raises an ``ImportError`` that names it.
The command line parses with argparse.
"""

from __future__ import annotations

import argparse
import os
import shutil
from glob import glob

import numpy as np

from playaid_core_torch import constants, imgcodec, imgproc
from playaid_core_torch.geometry import aspect_resize
from playaid_core_torch.ontology import MOVE_TO_CLASS_ID
from playaid_core_torch.train.dataset import get_stage_paths, load_stage


def get_character_animations_flat(clean_char_dir=None):
    """char -> {move: [frame paths]}, each move's ``*.png`` and ``*.npy``
    files in sorted order (reference: dataset_utils.py:410-426 returns a
    flat list; here grouped by move)."""
    clean_char_dir = clean_char_dir or constants.ULT_DATASET_CLEAN_CHAR_DIR
    out = {}
    if not os.path.isdir(clean_char_dir):
        return out
    for fighter in os.listdir(clean_char_dir):
        fdir = os.path.join(clean_char_dir, fighter)
        if not os.path.isdir(fdir):
            continue
        moves = {}
        for move in os.listdir(fdir):
            mdir = os.path.join(fdir, move)
            if os.path.isdir(mdir):
                frames = sorted(glob(os.path.join(mdir, "*.png"))
                                + glob(os.path.join(mdir, "*.npy")))
                if frames:
                    moves[move] = frames
        if moves:
            out[fighter] = moves
    return out


def _write_jpg(path, image):
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"writing the frame {path} needs cv2, which is not installed") from e
    cv2.imwrite(path, image)


class SynthCharacter:
    """One synthetic fighter: position, current move and animation cursor
    (reference: gen_synth_video_actions.py:70-188)."""

    def __init__(self, fighter_name, x, y, char_animations, rng, scale_range=(80, 200)):
        self.fighter_name = fighter_name
        self.x = x
        self.y = y
        self.rng = rng
        self.animations = char_animations[fighter_name]
        self.scale = int(rng.integers(*scale_range))
        self.move = None
        self.frames = []
        self.cursor = 0
        self.sprite = None
        self.next_move()

    def next_move(self):
        self.move = self.rng.choice(sorted(self.animations.keys()))
        self.frames = self.animations[self.move]
        self.cursor = 0

    def tick(self):
        if self.cursor >= len(self.frames):
            self.next_move()
        path = self.frames[self.cursor]
        self.cursor += 1
        sprite = imgcodec.read_sprite(path)
        self.sprite = None if sprite is None else aspect_resize(sprite, width=self.scale)

    def label(self):
        return MOVE_TO_CLASS_ID.get(self.move, 0)

    def bbox_pixels(self):
        h, w = self.sprite.shape[:2]
        return (self.x - w // 2, self.y - h // 2, w, h)

    def bbox_yolo_norm(self, width, height):
        x, y, w, h = self.bbox_pixels()
        # AVA uses x1,y1,x2,y2 normalized.
        return (
            max(0.0, x / width),
            max(0.0, y / height),
            min(1.0, (x + w) / width),
            min(1.0, (y + h) / height),
        )

    def composite_onto(self, canvas):
        if self.sprite is None:
            return
        x, y, w, h = self.bbox_pixels()
        fh, fw = canvas.shape[:2]
        vy0, vy1 = max(0, y), min(fh, y + h)
        vx0, vx1 = max(0, x), min(fw, x + w)
        if vy1 <= vy0 or vx1 <= vx0:
            return
        region = self.sprite[vy0 - y : vy1 - y, vx0 - x : vx1 - x]
        alpha = region[:, :, 3:4].astype(np.float32) / 255.0
        canvas[vy0:vy1, vx0:vx1, :3] = (
            region[:, :, :3].astype(np.float32) * alpha
            + canvas[vy0:vy1, vx0:vx1, :3].astype(np.float32) * (1 - alpha)
        ).astype(np.uint8)


class SynthVideoGenerator:
    def __init__(self, num_videos_per_split=None, overwrite=False, video_length=60,
                 width=1280, height=960, seed=0, output_root=None, stages_dir=None,
                 clean_char_dir=None, char_list=None):
        self.num_videos_per_split = num_videos_per_split or {
            "train": 1000, "validation": 32, "test": 32,
        }
        self.video_length = video_length
        self.width = width
        self.height = height
        self.rng = np.random.default_rng(seed)
        self.root = output_root or constants.SYNTH_ACTION_RECOGNITON_DIR
        self.frames_dir = os.path.join(self.root, "frames")
        self.annotations_dir = os.path.join(self.root, "annotations")
        self.stage_paths = get_stage_paths(stages_dir)
        self.char_animations = get_character_animations_flat(clean_char_dir)
        self.char_list = char_list or [
            c for c in constants.CHAR_LIST if c in self.char_animations
        ]
        self.video_id = 0
        if overwrite and os.path.exists(self.root):
            shutil.rmtree(self.root)
        os.makedirs(self.frames_dir, exist_ok=True)
        os.makedirs(self.annotations_dir, exist_ok=True)

    def init_characters(self, num_characters):
        characters = []
        for _ in range(num_characters):
            cx = int(self.rng.normal(self.width / 2, self.width / 6))
            cy = int(self.rng.normal(self.height / 2, self.height / 6))
            if cx < 0 or cx > self.width:
                cx = self.width // 2
            if cy < 0 or cy > self.height:
                cy = self.height // 2
            name = self.rng.choice(self.char_list)
            characters.append(
                SynthCharacter(name, cx, cy, self.char_animations, self.rng)
            )
        return characters

    def gen_frames(self, split, video_index):
        csv_path = os.path.join(self.annotations_dir, split + ".csv")
        txt_path = os.path.join(self.frames_dir, split + ".txt")
        video_name = f"video_{video_index}"
        out_dir = os.path.join(self.frames_dir, video_name)
        os.makedirs(out_dir, exist_ok=True)

        stage = load_stage(self.rng.choice(self.stage_paths))
        stage = imgproc.resize_bicubic(stage, (self.width, self.height))[:, :, ::-1].copy()
        characters = self.init_characters(2)

        if not os.path.exists(txt_path):
            with open(txt_path, "w") as f:
                # Misspelled header is part of the AVA format.
                f.write("original_vido_id video_id frame_id path labels\n")

        for frame_num in range(1, self.video_length + 1):
            canvas = stage.copy()
            for ch in characters:
                ch.tick()
                ch.composite_onto(canvas)
            file_name = f"{video_name}_{frame_num:06d}.jpg"
            _write_jpg(os.path.join(out_dir, file_name), canvas)

            with open(csv_path, "a") as f:
                for player_id, ch in enumerate(characters):
                    if ch.sprite is None:
                        continue
                    x1, y1, x2, y2 = ch.bbox_yolo_norm(self.width, self.height)
                    f.write(
                        f"{video_name}, {frame_num}, {x1}, {y1}, {x2}, {y2}, "
                        f"{ch.label()}, {player_id}\n"
                    )
            with open(txt_path, "a") as f:
                for ch in characters:
                    f.write(
                        f"{video_name} {self.video_id} {frame_num} "
                        f'{os.path.join(video_name, file_name)} ""\n'
                    )

    def on_complete(self):
        with open(os.path.join(self.annotations_dir, "excluded.csv"), "w"):
            pass
        with open(os.path.join(self.annotations_dir, "label_map_file.pbtxt"), "w") as f:
            for move, label_id in MOVE_TO_CLASS_ID.items():
                f.write("item {\n")
                f.write(f'  name: "{move}"\n')
                f.write(f"  id: {label_id}\n")
                f.write("}\n")

    def generate(self):
        if not self.stage_paths or not self.char_animations:
            raise RuntimeError("stage/sprite assets not available")
        for split, count in self.num_videos_per_split.items():
            for _ in range(count):
                self.gen_frames(split, self.video_id)
                self.video_id += 1
        self.on_complete()


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m playaid_core_torch.datagen.gen_synth_video_actions",
        description="Write synthetic AVA-format action videos under "
                    "SYNTH_ACTION_RECOGNITON_DIR.")
    p.add_argument("--train", default=1000, type=int)
    p.add_argument("--val", default=32, type=int)
    p.add_argument("--test", default=32, type=int)
    p.add_argument("--video-length", default=60, type=int)
    args = p.parse_args(argv)
    SynthVideoGenerator(
        {"train": args.train, "validation": args.val, "test": args.test},
        video_length=args.video_length,
    ).generate()
    print("🎉 COMPLETED 🎉")


if __name__ == "__main__":
    main()
