#!/usr/bin/env python3
"""Write playaid_core_torch/assets/gt_digests.json: what the JAX package's
ground-truth modules give on chip_smoke.py phase 17's inputs, which phase
17 holds the port's output to on the card.

Run from the root of a checkout, where the JAX package, cv2 and pandas are
installed:

    JAX_PLATFORMS=cpu python3 tools/torch_port_gt_digests.py [--check-port]

Phase 8's scripted 480-frame log is the pairing; its frames are
chip_smoke.GtClipCapture's 1280x720 stand-ins, served through the JAX
package's VideoReader (its cv2.VideoCapture replaced by a shim over the
stand-in).  The JAX modules run as they are:

* gen_gt_action_detection.process_pairing: the crops it hands to
  cv2.imwrite (captured) and its label files, digested per fighter;
* gen_gt_char_detection.generate_data (interval 10): its label files, and
  the frames it hands to cv2.imwrite, digested;
* raw_anim_cleaner on chip_smoke.write_raw_dump's PNG files (written with
  cv2): each cleaned PNG as cv2.imread(IMREAD_UNCHANGED) decodes it;
* char_loader.CharacterLoader(seed=0) on chip_smoke.write_char_frames's PNG
  frames (written with cv2): the digest of its draws.

--check-port runs the port's side (chip_smoke.port_gt_trees, on the CPU)
and exits non-zero unless its digests equal these.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

import cv2
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from playaid_core_tpu import char_loader  # noqa: E402
from playaid_core_tpu.datagen import gen_gt_action_detection as gt_action  # noqa: E402
from playaid_core_tpu.datagen import gen_gt_char_detection as gt_char  # noqa: E402
from playaid_core_tpu.datagen import raw_anim_cleaner  # noqa: E402
from playaid_core_tpu.video import reader as jax_reader  # noqa: E402


class CvShim:
    """The calls the JAX VideoReader makes of a cv2.VideoCapture, on a
    stand-in capture (seek / read / release)."""

    def __init__(self, capture):
        self.capture = capture

    def set(self, prop, value):
        assert prop == cv2.CAP_PROP_POS_FRAMES, prop
        self.capture.seek(int(value))
        return True

    def read(self):
        return self.capture.read()

    def grab(self):
        return self.capture.read()[0]

    def release(self):
        self.capture.release()


def stand_in_reader(boxes):
    """The JAX VideoReader class, opening GtClipCapture(boxes) for any path."""

    class StandInReader(jax_reader.VideoReader):
        def __init__(self, path):
            self.path = path
            self.cap = CvShim(chip_smoke.GtClipCapture(boxes))
            self.fps, self.width, self.height = 60.0, chip_smoke.GT_W, chip_smoke.GT_H
            self.frame_count = len(boxes)
            self._pos = 0

    return StandInReader


def capture_imwrite():
    """Replace cv2.imwrite by a recorder ({path: array}); returns the dict
    and the real function."""
    seen, real = {}, cv2.imwrite

    def imwrite(path, img, *args):
        seen[str(path)] = np.array(img, copy=True)
        return True

    cv2.imwrite = imwrite
    return seen, real


def jax_digests(work):
    vods = os.path.join(work, "vods")
    boxes, csv = chip_smoke.write_gt_pairing(vods)
    reader = stand_in_reader(boxes)
    gt_action.VideoReader = gt_char.VideoReader = reader
    seen, real = capture_imwrite()
    try:
        action_root = os.path.join(work, "action", "train")
        gt_action.process_pairing(action_root, chip_smoke.GT_PAIRING, ground_truth_dir=vods)
        crops = {}
        for path, img in seen.items():
            parts = os.path.relpath(path, action_root).split(os.sep)
            crops["/".join(parts[:2] + [parts[-1][:-4]])] = img
        seen.clear()
        char_root = os.path.join(work, "char")
        gt_char.generate_data(csv, "train", interval=chip_smoke.GT_CHAR_INTERVAL,
                              output_root=char_root, ground_truth_dir=vods)
        char_frames = [(os.path.basename(p)[:-4], img) for p, img in seen.items()]
    finally:
        cv2.imwrite = real
    labels = {}
    for dirpath, _, files in os.walk(action_root):
        for name in files:
            parts = os.path.relpath(os.path.join(dirpath, name), action_root).split(os.sep)
            with open(os.path.join(dirpath, name)) as f:
                labels["/".join(parts[:2] + [name[:-4]])] = f.read()
    char_labels = {}
    for name in os.listdir(os.path.join(char_root, "train", "labels")):
        with open(os.path.join(char_root, "train", "labels", name)) as f:
            char_labels[name[:-4]] = f.read()

    raw, clean = os.path.join(work, "raw"), os.path.join(work, "clean")
    chip_smoke.write_raw_dump(raw, cv2.imwrite)
    for fighter in chip_smoke.RAW_ANIMS:
        raw_anim_cleaner.clean_all_raw_fighter_anim_data(fighter, raw_dir=raw, clean_dir=clean)
    cleaned = {}
    for dirpath, _, files in os.walk(clean):
        for name in files:
            path = os.path.join(dirpath, name)
            cleaned["/".join(os.path.relpath(path, clean).split(os.sep))] = \
                chip_smoke.digest_arrays([("png", cv2.imread(path, cv2.IMREAD_UNCHANGED))])

    chars = os.path.join(work, "chars")
    chip_smoke.write_char_frames(chars, boxes, cv2.imwrite)
    strips = chip_smoke.char_strip_digest(char_loader,
                                          char_loader.dataframe_from_directory(chars))
    return {
        "settings": {"log_frames": chip_smoke.NUM_FRAMES, "frame_size": [chip_smoke.GT_W,
                                                                         chip_smoke.GT_H],
                     "char_interval": chip_smoke.GT_CHAR_INTERVAL,
                     "raw_anims": chip_smoke.RAW_ANIMS, "raw_frames": chip_smoke.RAW_FRAMES,
                     "char_draws": chip_smoke.CHAR_DRAWS, "cv2": cv2.__version__},
        "action": chip_smoke.action_tree_digests(crops, labels),
        "char_labels": dict(sorted(char_labels.items())),
        "char_frames_sha256": chip_smoke.digest_arrays(char_frames),
        "cleaned": dict(sorted(cleaned.items())),
        "strips_sha256": strips,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=chip_smoke.GT_DIGESTS)
    p.add_argument("--check-port", action="store_true",
                   help="also run the port's side on the CPU and compare")
    args = p.parse_args(argv)
    work = tempfile.mkdtemp(prefix="gt_digests_")
    try:
        ref = jax_digests(os.path.join(work, "jax"))
        with open(args.out, "w") as f:
            json.dump(ref, f, indent=1)
            f.write("\n")
        print(f"wrote {args.out}: {sum(v['crops'] for v in ref['action'].values())} crops, "
              f"{len(ref['char_labels'])} detection frames, {len(ref['cleaned'])} cleaned "
              f"sprites")
        if args.check_port:
            got = chip_smoke.port_gt_trees(os.path.join(work, "port"))["digests"]
            bad = [k for k in got if got[k] != ref[k]]
            print("port digests equal: " + ("all" if not bad else f"not {bad}"))
            return 1 if bad else 0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
