"""Generate the per-fighter action-crop training tree from (video, log)
pairings.

The port's copy of ``playaid_core_tpu/datagen/gen_gt_action_detection.py``
(reference: data_gen_scripts/gen_gt_action_detection.py:26-116): for each
pairing, replay the timeline and write
``<split>/<video>/<fighter_id>_<fighter_name>/{images,labels}/NNNNNN.{jpg,txt}``
with 128px square crops and action-string labels.  Idempotent per video
directory; a thread pool over pairings, sized to the host's cores.

Frames come through ``video/reader.VideoReader`` (the capture seam:
``video/reader.open_capture``), crops from
``YoloCrop.square_crop`` on the host, as in the JAX module.  ``fmt="jpg"``
writes the crops through cv2, as the JAX module does; ``fmt="npy"`` writes
the exact arrays that the JAX module hands to ``cv2.imwrite``, needs no
cv2, and ``timeline.cache_dataset`` reads them.  The command line parses
with argparse.
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor

from playaid_core_torch import constants, imgcodec
from playaid_core_torch.timeline import (
    load_ground_truth_from_path,
    load_ground_truth_pairings_from_file,
    precompute_timeline_projection,
    update_fighters_from_timeline,
)
from playaid_core_torch.video.reader import VideoReader

OUTPUT_DIMENSION = 128
CROP_PADDING = 30
FORMATS = ("jpg", "npy")


def check_fmt(fmt):
    """Refuse a crop format other than jpg (through cv2) and npy."""
    if fmt not in FORMATS:
        raise ValueError(f"fmt must be one of {FORMATS}, got {fmt!r}")


def process_pairing(sub_dir, pairing, ground_truth_dir=None, overwrite=False, fmt="jpg"):
    """Write one pairing's crops and labels under ``sub_dir``; the number
    of crops written (0 when the video's first fighter directory exists and
    ``overwrite`` is off)."""
    check_fmt(fmt)
    ground_truth_dir = ground_truth_dir or constants.GROUND_TRUTH_DIR
    dir_name, video_name, log_name, log_offset = pairing
    video_path = os.path.join(ground_truth_dir, dir_name, video_name)
    label_path = os.path.join(ground_truth_dir, dir_name, log_name)

    reader = VideoReader(video_path)
    timeline = load_ground_truth_from_path(label_path, log_offset=log_offset)
    precompute_timeline_projection(timeline)
    max_frames = min(reader.frame_count, len(timeline))

    fighters = []
    written = 0
    for i, input_frame in reader.iter_frames(0, max_frames):
        fighters = update_fighters_from_timeline(i, timeline[i], fighters)

        for j, fighter in enumerate(fighters):
            anim_dir = os.path.join(
                sub_dir, dir_name,
                f"{fighter.fighter_id}_{fighter.fighter_name.lower().replace(' ', '_')}",
            )
            if i == 0 and j == 0 and os.path.exists(anim_dir) and not overwrite:
                reader.release()
                return 0

            ok, crop = fighter.crop.square_crop(
                input_frame, OUTPUT_DIMENSION, padding=CROP_PADDING
            )
            if not ok:
                # Fighter offscreen.
                continue

            images_dir = os.path.join(anim_dir, "images")
            labels_dir = os.path.join(anim_dir, "labels")
            os.makedirs(images_dir, exist_ok=True)
            os.makedirs(labels_dir, exist_ok=True)

            imgcodec.write_image(os.path.join(images_dir, f"{str(i).zfill(6)}.{fmt}"), crop)
            with open(os.path.join(labels_dir, f"{str(i).zfill(6)}.txt"), "w") as f:
                f.write(fighter.action or "Undefined")
            written += 1
    reader.release()
    return written


def generate_data(pairings_file, sub_dir_name, output_root=None, workers=None, fmt="jpg",
                  ground_truth_dir=None):
    """Every pairing of ``pairings_file`` under ``output_root/sub_dir_name``
    on a thread pool; the number of crops written."""
    check_fmt(fmt)
    output_root = output_root or constants.ACTION_GROUND_TRUTH_DIR
    sub_dir = os.path.join(output_root, sub_dir_name)
    pairings = load_ground_truth_pairings_from_file(pairings_file)
    workers = workers or max(os.cpu_count() or 1, 1)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        results = list(pool.map(
            lambda p: process_pairing(sub_dir, p, ground_truth_dir, fmt=fmt), pairings))
    return sum(results)


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m playaid_core_torch.datagen.gen_gt_action_detection",
        description="Write the action-crop tree of the train, validation and test "
                    "pairings under ACTION_GROUND_TRUTH_DIR.")
    p.add_argument("--workers", default=None, type=int)
    p.add_argument("--fmt", default="jpg", choices=FORMATS,
                   help="jpg through cv2, or npy (the exact crops; no cv2)")
    args = p.parse_args(argv)
    for pairings, split in ((constants.GROUND_TRUTH_TRAIN, "train"),
                            (constants.GROUND_TRUTH_VAL, "validation"),
                            (constants.GROUND_TRUTH_TEST, "test")):
        generate_data(pairings, split, workers=args.workers, fmt=args.fmt)
    print("🎉 COMPLETED 🎉")


if __name__ == "__main__":
    main()
