"""Generate full-frame character-detection training data (YOLO format).

The port's copy of ``playaid_core_tpu/datagen/gen_gt_char_detection.py``
(reference: data_gen_scripts/gen_gt_char_detection.py:24-99): full frames
and square normalized boxes from the log-projected crops, with per-split
sampling intervals (train every 5 frames, validation every 600, test
every 900).  Frames come through ``video/reader.VideoReader`` (the capture
seam).  ``fmt="jpg"`` writes them through cv2, as the JAX module does;
``fmt="npy"`` writes the frames themselves and needs no cv2
(``DetectionDataset`` reads ``.npy`` frames).  The command line parses
with argparse.
"""

from __future__ import annotations

import argparse
import os

from playaid_core_torch import constants, imgcodec
from playaid_core_torch.datagen.gen_gt_action_detection import FORMATS, check_fmt
from playaid_core_torch.timeline import (
    load_ground_truth_from_path,
    load_ground_truth_pairings_from_file,
    precompute_timeline_projection,
    update_fighters_from_timeline,
)
from playaid_core_torch.video.reader import VideoReader


def write_yolo_output(output_path, yolo_data):
    """(reference: gen_gt_char_detection.py:24-34)"""
    with open(output_path, "w") as f:
        for class_id, bbox_yolo in yolo_data:
            f.write(f"{class_id} {bbox_yolo[0]} {bbox_yolo[1]} {bbox_yolo[2]} {bbox_yolo[3]}\n")


def generate_data(pairings_file, sub_dir_name, interval=1, offset=0, max_frames=None,
                  overwrite=False, output_root=None, ground_truth_dir=None, fmt="jpg"):
    """Frames and YOLO label files of every pairing, every ``interval``-th
    frame from ``offset``; stops a pairing at its first frame already
    written unless ``overwrite``.  Returns the number of frames written."""
    check_fmt(fmt)
    output_root = output_root or constants.GROUND_TRUTH_CHAR_DETECTION_DIR
    ground_truth_dir = ground_truth_dir or constants.GROUND_TRUTH_DIR
    sub_dir = os.path.join(output_root, sub_dir_name)
    images_dir = os.path.join(sub_dir, "images")
    labels_dir = os.path.join(sub_dir, "labels")
    os.makedirs(images_dir, exist_ok=True)
    os.makedirs(labels_dir, exist_ok=True)

    written = 0
    for pairing in load_ground_truth_pairings_from_file(pairings_file):
        dir_name, video_name, log_name, log_offset = pairing
        video_path = os.path.join(ground_truth_dir, dir_name, video_name)
        label_path = os.path.join(ground_truth_dir, dir_name, log_name)
        reader = VideoReader(video_path)
        limit = max_frames if max_frames else reader.frame_count
        timeline = load_ground_truth_from_path(label_path, log_offset=log_offset)
        precompute_timeline_projection(timeline)
        limit = min(limit, len(timeline))

        fighters = []
        for i, input_frame in reader.iter_frames(offset, limit):
            fighters = update_fighters_from_timeline(i, timeline[i], fighters)
            if (i + offset) % interval != 0:
                continue

            output_img_path = os.path.join(images_dir, f"{dir_name}-{i}.{fmt}")
            if not overwrite and os.path.exists(output_img_path):
                break

            yolo_data = [
                (
                    constants.CHAR_LIST.index(f.fighter_name)
                    if f.fighter_name in constants.CHAR_LIST else -1,
                    f.crop.square_yolo_crop(input_frame),
                )
                for f in fighters
            ]
            imgcodec.write_image(output_img_path, input_frame)
            write_yolo_output(os.path.join(labels_dir, f"{dir_name}-{i}.txt"), yolo_data)
            written += 1
        reader.release()
    return written


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m playaid_core_torch.datagen.gen_gt_char_detection",
        description="Write the YOLO character-detection tree of the train, validation "
                    "and test pairings under GROUND_TRUTH_CHAR_DETECTION_DIR.")
    p.add_argument("--fmt", default="jpg", choices=FORMATS,
                   help="jpg through cv2, or npy (the frames themselves; no cv2)")
    args = p.parse_args(argv)
    generate_data(constants.GROUND_TRUTH_TRAIN, "train", interval=5, fmt=args.fmt)
    generate_data(constants.GROUND_TRUTH_VAL, "validation", interval=60 * 10, offset=3,
                  fmt=args.fmt)
    generate_data(constants.GROUND_TRUTH_TEST, "test", interval=60 * 15, offset=6,
                  fmt=args.fmt)
    print("🎉 COMPLETED 🎉")


if __name__ == "__main__":
    main()
