"""Clean raw animation dumps into ontology-named RGBA sprites.

The port's copy of ``playaid_core_tpu/datagen/raw_anim_cleaner.py``
(reference: data_gen_scripts/raw_anim_data_cleaner.py:20-161): black
background -> alpha, tight crop to the character, raw animation
directories renamed to the canonical move names.  PNG files are read and
written through ``imgcodec``'s numpy codec, which gives what
``cv2.imread`` gives and writes files that ``cv2.imread`` reads back
equal, so the cleaner runs without cv2; ``cv2.inRange``, ``split`` and
``merge`` are numpy here.  Fighters are cleaned on a thread pool, as in
the JAX module.  The command line parses with argparse.
"""

from __future__ import annotations

import argparse
import os
import pathlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from playaid_core_torch import constants, imgcodec
from playaid_core_torch.ontology import get_animation_type_for_anim_file


def get_bounding_box(img):
    """Tight bbox of fully-opaque pixels of an RGBA image, vectorized.
    Returns ((left, top), (right, top), (left, bottom), (right, bottom)),
    matching the reference's corner order."""
    opaque = img[:, :, 3] == 255
    rows = np.flatnonzero(opaque.any(axis=1))
    cols = np.flatnonzero(opaque.any(axis=0))
    if rows.size == 0 or cols.size == 0:
        h, w = img.shape[:2]
        return ((w, h), (0, h), (w, 0), (0, 0))
    top, bottom = int(rows[0]), int(rows[-1])
    left, right = int(cols[0]), int(cols[-1])
    return ((left, top), (right, top), (left, bottom), (right, bottom))


def remove_black_background(img):
    """Black background -> transparent (reference:
    raw_anim_data_cleaner.py:45-55): a pixel whose every channel is 0 or 1
    (``cv2.inRange(img, 0, 1)``) gets alpha 0, every other 255.  Input
    BGR, output BGRA."""
    mask = np.where((img <= 1).all(axis=2), 0, 255).astype(np.uint8)
    return np.concatenate([img, mask[..., None]], axis=2)


def clean_single_raw_fighter_anim_data(raw_image_path: str):
    img = imgcodec.read_image(raw_image_path)
    transparent = remove_black_background(img)
    (left, top), (right, _), (_, bottom), _ = get_bounding_box(transparent)
    return transparent[top : bottom + 1, left : right + 1]


def clean_raw_fighter_anim_data(fighter: str, raw_animation_name: str, overwrite=False,
                                raw_dir=None, clean_dir=None):
    raw_dir = raw_dir or constants.ULT_DATASET_RAW_CHAR_DIR
    clean_dir = clean_dir or constants.ULT_DATASET_CLEAN_CHAR_DIR
    fighter_dir = os.path.join(raw_dir, fighter)
    animation_type = get_animation_type_for_anim_file(raw_animation_name)
    if animation_type == "Undefined":
        return 0

    output_dir = os.path.join(clean_dir, fighter, animation_type)
    os.makedirs(output_dir, exist_ok=True)
    input_dir = os.path.join(fighter_dir, raw_animation_name)

    written = 0
    for file in pathlib.Path(input_dir).iterdir():
        if ".png" not in file.name:
            continue
        output_file = os.path.join(output_dir, file.name)
        if os.path.exists(output_file) and not overwrite:
            break
        cropped = clean_single_raw_fighter_anim_data(str(file))
        if not cropped.shape[0] or not cropped.shape[1]:
            continue
        imgcodec.write_image(output_file, cropped)
        written += 1
    return written


def clean_all_raw_fighter_anim_data(fighter: str, overwrite=False, raw_dir=None,
                                    clean_dir=None):
    raw_dir = raw_dir or constants.ULT_DATASET_RAW_CHAR_DIR
    fighter_dir = os.path.join(raw_dir, fighter)
    if not os.path.isdir(fighter_dir):
        return 0
    total = 0
    for anim in os.listdir(fighter_dir):
        if os.path.isdir(os.path.join(fighter_dir, anim)):
            total += clean_raw_fighter_anim_data(
                fighter, anim, overwrite=overwrite, raw_dir=raw_dir, clean_dir=clean_dir
            )
    return total


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m playaid_core_torch.datagen.raw_anim_cleaner",
        description="Clean every fighter's raw animation dumps under "
                    "ULT_DATASET_RAW_CHAR_DIR into ULT_DATASET_CLEAN_CHAR_DIR.")
    p.add_argument("--workers", default=8, type=int)
    args = p.parse_args(argv)
    raw = constants.ULT_DATASET_RAW_CHAR_DIR
    fighters = [f for f in os.listdir(raw) if os.path.isdir(os.path.join(raw, f))]
    with ThreadPoolExecutor(max_workers=args.workers) as pool:
        list(pool.map(clean_all_raw_fighter_anim_data, fighters))
    print("🎉 COMPLETED 🎉")


if __name__ == "__main__":
    main()
