"""Generate synthetic character-detection composites.

The port's copy of ``playaid_core_tpu/datagen/gen_synth_char_detection.py``
(reference: data_gen_scripts/gen_synth_char_detection.py:190-310): paste
1-4 augmented RGBA character sprites Gaussian-centered onto stage
screenshots and emit YOLO labels.  ``class_type='CHAR'`` labels by
character; ``'CHAR+ACTION'`` labels by ``num_moves * char_id + action_id``
composite ids.  The same seed gives the JAX module's images and labels.

It composites with PIL, degrades and writes with cv2 and finds its HUD
fonts through matplotlib, each imported inside the function that uses it:
the module imports on a machine without them (the card's), and runs only
where they exist.  The command line parses with argparse.
"""

from __future__ import annotations

import argparse
import os
from glob import glob

import numpy as np

from playaid_core_torch import constants
from playaid_core_torch.ontology import MOVE_TO_CLASS_ID
from playaid_core_torch.train.augment import augment_synth_char_crop
from playaid_core_torch.train.dataset import get_stage_paths, load_stage

MAX_NUM_CHAR = 4


def write_yolo_output(output_path, yolo_data):
    with open(output_path, "w") as f:
        for class_id, bbox in yolo_data:
            f.write(f"{class_id} {bbox[0]} {bbox[1]} {bbox[2]} {bbox[3]}\n")


def get_flat_character_animations(clean_char_dir=None):
    """char -> move -> [sprite paths] (flat variant of the nested dict)."""
    clean_char_dir = clean_char_dir or constants.ULT_DATASET_CLEAN_CHAR_DIR
    out = {}
    if not os.path.isdir(clean_char_dir):
        return out
    for fighter in os.listdir(clean_char_dir):
        fdir = os.path.join(clean_char_dir, fighter)
        if not os.path.isdir(fdir):
            continue
        out[fighter] = {}
        for move in os.listdir(fdir):
            mdir = os.path.join(fdir, move)
            if os.path.isdir(mdir):
                paths = glob(os.path.join(mdir, "*.png"))
                if paths:
                    out[fighter][move] = paths
    return out


def _hud_font_paths():
    """Bundled TTF pool for HUD-distractor text (matplotlib ships a
    font directory in every image; no external assets needed).

    The Computer Modern (cm*) faces are excluded on purpose: the
    capstone eval renders its HUD in cmr10 as a held-out font family
    (tools/pixels_capstone.py HUD_FONT), and keeping the whole foundry
    out of the distractor pool preserves that claim for the detector
    as well as the OCR.  Sym/cmex-style symbol faces map ASCII to math
    glyphs, so digit-bearing distractors draw from text faces only."""
    import matplotlib

    font_dir = os.path.join(os.path.dirname(matplotlib.__file__), "mpl-data",
                            "fonts", "ttf")
    paths = [p for p in sorted(glob(os.path.join(font_dir, "*.ttf")))
             if not os.path.basename(p).startswith("cm")]
    text = [p for p in paths if "Sym" not in os.path.basename(p)]
    return text, paths


def draw_hud_distractors(stage, rng, max_elements=3):
    """Render game-HUD-style overlay clutter (damage readouts, name-tag
    bars, timers) onto a composite IN PLACE.

    Real match frames always carry HUD elements — big stylized damage
    percentages, player tags, stock icons — and the reference's YOLO
    detector learned to ignore them because it trained on real frames
    (reference: data_gen_scripts/gen_synth_char_detection.py pastes onto
    real stage screenshots that include HUDs).  Synthetic stages have no
    HUD, and a detector that never saw one fires phantom detections on
    damage text at inference (red/pink digit clusters score as
    similarly-colored fighters; measured as multi-second fighter losses
    on the capstone eval).  These distractors carry no labels: they are
    pure hard-negative background.
    """
    from PIL import ImageDraw, ImageFont

    text_fonts, all_fonts = _hud_font_paths()
    if not text_fonts:
        return
    draw = ImageDraw.Draw(stage)
    w, h = stage.width, stage.height
    for _ in range(int(rng.integers(1, max_elements + 1))):
        kind = rng.random()
        # Bias positions toward the real HUD band (bottom fifth) but
        # cover the whole frame so placement isn't memorized.
        if rng.random() < 0.6:
            cx = int(rng.uniform(0.1, 0.9) * w)
            cy = int(rng.uniform(0.82, 0.95) * h)
        else:
            cx = int(rng.uniform(0.05, 0.95) * w)
            cy = int(rng.uniform(0.05, 0.95) * h)
        fonts = text_fonts if kind < 0.8 else all_fonts
        font_path = fonts[int(rng.integers(len(fonts)))]
        size = int(rng.integers(int(h * 0.045), int(h * 0.11)))
        try:
            font = ImageFont.truetype(font_path, size)
        except OSError:
            continue
        if kind < 0.6:
            # damage readout: digits + %, white->red with damage
            val = float(rng.uniform(0, 300))
            text = f"{val:.1f}%" if rng.random() < 0.5 else f"{int(val)}%"
            frac = min(val / 150.0, 1.0)
            fill = (255, int(255 * (1 - 0.85 * frac)),
                    int(255 * (1 - 0.95 * frac)))
        elif kind < 0.8:
            # player tag / name bar
            text = "".join(chr(int(rng.integers(65, 91)))
                           for _ in range(int(rng.integers(2, 8))))
            fill = tuple(int(c) for c in rng.integers(140, 256, 3))
        else:
            # timer
            text = f"{int(rng.integers(0, 8))}:{int(rng.integers(0, 60)):02d}"
            fill = (255, 255, int(rng.integers(180, 256)))
        bb = draw.textbbox((cx, cy), text, font=font)
        if rng.random() < 0.6:
            pad = size // 5
            backing = tuple(int(c) for c in rng.integers(0, 40, 3))
            draw.rectangle((bb[0] - pad, bb[1] - pad, bb[2] + pad, bb[3] + pad),
                           fill=backing)
        if rng.random() < 0.5:
            draw.text((cx + 2, cy + 2), text, font=font,
                      fill=(15, 10, 10))  # drop shadow
        stroke = int(rng.integers(0, 3))
        draw.text((cx, cy), text, font=font, fill=fill, stroke_width=stroke,
                  stroke_fill=(25, 20, 30))


def _codec_degrade(img_bgr, rng):
    """Approximate video-codec softening on a composite: optional
    downscale/upscale (mpeg4 macroblock smear at default VideoWriter
    bitrates) followed by a JPEG round-trip at a random quality.
    Detectors trained on pristine JPEG composites but deployed on
    decoded video frames otherwise see a large confidence shift."""
    import cv2

    if rng.random() < 0.5:
        f = float(rng.uniform(0.55, 0.9))
        h, w = img_bgr.shape[:2]
        small = cv2.resize(img_bgr, (max(1, int(w * f)), max(1, int(h * f))))
        img_bgr = cv2.resize(small, (w, h))
    q = int(rng.integers(35, 92))
    ok, buf = cv2.imencode(".jpg", img_bgr, [cv2.IMWRITE_JPEG_QUALITY, q])
    return cv2.imdecode(buf, cv2.IMREAD_COLOR) if ok else img_bgr


def composite_chars_onto_stage(stage_path, char_paths, output_path, class_type="CHAR",
                               rng=None, bbox_overlay=False, char_list=None,
                               augment=True, identity_safe=False, degrade=0.0,
                               hud_distractors=0.0):
    """(reference: gen_synth_char_detection.py:190-262)

    ``augment=False`` skips the sprite augmentation entirely;
    ``identity_safe=True`` keeps the augmentation but bounds the hue
    rotation so color-coded identity survives (sprite assets carry
    class identity in palette).  ``degrade`` is the probability of a
    codec-style degradation of the finished composite (see
    :func:`_codec_degrade`) so train-time statistics match decoded
    video frames.  ``hud_distractors`` is the probability of rendering
    unlabeled HUD-style overlay text (see :func:`draw_hud_distractors`)."""
    import cv2
    from PIL import Image

    rng = rng or np.random.default_rng()
    char_list = char_list or constants.CHAR_LIST
    stage = Image.fromarray(load_stage(stage_path))

    yolo_output = []
    pixel_bbox_data = []
    for char_path in char_paths:
        char = Image.open(char_path).convert("RGBA")
        if char.width < 100 or char.height < 100:
            continue

        char_name = os.path.normpath(char_path).split(os.sep)[-3]
        action_name = os.path.normpath(char_path).split(os.sep)[-2]
        char_label = char_list.index(char_name) if char_name in char_list else 0
        action_label = MOVE_TO_CLASS_ID.get(action_name, 0)
        composite = len(MOVE_TO_CLASS_ID) * char_label + action_label
        class_id = char_label if class_type == "CHAR" else composite

        basewidth = int(rng.integers(50, 151))
        hsize = int(char.size[1] * basewidth / float(char.size[0]))
        char = char.resize((basewidth, max(hsize, 1)))
        if augment:
            char = Image.fromarray(
                augment_synth_char_crop(np.array(char), rng=rng, output_size=basewidth,
                                        identity_safe=identity_safe)
            )

        # Gaussian placement toward the stage center
        # (reference: gen_synth_char_detection.py:225-234).
        center_x = int(rng.normal(stage.width / 2, stage.width / 6))
        center_y = int(rng.normal(stage.height / 2, stage.height / 6))
        if center_x < 0 or center_x > stage.width:
            center_x = stage.width // 2
        if center_y < 0 or center_y > stage.height:
            center_y = stage.height // 2

        stage.paste(
            char,
            (int(center_x - char.width / 2), int(center_y - char.height / 2)),
            char,
        )
        pixel_bbox_data.append((center_x, center_y, char.width, char.height))
        yolo_output.append(
            (
                class_id,
                (
                    center_x / stage.width,
                    center_y / stage.height,
                    char.width / stage.width,
                    char.height / stage.height,
                ),
            )
        )

    if hud_distractors and rng.random() < hud_distractors:
        # HUD renders over everything in a real frame (after sprites,
        # before codec loss).
        draw_hud_distractors(stage, rng)

    out = cv2.cvtColor(np.array(stage), cv2.COLOR_RGB2BGR)
    if degrade and rng.random() < degrade:
        out = _codec_degrade(out, rng)
    if bbox_overlay:
        for cx, cy, w, h in pixel_bbox_data:
            out = cv2.rectangle(
                out, (int(cx - w / 2), int(cy - h / 2)), (int(cx + w / 2), int(cy + h / 2)),
                (255, 0, 0, 255), thickness=4,
            )
    cv2.imwrite(output_path, out)
    label_path = output_path.replace("images", "labels").replace(".jpg", ".txt")
    write_yolo_output(label_path, yolo_output)
    return yolo_output


def generate_stage_char_compositions(sub_dir_name, n_generations, class_type="CHAR",
                                     overwrite=False, bbox_overlay=False, seed=None,
                                     output_root=None, stages_dir=None,
                                     clean_char_dir=None, char_list=None,
                                     augment=True, identity_safe=False,
                                     degrade=0.0, hud_distractors=0.0):
    rng = np.random.default_rng(seed)
    stages = get_stage_paths(stages_dir)
    char_animations = get_flat_character_animations(clean_char_dir)
    char_list = char_list or [c for c in constants.CHAR_LIST if c in char_animations]
    if not stages or not char_animations:
        raise RuntimeError("stage/sprite assets not available")

    sub_dir = os.path.join(output_root or constants.COMPOSITES_DIR, sub_dir_name)
    images_dir = os.path.join(sub_dir, "images")
    labels_dir = os.path.join(sub_dir, "labels")
    os.makedirs(images_dir, exist_ok=True)
    os.makedirs(labels_dir, exist_ok=True)

    num_existing = 0 if overwrite else len(glob(os.path.join(images_dir, "*.jpg")))
    for i in range(num_existing, num_existing + n_generations):
        num_chars = int(rng.integers(1, MAX_NUM_CHAR + 1))
        selected = []
        for _ in range(num_chars):
            character = rng.choice([c for c in char_list if char_animations.get(c)])
            action = rng.choice(sorted(char_animations[character].keys()))
            selected.append(rng.choice(char_animations[character][action]))
        stage = rng.choice(stages)
        composite_chars_onto_stage(
            stage, selected, os.path.join(images_dir, f"comp-{i}.jpg"),
            class_type=class_type, rng=rng, bbox_overlay=bbox_overlay,
            char_list=char_list, augment=augment, identity_safe=identity_safe,
            degrade=degrade, hud_distractors=hud_distractors,
        )
    return n_generations


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m playaid_core_torch.datagen.gen_synth_char_detection",
        description="Write synthetic detection composites under COMPOSITES_DIR.")
    p.add_argument("--train", default=20000, type=int)
    p.add_argument("--val", default=256, type=int)
    p.add_argument("--test", default=256, type=int)
    p.add_argument("--class-type", default="CHAR", choices=["CHAR", "CHAR+ACTION"])
    args = p.parse_args(argv)
    generate_stage_char_compositions("train", args.train, class_type=args.class_type)
    generate_stage_char_compositions("validation", args.val, class_type=args.class_type)
    generate_stage_char_compositions("test", args.test, class_type=args.class_type)
    print("🎉 COMPLETED 🎉")


if __name__ == "__main__":
    main()
