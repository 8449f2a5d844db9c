#!/usr/bin/env python3
"""Write playaid_core_torch/assets/sprite_digests.json from the JAX package's
sprite renderer, which draws with OpenCV.

    JAX_PLATFORMS=cpu python3 tools/torch_port_sprite_digests.py

It draws the sprite tree that chip_smoke.py phase 15 draws with the port
(the settings below, which the file also records) through
playaid_core_tpu.datagen.skeletal_sprites.generate_sprite_set as PNG files,
reads a fixed subset of 48 back with cv2.imread(..., IMREAD_UNCHANGED) and
stores each one's skeletal_sprites.sprite_digest.  Phase 15 draws the same
tree on the card's machine, which has no cv2, with the port's
generate_sprite_set(fmt="npy") and compares its digests with these: equal
digests say the port draws there what cv2 draws here.  Needs cv2 and the
JAX package; rerun it when the renderer or the settings change.
"""

from __future__ import annotations

import json
import os
import platform
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "playaid_core_torch", "assets", "sprite_digests.json")

# The tree: 6 fighters x 8 moves x 8 frames x variants 0-1 x both facings.
SETTINGS = {
    "fighters": ["Byleth", "Diddy Kong", "Pikachu", "Joker", "Donkey Kong", "Jigglypuff"],
    "moves": ["Wait", "Dash", "Jab", "ForwardSmash", "NeutralAir", "Shield", "SpotDodge",
              "Roll"],
    "frames_per_move": 8,
    "variant_seeds": [0, 1],
    "seed": 0,
}


def subset(settings):
    """The 48 sprites whose digests are kept, as paths relative to the tree
    without their extension: one a fighter and move, the frame, variant and
    facing stepping with them."""
    names = []
    for fi, fighter in enumerate(settings["fighters"]):
        for mi, move in enumerate(settings["moves"]):
            k = fi + mi
            frame, variant = k % settings["frames_per_move"], settings["variant_seeds"][k % 2]
            cam = 90 if mi % 2 == 0 else 270
            names.append(f"{fighter}/{move}/{fighter.lower().replace(' ', '-')}_c{variant:02d}_"
                         f"{move.lower()}_frame_{cam}_{frame}")
    return names


def main():
    import cv2

    from playaid_core_torch.datagen.skeletal_sprites import sprite_digest
    from playaid_core_tpu.datagen import skeletal_sprites as jax_sprites

    with tempfile.TemporaryDirectory() as root:
        n = jax_sprites.generate_sprite_set(
            root, fighters=SETTINGS["fighters"], moves=SETTINGS["moves"],
            frames_per_move=SETTINGS["frames_per_move"],
            variant_seeds=tuple(SETTINGS["variant_seeds"]), seed=SETTINGS["seed"])
        digests = {name: sprite_digest(cv2.imread(os.path.join(root, name + ".png"),
                                                  cv2.IMREAD_UNCHANGED))
                   for name in subset(SETTINGS)}
    record = {
        "provenance": "tools/torch_port_sprite_digests.py: playaid_core_tpu's "
                      "generate_sprite_set (OpenCV " + cv2.__version__ + " on "
                      + platform.machine() + ", CPU features " + cv2.getCPUFeaturesLine()
                      + "; its HSV->RGB rounds as its AVX2 code's 32-pixel vector block, "
                      "which playaid_core_torch.imgproc.hsv_to_rgb follows) with these "
                      "settings, "
                      "PNG read back with cv2.IMREAD_UNCHANGED, hashed with "
                      "playaid_core_torch.datagen.skeletal_sprites.sprite_digest",
        "settings": SETTINGS, "sprites": n, "digests": digests,
    }
    with open(OUT, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(f"{OUT}: {len(digests)} digests of a tree of {n} sprites")
    return 0


if __name__ == "__main__":
    sys.exit(main())
