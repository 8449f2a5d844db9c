#!/usr/bin/env python3
"""Write the OCR training fixture that chip_smoke.py's phase 14 trains on.

The card's machine has no PIL, cv2 or matplotlib, so it cannot render HUD
digits.  This tool renders, on a machine that has them, BATCHES batches of
the port's ``synth_batch`` (``playaid_core_torch.infer.ocr_conv``) over the
training fonts, drawn in turn from ``np.random.default_rng(SEED)`` as
``train()`` draws them, and stores them exactly (float32 patches, int32
labels, compressed) with a provenance record: the seed, the font files and
the PIL, OpenCV and matplotlib versions.

    python3 tools/torch_port_ocr_fixture.py [--out PATH]

The default path is the committed ``playaid_core_torch/assets/
ocr_synth_batches.npz``: ``x`` [BATCHES, BATCH, 48, 48, 1], ``y`` [BATCHES,
BATCH], ``provenance`` (a JSON string).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
FIXTURE = os.path.join(ROOT, "playaid_core_torch", "assets", "ocr_synth_batches.npz")
BATCHES, BATCH, SEED = 8, 128, 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=FIXTURE)
    args = ap.parse_args(argv)

    import cv2
    import matplotlib
    import PIL

    from playaid_core_torch.infer.ocr_conv import synth_batch, train_fonts

    fonts = train_fonts()
    rng = np.random.default_rng(SEED)
    xs, ys = zip(*(synth_batch(rng, fonts, BATCH) for _ in range(BATCHES)))
    provenance = {
        "tool": "tools/torch_port_ocr_fixture.py", "seed": SEED,
        "batches": BATCHES, "batch": BATCH,
        "fonts": [os.path.basename(f) for f in fonts],
        "PIL": PIL.__version__, "cv2": cv2.__version__, "matplotlib": matplotlib.__version__,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, x=np.stack(xs), y=np.stack(ys),
                        provenance=np.array(json.dumps(provenance)))
    print(f"wrote {args.out}: {os.path.getsize(args.out)} B; {json.dumps(provenance)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
