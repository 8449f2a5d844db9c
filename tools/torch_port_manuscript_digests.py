#!/usr/bin/env python3
"""Write playaid_core_torch/assets/manuscript_digests.json from the JAX
package's annotated-match path, which draws with cv2 and PIL.

    JAX_PLATFORMS=cpu python3 tools/torch_port_manuscript_digests.py [--check-port]

It renders what chip_smoke.py phase 16 (a) renders — Manuscript.render with
graphs and summaries on, over chip_smoke.write_match_log's 480-frame log at
1920x1080, frames from chip_smoke.manuscript_reader (the log clip's noise
and discs) and output to chip_smoke.HashingWriter — through
playaid_core_tpu.pipeline.manuscript, and stores the SHA-256 of the frames
at chip_smoke.MS_DIGEST_FRAMES, the frame count and canvas, and the
SHA-256 of every chart panel of the final stats
(chip_smoke.chart_panel_digests).  Phase 16 renders the same with the port
on the card's machine, which has no cv2, PIL or JAX, and compares.
``--check-port`` renders with the port here too and exits non-zero if a
digest differs.  Rerun it when the annotator, the charts or the settings
change.
"""

from __future__ import annotations

import json
import os
import platform
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the phase's settings and stand-ins)


def render(package):
    """(digests, frame count, canvas, panel digests) of one package's run."""
    import importlib

    from playaid_core_torch.infer.vod_pipeline import boxes_from_log

    ms = importlib.import_module(f"{package}.pipeline.manuscript")
    ann = importlib.import_module(f"{package}.render.annotator")
    charts = importlib.import_module(f"{package}.render.charts")
    work = tempfile.mkdtemp()
    log_path = os.path.join(work, "match_log.txt")
    chip_smoke.write_match_log(log_path, chip_smoke.NUM_FRAMES)
    boxes = boxes_from_log(log_path)
    writer, m, seconds = chip_smoke.render_manuscript(ms, ann, charts, log_path, boxes)
    panels = chip_smoke.chart_panel_digests(charts, m.fighters, m.stats, writer.size[0])
    print(f"{package}: {writer.count} frames in {seconds:.1f} s", flush=True)
    return {"frames": writer.digests, "frame_count": writer.count,
            "canvas": [writer.size[1], writer.size[0]], "panels": panels}


def main():
    import cv2
    import PIL

    out = os.path.join(ROOT, "playaid_core_torch", "assets", "manuscript_digests.json")
    ref = render("playaid_core_tpu")
    doc = {
        "settings": {"num_frames": chip_smoke.NUM_FRAMES,
                     "frame": [chip_smoke.HEIGHT, chip_smoke.WIDTH],
                     "digest_frames": list(chip_smoke.MS_DIGEST_FRAMES),
                     "graphs": True, "summaries": True},
        "provenance": {"tool": "tools/torch_port_manuscript_digests.py",
                       "opencv": cv2.__version__, "pillow": PIL.__version__,
                       "machine": platform.machine()},
        **ref,
    }
    with open(out, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {os.path.relpath(out, ROOT)}: {len(ref['frames'])} frames, "
          f"{len(ref['panels'])} panels")
    if "--check-port" in sys.argv[1:]:
        port = render("playaid_core_torch")
        bad = [k for k in ("frames", "frame_count", "canvas", "panels") if port[k] != ref[k]]
        print("port differs in " + ", ".join(bad) if bad else "port equal")
        return 1 if bad else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
