"""Match-inspection dashboard.

Working replacement for the reference's stale manuscript visualization
(reference: visualizations/manuscript_vis.py — which called a
``detect_actions_for_frame`` that no longer existed).  Renders an HTML
inspection report for a (video, log) pair: selected frames with the
annotated overlay, per-fighter state readouts, and the narration history
window around each frame.

The port's own copy of ``playaid_core_tpu/viz/manuscript_vis.py``: the
overlay is the port's annotator; the frames are inlined as JPEG through
cv2's encoder, imported when a frame is encoded (an ImportError names cv2
where it is missing); the command line is argparse (``python -m
playaid_core_torch.viz.manuscript_vis``).
"""

from __future__ import annotations

import argparse
import base64
import html
import os

import numpy as np

from playaid_core_torch.pipeline.manuscript import bgr_to_rgba
from playaid_core_torch.render.annotator import Annotator
from playaid_core_torch.stats import Stats
from playaid_core_torch.timeline import (
    load_ground_truth_from_path,
    precompute_timeline_projection,
    update_fighters_from_timeline,
)
from playaid_core_torch.video.reader import VideoReader


def _jpeg_b64(bgr, quality=85):
    try:
        import cv2
    except ImportError as e:
        raise ImportError("manuscript_vis encodes its frames as JPEG with cv2, which is "
                          "not installed") from e
    ok, buf = cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, quality])
    return base64.b64encode(buf.tobytes()).decode()


def inspect_match(video_path, log_path, frames, out_path, log_offset=0,
                  history_window=60):
    """Render an inspection report for the given frame numbers."""
    timeline = load_ground_truth_from_path(log_path, log_offset=log_offset)
    precompute_timeline_projection(timeline)
    reader = VideoReader(video_path)
    stats = Stats(video_path)
    fighters = []

    wanted = sorted(set(f for f in frames if 0 <= f < len(timeline)))
    max_frame = max(wanted) if wanted else 0

    sections = []
    for i in range(min(max_frame + 1, len(timeline))):
        fighters = update_fighters_from_timeline(i, timeline[i], fighters)
        stats.record_frame(fighters)
        if i not in wanted:
            continue

        ok, frame = reader.read_at(i)
        if not ok:
            continue
        rgba = bgr_to_rgba(frame)
        annot = Annotator.__new__(Annotator)  # overlay only, no writer
        annot.input_width, annot.input_height = reader.width, reader.height
        annot.pil = False
        annot.im = rgba
        annot.lw = 3
        for fighter in fighters:
            annot.box_label(
                fighter.crop.xyxy_pixels(reader.width, reader.height),
                label=f"{fighter.action} | #{fighter.animation_frame_num}",
                color=(25, 58, 115) if fighter.fighter_id == 0 else (201, 99, 48),
            )
        bgr = np.ascontiguousarray(np.asarray(annot.im)[:, :, 2::-1])

        readouts = []
        for f in fighters:
            readouts.append(
                f"P{f.fighter_id + 1} {f.fighter_name}: {f.action} "
                f"(#{f.animation_frame_num}, {f.anim_state or 'n/a'}) "
                f"dmg {f.damage:.1f} pos ({f.pos_x:.1f}, {f.pos_y:.1f}) "
                f"status {f.status}"
            )
        history = stats.history_subset(max(0, i - history_window), i)

        sections.append(
            "<div class='frame'>"
            f"<h2>Frame {i}</h2>"
            f"<img src='data:image/jpeg;base64,{_jpeg_b64(bgr)}'>"
            + "".join(f"<p class='state'>{html.escape(r)}</p>" for r in readouts)
            + "<h3>Narration</h3><ul>"
            + "".join(
                f"<li>#{fn}: {html.escape(text)}</li>" for fn, text in history[-8:]
            )
            + "</ul></div><hr>"
        )
    reader.release()

    doc = (
        "<html><head><meta charset='utf-8'><style>"
        "body{font-family:sans-serif;background:#111;color:#eee}"
        "img{max-width:960px}.state{color:#9cf}</style>"
        f"<title>Match inspection</title></head><body><h1>"
        f"{html.escape(os.path.basename(video_path))}</h1>"
        + "\n".join(sections)
        + "</body></html>"
    )
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        f.write(doc)
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m playaid_core_torch.viz.manuscript_vis")
    p.add_argument("--video", "-v", required=True)
    p.add_argument("--log", "-l", dest="log_path", required=True)
    p.add_argument("--frames", "-f", default="0,60,120", help="comma-separated frame numbers")
    p.add_argument("--out", "-o", default="manuscript_inspection.html")
    args = p.parse_args(argv)
    frame_list = [int(v) for v in args.frames.split(",")]
    path = inspect_match(args.video, args.log_path, frame_list, args.out)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
