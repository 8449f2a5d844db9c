"""End-to-end match annotation pipeline + CLI.

Rebuild of the reference Manuscript orchestrator (reference:
manuscript.py:24-389) with the same public CLI surface
(``--video-path --log-path --frames --skip-graphs --video-index
--skip-summaries --show-timer --ai-output-path``) and the same output
(annotated MP4 with per-fighter labels, onscreen/offscreen charts,
post-game summaries, audio remux).

Performance changes vs the reference:

* sequential streaming decode instead of a container seek per frame
  (reference: manuscript.py:154 — its dominant cost);
* camera projection batched over the whole timeline in one vectorized
  pass (``precompute_timeline_projection``) instead of five matrix
  inversions per fighter per frame;
* the inline ``if True:``/``if False:`` feature blocks promoted to real
  options (reference: manuscript.py:176-218).

The port's own copy of ``playaid_core_tpu/pipeline/manuscript.py``, without
cv2, PIL, matplotlib, yaml, click or tqdm: the command line is argparse
(``python -m playaid_core_torch.pipeline.manuscript``, the same options),
progress is a line every ``PROGRESS_EVERY`` frames, and the frames are the
JAX package's bit for bit (tests/test_torch_port_manuscript.py).  The work
here is host work, as in the JAX package; the card enters through what
feeds it (the ``ai_output.yaml`` of the port's ``AIRunner``).
"""

from __future__ import annotations

import argparse
import base64
import os
import time
from datetime import datetime
from pathlib import Path

import numpy as np

from playaid_core_torch import constants
from playaid_core_torch.render.annotator import Annotator
from playaid_core_torch.stats import Stats
from playaid_core_torch.timeline import (
    load_ground_truth_from_path,
    load_ground_truth_pairings_from_file,
    load_timeline_from_ai_output,
    precompute_timeline_projection,
    update_fighters_from_timeline,
)
from playaid_core_torch.video.reader import VideoReader
from playaid_core_torch.video.writer import add_audio
from playaid_core_torch.viz.eval_dashboard import _png_b64

FIGHTER_COLORS = {
    0: (25, 58, 115),
    1: (201, 99, 48),
    2: (201, 99, 48),
    3: (201, 99, 48),
    4: (201, 99, 48),
    5: (201, 99, 48),
    6: (201, 99, 48),
    7: (201, 99, 48),
}
HITSTUN_COLOR = (55, 55, 55)
# A progress line every this many frames when ``progress`` is on.
PROGRESS_EVERY = 600


def bgr_to_rgba(frame):
    """``cv2.cvtColor(frame, cv2.COLOR_BGR2RGBA)``: channels reversed, alpha
    255."""
    out = np.empty(frame.shape[:2] + (4,), np.uint8)
    # Channel by channel: a copy through a reversed view is several times slower.
    out[..., 0] = frame[..., 2]
    out[..., 1] = frame[..., 1]
    out[..., 2] = frame[..., 0]
    out[..., 3] = 255
    return out


class _Progress:
    """A line on stdout every ``PROGRESS_EVERY`` frames (tqdm's place)."""

    def __init__(self, total, desc, enabled):
        self.total, self.desc, self.enabled = total, desc, enabled
        self.n = 0
        self.t0 = time.perf_counter()

    def update(self, k=1):
        self.n += k
        if self.enabled and self.n % PROGRESS_EVERY == 0:
            rate = self.n / max(time.perf_counter() - self.t0, 1e-9)
            print(f"{self.desc}: {self.n}/{self.total} frames, {rate:.1f} frames/s", flush=True)

    def close(self):
        if self.enabled:
            print(f"{self.desc}: {self.n} frames in {time.perf_counter() - self.t0:.1f} s",
                  flush=True)


class Manuscript:
    """Runs e2e tracking, stats and annotation for one VOD + log."""

    def __init__(
        self,
        input_video_path: str,
        output_video_path: str,
        start_frame: int = 0,
        max_frames: int = -1,
        image_debug=False,
        ground_truth_path=None,
        ai_output_path=None,
        skip_graphs: bool = False,
        chart_refresh: int = 1,
        log_offset: int = 0,
        include_audio: bool = True,
        skip_summaries: bool = False,
        show_timer: bool = False,
        show_anim_frame: bool = True,
        show_anim_state: bool = True,
        progress: bool = True,
        profile: bool = False,
    ):
        self.stats = Stats(input_video_path)
        self.output_video_path = output_video_path
        self.input_video_path = input_video_path
        self.image_debug = image_debug
        output_path = Path(output_video_path)
        self.debug_output_dir = os.path.join(
            os.path.dirname(output_path.absolute()), output_path.stem
        )

        self.reader = VideoReader(input_video_path)
        self.fps = self.reader.fps
        self.w = self.reader.width
        self.h = self.reader.height
        self.fighters = []
        self.log_offset = log_offset

        self.start_frame = start_frame
        self.max_frames = max_frames if max_frames >= 0 else self.reader.frame_count

        self.skip_graphs = skip_graphs
        # Re-render the offscreen chart panels every N frames, blitting the
        # cached renders in between (1 = every frame, the reference's
        # semantics).  Active play changes the chart data almost every
        # frame, so the lru caches alone don't bound the matplotlib cost.
        self.chart_refresh = max(int(chart_refresh), 1)
        self.include_audio = include_audio
        self.skip_summaries = skip_summaries
        self.show_timer = show_timer
        self.show_anim_frame = show_anim_frame
        self.show_anim_state = show_anim_state
        self.progress = progress
        # Per-stage wall-clock profile of the render loop (the reference
        # had no profiling story, SURVEY §5).
        from playaid_core_torch.profiling import StageTimer

        self.profile = profile
        self.timer = StageTimer()

        # Motion hexes with no params_labels entry, reported once.
        self.unknown_hashes = set()

        if ground_truth_path:
            self.timeline = load_ground_truth_from_path(ground_truth_path, log_offset=log_offset)
        elif ai_output_path:
            self.timeline = load_timeline_from_ai_output(ai_output_path)
        else:
            raise ValueError("Either ground_truth_path or ai_output_path is required")
        precompute_timeline_projection(self.timeline)

    def update_fighters_from_gt(self, frame_number: int) -> bool:
        if frame_number >= len(self.timeline):
            return False
        update_fighters_from_timeline(frame_number, self.timeline[frame_number], self.fighters)
        return True

    def fighter_label(self, fighter, frame_idx: int) -> str:
        """Per-fighter overlay text: action | #anim_frame | anim_state
        (reference: manuscript.py:165-209)."""
        label = (
            f"{fighter.action}"
            if fighter.action != "Undefined" and fighter.action != ""
            else ""
        )
        if self.show_anim_frame:
            label += f" | #{fighter.animation_frame_num}"
        if self.show_anim_state and fighter.anim_state:
            label += f" | {fighter.anim_state}"

        if fighter.action == "Undefined" or not fighter.action:
            if fighter.motion_hex not in self.unknown_hashes:
                print(
                    f"Unknown hex for {fighter.fighter_name} at {frame_idx} - {fighter.motion_hex}"
                )
                self.unknown_hashes.add(fighter.motion_hex)
        return label

    def render(self):
        show_stats = not self.skip_graphs
        annotator = Annotator(
            self.output_video_path, int(self.fps), self.w, self.h, show_stats=show_stats
        )

        # Warm up stats over the skipped prefix.
        if self.start_frame:
            for i in range(self.start_frame):
                if not self.update_fighters_from_gt(i):
                    break
                self.stats.record_frame(self.fighters)

        timer = self.timer
        frames = self.reader.iter_frames(self.start_frame, self.max_frames)
        pbar = _Progress(self.max_frames - self.start_frame, "render", self.progress)
        while True:
            with timer.stage("decode"):
                item = next(frames, None)
            if item is None:
                break
            i, input_frame = item
            pbar.update(1)
            input_frame = bgr_to_rgba(input_frame)
            annotator.set_frame(input_frame, line_width=4, font_size=0.2, pil=False)

            with timer.stage("state+stats"):
                ok = self.update_fighters_from_gt(i)
                if ok:
                    self.stats.record_frame(self.fighters)
            if not ok:
                break

            for j, fighter in enumerate(self.fighters):
                if self.log_offset < 0 and i < abs(self.log_offset):
                    break
                label = self.fighter_label(fighter, i)
                color = FIGHTER_COLORS[fighter.fighter_id]
                if fighter.hitstun_left:
                    color = HITSTUN_COLOR
                annotator.box_label(
                    fighter.crop.xyxy_pixels(input_frame.shape[1], input_frame.shape[0]),
                    label=label,
                    color=color,
                    draw_box=False,
                )

            if self.show_timer:
                annotator.box_label(
                    (980, 80, 1200, 60),
                    label=f"Frame #{max(i + self.log_offset, 0)}",
                    color=FIGHTER_COLORS[0],
                    draw_box=False,
                )

            with timer.stage("charts"):
                annotator.update_onscreen_charts(self.fighters, self.stats)
                if show_stats:
                    reuse = (i - self.start_frame) % self.chart_refresh != 0
                    annotator.update_offscreen_charts(
                        self.fighters, self.stats, reuse=reuse
                    )

            rendered_result = annotator.result()
            with timer.stage("encode"):
                annotator.write()

            if self.image_debug:
                os.makedirs(self.debug_output_dir, exist_ok=True)
                # As cv2.imwrite writes the RGBA canvas: its channels read as BGRA.
                with open(os.path.join(self.debug_output_dir, f"{i}.png"), "wb") as f:
                    f.write(base64.b64decode(_png_b64(rendered_result[..., [2, 1, 0, 3]])))

        pbar.close()
        if self.profile:
            print("stage profile:", self.timer.report())

        if not self.skip_summaries and self.fighters:
            annotator.post_game_summaries(self.fighters, self.stats)

        annotator.video_writer.release()
        self.reader.release()

        if self.include_audio and self.start_frame == 0:
            add_audio(self.output_video_path, self.input_video_path)

    def __str__(self):
        reprs = []
        for i, chars in enumerate(self.timeline):
            reprs.append(f"{i} - {[str(c) for c in chars]}")
        return "\n".join(reprs)


def run_manuscript(frames=None, skip_graphs=False, video_index=None, skip_summaries=False,
                   show_timer=False, video_path=None, log_path=None, ai_output_path=None,
                   output_path=None, profile=False, chart_refresh=1):
    """Entrypoint to Manuscript (reference: manuscript.py:293-385)."""
    if not video_index and not video_path:
        print("Must specify either --video-index or --video-path")
        return

    date_time_str = datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
    start_frame, end_frame = 0, -1
    if frames:
        raw = frames[1:] if frames.startswith(",") else frames
        start_frame, end_frame = map(int, raw.split(","))

    manuscript_args = {
        "start_frame": start_frame,
        "max_frames": end_frame,
        "skip_graphs": skip_graphs,
        "include_audio": True,
        "skip_summaries": skip_summaries,
        "show_timer": show_timer,
        "profile": profile,
        "chart_refresh": chart_refresh,
    }

    if video_index:
        pairings = load_ground_truth_pairings_from_file(constants.GROUND_TRUTH_TRAIN)
        dir_name, video_name, log_name, log_offset = pairings[int(video_index)]
        video_path = os.path.join(constants.GROUND_TRUTH_DIR, dir_name, video_name)
        label_path = os.path.join(constants.GROUND_TRUTH_DIR, dir_name, log_name)
        manuscript_args.update(
            {
                "input_video_path": video_path,
                "output_video_path": output_path
                or os.path.join(
                    constants.EXPERIMENT_OUTPUT,
                    f"{dir_name}-{start_frame}-{end_frame}_{date_time_str}.mp4",
                ),
                "ground_truth_path": label_path,
                "log_offset": log_offset,
            }
        )
    else:
        _, file_name = os.path.split(video_path)
        video_name, _ = os.path.splitext(file_name)
        manuscript_args.update(
            {
                "input_video_path": video_path,
                "ai_output_path": ai_output_path,
                "ground_truth_path": log_path,
                "output_video_path": output_path
                or os.path.join(
                    constants.EXPERIMENT_OUTPUT,
                    f"{video_name}-{start_frame}-{end_frame}_{date_time_str}.mp4",
                ),
                "log_offset": 5,
            }
        )

    manuscript = Manuscript(**manuscript_args)
    manuscript.render()
    print("🎉 COMPLETED 🎉")


def parser():
    """The command line: the JAX package's click options on argparse."""
    p = argparse.ArgumentParser(prog="python -m playaid_core_torch.pipeline.manuscript",
                                description=run_manuscript.__doc__)
    p.add_argument("--frames", "-f", default=None,
                   help="Frames in the format start,end. If empty, will use entire video.")
    p.add_argument("--skip-graphs", "-s", action="store_true",
                   help="Whether to skip the graphs on the sides of the video (faster)")
    p.add_argument("--video-index", "-v", default=None,
                   help="Index of the video you want to play from train.csv")
    p.add_argument("--skip-summaries", "-c", action="store_true",
                   help="If true, skip post-game summary")
    p.add_argument("--show-timer", "-t", action="store_true",
                   help="Show timer in top right for debugging")
    p.add_argument("--video-path", "-p", default=None, help="Path to input video")
    p.add_argument("--log-path", "-l", default=None, help="Path to the input log")
    p.add_argument("--ai-output-path", "-ai", default=None, help="Path to cached ai output")
    p.add_argument("--output-path", "-o", default=None, help="Path to write annotated video")
    p.add_argument("--profile", action="store_true", help="Print per-stage timing at the end")
    p.add_argument("--chart-refresh", default=1, type=int,
                   help="Re-render side charts every N frames (blit cached panels in "
                        "between); 1 = every frame")
    return p


def main(argv=None):
    run_manuscript(**vars(parser().parse_args(argv)))


if __name__ == "__main__":
    main()
