"""Overlay compositor + output video writer.

Rebuild of the reference Annotator (reference: annotator.py:42-363): black
side/bottom padding for stats panels, labeled boxes (cv2 fast path, PIL
for non-ASCII), fading onscreen pie charts, offscreen history strips +
damage graph side panels, bottom outcome bars, post-game summary cards,
and frame writing.

The port's own copy of ``playaid_core_tpu/render/annotator.py``, without
cv2 or PIL: the labels of the ASCII path go through
:mod:`playaid_core_torch.draw` (OpenCV's antialiased rectangles and
``putText``), those of the PIL path through :mod:`playaid_core_torch.text`
(Pillow's rectangles and its built-in font), and the frame stays a numpy
array throughout (``self.pil`` says which path draws), so each frame is the
JAX package's bit for bit.
"""

from __future__ import annotations

import numpy as np

from playaid_core_torch import draw, text
from playaid_core_torch.constants import TEXT_FONT_PATH
from playaid_core_torch.render.charts import (
    defensive_option_chart,
    disadvantage_ledge_history,
    disadvantage_ledge_option_chart,
    disadvantage_tech_history,
    disadvantage_tech_option_chart,
    move_damage_graph,
    move_pie_chart,
    move_pie_chart_history,
    move_success_punished_missed_bar_graph,
)
from playaid_core_torch.render.compositing import is_ascii, paste_on_top
from playaid_core_torch.video.writer import VideoWriter


def split_text(text, chunk_size=90):
    """Greedy word-wrap into lines of at most ~chunk_size characters.

    Wrap points match the reference renderer exactly (reference:
    annotator.py:25-42) so narration text breaks onto the same lines,
    including two quirks of its accounting: the joining space is not
    counted against the budget, and a first word longer than the budget
    yields a leading empty line.
    """
    lines = []
    current = []
    used = 0  # length of " ".join(current)
    for word in text.split():
        if used + len(word) > chunk_size:
            lines.append(" ".join(current))
            current = [word]
            used = len(word)
        else:
            current.append(word)
            used += len(word) + (0 if len(current) == 1 else 1)
    if current:
        lines.append(" ".join(current))
    return lines


class Annotator:
    def __init__(
        self,
        output_video_path: str,
        fps: int,
        input_width: int,
        input_height: int,
        show_stats=True,
    ):
        self.output_video_path = output_video_path
        self.fps = fps
        self.input_width = input_width
        self.input_height = input_height
        self.show_stats = show_stats

        # 400px black padding on left/right/bottom when stats are shown
        # (reference: annotator.py:57-70).
        self.right_padding = 400 if show_stats else 0
        self.left_padding = 400 if show_stats else 0
        self.bottom_padding = 400 if show_stats else 0
        self.output_width = self.input_width + self.left_padding + self.right_padding
        self.output_height = self.input_height + self.bottom_padding

        self.video_writer = VideoWriter(
            output_video_path, fps, self.output_width, self.output_height
        )
        self.im = None
        self.pil = False
        self.lw = 2
        self._canvas = None     # reusable padded canvas (maybe_pad_image)
        self._panels_stale = True  # canvas panel regions need a (re)blit
        self._text_font = None  # the font loads once, not per frame

    def set_frame(self, im, line_width=None, font_size=None, font=TEXT_FONT_PATH,
                  pil=False, example="abc✅"):
        assert im.data.contiguous, (
            "Image not contiguous. Apply np.ascontiguousarray(im) to Annotator() input images."
        )
        # ``pil=True`` forces the PIL text path for the whole frame; a
        # non-ASCII label switches to it from that label on (_ensure_pil),
        # as the reference picks the path by ASCII-ness (annotator.py:79-101).
        self.pil = False
        self.im = im
        if pil:
            self._ensure_pil()
        self.lw = line_width or max(round(sum(im.shape) / 2 * 0.003), 2)

    def _ensure_pil(self):
        """Switch the current frame to the PIL draw path (first non-ASCII
        label, or an explicit pil=True set_frame): the frame becomes a
        writable array of its own, as ``Image.fromarray`` copies it."""
        if not self.pil or not self.im.flags.writeable:
            self.im = np.array(self.im)
        self.pil = True
        if self._text_font is None:
            self._text_font = text.load_default()
        self.text_font = self._text_font

    def box_label(self, box, label="", color=(128, 128, 128), txt_color=(255, 255, 255),
                  draw_box=True):
        """Draw one labeled box (reference: annotator.py:103-187)."""
        if self.pil or not is_ascii(label):
            self._ensure_pil()
            if draw_box:
                text.rectangle(self.im, box, width=self.lw, outline=color)
            if label:
                bbox = text.textbbox((0, 0), label, self.text_font)
                w, h = bbox[2] - bbox[0], bbox[3] - bbox[1]
                outside = box[1] - h >= 0
                if color:
                    text.rectangle(
                        self.im,
                        (
                            box[0],
                            box[1] - h if outside else box[1],
                            box[0] + w + 1,
                            box[1] + 1 if outside else box[1] + h + 1,
                        ),
                        fill=color,
                    )
                text.text(
                    self.im,
                    (box[0], box[1] - h if outside else box[1]),
                    label,
                    self.text_font,
                    (255, 255, 255),
                )
        else:
            p1, p2 = (int(box[0]), int(box[1])), (int(box[2]), int(box[3]))
            if draw_box:
                draw.rectangle_outline(self.im, p1, p2, color, thickness=self.lw)
            if label:
                tf = max(self.lw - 2, 1)
                w, h = draw.get_text_size(label, 0, self.lw / 5, tf)[0]
                outside = p1[1] - h >= 3
                p2 = p1[0] + w, p1[1] - h - 3 if outside else p1[1] + h + 3
                draw.rectangle(self.im, p1, p2, color)
                draw.put_text(
                    self.im,
                    label,
                    (p1[0], p1[1] - 2 if outside else p1[1] + h + 2),
                    0,
                    self.lw / 5,
                    txt_color,
                    thickness=tf,
                )

    def update_onscreen_charts(self, fighters, stats, show_tracked_chart=True,
                               show_history_charts=False):
        """Fading per-fighter move pies near each fighter's bbox
        (reference: annotator.py:189-215)."""
        self.im = np.asarray(self.im)
        if not self.im.flags.writeable:
            self.im = np.array(self.im)
        size = 60
        for fighter in fighters:
            if not show_tracked_chart:
                continue
            (ulx, uly, _, _) = fighter.crop.xyxy_pixels(self.input_width, self.input_height)
            chart, pie_chart_image = move_pie_chart(fighter, stats, size)
            if pie_chart_image is None:
                continue
            paste_on_top(pie_chart_image, self.im, ulx - 70, uly - 45)

        for fighter in fighters:
            if not show_history_charts:
                continue
            move_pie_chart_history(fighter, stats, size)

    def _blit(self, image, x, y):
        """Write an RGB(A) panel into the canvas, clipping at the borders
        (the reference assumed 720p inputs and indexed unguarded,
        annotator.py:237-275)."""
        h = min(image.shape[0], self.im.shape[0] - y)
        w = min(image.shape[1], self.im.shape[1] - x)
        if h <= 0 or w <= 0:
            return
        c = image.shape[2]
        self.im[y : y + h, x : x + w, :c] = image[:h, :w]

    def update_offscreen_charts(self, fighters, stats, reuse=False):
        """Side panels (ledge/tech strips + damage graph) and bottom outcome
        bars (reference: annotator.py:217-276).

        ``reuse=True`` blits the previous call's rendered panels instead of
        recomputing them — the chart-refresh fast path (active play changes
        the underlying counters nearly every frame, defeating the data-tuple
        lru caches; refreshing every few frames is visually identical at a
        fraction of the render cost).
        """
        self.maybe_pad_image()
        if reuse and getattr(self, "_panel_cache", None):
            # The persistent canvas still holds the previous blit: only the
            # video region is rewritten between chart refreshes, so the
            # panel pixels are already correct and the ~5 MB/frame re-blit
            # can be skipped outright.
            if not self._panels_stale:
                return
            for image, x, y in self._panel_cache:
                self._blit(image, x, y)
            self._panels_stale = False
            return

        cache = []
        # Identity blit-skip: chart renderers return lru-cached arrays, so
        # an unchanged panel comes back as the SAME object — and since the
        # canvas persists across frames with only the video region
        # rewritten, its pixels are already on the canvas.  Skipping the
        # re-blit is pixel-exact and removes ~5 MB/frame of copies during
        # quiet stretches.
        prev = getattr(self, "_panel_prev", {})
        fresh = not prev or self._panels_stale

        def blit(image, x, y):
            cache.append((image, x, y))
            if fresh or prev.get((x, y)) is not image:
                self._blit(image, x, y)

        index_to_side_x = {0: 0, 1: self.left_padding + self.input_width}
        index_to_bottom_x = {0: 0, 1: self.output_width // 2}
        for fighter in fighters:
            x = index_to_side_x[fighter.fighter_id]
            y = 0
            timeline_height = 120
            blit(disadvantage_ledge_history(fighter=fighter, stats=stats), x, y)
            y += timeline_height
            blit(disadvantage_tech_history(fighter=fighter, stats=stats), x, y)
            y += timeline_height

            im_height, im_width = 480, 400
            chart, image = move_damage_graph(fighter, stats, width=im_width, height=im_height)
            blit(image, x, y)

            x = index_to_bottom_x[fighter.fighter_id]
            y = self.input_height
            im_width = self.output_width // 2
            chart, image = move_success_punished_missed_bar_graph(
                fighter, stats, height=400, width=im_width
            )
            blit(image, x, y)
        self._panel_cache = cache
        self._panel_prev = {(x, y): image for image, x, y in cache}
        self._panels_stale = False

    def basic_counter(self, x, fighter, stats):
        """Plain-text per-move counters on one side (reference:
        annotator.py:278-298)."""
        self.box_label(
            (x, 0, x + 20, 40), fighter.fighter_name, draw_box=False, color=None,
            txt_color=(255, 255, 255),
        )
        y = 70
        for key, value in stats.stats[fighter.fighter_id].action_count.items():
            self.box_label(
                (x, y, x + 20, y + 40), f"{key}: {value}", draw_box=False, color=None,
                txt_color=(255, 255, 255),
            )
            y += 30

    def maybe_pad_image(self):
        """Grow the frame to the padded output canvas (reference:
        annotator.py:300-313).

        The canvas is REUSED across frames: every padding pixel is either
        re-blitted each frame (side strips + damage graphs cover the side
        columns exactly, the two bottom bar charts cover the bottom band)
        or never written (stays black), so a persistent canvas is
        pixel-identical to np.pad while skipping a ~9 MB allocate+copy
        per frame.
        """
        self.im = np.asarray(self.im)
        if self.im.shape[0] != self.output_height or self.im.shape[1] != self.output_width:
            if (self._canvas is None
                    or self._canvas.shape[2] != self.im.shape[2]
                    or self._canvas.dtype != self.im.dtype):
                self._canvas = np.zeros(
                    (self.output_height, self.output_width, self.im.shape[2]),
                    self.im.dtype,
                )
                self._panels_stale = True
            self._canvas[: self.im.shape[0],
                         self.left_padding : self.left_padding + self.im.shape[1]] = self.im
            self.im = self._canvas
        self.pil = False

    def post_game_summaries(self, fighters, stats):
        """Five full-canvas summary charts, each held 3 seconds
        (reference: annotator.py:315-347)."""
        self.maybe_pad_image()
        self._panels_stale = True  # summary cards overwrite the panel regions
        index_to_x = {0: 0, 1: self.output_width // 2}
        graphs = [
            move_success_punished_missed_bar_graph,
            move_damage_graph,
            defensive_option_chart,
            disadvantage_tech_option_chart,
            disadvantage_ledge_option_chart,
        ]
        for graph in graphs:
            for fighter in fighters:
                x = index_to_x[fighter.fighter_id]
                width = self.output_width // 2
                height = self.output_height
                chart, image = graph(fighter, stats, width=width, height=height)
                self._blit(image, x, 0)
            self.write_num_seconds(3)

    def write_num_seconds(self, num_seconds):
        for _ in range(num_seconds * 60):
            self.write()

    def result(self):
        return np.asarray(self.im)

    def write(self):
        result = self.result()
        # Hand the RGBA canvas straight to the writer seam: the native
        # encoder converts RGBA->YUV420 in one sws pass on its thread, so
        # the render thread only pays the ownership copy (the canvas is
        # reused).
        self.video_writer.write(result, copy=True)
