"""The arithmetic behind the metric readers in ``metrics/``.

End-to-end metrics read the window's runs (host clock).  Per-layer metrics
read the traced runs: the harness's host-clock marks, the chrome trace's
device events and spans, and the work counted from shapes
(``roofline.py``).  A reader that finds nothing to read returns None, and
the metric is left out of the run's line; a share of a roofline or a peak
is never reported as 0.
"""

from __future__ import annotations

import statistics

from portbench import program_spans, roofline
from portbench.constants import PEAK_TF32_FLOPS

K2 = "conv3x3_wgmma_kernel"
K4 = "yuv420_unpack_kernel"


def _ok(runs):
    return [r for r in runs if r.ok]


def frames_per_s(ctx):
    """All frames of the window's VODs over the time from the first start
    to the last end."""
    runs = _ok(ctx.runs)
    if not runs:
        return None
    span = max(r.end for r in ctx.runs) - min(r.start for r in ctx.runs)
    return sum(r.frames for r in runs) / span


def host_loop_ms_per_chunk(ctx):
    """Host clock from ``analyze``'s call to ``classify_buffer``'s entry,
    after the card has finished the chunks' work, over the chunks."""
    runs = [r for r in ctx.traced if r.ok and r.classify and r.embeds]
    if not runs:
        return None
    return statistics.fmean((r.classify[0] - r.start) * 1e3 / len(r.embeds) for r in runs)


def classify_ms_per_vod(ctx):
    """Host clock of ``classify_buffer``, the card synchronised at both ends."""
    spans = [r.classify for r in ctx.traced if r.ok and r.classify]
    if not spans:
        return None
    return statistics.fmean((t1 - t0) * 1e3 for t0, t1 in spans)


def h2d_bytes_per_frame(ctx):
    """Host-to-device copy bytes in the traced window over its frames."""
    nbytes = ctx.trace.h2d_bytes()
    frames = sum(r.frames for r in ctx.traced if r.ok)
    return nbytes / frames if nbytes and frames else None


def _crops(ctx):
    return sum(sum(r.embeds) for r in ctx.traced)


def embed_device_us_per_crop(ctx):
    """Device time of the kernels each VOD ran before its
    ``classify_buffer`` span opened, over the crops embedded."""
    tr = ctx.trace
    analyses = tr.spans.get("portbench.analyze", [])
    classifies = tr.spans.get("portbench.classify", [])
    if not analyses or len(analyses) != len(classifies):
        return None
    us = sum(sum(tr.kernels("", a_ts, c_ts)) for (a_ts, _), (c_ts, _) in zip(analyses, classifies))
    crops = _crops(ctx)
    return us / crops if us and crops else None


def _roofline(ctx, kernel, least_s_of_crops):
    """The least time of the traced embed calls, each from its crops
    alone, over the device time of the kernels each call launched, in
    percent; None unless every call launched at least one."""
    per_call = ctx.trace.kernels_by_span("portbench.embed", kernel)
    crops = [n for r in ctx.traced for n in r.embeds]
    if not crops or len(per_call) != len(crops) or not all(per_call):
        return None
    least = sum(least_s_of_crops(n) for n in crops)
    return 100.0 * least / (sum(map(sum, per_call)) / 1e6)


def k2_roofline(ctx):
    """K2's share over every block the family's trunk runs on it: a call of
    ``n`` crops takes the least time of each block at its shape.  None
    unless the port's ``k2_blocks`` count on each ``playaid.embed`` span is
    the family's number of blocks, so that a change to what K2 runs
    silences the metric instead of misreading it."""
    blocks = ctx.family.k2_blocks(ctx.config)
    calls = sum(len(r.embeds) for r in ctx.traced)
    counted = program_spans.counts_by_span(ctx, "playaid.embed", "k2_blocks")
    if not blocks or counted != [len(blocks)] * calls:
        return None
    return _roofline(ctx, K2, lambda n: sum(roofline.least_s(*roofline.k2_counts(n, c, (h, w)))
                                            for c, h, w in blocks))


def k4_roofline(ctx):
    size = ctx.config["crop_size"]
    return _roofline(ctx, K4, lambda n: roofline.least_s(0, roofline.k4_bytes(n, size)))


def idle_share(ctx):
    """Share of the traced window in which the card ran nothing, percent."""
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def mfu(ctx):
    """The model's operations over the traced frames, over the traced
    window, as a share of the card's float32 peak, percent."""
    frames = sum(r.frames for r in ctx.traced if r.ok)
    if not frames:
        return None
    flops = roofline.frame_flops(ctx.config, ctx.traffic["analyzer"]["stride"],
                                 family=ctx.family) * frames
    return 100.0 * flops / ctx.trace.window_s / PEAK_TF32_FLOPS
