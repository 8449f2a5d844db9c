"""Classify: device time of the kernels launched inside the port's spans `playaid.head` (the temporal head's call in `classify_buffer`), ms, over the traced VODs."""

import bisect

from portbench import program_spans


def head_kernel_us(ctx):
    """Device us of the kernels launched inside each ``playaid.head`` span
    of the trace, in time order (a launch and its kernel share a
    correlation id); None without such spans, or where one launched no
    kernel."""
    spans = program_spans.spans(ctx, "playaid.head")
    if not spans:
        return None
    starts = [ts for ts, _ in spans]
    out = [0.0] * len(spans)
    for _, cat, _, dur, _, corr in ctx.trace.device:
        t = ctx.trace.launched.get(corr)
        if cat != "kernel" or t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= starts[i] + spans[i][1]:
            out[i] += dur
    return out if all(out) else None


def read(ctx):
    us = head_kernel_us(ctx)
    vods = [r for r in ctx.traced if r.ok]
    if us is None or len(us) != len(vods):
        return None
    return sum(us) / 1e3 / len(vods)
