"""What the port's own spans and counters give the metric readers.

The port (``playaid_core_torch/profiling.py``) mirrors each of its spans
(names ``playaid.*``, on every thread of an analysis) into the trace as a
``user_annotation`` event while a ``torch.profiler`` session is on, and
keeps their counts (``frames``, ``chunks``, ``crops``, ``staged_bytes``,
``rows``, ``k2_blocks``) in one recording for the process.  Spans come
from the trace's host events, counts from that recording, for the
analyses the trace holds.  A program without them gives nothing to read: every function here
returns None, never 0, and raises nothing.
"""

from __future__ import annotations

import statistics


def spans(ctx, name):
    """``(start us, duration us)`` of the trace's spans ``name``, in time order."""
    return sorted((ts, dur) for n, ts, dur in ctx.trace.host if n == name)


def _analyses(ctx):
    """The recording and the analyses the trace holds: the recording's
    newest analyses, as many as the trace's ``playaid.analyze`` spans;
    None where the program keeps no such recording or lost one of them."""
    from playaid_core_torch import profiling

    n = len(spans(ctx, "playaid.analyze"))
    if not n:
        return None
    recording = getattr(profiling, "session_recording", None)
    if recording is None:
        return None
    rec = recording()
    roots = rec.roots()[-n:]
    if len(roots) < n:
        return None
    return rec, {r.analysis for r in roots}


def counts(ctx):
    """Each count summed over the analyses the trace holds; None where
    :func:`_analyses` finds none."""
    held = _analyses(ctx)
    return None if held is None else held[0].totals(held[1])


def counts_by_span(ctx, name, counter):
    """The count ``counter`` (0 where it is absent) on each span ``name``
    of the analyses the trace holds, in the order they opened; None where
    :func:`_analyses` finds none."""
    held = _analyses(ctx)
    if held is None:
        return None
    rec, analyses = held
    return [s.counts.get(counter, 0) for s in rec.spans
            if s.name == name and s.analysis in analyses and s.end_ns is not None]


def per_count(ctx, name, counter, scale):
    """The total duration of the spans ``name`` (us, times ``scale``) over
    the count ``counter``."""
    total = sum(dur for _, dur in spans(ctx, name))
    c = counts(ctx)
    if not total or not c or not c.get(counter):
        return None
    return total * scale / c[counter]


def ratio(ctx, num, den):
    """The count ``num`` over the count ``den``."""
    c = counts(ctx)
    if not c or not c.get(num) or not c.get(den):
        return None
    return c[num] / c[den]


def classify_ms_per_vod(ctx):
    """From each ``playaid.classify`` start to the end of the next
    ``playaid.labels_to_host``, ms, averaged over the VODs."""
    classify = spans(ctx, "playaid.classify")
    to_host = spans(ctx, "playaid.labels_to_host")
    if not classify or len(classify) != len(to_host):
        return None
    out = []
    for c_ts, _ in classify:
        after = [ts + dur for ts, dur in to_host if ts >= c_ts]
        if not after:
            return None
        out.append((after[0] - c_ts) / 1e3)
    return statistics.fmean(out)


def _merge(intervals):
    """``[start, end)`` intervals merged, in order."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(xs, ys):
    """Length of the intersection of two merged interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_share_under(ctx, names):
    """Share of the traced window, percent, in which the card ran nothing
    while a span of one of ``names`` was open (on any thread); None without
    device events or such spans."""
    tr = ctx.trace
    inside = _merge([(max(ts, tr.t0), min(ts + dur, tr.t1)) for name in names
                     for ts, dur in spans(ctx, name) if ts + dur > tr.t0 and ts < tr.t1])
    if not tr.device or not inside:
        return None
    busy = _merge([(ts, ts + dur) for _, _, ts, dur, *_ in tr.device])
    idle = sum(b - a for a, b in inside) - _overlap(inside, busy)
    return 100.0 * idle / (tr.t1 - tr.t0)
