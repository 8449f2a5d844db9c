"""The traced sub-window: a ``torch.profiler`` session of the host and the
card, written as a chrome trace, and what the metric readers take from it.

The harness's own spans (``record_function``, names ``portbench.*``) mark
the traced window (``portbench.window``), each analysis
(``portbench.analyze``), each embed call (``portbench.embed``, on the
port's dispatch thread) and each ``classify_buffer`` call
(``portbench.classify``).  Device time is the union of the intervals of
the kernels, copies and sets the card ran inside the window.  A kernel
belongs to the span in which the host launched it: the launch and the
kernel share a correlation id.
"""

from __future__ import annotations

import bisect
import contextlib
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
CONTAINER_SPANS = ("portbench.window", "portbench.analyze")  # cover every gap: not a cause


@contextlib.contextmanager
def profiled(torch, path, cuda=True):
    """Profile the block (the host, and the card if ``cuda``) and write the
    chrome trace to ``path``.  Every thread of the process is profiled: the
    port embeds on a thread of its own.  The session first runs one small
    kernel to its end: traces that open with a copy have lost device
    records of copies."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities,
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        if cuda:
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


def union_us(intervals):
    """Length of the union of ``(start, duration)`` intervals."""
    total, end = 0.0, float("-inf")
    for ts, dur in sorted(intervals):
        if ts + dur > end:
            total += ts + dur - max(ts, end)
            end = ts + dur
    return total


class Trace:
    """The events of one exported trace: ``device`` (name, category, start
    us, duration us, bytes, correlation id), ``spans`` of the harness by
    name, in time order, ``host`` events (name, start, duration), and
    ``launched``: correlation id -> start of the host call that launched
    it."""

    def __init__(self, path):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        self.device, self.host, self.spans, self.launched = [], [], {}, {}
        for e in events:
            cat, dur = e.get("cat"), e.get("dur")
            if dur is None:
                continue
            ts, dur, name = float(e["ts"]), float(dur), e.get("name", "")
            args = e.get("args", {})
            if cat in DEVICE_CATS:
                self.device.append((name, cat, ts, dur, args.get("bytes"),
                                    args.get("correlation")))
            elif cat in HOST_CATS:
                self.host.append((name, ts, dur))
                if cat in LAUNCH_CATS and "correlation" in args:
                    self.launched[args["correlation"]] = ts
                if cat == "user_annotation" and name.startswith("portbench."):
                    self.spans.setdefault(name, []).append((ts, dur))
        for spans in self.spans.values():
            spans.sort()
        (self.t0, wdur), = self.spans["portbench.window"]
        self.t1 = self.t0 + wdur
        self.device = sorted((d for d in self.device if self.t0 <= d[2] <= self.t1),
                             key=lambda d: d[2])

    @property
    def window_s(self):
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self):
        return union_us([(d[2], d[3]) for d in self.device]) / 1e6

    def kernels(self, fragment, t0=None, t1=None):
        """Durations (us) of the kernels whose name holds ``fragment``,
        started in ``[t0, t1]`` (the whole window by default)."""
        t0 = self.t0 if t0 is None else t0
        t1 = self.t1 if t1 is None else t1
        return [dur for name, cat, ts, dur, *_ in self.device
                if cat == "kernel" and fragment in name and t0 <= ts <= t1]

    def kernels_by_span(self, span, fragment):
        """For each span named ``span``, in time order, the durations (us)
        of the kernels whose name holds ``fragment`` and whose launch lies
        inside it."""
        spans = self.spans.get(span, [])
        starts = [ts for ts, _ in spans]
        out = [[] for _ in spans]
        for name, cat, _, dur, _, corr in self.device:
            t = self.launched.get(corr)
            if cat != "kernel" or fragment not in name or t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= starts[i] + spans[i][1]:
                out[i].append(dur)
        return out

    def h2d_bytes(self):
        return sum(b or 0 for name, cat, _, _, b, _ in self.device
                   if cat == "gpu_memcpy" and "HtoD" in name)

    def device_ops(self, top=10):
        """``[[name, seconds], ...]``: the device operations that took most
        time in the window, by name."""
        by_name = {}
        for name, _, _, dur, *_ in self.device:
            by_name[name] = by_name.get(name, 0.0) + dur
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:160], us / 1e6] for name, us in ranked]

    def idle_gaps(self, top=10):
        """``[[host event, seconds], ...]``: the card's idle time in the
        window, each gap named by the innermost host event (an operator, a
        runtime call, the classify span) that covers its middle, or, where
        none does, ``after <event>`` by the last one to end before it;
        summed by name, longest first."""
        gaps, end = [], self.t0
        for _, _, ts, dur, *_ in self.device:
            if ts > end:
                gaps.append((end, ts - end))
            end = max(end, ts + dur)
        if self.t1 > end:
            gaps.append((end, self.t1 - end))
        host = sorted((h for h in self.host if h[0] not in CONTAINER_SPANS), key=lambda h: h[1])
        by_name, active, i, last = {}, [], 0, (float("-inf"), "nothing")
        for start, length in gaps:  # in time order: one sweep over the host events
            mid = start + length / 2
            while i < len(host) and host[i][1] <= mid:
                name, ts, dur = host[i]
                active.append((ts + dur, dur, name))
                i += 1
            for a in active:
                if a[0] < mid and a[0] > last[0]:
                    last = (a[0], a[2])
            active = [a for a in active if a[0] >= mid]
            name = min(active, key=lambda a: a[1])[2] if active else f"after {last[1]}"
            by_name[name] = by_name.get(name, 0.0) + length
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:160], us / 1e6] for name, us in ranked]
