"""Tracing and per-stage timing.

Counterpart of ``playaid_core_tpu/profiling.py``:

* :class:`StageTimer` — per-stage wall-clock accumulation (as is);
* :func:`trace` — a ``torch.profiler`` session of the host and, when there
  is one, the CUDA device, written as a chrome trace (``trace.json``, for
  Perfetto or ``chrome://tracing``) into ``log_dir``;
* :func:`annotate_stage` — ``torch.profiler.record_function``, so host
  stages show on the trace's timeline.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

TRACE_FILE = "trace.json"


class StageTimer:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - start
            self.counts[name] += 1

    def add(self, name, seconds):
        self.totals[name] += seconds
        self.counts[name] += 1

    def summary(self):
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_ms": round(1000 * self.totals[name] / max(self.counts[name], 1), 3),
            }
            for name in sorted(self.totals)
        }

    def report(self):
        return json.dumps(self.summary(), indent=1)


@contextlib.contextmanager
def trace(log_dir):
    """Trace the block with ``torch.profiler`` (host, and the CUDA device
    when one is available) and write ``log_dir/trace.json``.  Yields the
    profiler.

    On CUDA the session first runs one small kernel to its end: traces
    that began with copies lost device records of them late in a long
    process, and traces that began with a kernel did not (PERF.md,
    ``tools/torch_port_trace_audit.py lead``).
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        if cuda:
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate_stage(name):
    """Named region on the profiler timeline for host-side stages."""
    import torch

    return torch.profiler.record_function(name)
