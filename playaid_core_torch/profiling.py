"""Tracing: spans and counters of the port's host work, a ``torch.profiler``
session of every thread, and per-stage timing.

Counterpart of ``playaid_core_tpu/profiling.py``:

* :func:`span` and :func:`count` — a named span of host work, with counts,
  and a count added to the enclosing span.  Both do nothing unless
  recording is on: while an operator holds ``with recording() as rec:``,
  or while any ``torch.profiler`` session is on, when they go to one
  recording for the whole process (:func:`session_recording`).  Under a
  session each span also enters ``record_function``, so it sits in the
  exported trace on the device events' clock and the kernels it launches
  join it by correlation id;
* :func:`tally` — the counts of this thread held aside, recording or not:
  what work captured into a CUDA graph counts, for each replay to count
  again;
* :func:`new_analysis` and :func:`bind` — an analysis id for the spans of
  one VOD analysis, passed to the threads that work for it;
* :func:`trace` — a ``torch.profiler`` session of every thread of the
  host and, when there is one, the CUDA device, written as a chrome trace
  (``trace.json``, for Perfetto or ``chrome://tracing``) and the session's
  spans and counters (``spans.json``) into ``log_dir``;
* :class:`StageTimer` — per-stage wall-clock accumulation (as is).

Span times are ``time.time_ns()``, the clock of the chrome trace's host
events (``baseTimeNanoseconds + 1000 * ts``).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict

from torch.autograd import profiler as _autograd_profiler

TRACE_FILE = "trace.json"
SPANS_FILE = "spans.json"
MAX_SPANS = 200_000  # a recording keeps the newest spans; about 1,800 a match

_active = None  # the recording an operator holds open, or None
_local = threading.local()  # per thread: ``stack`` of open spans, bound ``analysis``
_analyses = itertools.count(1)


class Recording:
    """Spans (the newest ``cap``; ``dropped`` counts the older ones let go)
    and ``counters`` (every count, dropped spans' too)."""

    def __init__(self, cap=MAX_SPANS):
        self.spans = collections.deque(maxlen=cap)
        self.counters = defaultdict(int)
        self.dropped = 0
        self._roots = {}  # analysis -> id of its root span
        self._ids = itertools.count()
        self._lock = threading.Lock()

    def _open(self, s):
        with self._lock:
            s.id = next(self._ids)
            if s.analysis is not None and s.analysis not in self._roots:
                self._roots[s.analysis] = s.id
            if len(self.spans) == self.spans.maxlen:
                self.dropped += 1
            self.spans.append(s)
            for name, n in s.counts.items():
                self.counters[name] += n

    def _add(self, name, n):
        with self._lock:
            self.counters[name] += n

    def _ended(self):
        with self._lock:
            return [s for s in self.spans if s.end_ns is not None]

    def roots(self):
        """The root span of each analysis whose spans are all held, oldest
        first (a root is its analysis's first span, so the spans after it
        are held while it is)."""
        return [s for s in self._ended() if self._roots.get(s.analysis) == s.id]

    def totals(self, analyses=None):
        """Each count summed over the ended spans held, of ``analyses``
        only when given."""
        out = defaultdict(int)
        for s in self._ended():
            if analyses is None or s.analysis in analyses:
                for name, n in s.counts.items():
                    out[name] += n
        return dict(out)

    def summary(self):
        """Per span name: ``count``, ``total_ms``, ``self_ms`` (less what its
        children on the same thread cover) and the sums of its counts."""
        spans = self._ended()
        covered = defaultdict(int)
        for s in spans:
            if s.parent is not None:
                covered[(s.parent, s.thread)] += s.end_ns - s.start_ns
        out = {}
        for s in spans:
            e = out.setdefault(s.name, {"count": 0, "total_ms": 0.0, "self_ms": 0.0})
            ns = s.end_ns - s.start_ns
            e["count"] += 1
            e["total_ms"] += ns / 1e6
            e["self_ms"] += (ns - covered[(s.id, s.thread)]) / 1e6
            for name, n in s.counts.items():
                e[name] = e.get(name, 0) + n
        return out

    def write(self, path):
        """The spans, counters and summary as JSON, times in ``time.time_ns()``."""
        with open(path, "w") as f:
            json.dump({"clock": "time.time_ns", "dropped": self.dropped,
                       "counters": dict(self.counters), "summary": self.summary(),
                       "spans": [s.record() for s in self._ended()]}, f)


class Span:
    """One span of host work on one thread; a context manager."""

    __slots__ = ("name", "counts", "analysis", "thread", "parent", "id", "start_ns", "end_ns",
                 "_rec", "_mirror")

    def __init__(self, rec, name, analysis, counts):
        self._rec, self.name, self.analysis, self.counts = rec, name, analysis, counts
        self.parent = self.start_ns = self.end_ns = self._mirror = None

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        if stack:
            self.parent = stack[-1].id
            if self.analysis is None:
                self.analysis = stack[-1].analysis
        else:
            if self.analysis is None:
                self.analysis = getattr(_local, "analysis", None)
            self.parent = self._rec._roots.get(self.analysis)
        self.thread = threading.get_ident()
        self._rec._open(self)
        stack.append(self)
        if _autograd_profiler._is_profiler_enabled:
            self._mirror = _autograd_profiler.record_function(self.name)
            self._mirror.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if self._mirror is not None:
            self._mirror.__exit__(*exc)
        _local.stack.pop()
        return False

    def record(self):
        return {"name": self.name, "thread": self.thread, "analysis": self.analysis,
                "parent": self.parent, "id": self.id, "start_ns": self.start_ns,
                "end_ns": self.end_ns, "counts": self.counts}


_OFF = contextlib.nullcontext()  # the span while recording is off
_session = Recording()


def span(name, analysis=None, **counts):
    """A span of the block, named ``name``, holding ``counts``.  It belongs
    to ``analysis`` if given, else to the enclosing span's analysis, else
    to the thread's (:func:`bind`); its parent is the enclosing span on
    this thread, else the analysis's root (its first span)."""
    if _active is None and not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return Span(_active or _session, name, analysis, counts)


def count(name, n):
    """Add ``n`` to the counter ``name``, and to the enclosing span's counts;
    while a :func:`tally` is open on this thread, to the tally alone."""
    held = getattr(_local, "tally", None)
    if held is not None:
        held[name] += n
        return
    if _active is None and not _autograd_profiler._is_profiler_enabled:
        return
    stack = getattr(_local, "stack", None)
    if stack:
        top = stack[-1]
        top.counts[name] = top.counts.get(name, 0) + n
        top._rec._add(name, n)
    else:
        (_active or _session)._add(name, n)


@contextlib.contextmanager
def tally():
    """Hold this thread's counts while the block runs, whether or not
    recording is on, and add them nowhere else; yields the ``Counter``
    they go to.  Kernel launches that ``ops/_build.count_launch`` counts
    go to it too, under their wrapper.  What a CUDA graph's capture
    counts: each replay counts it again (``infer/graph_cache.py``)."""
    prev = getattr(_local, "tally", None)
    _local.tally = held = collections.Counter()
    try:
        yield held
    finally:
        _local.tally = prev


def tallying():
    """This thread's open :func:`tally`, or None."""
    return getattr(_local, "tally", None)


def new_analysis():
    """A fresh analysis id, unique in the process."""
    return next(_analyses)


def bind(analysis):
    """Spans this thread opens outside any other belong to ``analysis``,
    under its root: the first call of a thread that works for one analysis."""
    _local.analysis = analysis


@contextlib.contextmanager
def recording():
    """Record the spans and counts of every thread while the block runs;
    yields the :class:`Recording`."""
    global _active
    rec, prev = Recording(), _active
    _active = rec
    try:
        yield rec
    finally:
        _active = prev


def session_recording():
    """The process's recording of spans and counts made while a
    ``torch.profiler`` session was on and no :func:`recording` was open."""
    return _session


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
    """Trace the block with ``torch.profiler`` (every thread of the host,
    and the CUDA device when one is available) and write
    ``log_dir/trace.json``, and the block's spans and counters to
    ``log_dir/spans.json``.  Yields the profiler.

    On CUDA the session first runs one small kernel to its end: traces
    that began with copies lost device records of them late in a long
    process, and traces that began with a kernel did not (PERF.md,
    ``tools/torch_port_trace_audit.py lead``).
    """
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with recording() as rec:
        with profile(activities=activities,
                     experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
            if cuda:
                torch.ones(1, device="cuda").add_(1)
                torch.cuda.synchronize()
            yield prof
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
    rec.write(os.path.join(log_dir, SPANS_FILE))
