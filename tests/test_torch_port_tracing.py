"""The port's spans and counters (``playaid_core_torch/profiling.py``) on
the CPU: off, they do nothing; under ``recording()`` a ``VodAnalyzer``
run gives one root a run, each span on its thread and in its analysis,
and counts that match what was staged and embedded; ``profiling.trace``
writes them on the chrome trace's clock; the recording of a bare profiler
session is capped.

The clip is 96 frames of 192x112 mpeg4 written by the port's encoder
(noise and two moving squares), analysed at 64-px crops by a seeded CNN.
"""

import json
import threading

import numpy as np
import pytest
import torch

from playaid_core_torch import profiling
from playaid_core_torch.infer.pipeline import BatchedActionPipeline
from playaid_core_torch.infer.vod_pipeline import VodAnalyzer
from playaid_core_torch.video.native_encoder import NativeVideoWriter

torch.set_num_threads(2)

NUM_FRAMES, HEIGHT, WIDTH, CROP, CHUNK, STRIDE = 96, 112, 192, 64, 48, 2
CALLER = {"playaid.analyze", "playaid.chunk_loop", "playaid.classify", "playaid.head",
          "playaid.viterbi", "playaid.labels_to_host"}
DECODER = {"playaid.decode", "playaid.sink_wait"}
DISPATCHER = {"playaid.dispatch_wait", "playaid.stage", "playaid.embed", "playaid.scatter"}


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    rng = np.random.default_rng(0)
    frames = np.repeat(rng.integers(0, 60, (HEIGHT, WIDTH, 3), np.uint8)[None], NUM_FRAMES, 0)
    boxes = np.zeros((NUM_FRAMES, 2, 4), np.float32)
    for i in range(NUM_FRAMES):
        for k, x in enumerate((20 + i, 150 - i)):
            frames[i, 40:70, x:x + 30] = (0, 200, 255) if k else (255, 80, 0)
            boxes[i, k] = ((x + 15) / WIDTH, 55 / HEIGHT, 30 / WIDTH, 30 / HEIGHT)
    path = str(tmp_path_factory.mktemp("tracing") / "clip.mp4")
    with NativeVideoWriter(path, 30, (WIDTH, HEIGHT), codec="mpeg4", preset=None,
                           crf=2) as writer:
        for frame in frames:
            writer.write(frame)
    return path, boxes


@pytest.fixture(scope="module")
def pipe():
    return BatchedActionPipeline(family="cnn", crop_size=CROP, device="cpu").init(0)


def _analyzer(pipe, workers):
    return VodAnalyzer(pipe, chunk=CHUNK, stride=STRIDE, padding=4, decode_workers=workers,
                       decode="viterbi")


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    """With no recording and no profiler session, a span is one shared
    object, and neither it nor a count reads the clock or calls torch."""
    def refuse(*args, **kwargs):
        raise AssertionError("called while recording is off")

    assert profiling._active is None and not torch.autograd.profiler._is_profiler_enabled
    session = profiling.session_recording()
    before = (len(session.spans), dict(session.counters))
    monkeypatch.setattr(profiling.time, "time_ns", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with profiling.span("playaid.embed", crops=4):
        profiling.count("crops", 4)
    assert profiling.span("playaid.embed", crops=4) is profiling.span("playaid.stage") \
        is profiling._OFF
    assert (len(session.spans), dict(session.counters)) == before


@pytest.mark.parametrize("workers", [1, 2])
def test_analyze_spans_threads_and_counts(clip, pipe, monkeypatch, workers):
    """One root a run; every span in its analysis; each name on the thread
    the port runs it on; one embed a chunk; ``crops`` twice the sampled
    rows; ``staged_bytes`` the bytes of the staged arrays."""
    path, boxes = clip
    staged = []
    stage = profiling.Span.__init__

    def noted(self, rec, name, analysis, counts):
        if name == "playaid.stage":
            staged.append(counts["staged_bytes"])
        stage(self, rec, name, analysis, counts)

    monkeypatch.setattr(profiling.Span, "__init__", noted)
    with profiling.recording() as rec:
        out = _analyzer(pipe, workers).analyze(path, boxes)
    assert out["frames"] == NUM_FRAMES
    spans = list(rec.spans)
    roots = rec.roots()
    assert [r.name for r in roots] == ["playaid.analyze"] and roots[0].parent is None
    root = roots[0]
    assert {s.analysis for s in spans} == {root.analysis}
    by_thread = {}
    for s in spans:
        by_thread.setdefault(s.thread, set()).add(s.name)
    caller = threading.get_ident()
    dispatcher = [t for t, names in by_thread.items() if "playaid.embed" in names]
    assert len(dispatcher) == 1 and dispatcher[0] != caller
    assert by_thread.pop(dispatcher[0]) == DISPATCHER
    # The decode spans are on the pool's worker threads, one thread or more.
    assert by_thread.pop(caller) == CALLER
    assert by_thread and all(names == DECODER for names in by_thread.values())
    assert len(by_thread) <= workers
    for s in spans:
        if s.thread != caller:  # a worker's outermost spans hang under the root
            outer = {p.id for p in spans if p.thread == s.thread}
            assert s.parent in outer or s.parent == root.id
    rows = NUM_FRAMES // STRIDE
    chunks = NUM_FRAMES // CHUNK
    windows = 2 * 64  # both fighters' rows of the buffer, padded to a power of two
    assert sum(s.name == "playaid.embed" for s in spans) == chunks
    assert len(staged) == chunks and sum(staged) == 2 * rows * CROP * CROP * 3 // 2
    assert rec.totals() == dict(rec.counters) == {
        "frames": NUM_FRAMES, "chunks": chunks, "crops": 2 * rows, "rows": rows,
        "windows": windows, "staged_bytes": sum(staged)}
    assert root.counts == {"frames": NUM_FRAMES, "chunks": chunks}
    summary = rec.summary()
    assert summary["playaid.embed"]["count"] == chunks
    assert summary["playaid.embed"]["crops"] == 2 * rows
    assert summary["playaid.analyze"]["self_ms"] < summary["playaid.analyze"]["total_ms"]


def test_self_time_subtracts_only_children_on_the_same_thread(monkeypatch):
    """A root with a child on its thread and one on a worker bound to its
    analysis: the root's self time loses the first child only; the
    worker's span hangs under the root."""
    clock = iter([0, 10, 30, 40, 100, 200])
    monkeypatch.setattr(profiling.time, "time_ns", lambda: next(clock))
    with profiling.recording() as rec:
        analysis = profiling.new_analysis()
        with profiling.span("root", analysis=analysis) as root:
            with profiling.span("child"):
                pass

            def work():
                profiling.bind(analysis)
                with profiling.span("worker", n=3):
                    pass

            t = threading.Thread(target=work)
            t.start()
            t.join()
    summary = rec.summary()
    assert summary["root"] == {"count": 1, "total_ms": 200e-6, "self_ms": 180e-6}
    assert summary["child"]["self_ms"] == 20e-6
    assert summary["worker"] == {"count": 1, "total_ms": 60e-6, "self_ms": 60e-6, "n": 3}
    worker = next(s for s in rec.spans if s.name == "worker")
    assert worker.parent == root.id and worker.analysis == analysis
    assert worker.thread != root.thread


def test_trace_holds_the_dispatchers_spans_on_its_clock(clip, pipe, tmp_path):
    """Under ``profiling.trace``, the dispatcher's ``playaid.embed`` spans
    are in ``trace.json`` (every thread profiled), and ``spans.json`` times
    them on the trace's clock, within 1 ms."""
    path, boxes = clip
    with profiling.trace(str(tmp_path)):
        _analyzer(pipe, 2).analyze(path, boxes)
    trace = json.loads((tmp_path / profiling.TRACE_FILE).read_text())
    base = int(trace["baseTimeNanoseconds"])
    traced = sorted(base + 1000 * float(e["ts"]) for e in trace["traceEvents"]
                    if e.get("name") == "playaid.embed" and e.get("cat") == "user_annotation")
    spans = json.loads((tmp_path / profiling.SPANS_FILE).read_text())
    recorded = sorted(s["start_ns"] for s in spans["spans"] if s["name"] == "playaid.embed")
    assert len(traced) == len(recorded) == NUM_FRAMES // CHUNK
    assert max(abs(a - b) for a, b in zip(traced, recorded)) < 1e6
    assert spans["counters"]["crops"] == 2 * NUM_FRAMES // STRIDE
    assert spans["summary"]["playaid.analyze"]["count"] == 1


def test_bare_session_recording_is_capped(monkeypatch):
    """Spans made under a profiler session with no recording open go to the
    process's recording, which keeps the newest spans, counts those it
    lets go, and keeps every count."""
    monkeypatch.setattr(profiling, "_session", profiling.Recording(cap=5))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for i in range(8):
            with profiling.span("playaid.stage", staged_bytes=10):
                profiling.count("crops", 2)
    rec = profiling.session_recording()
    assert rec is profiling._session
    assert rec.dropped == 3 and len(rec.spans) == 5
    assert dict(rec.counters) == {"staged_bytes": 80, "crops": 16}
    assert rec.totals() == {"staged_bytes": 50, "crops": 10}
    with profiling.span("playaid.stage"):  # the session is over: off again
        pass
    assert len(rec.spans) == 5 and rec.dropped == 3


def test_recording_mirrors_into_the_profiler_only_under_a_session(monkeypatch):
    """``recording()`` alone enters no ``record_function``; a recording
    ends with its block, and the previous one (none) is back."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no session on")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    with profiling.recording() as outer:
        with profiling.recording() as inner:
            with profiling.span("a"):
                pass
        with profiling.span("b"):
            pass
    assert [s.name for s in inner.spans] == ["a"] and [s.name for s in outer.spans] == ["b"]
    assert profiling._active is None
