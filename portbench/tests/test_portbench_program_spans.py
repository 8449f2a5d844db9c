"""The readers of the port's own spans and counters (``program_spans.py``
and its seven metrics): on a chrome trace written here with a recording
made here, on a program that keeps neither, and in a traced run of the
fixture's cell on the CPU."""

import json
from types import SimpleNamespace

import pytest

from playaid_core_torch import profiling
from portbench import program_spans, run
from portbench.tracing import Trace

SEED = 2**31 + 78

SPAN_METRICS = {"chunk_loop_ms_per_chunk", "embed_host_us_per_crop", "stage_host_us_per_chunk",
                "staged_bytes_per_frame", "classify_span_ms_per_vod"}
IDLE_METRICS = {"idle_decode_wait_share", "idle_dispatch_share"}

# Two analyses in a window of 1,000 us.  The card is idle in [0, 150),
# [260, 320), [480, 640) and [690, 720): 400 us.  The first dispatch wait
# covers half of the first gap, the second part of the third; the third
# gap is mostly, and [310, 320) and [705, 720) wholly, under no span.
HOST = [
    ("portbench.window", 0, 1000),
    ("playaid.analyze", 0, 500), ("playaid.analyze", 500, 500),
    ("playaid.chunk_loop", 10, 390), ("playaid.chunk_loop", 510, 390),
    ("playaid.dispatch_wait", 100, 100), ("playaid.dispatch_wait", 600, 50),
    ("playaid.stage", 200, 20), ("playaid.stage", 650, 10),
    ("playaid.embed", 220, 80), ("playaid.embed", 660, 40),
    ("playaid.scatter", 300, 10), ("playaid.scatter", 700, 5),
    ("playaid.classify", 410, 40), ("playaid.classify", 910, 40),
    ("playaid.labels_to_host", 460, 10), ("playaid.labels_to_host", 960, 30),
    ("aten::conv2d", 230, 20),
]
DEVICE = [(150, 110), (320, 160), (640, 50), (720, 280)]


def _ctx(tmp_path, host=HOST, device=DEVICE):
    ev = [{"cat": "user_annotation" if name.startswith(("portbench.", "playaid.")) else "cpu_op",
           "name": name, "ts": ts, "dur": dur} for name, ts, dur in host]
    ev += [{"cat": "kernel", "name": "conv", "ts": ts, "dur": dur} for ts, dur in device]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return SimpleNamespace(trace=Trace(str(path)))


def _analysis(rec, frames, chunks, crops, staged):
    with profiling.Span(rec, "playaid.analyze", profiling.new_analysis(),
                        {"frames": frames, "chunks": chunks}):
        for _ in range(chunks):
            with profiling.Span(rec, "playaid.stage", None, {"staged_bytes": staged}):
                pass
            with profiling.Span(rec, "playaid.embed", None, {"crops": crops}):
                pass


@pytest.fixture
def recorded(monkeypatch):
    """The process's recording: an analysis the trace does not hold, then
    the trace's two."""
    rec = profiling.Recording()
    monkeypatch.setattr(profiling, "_session", rec)
    for frames, chunks, crops in ((1000, 99, 7), (96, 2, 24), (96, 2, 24)):
        _analysis(rec, frames, chunks, crops, 1000)
    return rec


def _read(name, ctx):
    from portbench.catalog import Catalog
    from portbench.tests.helpers import benchmark

    return Catalog(benchmark()).module("metrics", name).read(ctx)


def test_readers_on_a_written_trace(tmp_path, recorded):
    ctx = _ctx(tmp_path)
    assert program_spans.counts(ctx) == {"frames": 192, "chunks": 4, "crops": 96,
                                         "staged_bytes": 4000}
    assert _read("chunk_loop_ms_per_chunk", ctx) == pytest.approx(780e-3 / 4)
    assert _read("embed_host_us_per_crop", ctx) == pytest.approx(120 / 96)
    assert _read("stage_host_us_per_chunk", ctx) == pytest.approx(30 / 4)
    assert _read("staged_bytes_per_frame", ctx) == pytest.approx(4000 / 192)
    assert _read("classify_span_ms_per_vod", ctx) == pytest.approx((60e-3 + 80e-3) / 2)
    # [100, 150) and [600, 640) idle under a dispatch wait; [260, 310) and
    # [690, 705) under staging, embed and scatter; of 400 us idle in all.
    assert _read("idle_decode_wait_share", ctx) == pytest.approx(9.0)
    assert _read("idle_dispatch_share", ctx) == pytest.approx(6.5)
    assert _read("idle_share", ctx) == pytest.approx(40.0)


def test_no_reading_without_device_events_or_spans(tmp_path, recorded):
    """Without device events (the CPU) the idle shares are None; a trace of
    a program without spans gives no reading at all, never 0."""
    ctx = _ctx(tmp_path, device=[])
    assert {m: _read(m, ctx) for m in IDLE_METRICS} == dict.fromkeys(IDLE_METRICS)
    assert _read("chunk_loop_ms_per_chunk", ctx) == pytest.approx(0.195)
    bare = _ctx(tmp_path, host=[h for h in HOST if not h[0].startswith("playaid.")])
    names = SPAN_METRICS | IDLE_METRICS
    assert {m: _read(m, bare) for m in names} == dict.fromkeys(names)


def test_no_reading_without_the_programs_recording(tmp_path, recorded, monkeypatch):
    """A recording that lost one of the trace's analyses, and a program
    with no recording (one that predates its spans): the counted metrics
    are None, and nothing raises."""
    ctx = _ctx(tmp_path)
    monkeypatch.setattr(profiling, "_session", profiling.Recording(cap=2 + 2 * 2))
    for _ in range(2):
        _analysis(profiling._session, 96, 2, 24, 1000)
    assert len(profiling._session.roots()) == 1
    assert program_spans.counts(ctx) is None
    monkeypatch.delattr(profiling, "session_recording")
    counted = SPAN_METRICS - {"classify_span_ms_per_vod"}
    assert {m: _read(m, ctx) for m in counted} == dict.fromkeys(counted)
    assert _read("classify_span_ms_per_vod", ctx) == pytest.approx(0.07)


def test_traced_run_reports_the_span_metrics(tiny):
    """A traced run of the fixture's cell on the CPU reports the five span
    and counter metrics, and no idle share (no device events)."""
    result = run.run_cell(tiny, "tiny.match", SEED, 0.5, 1, device="cpu")
    assert result["correct"] and result["attempted"] == 1
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    assert SPAN_METRICS <= set(metrics) and not IDLE_METRICS & set(metrics)
    assert metrics["staged_bytes_per_frame"] == 24576  # 2 crops of 128² YUV420 a sampled frame
    assert all(metrics[m] > 0 for m in SPAN_METRICS)
    assert metrics["chunk_loop_ms_per_chunk"] <= metrics["host_loop_ms_per_chunk"]
