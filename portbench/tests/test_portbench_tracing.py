"""What the readers take from a chrome trace, on a trace written here."""

import json

import pytest

from portbench.tracing import Trace, union_us


def _trace(tmp_path):
    ev = [
        {"cat": "user_annotation", "name": "portbench.window", "ts": 100, "dur": 100},
        {"cat": "user_annotation", "name": "portbench.analyze", "ts": 100, "dur": 100},
        {"cat": "kernel", "name": "k_a", "ts": 90, "dur": 5},            # before the window
        {"cat": "kernel", "name": "yuv420_unpack_kernel", "ts": 100, "dur": 10},
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)", "ts": 105, "dur": 10,
         "args": {"bytes": 4096}},
        {"cat": "kernel", "name": "conv", "ts": 140, "dur": 20},
        {"cat": "kernel", "name": "conv", "ts": 150, "dur": 5},          # overlaps the last
        {"cat": "cpu_op", "name": "aten::copy_", "ts": 112, "dur": 10},  # ends before gap 1's middle
        {"cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 165, "dur": 30},
        {"cat": "cpu_op", "name": "no duration", "ts": 1},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return Trace(str(path))


def test_window_and_busy(tmp_path):
    tr = _trace(tmp_path)
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx(35e-6)   # [100, 115) and [140, 160)
    assert tr.kernels("conv") == [20, 5] and tr.kernels("k_a") == []
    assert tr.h2d_bytes() == 4096


def test_idle_gaps_by_host_event(tmp_path):
    gaps = dict(_trace(tmp_path).idle_gaps())
    # [115, 140): nothing covers 127.5, aten::copy_ ended last; [160, 200): the sync.
    assert gaps == {"after aten::copy_": pytest.approx(25e-6),
                    "cudaStreamSynchronize": pytest.approx(40e-6)}


def test_union():
    assert union_us([(0, 10), (5, 10), (30, 1)]) == 16


def _embed_trace(tmp_path, second_call_records=True):
    """Two embed spans; K2's kernels launched inside them (two in the first
    call, one in the second, or none), one launched outside both."""
    ev = [
        {"cat": "user_annotation", "name": "portbench.window", "ts": 0, "dur": 1000},
        {"cat": "user_annotation", "name": "playaid.analyze", "ts": 50, "dur": 900},
        {"cat": "user_annotation", "name": "portbench.embed", "ts": 100, "dur": 50},
        {"cat": "user_annotation", "name": "portbench.embed", "ts": 300, "dur": 50},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 110, "dur": 5,
         "args": {"correlation": 1}},
        {"cat": "cuda_driver", "name": "cuLaunchKernel", "ts": 120, "dur": 5,
         "args": {"correlation": 2}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 310, "dur": 5,
         "args": {"correlation": 3}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 500, "dur": 5,
         "args": {"correlation": 4}},
        {"cat": "kernel", "name": "conv3x3_wgmma_kernel", "ts": 200, "dur": 40,
         "args": {"correlation": 1}},
        {"cat": "kernel", "name": "conv3x3_wgmma_kernel", "ts": 240, "dur": 20,
         "args": {"correlation": 2}},
        {"cat": "kernel", "name": "conv3x3_wgmma_kernel", "ts": 600, "dur": 7,
         "args": {"correlation": 4}},
        {"cat": "kernel", "name": "other", "ts": 700, "dur": 9, "args": {"correlation": 3}},
    ]
    if second_call_records:
        ev.append({"cat": "kernel", "name": "conv3x3_wgmma_kernel", "ts": 400, "dur": 30,
                   "args": {"correlation": 3}})
    path = tmp_path / "e.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return Trace(str(path))


def test_kernels_belong_to_the_span_that_launched_them(tmp_path):
    tr = _embed_trace(tmp_path)
    assert tr.kernels_by_span("portbench.embed", "conv3x3") == [[40, 20], [30]]
    assert tr.kernels_by_span("portbench.classify", "conv3x3") == []


@pytest.mark.parametrize("complete,k2_blocks", [(True, 5), (False, 5), (True, 4)])
def test_roofline_from_each_calls_crops(tmp_path, monkeypatch, complete, k2_blocks):
    """The least time of both calls, each from its crops at every block the
    CNN family runs on K2, over the device time of their launches, whatever
    the launches a call; no reading where a call left no record, or where
    the port's count of K2 blocks on an embed span is not the family's."""
    from types import SimpleNamespace

    from playaid_core_torch import profiling
    from portbench import readers, roofline
    from portbench.catalog import Catalog

    rec = profiling.Recording()
    monkeypatch.setattr(profiling, "_session", rec)
    with profiling.Span(rec, "playaid.analyze", profiling.new_analysis(), {}):
        for blocks in (5, k2_blocks):
            with profiling.Span(rec, "playaid.embed", None, {"k2_blocks": blocks}):
                pass
    ctx = SimpleNamespace(trace=_embed_trace(tmp_path, complete),
                          traced=[SimpleNamespace(embeds=[48, 24])],
                          config={"crop_size": 128}, family=Catalog().family("cnn"))
    shapes = [(64, 32, 32), (64, 32, 32), (128, 16, 16), (256, 8, 8), (512, 4, 4)]
    least = sum(roofline.least_s(*roofline.k2_counts(n, c, (h, w)))
                for n in (48, 24) for c, h, w in shapes)
    sound = complete and k2_blocks == 5
    assert readers.k2_roofline(ctx) == (pytest.approx(100.0 * least / 90e-6) if sound else None)
