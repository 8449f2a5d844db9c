"""K5's work from shapes and the ``k5_roofline`` reader (``portbench/k5.py``)."""

import json
from types import SimpleNamespace

import pytest

from portbench import k5, roofline
from portbench.catalog import Catalog
from portbench.tracing import Trace

CATALOG = Catalog()


def test_1x1_work_of_resnet50():
    """36 convolutions a ResNet-50 crop at 128 px (16 conv1, 16 conv3, 4
    projections), 1.384 GFLOP: about half of the trunk's 2.669."""
    convs = k5.k5_convs(CATALOG.family("resformer"), 128)
    assert len(convs) == 36 and [c[4] for c in convs].count("residual") == 16
    assert [c[4] for c in convs].count("none") == 4
    assert sum(c[2] == 2 for c in convs) == 3  # the projections of layers 2-4
    flops = sum(k5.conv1x1_counts(1, *c)[0] for c in convs)
    assert flops == 1_384_120_320
    assert flops / roofline.resnet_flops("resnet50", 128) == pytest.approx(0.5186, abs=1e-4)


@pytest.mark.parametrize("family", ["cnn", "rnn"])
def test_resnet18_families_run_no_1x1_on_k5(family):
    assert k5.k5_convs(CATALOG.family(family), 128) == []


def test_counts_of_one_convolution():
    # layer 2's projection: 256 -> 512, stride 2, from 32 x 32 to 16 x 16.
    flops, nbytes = k5.conv1x1_counts(48, 256, 512, 2, 32)
    assert flops == 2 * 48 * 256 * 256 * 512
    assert nbytes == (48 * 256 * (256 + 512) + 256 * 512 + 2 * 512) * 4
    # layer 4's conv3 reads the residual besides: 512 -> 2048 at 4 x 4.
    _, with_residual = k5.conv1x1_counts(48, 512, 2048, 1, 4, "residual")
    assert with_residual == (48 * 16 * (512 + 2 * 2048) + 512 * 2048 + 2 * 2048) * 4


def _trace(tmp_path, second_call_records=True):
    """Two embed spans; K5 kernels launched inside them (two in the first
    call, one or none in the second), one launched outside both."""
    ev = [
        {"cat": "user_annotation", "name": "portbench.window", "ts": 0, "dur": 1000},
        {"cat": "user_annotation", "name": "playaid.analyze", "ts": 50, "dur": 900},
        {"cat": "user_annotation", "name": "portbench.embed", "ts": 100, "dur": 50},
        {"cat": "user_annotation", "name": "portbench.embed", "ts": 300, "dur": 50},
    ]
    for corr, ts in ((1, 110), (2, 120), (3, 310), (4, 500)):
        ev.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 5,
                   "args": {"correlation": corr}})
    for corr, ts, dur in ((1, 200, 40), (2, 240, 20), (4, 600, 7)):
        ev.append({"cat": "kernel", "name": "void conv1x1_gemm_kernel<1, 64, 1>",
                   "ts": ts, "dur": dur, "args": {"correlation": corr}})
    ev.append({"cat": "kernel", "name": "other", "ts": 700, "dur": 9,
               "args": {"correlation": 3}})
    if second_call_records:
        ev.append({"cat": "kernel", "name": "conv1x1_gemm_kernel", "ts": 400, "dur": 30,
                   "args": {"correlation": 3}})
    path = tmp_path / "e.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return Trace(str(path))


@pytest.mark.parametrize("family,complete,counted", [
    ("resformer", True, 36), ("resformer", False, 36), ("resformer", True, 35),
    ("cnn", True, 0), ("rnn", True, 0)])
def test_roofline_from_each_calls_crops(tmp_path, monkeypatch, family, complete, counted):
    """The least time of both calls, each from its crops at every 1x1 the
    family runs on K5, over the device time of their K5 launches; no reading
    where a call left no K5 record, where the port's ``k5_convs`` on an
    embed span is not the family's count, or where the family runs none."""
    from playaid_core_torch import profiling

    rec = profiling.Recording()
    monkeypatch.setattr(profiling, "_session", rec)
    with profiling.Span(rec, "playaid.analyze", profiling.new_analysis(), {}):
        for convs in (36 if family == "resformer" else 0, counted):
            with profiling.Span(rec, "playaid.embed", None, {"k5_convs": convs}):
                pass
    ctx = SimpleNamespace(trace=_trace(tmp_path, complete),
                          traced=[SimpleNamespace(embeds=[48, 24])],
                          config={"crop_size": 128}, family=CATALOG.family(family))
    convs = k5.k5_convs(ctx.family, 128)
    least = sum(roofline.least_s(*k5.conv1x1_counts(n, *c)) for n in (48, 24) for c in convs)
    sound = family == "resformer" and complete and counted == 36
    assert k5.k5_roofline(ctx) == (pytest.approx(100.0 * least / 90e-6) if sound else None)


def test_the_reader_is_found_by_name():
    assert CATALOG.module("metrics", "k5_roofline").read is not None
