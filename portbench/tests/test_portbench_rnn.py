"""The RNN family (``families/rnn.py``) against the port on the CPU, on
seeded weights at the published widths; its counts written out; a cell of
it run through the harness at a tiny size; and the readers of the port's
``playaid.head`` spans on a trace written here."""

import json
from types import SimpleNamespace

import pytest
import torch

from playaid_core_torch import profiling
from portbench import program_spans, roofline, run
from portbench.catalog import Catalog
from portbench.tests.helpers import ROOT, benchmark
from portbench.tests.test_portbench_run import (_plant, altered_confidence, altered_label,
                                                half_batch, unchanged_state)
from portbench.tracing import Trace

SEED = 2**31 + 81
CATALOG = Catalog(benchmark())
CONFIG = CATALOG.config("rnn")
FAMILY = CATALOG.family("rnn")


@pytest.fixture(scope="module")
def pipe_and_weights():
    from playaid_core_torch.infer.pipeline import BatchedActionPipeline

    sd = FAMILY.weights(CONFIG, SEED, "cpu", ROOT)
    pipe = BatchedActionPipeline(family="rnn", num_actions=CONFIG["num_actions"],
                                 sequence_length=CONFIG["sequence_length"],
                                 frame_delta=CONFIG["frame_delta"], device="cpu")
    return pipe.load_state_dicts(sd), sd


def test_weights_load_strictly_and_follow_the_seed(pipe_and_weights):
    """One draw over the port's own names and shapes, in its order, that
    ``load_state_dict`` takes strictly; the same seed draws the same."""
    pipe, sd = pipe_and_weights
    for g in ("embed", "head"):
        port = getattr(pipe, g).state_dict()
        assert [(k, tuple(v.shape)) for k, v in port.items()] == \
            [(k, tuple(v.shape)) for k, v in sd[g].items()]
        assert all(torch.equal(port[k], sd[g][k]) for k in port)
    again = FAMILY.weights(CONFIG, SEED, "cpu", ROOT)
    other = FAMILY.weights(CONFIG, SEED + 1, "cpu", ROOT)
    w = "lstm.weight_hh_l2"
    assert torch.equal(again["head"][w], sd["head"][w])
    assert not torch.equal(other["head"][w], sd["head"][w])
    assert sd["head"]["lstm.weight_ih_l0"].shape == (4 * 512, 300)


def test_embed_matches_the_port(pipe_and_weights):
    pipe, sd = pipe_and_weights
    crops = torch.rand(3, 128, 128, 3, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        ref = FAMILY.embed(crops.permute(0, 3, 1, 2), sd["embed"], CONFIG)
    port = pipe.embed_crops(crops)
    assert ref.shape == port.shape == (3, 300)
    # Both sides convolve in float32 on the CPU in their own order: rounding
    # of sums over up to 4,608 terms, far under 1e-4 of the largest output.
    assert torch.allclose(ref, port, atol=1e-4 * port.abs().max().item(), rtol=0)


def test_head_matches_the_port(pipe_and_weights):
    pipe, sd = pipe_and_weights
    windows = torch.randn(64, 7, 300, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        ref = FAMILY.head(windows, sd["head"], CONFIG)
        port = pipe._head_apply(windows)
    assert ref.shape == port.shape == (64, 63)
    # nn.LSTM's fused gates against the gate equations, float32: rounding of
    # sums over 812-1,024 terms, about 1e-7 nats after three layers.
    assert torch.allclose(ref, port, atol=1e-5, rtol=0)


def test_gate_equations_are_nn_lstm():
    """The reference's LSTM against ``nn.LSTM`` (gates i, f, g, o; both
    biases; zero initial state; 3 layers), with biases drawn nonzero."""
    lstm = torch.nn.LSTM(300, 512, 3, batch_first=True)
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for p in lstm.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
        x = torch.randn(16, 7, 300, generator=gen)
        ref = FAMILY.lstm(x, {f"lstm.{k}": v for k, v in lstm.state_dict().items()}, 3)
        assert torch.allclose(ref, lstm(x)[0], atol=1e-5, rtol=0)  # float32 rounding, |h| < 1


def test_centre_step_reads_no_later_step(pipe_and_weights):
    """The LSTM is causal: the centre step's log-probs do not change when
    the inputs of steps 4 to 6 do, in the reference and in the port."""
    pipe, sd = pipe_and_weights
    gen = torch.Generator().manual_seed(8)
    windows = torch.randn(8, 7, 300, generator=gen)
    later = windows.clone()
    later[:, 4:] = torch.randn(8, 3, 300, generator=gen)
    with torch.no_grad():
        assert torch.equal(FAMILY.head(windows, sd["head"], CONFIG),
                           FAMILY.head(later, sd["head"], CONFIG))
        assert torch.equal(pipe._head_apply(windows), pipe._head_apply(later))


def test_counts_written_out():
    """A window: the input products of steps 0-3 and the recurrent products
    of steps 1-3 in each layer, the decoder at step 3; a crop: ResNet-18 to
    its pooled 512 and the dense layer to 300."""
    gates = 4 * 512
    layers = (4 * 2 * 300 * gates + 3 * 2 * 512 * gates
              + 2 * (4 * 2 * 512 * gates + 3 * 2 * 512 * gates))
    head = layers + 2 * 512 * 128 + 2 * 128 * 63
    assert FAMILY.head_flops(CONFIG) == head == 40_713_984
    assert FAMILY.embed_flops(CONFIG) == roofline.resnet_flops("resnet18", 128) + 2 * 512 * 300
    assert roofline.frame_flops(CONFIG, 2, FAMILY) == FAMILY.embed_flops(CONFIG) + head
    assert FAMILY.k2_blocks(CONFIG) == CATALOG.family("cnn").k2_blocks(CATALOG.config("cnn63"))


@pytest.fixture
def tiny_rnn(tiny, tmp_path):
    """The fixture's catalog with a cell of the RNN family on the tiny
    traffic, added by entries and a copy of ``rnn.match``'s limits."""
    limits = json.dumps(CATALOG.limits("rnn.match"))
    (tmp_path / "limits" / "tiny-rnn.match.json").write_text(limits)
    tiny.bench["workloads"].append({"name": "tiny-rnn.match", "config": "rnn",
                                    "traffic": "tiny", "chips": 1, "why": "test"})
    for metric in tiny.bench["end_to_end"] + tiny.bench["per_layer"]:
        if "tiny.match" in metric.get("workloads", []):
            metric["workloads"].append("tiny-rnn.match")
    return tiny


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_of_the_family_is_correct(tiny_rnn, trace):
    """The RNN family through the harness on the CPU: correct, with its
    metrics; traced, no reading of what needs a card, the head's among
    them."""
    result = run.run_cell(tiny_rnn, "tiny-rnn.match", SEED, 0.5, trace, device="cpu")
    assert result["correct"] and result["failed"] == 0, result["checks"]
    metrics = result["metrics"]
    if trace:
        assert metrics["mfu"]["value"] > 0 and metrics["classify_span_ms_per_vod"]["value"] > 0
        assert not {"head_device_ms_per_vod", "head_roofline", "k2_roofline"} & set(metrics)
    else:
        assert metrics["vod_frames_per_s"]["value"] > 0


@pytest.mark.parametrize("fault", [unchanged_state, half_batch, altered_label,
                                   altered_confidence])
def test_fault_is_not_correct_under_the_cells_limits(tiny_rnn, monkeypatch, fault):
    """Each fault of ``test_portbench_run.py``, planted under the route's
    set-up, fails ``rnn.match``'s limits in the RNN family's tiny cell,
    though its seeded head's log-probs lie within a tenth of a nat of
    uniform."""
    _plant(tiny_rnn, monkeypatch, fault)
    result = run.run_cell(tiny_rnn, "tiny-rnn.match", SEED, 0.5, 0, device="cpu")
    assert not result["correct"], result["checks"]


# Two analyses; each classify holds one head span.  The head's launches:
# two in the first span, one in the second, one outside both.
HEAD_HOST = [
    ("portbench.window", 0, 1000),
    ("playaid.analyze", 0, 500), ("playaid.analyze", 500, 500),
    ("playaid.classify", 300, 150), ("playaid.classify", 800, 150),
    ("playaid.head", 310, 50), ("playaid.head", 810, 50),
]
LAUNCHES = [(1, 320, 100), (2, 330, 60), (3, 820, 40), (4, 400, 500)]


def _head_ctx(tmp_path, host=HEAD_HOST):
    ev = [{"cat": "user_annotation", "name": n, "ts": ts, "dur": dur} for n, ts, dur in host]
    for corr, ts, dur in LAUNCHES:
        ev.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 2,
                   "args": {"correlation": corr}})
        ev.append({"cat": "kernel", "name": "lstm", "ts": ts + 5, "dur": dur,
                   "args": {"correlation": corr}})
    path = tmp_path / "h.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return SimpleNamespace(trace=Trace(str(path)), config=CONFIG, family=FAMILY,
                           traced=[SimpleNamespace(ok=True)] * 2)


@pytest.fixture
def head_recording(monkeypatch):
    """The process's recording of the trace's two analyses, with the head
    counts given (None: a head span without ``windows``)."""
    rec = profiling.Recording()
    monkeypatch.setattr(profiling, "_session", rec)

    def record(windows):
        for w in windows:
            with profiling.Span(rec, "playaid.analyze", profiling.new_analysis(), {}):
                with profiling.Span(rec, "playaid.classify", None, {"rows": 5400}):
                    with profiling.Span(rec, "playaid.head", None,
                                        {} if w is None else {"windows": w}):
                        pass
    return record


def _read(name, ctx):
    return CATALOG.module("metrics", name).read(ctx)


def test_head_readers_on_a_written_trace(tmp_path, head_recording):
    head_recording([16384, 16384])
    ctx = _head_ctx(tmp_path)
    assert program_spans.counts_by_span(ctx, "playaid.head", "windows") == [16384, 16384]
    assert _read("head_device_ms_per_vod", ctx) == pytest.approx((160 + 40) / 1e3 / 2)
    least = 2 * 2 * 5400 * FAMILY.head_flops(CONFIG) / 495e12
    assert _read("head_roofline", ctx) == pytest.approx(100 * least / 200e-6)


def test_no_head_reading_without_its_spans_or_counts(tmp_path, head_recording):
    """A head span without ``windows``: no roofline.  A program without
    ``playaid.head`` spans (one that predates them): neither metric, and
    nothing raises."""
    head_recording([16384, None])
    ctx = _head_ctx(tmp_path)
    assert _read("head_device_ms_per_vod", ctx) == pytest.approx(0.1)
    assert _read("head_roofline", ctx) is None
    bare = _head_ctx(tmp_path, [h for h in HEAD_HOST if h[0] != "playaid.head"])
    assert _read("head_device_ms_per_vod", bare) is None
    assert _read("head_roofline", bare) is None
