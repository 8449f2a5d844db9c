"""The Granite hybrid family (``families/granite_hybrid.py``): its seeded
weights, its SSD in the chunked form against the recurrence, the reference
against the transformers library's ``GraniteMoeHybridModel``, the counts,
the configuration file against the catalog's published numbers, a cell of
it run through the harness at a tiny size (``routes/vod_seq.py``), and the
readers of ``k6_roofline`` and ``ssm_device_ms_per_vod`` on a trace written
here."""

import json
import math
from types import SimpleNamespace

import pytest
import torch

from playaid_core_torch import profiling
from playaid_core_torch.models import granite_hybrid as port_granite
from portbench import k6, roofline, run
from portbench.catalog import Catalog
from portbench.tests.helpers import ROOT, TINY_TRAFFIC, benchmark
from portbench.tests.test_portbench_run import (altered_confidence, altered_label, half_batch,
                                                unchanged_state)
from portbench.tracing import Trace

torch.set_num_threads(2)

SEED = 2**31 + 126
CATALOG = Catalog(benchmark())
CONFIG = CATALOG.config("granite-h-micro")
FAMILY = CATALOG.family("granite_hybrid")
TINY = dict(port_granite.PUBLISHED, hidden_size=64, num_hidden_layers=4,
            layer_types=["mamba", "attention", "mamba", "mamba"], shared_intermediate_size=96,
            mamba_n_heads=4, mamba_d_head=32, mamba_d_state=16, mamba_chunk_size=8,
            num_attention_heads=4, num_key_value_heads=2)
TINY_CONFIG = dict(CONFIG, **TINY)
# Keys of the catalog's entry (architectures.jsonl, granite-4.0-h-micro) as
# published; the configuration file holds each, vocab_size cut to the classes.
CATALOG_CONFIG = {
    "attention_bias": False, "attention_multiplier": 0.015625, "embedding_multiplier": 12,
    "hidden_act": "silu", "hidden_size": 2048, "intermediate_size": 8192,
    "logits_scaling": 8, "mamba_chunk_size": 256, "mamba_conv_bias": True, "mamba_d_conv": 4,
    "mamba_d_head": 64, "mamba_d_state": 128, "mamba_expand": 2, "mamba_n_groups": 1,
    "mamba_n_heads": 64, "mamba_proj_bias": False, "max_position_embeddings": 131072,
    "model_type": "granitemoehybrid", "normalization_function": "rmsnorm",
    "num_attention_heads": 32, "num_experts_per_tok": 0, "num_hidden_layers": 40,
    "num_key_value_heads": 8, "num_local_experts": 0, "position_embedding_type": "nope",
    "residual_multiplier": 0.22, "rms_norm_eps": 1e-05, "rope_scaling": None,
    "rope_theta": 10000, "shared_intermediate_size": 8192, "tie_word_embeddings": True,
    "vocab_size": 100352,
}


def test_configuration_holds_the_published_numbers():
    for key, value in CATALOG_CONFIG.items():
        if key in CONFIG["reduced"]:
            assert CONFIG[key] != value and CONFIG["published"][key] == value
        else:
            assert CONFIG[key] == value, key
    assert CONFIG["reduced"] == ["vocab_size"] and CONFIG["vocab_size"] == CONFIG["num_actions"]
    types = CONFIG["layer_types"]
    assert len(types) == 40 and [i for i, k in enumerate(types) if k == "attention"] == [
        5, 15, 25, 35]
    assert {"frame_proj", "output", "weights", "analyzer", "causal"} <= set(CONFIG["assumed"])


def test_weights_follow_the_seed_and_mamba_2s_initialisation():
    sd = FAMILY.weights(TINY_CONFIG, SEED, "cpu", ROOT)["head"]
    again = FAMILY.weights(TINY_CONFIG, SEED, "cpu", ROOT)["head"]
    other = FAMILY.weights(TINY_CONFIG, SEED + 1, "cpu", ROOT)["head"]
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    for name in ("layers.2.mamba.in_proj.weight", "layers.2.mamba.A_log"):
        assert not torch.equal(sd[name], other[name])
    for i in (0, 2, 3):
        m = f"layers.{i}.mamba."
        a = torch.exp(sd[m + "A_log"])
        dt = torch.nn.functional.softplus(sd[m + "dt_bias"])
        assert ((a >= 1) & (a <= 16)).all() and ((dt >= 0.001 - 1e-7) & (dt <= 0.1 + 1e-7)).all()
        assert torch.equal(sd[m + "D"], torch.ones(4))
    assert sd["layers.1.self_attn.k_proj.weight"].shape == (2 * 16, 64)


@pytest.mark.parametrize("chunk", [8, 256])
@pytest.mark.parametrize("length", [1, 255, 256, 257, 600])
def test_chunked_form_matches_the_recurrence(length, chunk):
    """The reference's SSD on the card (the paper's chunked closed form,
    heads in blocks) against its step-by-step recurrence, state carried
    across every chunk, A in [1, 16]."""
    g = torch.Generator().manual_seed(length + chunk)
    heads = 20  # two blocks of HEAD_BLOCK, the second short
    x = torch.randn(1, length, heads, 8, generator=g)
    dt = torch.rand(1, length, heads, generator=g) * 0.1 + 0.001
    a = -(torch.rand(heads, generator=g) * 15 + 1)
    b, c = torch.randn(2, 1, length, 1, 16, generator=g)
    d = torch.rand(heads, generator=g)
    ref = FAMILY.ssd_recurrence(x, dt, a, b, c, d)
    out = FAMILY.ssd_chunked(x, dt, a, b, c, d, chunk)
    # Float32 rounding of both forms, |y| up to about 6: near 1e-6.
    assert torch.allclose(out, ref, atol=2e-5 * ref.abs().max().item(), rtol=0)


def test_reference_matches_transformers():
    """The reference against the transformers library's
    ``GraniteMoeHybridModel`` at a tiny width with the same weights: the
    frame projection's output as ``inputs_embeds`` (the model multiplies by
    ``embedding_multiplier`` itself), its last hidden state through
    ``output`` and ``logits_scaling``."""
    transformers = pytest.importorskip("transformers")
    cfg = transformers.GraniteMoeHybridConfig(
        vocab_size=63, hidden_size=64, intermediate_size=96, shared_intermediate_size=96,
        num_hidden_layers=4, layer_types=TINY["layer_types"], num_attention_heads=4,
        num_key_value_heads=2, mamba_n_heads=4, mamba_d_head=32, mamba_d_state=16,
        mamba_n_groups=1, mamba_d_conv=4, mamba_expand=2, mamba_chunk_size=8,
        mamba_conv_bias=True, mamba_proj_bias=False, attention_bias=False,
        attention_multiplier=0.015625, embedding_multiplier=12, residual_multiplier=0.22,
        logits_scaling=8, rms_norm_eps=1e-5, position_embedding_type="nope",
        num_local_experts=0, num_experts_per_tok=0, hidden_act="silu")
    cfg._attn_implementation = "eager"
    model = transformers.GraniteMoeHybridModel(cfg).eval()
    sd = FAMILY.weights(TINY_CONFIG, SEED, "cpu", ROOT)["head"]
    theirs = {k: v for k, v in sd.items() if k.startswith(("layers.", "norm."))}
    missing, unexpected = model.load_state_dict(theirs, strict=False)
    assert missing == ["embed_tokens.weight"] and unexpected == []
    seq = torch.randn(2, 40, 512, generator=torch.Generator().manual_seed(12))
    with torch.no_grad():
        ref = FAMILY.sequence_head(seq, sd, TINY_CONFIG)
        embeds = torch.nn.functional.linear(seq, sd["frame_proj.weight"], sd["frame_proj.bias"])
        h = model(inputs_embeds=embeds).last_hidden_state
        logits = torch.nn.functional.linear(h, sd["output.weight"], sd["output.bias"]) / 8
        theirs = torch.log_softmax(logits, dim=-1)
    # Float32, their chunked einsums against the recurrence: about 1e-6.
    assert torch.allclose(ref, theirs, atol=1e-5, rtol=0)


def test_counts_written_out():
    """A row of the published stack: 36 Mamba-2 layers (in_proj 2,048 ->
    8,512, the 4-tap convolution over 4,352 channels, the SSD's 3,195,008,
    out_proj 4,096 -> 2,048), 4 attention layers (q and o 2,048 -> 2,048,
    k and v 2,048 -> 512), 40 MLPs (2,048 -> 16,384 -> 2,048), frame_proj
    and the output."""
    ssd = 128 * 257 + 64 * 64 * 257 + 4 * 64 * 64 * 128 + 2 * 64 * 64 * 128 / 256 + 2 * 64 * 64
    assert k6.ssd_flops_per_row(CONFIG) == ssd == 3_195_008
    mlp = 2 * 2048 * 16384 + 2 * 8192 * 2048
    mamba = 2 * 2048 * 8512 + 2 * 4 * 4352 + ssd + 2 * 4096 * 2048
    attention = 2 * (2 * 2048 * 2048) + 2 * (2 * 2048 * 512)
    head = 2 * 512 * 2048 + 36 * (mamba + mlp) + 4 * (attention + mlp) + 2 * 2048 * 63
    assert FAMILY.head_flops(CONFIG) == head == 6_088_172_032
    assert FAMILY.embed_flops(CONFIG) == roofline.resnet_flops("resnet18", 128)
    assert FAMILY.k2_blocks(CONFIG) == CATALOG.family("rnn").k2_blocks(CATALOG.config("rnn"))
    flops, nbytes = k6.ssd_counts(11264, CONFIG)
    assert flops == 11264 * ssd and nbytes == (11264 * (2 * 4096 + 64 + 256) + 128) * 4
    assert k6.mamba_layers(CONFIG) == 36


def test_spec_is_three_billion_parameters():
    n = sum(math.prod(s) for part in FAMILY.spec(CONFIG).values() for _, s in part)
    head = sum(math.prod(s) for _, s in FAMILY.spec(CONFIG)["head"])
    assert 2.98e9 < head < 3.0e9 and n > head


@pytest.fixture
def tiny_granite(tiny, tmp_path, monkeypatch):
    """The fixture's catalog with a cell of the Granite family at a tiny
    width on a tiny traffic of the sequence route, added by files and
    entries; the port's published sizes swapped for the tiny ones."""
    (tmp_path / "configs").mkdir()
    path = tmp_path / "configs" / "tiny-granite.json"
    path.write_text(json.dumps(dict(TINY_CONFIG, name="tiny-granite")))
    (tmp_path / "traffic" / "tiny-seq.json").write_text(
        json.dumps(dict(TINY_TRAFFIC, route="vod_seq")))
    limits = json.dumps(CATALOG.limits("granite-h-micro.match-seq"))
    (tmp_path / "limits" / "tiny-granite.match-seq.json").write_text(limits)
    tiny.bench["configs"].append({"name": "tiny-granite", "source": CONFIG["source"],
                                  "file": str(path), "reduced": CONFIG["reduced"], "why": "test"})
    tiny.bench["workloads"].append({"name": "tiny-granite.match-seq", "config": "tiny-granite",
                                    "traffic": "tiny-seq", "chips": 1, "why": "test"})
    for metric in tiny.bench["end_to_end"] + tiny.bench["per_layer"]:
        if "tiny.match" in metric.get("workloads", []) or metric["name"] in (
                "k6_roofline", "ssm_device_ms_per_vod"):
            metric["workloads"].append("tiny-granite.match-seq")
    monkeypatch.setattr(port_granite, "PUBLISHED", TINY)
    return tiny


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_of_the_family_is_correct(tiny_granite, trace):
    """The family through the harness on the CPU: correct, with its metrics;
    traced, no reading of what needs a card (the head's, K6's and the
    SSM's among them)."""
    result = run.run_cell(tiny_granite, "tiny-granite.match-seq", SEED, 0.5, trace, device="cpu")
    assert result["correct"] and result["failed"] == 0, result["checks"]
    metrics = result["metrics"]
    if trace:
        assert metrics["mfu"]["value"] > 0 and metrics["classify_span_ms_per_vod"]["value"] > 0
        assert not {"head_device_ms_per_vod", "head_roofline", "k6_roofline",
                    "ssm_device_ms_per_vod", "k2_roofline"} & set(metrics)
    else:
        assert metrics["vod_frames_per_s"]["value"] > 0


@pytest.mark.parametrize("fault", [unchanged_state, half_batch, altered_label,
                                   altered_confidence], ids=lambda f: f.__name__)
def test_fault_is_not_correct_under_the_cells_limits(tiny_granite, monkeypatch, fault):
    """Each fault of ``test_portbench_run.py``, planted under the sequence
    route's set-up, fails the cell's limits."""
    _plant_seq(tiny_granite, monkeypatch, fault)
    result = run.run_cell(tiny_granite, "tiny-granite.match-seq", SEED, 0.5, 0, device="cpu")
    assert not result["correct"], result["checks"]


def test_lost_state_pass_is_not_correct(tiny_granite, monkeypatch):
    """The program's scan with its state pass between chunks zeroed fails
    the cell's limits: the reference carries the state."""
    from playaid_core_torch.ops import ssd_scan

    monkeypatch.setattr(ssd_scan, "_state_pass", lambda states, acs: torch.zeros_like(states))
    result = run.run_cell(tiny_granite, "tiny-granite.match-seq", SEED, 0.5, 0, device="cpu")
    assert not result["correct"], result["checks"]
    assert result["checks"]["lp_err"]["value"] > result["checks"]["lp_err"]["limit"]


def _plant_seq(tiny, monkeypatch, fault):
    route_cls = tiny.module("routes", "vod_seq").Route
    setup = route_cls.setup

    def broken(route):
        setup(route)
        fault(route)

    monkeypatch.setattr(route_cls, "setup", broken)


# Two analyses, each with one head span holding two ssm spans; K6's kernels
# and the ssm's other kernels launched inside them, one kernel outside all.
HOST = [
    ("portbench.window", 0, 2000),
    ("playaid.analyze", 0, 1000), ("playaid.analyze", 1000, 1000),
    ("playaid.classify", 300, 600), ("playaid.classify", 1300, 600),
    ("playaid.head", 310, 500), ("playaid.head", 1310, 500),
    ("playaid.ssm", 320, 100), ("playaid.ssm", 500, 100),
    ("playaid.ssm", 1320, 100), ("playaid.ssm", 1500, 100),
]
LAUNCHES = [(1, 330, 40, "ssd_scan_out_kernel"), (2, 340, 10, "gemm"),
            (3, 510, 30, "void (anonymous namespace)::ssd_scan_state_kernel(Args)"),
            (4, 1330, 40, "ssd_scan_out_kernel"), (5, 1510, 20, "ssd_scan_pass_kernel"),
            (6, 1950, 40, "gemm")]


def _ctx(tmp_path, host=HOST, config=CONFIG):
    ev = [{"cat": "user_annotation", "name": n, "ts": ts, "dur": dur} for n, ts, dur in host]
    for corr, ts, dur, name in LAUNCHES:
        ev.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 2,
                   "args": {"correlation": corr}})
        ev.append({"cat": "kernel", "name": name, "ts": ts + 5, "dur": dur,
                   "args": {"correlation": corr}})
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return SimpleNamespace(trace=Trace(str(path)), config=config, family=FAMILY,
                           traced=[SimpleNamespace(ok=True)] * 2)


@pytest.fixture
def head_recording(monkeypatch):
    """The process's recording of the trace's two analyses, with each head
    span's ``ssd_layers`` given."""
    rec = profiling.Recording()
    monkeypatch.setattr(profiling, "_session", rec)

    def record(ssd_layers, positions=11264):
        for n in ssd_layers:
            with profiling.Span(rec, "playaid.analyze", profiling.new_analysis(), {}):
                with profiling.Span(rec, "playaid.classify", None, {"rows": 5400}):
                    counts = {"windows": positions, "positions": positions}
                    if n is not None:
                        counts["ssd_layers"] = n
                    with profiling.Span(rec, "playaid.head", None, counts):
                        pass
    return record


def _read(name, ctx):
    return CATALOG.module("metrics", name).read(ctx)


def test_k6_and_ssm_readers_on_a_written_trace(tmp_path, head_recording):
    head_recording([36, 36])
    ctx = _ctx(tmp_path)
    least = 2 * 36 * roofline.least_s(*k6.ssd_counts(11264, CONFIG))
    assert _read("k6_roofline", ctx) == pytest.approx(100 * least / ((40 + 30 + 40 + 20) / 1e6))
    assert _read("ssm_device_ms_per_vod", ctx) == pytest.approx((40 + 10 + 30 + 40 + 20) / 1e3 / 2)
    head = _read("head_roofline", ctx)
    assert head == pytest.approx(100 * 2 * 2 * 5400 * FAMILY.head_flops(CONFIG) / 495e12
                                 / ((40 + 10 + 30 + 40 + 20) / 1e6))


def test_no_k6_reading_unless_every_head_ran_its_layers_on_k6(tmp_path, head_recording):
    """A head span that ran fewer layers on K6, or none (the CPU), or that
    predates the count: no ``k6_roofline``.  A program without
    ``playaid.ssm`` spans (the parent): no ``ssm_device_ms_per_vod``, and
    nothing raises."""
    for counts in ([36, 35], [0, 0], [36, None]):
        head_recording(counts)
        assert _read("k6_roofline", _ctx(tmp_path)) is None
    bare = _ctx(tmp_path, [h for h in HOST if h[0] != "playaid.ssm"])
    assert _read("ssm_device_ms_per_vod", bare) is None
    # A family without Mamba-2 layers (the window families): nothing to read.
    head_recording([0, 0])
    assert _read("k6_roofline", _ctx(tmp_path, config=CATALOG.config("rnn"))) is None
