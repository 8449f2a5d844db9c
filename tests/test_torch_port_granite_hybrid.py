"""The Granite 4.0-H hybrid head (``models/granite_hybrid.py``) and K6's
plain twin (``ops/ssd_scan.py``) on the CPU, at a tiny width with seeded
weights, against the benchmark's plain reference
(``portbench/families/granite_hybrid.py``, whose SSD on the CPU is the
step-by-step recurrence): the scan, the head, a broken state pass, the rows
past the true length, ``classify_buffer`` end to end, and the spans and
counts.  K6 itself is held against the twin on the card
(``PLAYAID_TEST_TPU=1 python -m pytest tests/test_torch_port_granite_hybrid.py
-m card``; the variable keeps ``conftest.py`` from importing JAX)."""

import json

import numpy as np
import pytest
import torch

from playaid_core_torch import profiling
from playaid_core_torch.infer.pipeline import SEQUENCE_FAMILIES, BatchedActionPipeline
from playaid_core_torch.models import granite_hybrid
from playaid_core_torch.ops import ssd_scan as ssd_mod
from playaid_core_torch.ops.ssd_scan import ssd_scan, ssd_scan_ref
from portbench.catalog import Catalog
from portbench.reference import ops as ref_ops

torch.set_num_threads(2)

FAMILY = Catalog().family("granite_hybrid")
CONFIG_FILE = json.load(open(Catalog().root + "/portbench/configs/granite-h-micro.json"))
# Every width cut, every multiplier and kind of layer as published; one
# attention layer among three Mamba-2 layers, a chunk of 8 so that 40 rows
# cross four chunk boundaries.
TINY = dict(granite_hybrid.PUBLISHED, hidden_size=64, num_hidden_layers=4,
            layer_types=["mamba", "attention", "mamba", "mamba"], shared_intermediate_size=96,
            mamba_n_heads=4, mamba_d_head=32, mamba_d_state=16, mamba_chunk_size=8,
            num_attention_heads=4, num_key_value_heads=2)
CONFIG = dict(CONFIG_FILE, **TINY)
SEED = 2**31 + 26
TRUE_LEN = 40
# Float32 on both sides, in different orders (K6's chunked form against the
# recurrence; the fused attention against blocks of softmax): the head's
# log-probs read about 5e-7 apart at this width.  1e-5 nats is 20 times
# that, and a tenth of what a lost state pass moves them.
HEAD_TOL = 1e-5


def _scan_inputs(length, heads=4, p=8, groups=1, n=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, length, heads, p, generator=g)
    dt = torch.rand(2, length, heads, generator=g) * 0.1 + 0.001
    a = -(torch.rand(heads, generator=g) * 15 + 1)
    b = torch.randn(2, length, groups, n, generator=g)
    c = torch.randn(2, length, groups, n, generator=g)
    d = torch.rand(heads, generator=g)
    return x, dt, a, b, c, d


@pytest.fixture(scope="module")
def pipe_and_weights():
    """The pipeline with a TINY head: its default sizes patched while it is
    made (the published stack is 12 GB)."""
    sd = FAMILY.weights(CONFIG, SEED, "cpu", None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(granite_hybrid, "PUBLISHED", TINY)
        pipe = BatchedActionPipeline(family="granite_hybrid", device="cpu")
    assert pipe.head.config == TINY
    return pipe.load_state_dicts(sd), sd


def _sequences(n=TRUE_LEN, seed=3):
    return torch.randn(2, n, 512, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("chunk", [8, 256])
@pytest.mark.parametrize("length", [1, 255, 256, 257, 600])
def test_twin_matches_the_recurrence(length, chunk):
    """K6's twin, the chunked form with the state carried across every
    chunk, against the reference's step-by-step recurrence, with A in
    Mamba-2's [1, 16] so that slow heads carry state over many chunks."""
    args = _scan_inputs(length)
    ref = FAMILY.ssd_recurrence(*args)
    out = ssd_scan(*args, chunk=chunk)
    # Float32 sums over at most 600 steps of decaying terms, |y| up to about
    # 6: rounding near 1e-6; 2e-5 of max|ref| holds it with room.
    assert out.shape == ref.shape == (2, length, 4, 8)
    assert torch.allclose(out, ref, atol=2e-5 * ref.abs().max().item(), rtol=0)


def test_twin_groups_and_padding():
    """Two groups of two heads each, and a length that is no whole chunk."""
    args = _scan_inputs(37, heads=4, groups=2)
    ref = FAMILY.ssd_recurrence(*args)
    assert torch.allclose(ssd_scan_ref(*args, chunk=16), ref, atol=2e-5 * ref.abs().max().item(),
                          rtol=0)


def test_twin_without_the_state_pass_is_wrong(monkeypatch):
    """With the state between chunks zeroed the twin misses the
    recurrence past the first chunk by orders of magnitude more than the
    tolerance above."""
    args = _scan_inputs(64)
    ref = FAMILY.ssd_recurrence(*args)
    monkeypatch.setattr(ssd_mod, "_state_pass", lambda states, acs: torch.zeros_like(states))
    out = ssd_scan_ref(*args, chunk=8)
    assert torch.allclose(out[:, :8], ref[:, :8], atol=2e-5 * ref.abs().max().item(), rtol=0)
    assert (out - ref).abs().max() > 100 * 2e-5 * ref.abs().max()


def test_wrapper_refuses_bad_shapes():
    x, dt, a, b, c, d = _scan_inputs(16)
    with pytest.raises(ValueError):
        ssd_scan(x, dt[:, :8], a, b, c, d)
    with pytest.raises(ValueError):
        ssd_scan(x, dt, a[:3], b, c, d)
    with pytest.raises(ValueError):
        ssd_scan(x.to("meta"), dt.to("meta"), a.to("meta"), b.to("meta"), c.to("meta"),
                 d.to("meta"))


def test_head_matches_the_reference(pipe_and_weights):
    pipe, sd = pipe_and_weights
    seq = _sequences()
    with torch.no_grad():
        ref = FAMILY.sequence_head(seq, sd["head"], CONFIG)
        port = pipe._sequence_log_probs(seq, TRUE_LEN, 0)
    assert port.shape == (2, 40, 63) and ref.shape == (2, 40, 63)
    assert torch.allclose(port, ref, atol=HEAD_TOL, rtol=0)


def test_head_without_the_state_pass_fails(pipe_and_weights, monkeypatch):
    """A twin whose state pass between chunks is zeroed: the head misses
    the reference by more than the tolerance (on the rows past the first
    chunk), though it still meets it on the first chunk's rows."""
    pipe, sd = pipe_and_weights
    seq = _sequences()
    monkeypatch.setattr(ssd_mod, "_state_pass", lambda states, acs: torch.zeros_like(states))
    with torch.no_grad():
        ref = FAMILY.sequence_head(seq, sd["head"], CONFIG)
        port = pipe._sequence_log_probs(seq, TRUE_LEN, 0)
    err = (port - ref).abs()
    assert err[:, :8].max() <= HEAD_TOL
    assert err.max() > HEAD_TOL


def test_rows_past_the_true_length_change_no_label(pipe_and_weights):
    """The head is causal: what fills the buffer past the true length (37
    rows, run as 40 with three of the buffer's rows behind them) changes no
    label and no confidence."""
    pipe, _ = pipe_and_weights
    gen = torch.Generator().manual_seed(9)
    n = 37
    buf = pipe.make_embedding_buffer(n)
    buf[:2 * n] = torch.randn(2 * n, 512, generator=gen)
    other = buf.clone()
    other[2 * n:] = torch.randn(other.shape[0] - 2 * n, 512, generator=gen) * 5
    for decode in ("argmax", "viterbi"):
        a = pipe.classify_buffer(buf, n, decode=decode, switch_cost=2.0)
        b = pipe.classify_buffer(other, n, decode=decode, switch_cost=2.0)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert a[0].shape == (n, 2)


@pytest.mark.parametrize("cost", [0.05, 16.0])
def test_classify_buffer_against_the_reference(pipe_and_weights, cost):
    """``classify_buffer`` end to end: the labels are the reference's
    Viterbi decode of the reference's log-probs, the confidences 100 exp of
    the reference's log-prob of each label."""
    pipe, sd = pipe_and_weights
    seq = _sequences(seed=11) * 3
    buf = pipe.make_embedding_buffer(TRUE_LEN)
    buf[:2 * TRUE_LEN] = seq.transpose(0, 1).reshape(-1, 512)
    labels, conf = pipe.classify_buffer(buf, TRUE_LEN, decode="viterbi", switch_cost=cost)
    with torch.no_grad():
        ref = FAMILY.sequence_head(seq, sd["head"], CONFIG).numpy()
    want = ref_ops.viterbi(ref, cost).T
    assert np.array_equal(labels.numpy(), want)
    at = ref[np.arange(2)[None, :], np.arange(TRUE_LEN)[:, None], want]
    assert np.allclose(conf.numpy(), 100 * np.exp(at), atol=1e-3, rtol=0)


def test_spans_and_counts(pipe_and_weights):
    """One ``playaid.head`` a classify, both fighters in one call, counting
    ``positions`` and ``windows`` (2 x the rows rounded up to the chunk) and
    ``ssd_layers`` (0: no K6 on the CPU); a ``playaid.ssm`` for each Mamba-2
    layer and a ``playaid.attention`` for each attention layer under it;
    recording changes no label."""
    pipe, _ = pipe_and_weights
    buf = pipe.make_embedding_buffer(TRUE_LEN)
    buf[:2 * TRUE_LEN] = torch.randn(2 * TRUE_LEN, 512, generator=torch.Generator().manual_seed(4))
    off = pipe.classify_buffer(buf, TRUE_LEN, decode="viterbi", switch_cost=16.0)
    with profiling.recording() as rec:
        on = pipe.classify_buffer(buf, TRUE_LEN, decode="viterbi", switch_cost=16.0)
    assert torch.equal(off[0], on[0]) and torch.equal(off[1], on[1])
    classify, = [s for s in rec.spans if s.name == "playaid.classify"]
    head, = [s for s in rec.spans if s.name == "playaid.head"]
    assert head.parent == classify.id
    assert head.counts == {"windows": 2 * 40, "positions": 2 * 40, "ssd_layers": 0}
    ssm = [s for s in rec.spans if s.name == "playaid.ssm"]
    attn = [s for s in rec.spans if s.name == "playaid.attention"]
    assert len(ssm) == 3 and len(attn) == 1
    assert all(s.parent == head.id for s in ssm + attn)
    assert rec.totals()["rows"] == TRUE_LEN


def _k6_stand_in(*args, chunk):
    """The twin, counting as K6's wrapper counts a launch."""
    profiling.count("ssd_layers", 1)
    return ssd_scan_ref(*args, chunk=chunk)


@pytest.mark.parametrize("scan, want", [(_k6_stand_in, 3), (ssd_scan_ref, 0)],
                         ids=["counting-as-k6", "another-scan"])
def test_ssd_layers_counts_the_k6_launches(pipe_and_weights, monkeypatch, scan, want):
    """``ssd_layers`` on ``playaid.head`` is what the scans counted where
    they ran, not what the head assumes of its device: a scan that counts
    as K6 does reads the 3 Mamba-2 layers, any other scan 0.  The mixers'
    ``playaid.ssm`` spans keep nothing of it."""
    pipe, _ = pipe_and_weights
    monkeypatch.setattr(granite_hybrid, "ssd_scan",
                        lambda *args: scan(*args[:6], chunk=args[6]))
    with profiling.recording() as rec:
        pipe.classify_buffer(pipe.make_embedding_buffer(TRUE_LEN), TRUE_LEN)
    head, = [s for s in rec.spans if s.name == "playaid.head"]
    assert head.counts["ssd_layers"] == want
    assert all("ssd_layers" not in s.counts for s in rec.spans if s.name == "playaid.ssm")
    assert rec.counters["ssd_layers"] == want


def test_head_pads_to_whole_chunks(pipe_and_weights):
    """41 true rows run as 48 (six chunks of 8); a buffer shorter than that
    is padded with zero rows."""
    pipe, _ = pipe_and_weights
    with profiling.recording() as rec:
        pipe.classify_buffer(pipe.make_embedding_buffer(41), 41)
        pipe.classify_buffer(pipe.make_embedding_buffer(3), 3)
    heads = [s.counts["positions"] for s in rec.spans if s.name == "playaid.head"]
    assert heads == [2 * 48, 2 * 8]


def test_classify_sequence_and_min_frame(pipe_and_weights):
    pipe, sd = pipe_and_weights
    seq = _sequences()
    labels, conf = pipe.classify_sequence(seq[0], decode="argmax")
    with torch.no_grad():
        ref = FAMILY.sequence_head(seq[:1], sd["head"], CONFIG)[0]
    assert torch.equal(labels, ref.argmax(-1))
    with pytest.raises(ValueError):
        pipe.classify_sequence(seq[0], min_frame=3)


def test_published_widths_are_the_configuration_files():
    """The port's default sizes are the benchmark configuration's numbers,
    which the catalog holds as published."""
    assert SEQUENCE_FAMILIES == ("granite_hybrid",)
    for key, value in granite_hybrid.PUBLISHED.items():
        assert CONFIG_FILE[key] == value, key
    types = granite_hybrid.PUBLISHED["layer_types"]
    assert types.count("mamba") == 36 and [i for i, k in enumerate(types) if k != "mamba"] == [
        5, 15, 25, 35]


def test_state_dict_names_are_the_references(pipe_and_weights):
    """The port's names, shapes and order are the reference's spec."""
    pipe, _ = pipe_and_weights
    spec = FAMILY.spec(CONFIG)
    for part in ("embed", "head"):
        port = getattr(pipe, part).state_dict()
        assert [(k, tuple(v.shape)) for k, v in port.items()] == [(k, tuple(s))
                                                                  for k, s in spec[part]]


@pytest.fixture
def card_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_k6_matches_its_twin_on_the_card(card_device):
    """K6 on the card against its twin on the same inputs, at one chunk of
    the published head and state sizes and at three."""
    for length in (256, 700):
        args = [t.to(card_device) for t in _scan_inputs(length, heads=8, p=64, n=128)]
        ref = ssd_scan_ref(*args)
        with profiling.recording() as rec:
            out = ssd_scan(*args)
        assert torch.allclose(out, ref, atol=1e-5 * ref.abs().max().item(), rtol=0)
        assert rec.counters["ssd_layers"] == 1
