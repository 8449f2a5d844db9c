"""The port's Viterbi decode (playaid_core_torch/ops/viterbi.py) against the
JAX package's ``BatchedActionPipeline._viterbi_decode``.

The same numpy log-probs go through the JAX function (one sequence a call,
as ``_two_fighter_tail`` calls it) and through the port's wrapper, which
runs its plain version on a CPU tensor; labels must be identical.  The
CUDA kernel (csrc/viterbi.cu) is held against the plain version on the
card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from playaid_core_tpu.infer.pipeline import BatchedActionPipeline as JaxPipeline
from playaid_core_torch.infer.pipeline import BatchedActionPipeline
from playaid_core_torch.ops.viterbi import (
    MAX_CLASSES,
    scratch_layout,
    viterbi_decode,
    viterbi_decode_ref,
)

torch.set_num_threads(2)

# Jitted with every argument traced, as the JAX pipeline's classify
# programs call it: one compile a shape.
jax_viterbi = jax.jit(JaxPipeline._viterbi_decode)


def _jax_labels(lp, true_len, cost):
    """The JAX function on each sequence of ``lp`` ``[B, F, A]``."""
    return np.stack([np.asarray(jax_viterbi(jnp.asarray(seq), int(n), cost))
                     for seq, n in zip(lp, true_len)])


def _lp(seq, n_classes=3, strength=2.0, noise=None):
    """Log-prob rows favouring seq[i] by ``strength`` nats."""
    lp = np.full((len(seq), n_classes), -strength, np.float32)
    lp[np.arange(len(seq)), seq] = 0.0
    if noise is not None:
        lp += noise
    return lp


# (log_probs [F, A], true_len, switch_cost, expected labels): the five cases
# of tests/test_viterbi_decode.py.
CASES = {
    "suppresses_isolated_flips": (
        _lp([1 if i in (7, 13) else 0 for i in range(20)]), 20, 4.0, [0] * 20),
    "keeps_genuine_transition_sharp": (
        _lp([0] * 10 + [2] * 10,
            noise=np.random.default_rng(0).normal(0, 0.3, (20, 3)).astype(np.float32)),
        20, 4.0, [0] * 10 + [2] * 10),
    "switches_when_evidence_sustained": (
        _lp([0] * 8 + [1] * 5 + [0] * 7), 20, 4.0, [0] * 8 + [1] * 5 + [0] * 7),
    "true_len_masks_padding": (
        np.concatenate([_lp([0] * 10), _lp([1] * 6)]), 10, 4.0, [0] * 16),
    "infinite_cost_is_global_argmax": (_lp([0] * 6 + [1] * 14), 20, 1e6, [1] * 20),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_viterbi_cases_match_jax(case):
    lp, true_len, cost, expected = CASES[case]
    ref = _jax_labels(lp[None], [true_len], cost)
    out = viterbi_decode(torch.from_numpy(lp)[None], true_len, cost)
    assert out.dtype == torch.int64 and tuple(out.shape) == (1, len(expected))
    assert out[0].tolist() == ref[0].tolist()
    # The JAX function leaves padding rows to the caller; the port freezes
    # them at the last valid label, as the expected labels say.
    assert out[0, :true_len].tolist() == expected[:true_len]
    assert out[0].tolist() == expected


def _batch(seed, f, a, lengths, neg_inf):
    """Seeded log-probs ``[B, F, A]`` quantised to quarter nats, so that
    maxima and stay/switch scores tie; with ``neg_inf`` some entries, one
    class column and one whole row of a sequence hold -inf."""
    rng = np.random.default_rng(seed)
    lp = np.round(rng.normal(-3.0, 2.0, (len(lengths), f, a)) * 4) / 4
    lp = lp.astype(np.float32)
    if neg_inf:
        lp[rng.random(lp.shape) < 0.1] = -np.inf
        lp[0, :, a // 2] = -np.inf
        lp[-1, f // 2] = -np.inf
    return lp


@pytest.mark.parametrize("neg_inf", [False, True], ids=["finite", "neg_inf"])
@pytest.mark.parametrize("cost", [0.0, 4.0, 16.0, float("inf")])
@pytest.mark.parametrize("a", [1, 33, 63, 64])
def test_viterbi_batches_match_jax(a, cost, neg_inf):
    """Per-sequence true lengths 0, 1, F and one between, in one batch."""
    f = 40
    lengths = [0, 1, f, 23]
    lp = _batch(a * 7 + int(min(cost, 99)), f, a, lengths, neg_inf)
    ref = _jax_labels(lp, lengths, cost)
    out = viterbi_decode(torch.from_numpy(lp), torch.tensor(lengths), cost)
    assert out.numpy().tolist() == ref.tolist()
    # An int true_len decodes every sequence at that length.
    out_int = viterbi_decode(torch.from_numpy(lp), 23, cost)
    assert out_int.numpy().tolist() == _jax_labels(lp, [23] * len(lengths), cost).tolist()


@pytest.mark.parametrize("true_len", [0, 1, 5])
@pytest.mark.parametrize("a", [1, 63])
def test_viterbi_single_row(a, true_len):
    """F = 1: the argmax of the row (of zeros when true_len is 0)."""
    lp = _batch(3, 1, a, [true_len] * 2, neg_inf=False)
    ref = _jax_labels(lp, [true_len] * 2, 4.0)
    assert viterbi_decode(torch.from_numpy(lp), true_len, 4.0).numpy().tolist() == ref.tolist()


def test_viterbi_infinite_cost_is_global_argmax():
    lp = _batch(5, 30, 63, [30, 30], neg_inf=False)
    out = viterbi_decode(torch.from_numpy(lp), 30, float("inf"))
    best = lp.sum(axis=1).argmax(axis=1)
    assert out.numpy().tolist() == [[int(b)] * 30 for b in best]
    assert out.numpy().tolist() == _jax_labels(lp, [30, 30], float("inf")).tolist()


def test_viterbi_all_neg_inf_rows_give_no_nan_labels():
    lp = np.full((2, 12, 63), -np.inf, np.float32)
    lp[1, 6:, 5] = -1.0
    out = viterbi_decode(torch.from_numpy(lp), 12, 4.0)
    assert out.numpy().tolist() == _jax_labels(lp, [12, 12], 4.0).tolist()
    assert out.min() >= 0 and out.max() < 63


def test_pipeline_decodes_both_fighters_in_one_call(monkeypatch):
    """classify_buffer with Viterbi calls the wrapper once, on [2, F, A]."""
    from playaid_core_torch.infer import pipeline as pipeline_module

    port = BatchedActionPipeline(family="cnn", num_actions=5, sequence_length=3, frame_delta=1,
                                 crop_size=32, device="cpu").init(0)
    calls = []

    def recording(lp, true_len, cost):
        calls.append((tuple(lp.shape), true_len, cost))
        return viterbi_decode(lp, true_len, cost)

    monkeypatch.setattr(pipeline_module, "viterbi_decode", recording)
    buf = torch.from_numpy(np.random.default_rng(4).normal(0, 1, (32, 1000)).astype(np.float32))
    labels, conf = port.classify_buffer(buf, 11, decode="viterbi", switch_cost=3.0)
    assert calls == [((2, 16, 5), 11, 3.0)]
    assert tuple(labels.shape) == tuple(conf.shape) == (11, 2)
    port.classify_sequence(buf[:22:2], decode="viterbi", switch_cost=3.0)
    assert calls[1] == ((1, 11, 5), 11, 3.0)


def test_wrapper_uses_plain_version_on_cpu():
    lp = torch.from_numpy(_batch(6, 25, 63, [25, 9], neg_inf=True))
    before = viterbi_decode.launches
    out = viterbi_decode(lp, torch.tensor([25, 9]), 16.0)
    assert torch.equal(out, viterbi_decode_ref(lp, torch.tensor([25, 9]), 16.0))
    assert viterbi_decode.launches == before


def test_wrapper_refuses_what_the_kernel_does_not_take():
    lp = torch.zeros((2, 8, 63))
    with pytest.raises(TypeError):
        viterbi_decode(lp.double(), 8, 4.0)
    with pytest.raises(ValueError):
        viterbi_decode(lp[0], 8, 4.0)
    with pytest.raises(ValueError):
        viterbi_decode(torch.zeros((2, 0, 63)), 8, 4.0)
    with pytest.raises(ValueError):
        viterbi_decode(torch.zeros((1, 8, MAX_CLASSES + 1)), 8, 4.0)
    with pytest.raises(ValueError):
        viterbi_decode(lp, torch.tensor([8, 8, 8]), 4.0)
    with pytest.raises(ValueError):
        viterbi_decode(lp.to("meta"), 8, 4.0)


@pytest.mark.parametrize("f, a, layout", [
    (1, 63, (2, 64, 1, 0)),
    (240, 63, (2, 64, 8, 0)),
    (14400, 63, (2, 64, 450, 0)),        # 176,304 B of shared memory
    (30000, 63, (2, 64, 625, 313)),      # the rest spills to device memory
    (100, 32, (1, 64, 4, 0)),
    (100, 33, (2, 64, 4, 0)),
    (100, 65, (4, 64, 4, 0)),
    (20000, 1024, (32, 8, 40, 585)),     # 4 KB rows: tiles of 8
])
def test_scratch_layout(f, a, layout):
    k, rows, cap, spill = scratch_layout(f, a)
    assert (k, rows, cap, spill) == layout
    assert cap + spill == (f + 31) // 32
    # The ring's two tiles (rows and a 16-byte skew each), two mbarriers,
    # then the resident groups' words and froms.
    assert 2 * (rows * a * 4 + 16) + 16 + cap * 32 * (4 * k + 2) <= 232448
    assert rows * a * 4 % 16 == 0


def _transpose32(words):
    """csrc/viterbi.cu's ``transpose32`` over the 32 lanes' words: five
    rounds in which lanes l and l ^ s swap their off-diagonal blocks."""
    w = [int(x) for x in words]
    for s in (16, 8, 4, 2, 1):
        m = 0xFFFFFFFF // ((1 << s) + 1)  # bits j with j & s == 0
        other = [w[lane ^ s] for lane in range(32)]
        w = [((w[lane] & ~m) | ((other[lane] >> s) & m)) if lane & s
             else ((w[lane] & m) | ((other[lane] << s) & ~m)) for lane in range(32)]
    return [x & 0xFFFFFFFF for x in w]


def _ffs_index(word):
    return (word & -word).bit_length() - 1  # ffs - 1


def _kernel_emulation(lp, true_len, cost):
    """csrc/viterbi.cu's bookkeeping in numpy, on one sequence ``[F, A]``:
    lane l holds classes l + 32 k; for the step that makes row t, bit
    t % 32 of group t // 32 in a word a class of the classes that held the
    maximum and of those that stay; at the group's end each slot's 32 x 32
    bit matrix transposed over the lanes (``transpose32``), so that lane j
    finds step j's from as the first set bit of the first nonzero slot;
    then the backtrack a group at a time, from cur down to the highest
    clear bit of cur's stay word, where that step's from takes over.  The
    last row's label comes from ballots of ``carry == max``."""
    f, a = lp.shape
    k = 1
    while 32 * k < a:
        k *= 2
    n = min(max(true_len, 1), f)
    cost = np.float32(cost)

    def first_index(carry, m):
        lanes = np.uint64(1) << np.arange(32, dtype=np.uint64)
        ballots = ((carry == m).reshape(k, 32) * lanes).sum(axis=1)
        idx = 0
        for slot in reversed(range(k)):
            if int(ballots[slot]):
                idx = 32 * slot + _ffs_index(int(ballots[slot]))
        return idx

    carry = np.full(32 * k, -np.inf, np.float32)
    carry[:a] = lp[0] if true_len > 0 else 0.0
    groups = (n + 31) // 32
    words = np.zeros((groups, 32 * k), np.uint64)
    maxed = np.zeros((groups, 32 * k), np.uint64)
    row = np.full(32 * k, -np.inf, np.float32)
    for t in range(1, n):
        g, j = divmod(t, 32)
        m = carry.max()
        score = np.float32(m - cost)
        maxed[g] |= (carry == m).astype(np.uint64) << np.uint64(j)
        stay = carry >= score
        words[g] |= stay.astype(np.uint64) << np.uint64(j)
        row[:a] = lp[t]
        carry = row + np.where(stay, carry, score)
    froms = np.zeros((groups, 32), np.int64)
    for g in range(groups):
        slots = [_transpose32(maxed[g, 32 * s:32 * s + 32]) for s in range(k)]
        for lane in range(32):
            for s in reversed(range(k)):
                if slots[s][lane]:
                    froms[g, lane] = 32 * s + _ffs_index(slots[s][lane])
    last = first_index(carry, carry.max())
    labels = np.full(f, last, np.int64)
    cur = last
    for g in reversed(range(groups)):
        lo = int(g == 0)  # row 0 has no step
        top = min(31, n - 1 - 32 * g)
        label = np.full(32, cur, np.int64)  # lane j: label[32 g + j - 1]
        p = top
        while p >= lo:
            # Steps lo..p where cur did not stay; the last of them switches.
            moved = ~int(words[g, cur]) & ((2 << p) - 1) & ~((1 << lo) - 1)
            s = moved.bit_length() - 1                    # 31 - clz, or -1
            label[s + 1:p + 1] = cur
            if s < 0:
                break
            cur = int(froms[g, s])
            label[s] = cur
            p = s - 1
        labels[32 * g + lo - 1:32 * g + top] = label[lo:top + 1]
    return labels


@pytest.mark.parametrize("neg_inf", [False, True], ids=["finite", "neg_inf"])
@pytest.mark.parametrize("cost", [0.0, 4.0, float("inf")])
@pytest.mark.parametrize("a", [1, 33, 64, 1024])
def test_kernel_bookkeeping_matches_jax(a, cost, neg_inf):
    """The kernel's own bookkeeping, emulated, gives the JAX function's
    labels: lengths 0, 1, F and 70 (three groups of 32 steps, the last
    partial), quarter-nat ties, -inf entries, a column and a row."""
    f = 100
    lengths = [0, 1, f, 70]
    lp = _batch(a * 11 + int(min(cost, 99)), f, a, lengths, neg_inf)
    with np.errstate(invalid="ignore"):
        got = np.stack([_kernel_emulation(seq, n, cost) for seq, n in zip(lp, lengths)])
    assert got.tolist() == _jax_labels(lp, lengths, cost).tolist()
