"""The port's CNN-family pipeline (playaid_core_torch) against the JAX
package's, with the committed bench weights (assets/bench_cnn63.npz).

Inputs are made with numpy from a seed and go through both packages on
the CPU; the JAX side runs its plain preprocessing (use_pallas=False).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from playaid_core_tpu.infer.pipeline import BatchedActionPipeline as JaxPipeline
from playaid_core_torch.convert import from_jax_cnn, load_npz_tree
from playaid_core_torch.infer.pipeline import BatchedActionPipeline

torch.set_num_threads(2)

ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "playaid_core_tpu", "assets", "bench_cnn63.npz")


@pytest.fixture(scope="module")
def tree():
    return load_npz_tree(ASSET)


@pytest.fixture(scope="module")
def jax_pipe():
    return JaxPipeline(family="cnn", num_actions=63, sequence_length=7, frame_delta=3)


@pytest.fixture(scope="module")
def port(tree):
    return BatchedActionPipeline(device="cpu").load_state_dicts(from_jax_cnn(tree))


def test_from_jax_cnn_maps_every_key(tree):
    with np.load(ASSET) as z:
        keys = list(z.files)
    state = from_jax_cnn(tree)
    mapped = [k for sd in state.values() for k in sd if not k.endswith("num_batches_tracked")]
    assert len(mapped) == len(keys)  # one entry per leaf, none left over
    # Strict loading (the port fixture does it too) proves nothing is missing.
    BatchedActionPipeline(device="cpu").load_state_dicts(state)
    w = tree["embed"]["params"]["cnn2d"]["BasicBlock_7"]["Conv_0"]["kernel"]
    np.testing.assert_array_equal(state["embed"]["layer4.1.conv1.weight"].numpy(),
                                  w.transpose(3, 2, 0, 1))
    proj = tree["embed"]["batch_stats"]["cnn2d"]["BasicBlock_2"]["norm_proj"]["var"]
    np.testing.assert_array_equal(state["embed"]["layer2.0.downsample.1.running_var"].numpy(),
                                  proj)
    dense = tree["head"]["params"]["temporal_dense"]["kernel"]
    np.testing.assert_array_equal(state["head"]["temporal_dense.weight"].numpy(), dense.T)
    with pytest.raises(KeyError):
        from_jax_cnn({"embed": {"params": {"cnn2d": {"extra": {"kernel": dense}}}},
                      "head": {"params": {}}})


def test_resnet_matches_jax_with_bench_weights(tree, jax_pipe, port):
    crops = np.random.default_rng(0).integers(0, 256, (4, 128, 128, 3), dtype=np.uint8)
    crops = crops.astype(np.float32) / 255.0
    ref = np.asarray(jax_pipe.embed.apply(tree["embed"], jnp.asarray(crops)))
    out = port.embed_crops(torch.from_numpy(crops)).numpy()
    assert out.shape == (4, 1000)
    assert np.abs(out - ref).max() <= 1e-3 * np.abs(ref).max()


@pytest.mark.parametrize("route", ["u8", "yuv"])
def test_embed_u8_and_yuv_match_jax(tree, jax_pipe, port, route):
    rng = np.random.default_rng(1)
    if route == "u8":
        crops = rng.integers(0, 256, (3, 128, 128, 3), dtype=np.uint8)
        ref = np.asarray(jax_pipe.embed_crops_u8(tree, jnp.asarray(crops)))
        out = port.embed_crops_u8(torch.from_numpy(crops)).numpy()
    else:
        crops = rng.integers(0, 256, (3, 128 * 128 * 3 // 2), dtype=np.uint8)
        ref = np.asarray(jax_pipe.embed_crops_yuv(tree, jnp.asarray(crops)))
        out = port.embed_crops_yuv(torch.from_numpy(crops)).numpy()
    assert np.abs(out - ref).max() <= 1e-3 * np.abs(ref).max()


@pytest.mark.parametrize("smooth_radius", [0, 2])
@pytest.mark.parametrize("decode", ["argmax", "viterbi"])
def test_classify_matches_jax(tree, jax_pipe, port, decode, smooth_radius):
    """From identical embeddings: identical labels, confidences (percent)
    within 1e-4 relative."""
    rng = np.random.default_rng(2)
    true_len = 27
    buf = np.zeros((64, 1000), np.float32)
    buf[: true_len * 2] = rng.normal(0, 1.5, (true_len * 2, 1000))
    kw = dict(smooth_radius=smooth_radius, decode=decode, switch_cost=3.0)
    ref_l, ref_c = (np.asarray(a) for a in jax_pipe.classify_buffer(
        tree, jnp.asarray(buf), true_len, **kw))
    out_l, out_c = port.classify_buffer(torch.from_numpy(buf), true_len, **kw)
    assert out_l.numpy().tolist() == ref_l.tolist()
    np.testing.assert_allclose(out_c.numpy(), ref_c, rtol=1e-4)

    seq = buf[0: true_len * 2: 2]  # fighter 0's embeddings
    ref = [np.asarray(a) for a in jax_pipe.classify_sequence(
        tree, jnp.asarray(seq), pad_bucket=32, return_raw=True, **kw)]
    out = [a.numpy() for a in port.classify_sequence(torch.from_numpy(seq),
                                                     return_raw=True, **kw)]
    assert out[0].tolist() == ref[0].tolist()
    assert out[2].tolist() == ref[2].tolist()
    np.testing.assert_allclose(out[1], ref[1], rtol=1e-4)


def _lp(seq, n_classes=3, strength=2.0, noise=None):
    lp = np.full((len(seq), n_classes), -strength, np.float32)
    lp[np.arange(len(seq)), seq] = 0.0
    if noise is not None:
        lp += noise
    return torch.from_numpy(lp)


def _noisy_step():
    noise = np.random.default_rng(0).normal(0, 0.3, (20, 3)).astype(np.float32)
    return _lp([0] * 10 + [2] * 10, noise=noise), 20, 4.0, [0] * 10 + [2] * 10


def _padded():
    return torch.cat([_lp([0] * 10), _lp([1] * 6)]), 10, 4.0, [0] * 16


# (log_probs, true_len, switch_cost, expected labels) after tests/test_viterbi_decode.py
VITERBI_CASES = {
    "suppresses_isolated_flips": (
        _lp([1 if i in (7, 13) else 0 for i in range(20)]), 20, 4.0, [0] * 20),
    "keeps_genuine_transition_sharp": _noisy_step(),
    "switches_when_evidence_sustained": (
        _lp([0] * 8 + [1] * 5 + [0] * 7), 20, 4.0, [0] * 8 + [1] * 5 + [0] * 7),
    "true_len_masks_padding": _padded(),
    "infinite_cost_is_global_argmax": (_lp([0] * 6 + [1] * 14), 20, float("inf"), [1] * 20),
}


@pytest.mark.parametrize("case", sorted(VITERBI_CASES))
def test_viterbi_decode_cases(case):
    lp, true_len, cost, expected = VITERBI_CASES[case]
    labels = BatchedActionPipeline._viterbi_decode(lp, true_len, cost)
    assert labels.tolist() == expected


def test_make_embedding_buffer_sizes(jax_pipe, port):
    for n in (1, 5, 4096, 4097):
        buf = port.make_embedding_buffer(n)
        assert tuple(buf.shape) == tuple(jax_pipe.make_embedding_buffer(n).shape)
        assert buf.dtype == torch.float32 and not buf.any()
    with pytest.raises(IndexError):
        port.scatter_embeddings(port.make_embedding_buffer(2), torch.ones(6, 1000), 0)


def _disc_clip(num_frames, h, w, box_px):
    """Noise background with two discs moving along the fighter trajectories."""
    rng = np.random.default_rng(0)
    frames = np.repeat(rng.integers(0, 60, (1, h, w, 3), dtype=np.uint8), num_frames, axis=0)
    boxes = np.zeros((num_frames, 2, 4), np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    radius = box_px * 90 / 260
    for i in range(num_frames):
        x = 0.2 + 0.6 * (i / num_frames)
        boxes[i, 0] = (x, 0.5, box_px / w, box_px / h)
        boxes[i, 1] = (1.0 - x, 0.5 + 60 / 1080, box_px / w, box_px / h)
        for k, colour in enumerate(((0, 200, 255), (255, 80, 0))):
            cx, cy = boxes[i, k, 0] * w, boxes[i, k, 1] * h
            frames[i][(yy - cy) ** 2 + (xx - cx) ** 2 <= radius ** 2] = colour
    return frames, boxes


def test_slice_matches_jax(tree, jax_pipe, port):
    """preprocess -> embed -> scatter -> classify_buffer over 16 frames,
    stride 2, chunk 8: identical labels in both packages."""
    frames, boxes = _disc_clip(16, 270, 480, 65)
    stride, chunk, padding = 2, 8, 8
    sampled = chunk // stride
    jbuf = jax_pipe.make_embedding_buffer(16 // stride)
    tbuf = port.make_embedding_buffer(16 // stride)
    for c0 in range(0, 16, chunk):
        idx = np.arange(c0, c0 + chunk, stride)
        crops = jax_pipe.preprocess_frames(
            jnp.asarray(np.repeat(frames[idx], 2, axis=0)),
            jnp.asarray(boxes[idx].reshape(-1, 4)), padding=padding, use_pallas=False)
        jbuf = jax_pipe.scatter_embeddings(jbuf, jax_pipe.embed_crops(tree, crops),
                                           (c0 // stride) * 2)
        tcrops = port.preprocess_frames(torch.from_numpy(frames[idx]),
                                        torch.from_numpy(boxes[idx]), padding=padding)
        assert tuple(tcrops.shape) == (sampled, 2, 128, 128, 3)
        port.scatter_embeddings(tbuf, port.embed_crops(tcrops.reshape(-1, 128, 128, 3)),
                                (c0 // stride) * 2)
    jbuf = np.asarray(jbuf)
    assert np.abs(tbuf.numpy() - jbuf).max() <= 1e-3 * np.abs(jbuf).max()
    for decode in ("argmax", "viterbi"):
        ref_l, ref_c = jax_pipe.classify_buffer(tree, jnp.asarray(jbuf), 8, decode=decode,
                                                switch_cost=16.0)
        out_l, out_c = port.classify_buffer(tbuf, 8, decode=decode, switch_cost=16.0)
        assert out_l.numpy().tolist() == np.asarray(ref_l).tolist()
        np.testing.assert_allclose(out_c.numpy(), np.asarray(ref_c), rtol=1e-3)


def test_pipeline_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedActionPipeline()


@pytest.mark.parametrize("family", ["cnn3d", "transformer"])
def test_unported_families_raise(family):
    """The port has the JAX package's three families and no other."""
    with pytest.raises(ValueError, match="cnn.*resformer.*rnn"):
        BatchedActionPipeline(family=family, device="cpu")
