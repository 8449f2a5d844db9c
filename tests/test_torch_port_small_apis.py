"""The small APIs of this slice against the JAX package, on the CPU:
``BatchedActionPipeline.classify_chunked`` (tests/test_infer.py:131's case,
with the bench weights) and ``ops.preprocess.batched_crop_resize_shared_frame``
(tests/test_ops.py:91's case, and seeded frames, boxes and options).  Labels
are identical and confidences within 1e-4 relative (PERF.md section 2's
gates); the crops are equal to float32 rounding (1e-5 absolute).  On a
CUDA frame the shared-frame crop runs through K1, which ``chip_smoke.py``
phase 16 checks on the card.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from playaid_core_torch.convert import from_jax_cnn, load_npz_tree
from playaid_core_torch.infer.pipeline import BatchedActionPipeline
from playaid_core_torch.ops.crop_kernel import square_crop_resize
from playaid_core_torch.ops.preprocess import batched_crop_resize_shared_frame
from playaid_core_tpu.infer.pipeline import BatchedActionPipeline as JaxPipeline
from playaid_core_tpu.ops import preprocess as jax_preprocess

ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "playaid_core_tpu", "assets", "bench_cnn63.npz")


@pytest.fixture(scope="module")
def pipes():
    tree = load_npz_tree(ASSET)
    return (tree, JaxPipeline(family="cnn", num_actions=63, sequence_length=7, frame_delta=3),
            BatchedActionPipeline(device="cpu").load_state_dicts(from_jax_cnn(tree)))


def _chunks(emb, chunk):
    f = emb.shape[0]
    out = []
    for start in range(0, f, chunk):
        n = min(chunk, f - start)
        block = np.zeros((chunk, 2, emb.shape[2]), np.float32)
        block[:n] = emb[start:start + n]
        out.append(block.reshape(chunk * 2, -1))
    return out


@pytest.mark.parametrize("f,chunk,min_frame", [(10, 4, 0), (16, 8, 0), (13, 5, 3)])
def test_classify_chunked_equals_jax(pipes, f, chunk, min_frame):
    tree, jax_pipe, port = pipes
    emb = np.random.default_rng(f).normal(0, 1.5, (f, 2, 1000)).astype(np.float32)
    chunks = _chunks(emb, chunk)
    n_last = f % chunk or chunk
    ref_l, ref_c = (np.asarray(a) for a in jax_pipe.classify_chunked(
        tree, [jnp.asarray(c) for c in chunks], n_last=n_last, min_frame=min_frame))
    out_l, out_c = port.classify_chunked([torch.from_numpy(c) for c in chunks], n_last,
                                         min_frame=min_frame)
    assert out_l.shape == (f, 2) and out_l.numpy().tolist() == ref_l.tolist()
    np.testing.assert_allclose(out_c.numpy(), ref_c, rtol=1e-4)
    buf = np.zeros((32, 1000), np.float32)
    buf[: f * 2] = emb.reshape(f * 2, -1)
    whole_l, whole_c = port.classify_buffer(torch.from_numpy(buf), f, min_frame=min_frame)
    assert torch.equal(out_l, whole_l) and torch.equal(out_c, whole_c)


CROP_CASES = [
    # tests/test_ops.py:91's case.
    dict(shape=(180, 320), boxes=[[0.3, 0.5, 0.2, 0.2], [0.7, 0.5, 0.2, 0.2]], out_size=64),
    dict(shape=(720, 1280), boxes=[[0.2, 0.6, 0.1, 0.3], [0.95, 0.05, 0.2, 0.2],
                                   [0.5, 0.5, 0.0, 0.0]], out_size=128, padding=30,
         bgr_to_rgb=True),
    dict(shape=(96, 64), boxes=[[0.1, 0.9, 0.5, 0.4]], out_size=32, padding=4,
         normalize=False),
]


@pytest.mark.parametrize("case", range(len(CROP_CASES)))
def test_shared_frame_crops_equal_jax(case):
    kw = dict(CROP_CASES[case])
    shape, boxes = kw.pop("shape"), np.array(kw.pop("boxes"), np.float32)
    frame = np.random.default_rng(case).integers(0, 255, shape + (3,), dtype=np.uint8)
    ref = np.asarray(jax_preprocess.batched_crop_resize_shared_frame(
        jnp.asarray(frame), jnp.asarray(boxes), **kw))
    launches = square_crop_resize.launches
    out = batched_crop_resize_shared_frame(torch.from_numpy(frame), torch.from_numpy(boxes),
                                           **kw).numpy()
    assert out.shape == ref.shape == (len(boxes), kw["out_size"], kw["out_size"], 3)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * (1 if kw.get("normalize", True)
                                                              else 255))
    assert square_crop_resize.launches == launches  # the CPU frame took the plain version
    if case == 0:
        assert not np.allclose(out[0], out[1])


def test_shared_frame_refuses_batches():
    with pytest.raises(ValueError):
        batched_crop_resize_shared_frame(torch.zeros((2, 8, 8, 3), dtype=torch.uint8),
                                         torch.zeros((2, 4)))
