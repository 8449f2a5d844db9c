"""The plain reference against a tiny CPU run of the port, part by part."""

import numpy as np
import pytest
import torch

from portbench.catalog import Catalog
from portbench.tests.helpers import ROOT
from portbench.reference import ops

CNN = {"family": "cnn", "embed_dim": 1000, "sequence_length": 7, "num_actions": 63,
       "head": {"dense": 512, "hidden": 128}, "weights": "playaid_core_tpu/assets/bench_cnn63.npz"}
RESFORMER = {"family": "resformer", "embed_dim": 247, "sequence_length": 7, "num_actions": 63,
             "head": {"layers": 3, "heads": 8, "ffn": 2048, "time_freqs": 4},
             "weights": "seeded"}
FAMILIES = Catalog()


def test_yuv420_unpack():
    from playaid_core_torch.ops.yuv import yuv420_to_rgb_ref

    crops = torch.randint(0, 256, (3, 32 * 32 * 3 // 2), generator=torch.Generator().manual_seed(0),
                          dtype=torch.uint8)
    port = yuv420_to_rgb_ref(crops, 32).permute(0, 3, 1, 2)
    assert torch.allclose(ops.yuv420_to_rgb(crops, 32), port, atol=1e-6, rtol=0)


def test_middle_out_indices():
    from playaid_core_torch.ops.preprocess import middle_out_frame_indices

    port = middle_out_frame_indices(torch.arange(40), 7, 3, 40).numpy()
    assert np.array_equal(ops.middle_out_indices(40, 7, 3), port)


@pytest.mark.parametrize("cost", [0.0, 1.5, 16.0])
def test_viterbi(cost):
    from playaid_core_torch.ops.viterbi import viterbi_decode_ref

    lp = torch.log_softmax(torch.randn(2, 300, 63, generator=torch.Generator().manual_seed(2)),
                           dim=-1)
    port = viterbi_decode_ref(lp, 300, cost).numpy()
    assert np.array_equal(ops.viterbi(lp.numpy(), cost), port)


def _crops(n, seed=3):
    return torch.rand(n, 3, 128, 128, generator=torch.Generator().manual_seed(seed))


def test_cnn_trained_weights():
    """The committed CNN-63, read by each side on its own: embeddings and
    head log-probs."""
    from playaid_core_torch.convert import load_npz_tree
    from playaid_core_torch.infer.pipeline import BatchedActionPipeline

    pipe = BatchedActionPipeline(device="cpu").load_variables(
        load_npz_tree(f"{ROOT}/{CNN['weights']}"))
    family = FAMILIES.family("cnn")
    sd = family.weights(CNN, 0, "cpu", ROOT)
    x = _crops(4)
    with torch.no_grad():
        emb = family.embed(x, sd["embed"], CNN)
        port = pipe.embed_crops(x.permute(0, 2, 3, 1))
        assert torch.allclose(emb, port, atol=1e-4 * port.abs().max(), rtol=0)
        win = emb[torch.tensor([[0, 1, 2, 3, 3, 2, 1]] * 2)]
        assert torch.allclose(family.head(win, sd["head"], CNN), pipe._head_apply(win),
                              atol=1e-5, rtol=0)


def test_resformer_seeded_weights():
    """The seeded weights load strictly into the port's modules, and the
    two sides agree on them."""
    from playaid_core_torch.infer.pipeline import BatchedActionPipeline

    family = FAMILIES.family("resformer")
    sd = family.weights(RESFORMER, 7, "cpu", ROOT)
    again = family.weights(RESFORMER, 7, "cpu", ROOT)
    assert all(torch.equal(sd[g][k], again[g][k]) for g in sd for k in sd[g])
    pipe = BatchedActionPipeline(family="resformer", device="cpu").load_state_dicts(sd)
    x = _crops(2)
    with torch.no_grad():
        emb = family.embed(x, sd["embed"], RESFORMER)
        port = pipe.embed_crops(x.permute(0, 2, 3, 1))
        assert torch.allclose(emb, port, atol=1e-4 * port.abs().max(), rtol=0)
        win = torch.randn(3, 7, 247, generator=torch.Generator().manual_seed(4))
        ref = family.head(win, sd["head"], RESFORMER)
        assert ref.shape == (3, 63)
        assert torch.allclose(ref, pipe._head_apply(win), atol=1e-5, rtol=0)


def test_seeded_weights_follow_the_seed():
    family = FAMILIES.family("resformer")
    a = family.weights(RESFORMER, 1, "cpu", ROOT)["head"]["classifier.weight"]
    b = family.weights(RESFORMER, 2, "cpu", ROOT)["head"]["classifier.weight"]
    assert not torch.equal(a, b)
    assert a.std().item() == pytest.approx(256 ** -0.5, rel=0.1)
