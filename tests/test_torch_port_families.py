"""The port's ResFormer and RNN families (playaid_core_torch) against the
JAX package's, module by module and through the pipeline.

Weights come from the JAX models' own initialisers, then every batch-norm
statistic, norm scale and bias is redrawn from a numpy seed (the Flax
initialisers zero the last batch-norm scale of every residual block,
which would hide the residual branches), and the classifiers are scaled
up so the posteriors are not flat.  The same numpy trees go through both
packages on the CPU.  Crops are 64 px to keep the CPU time down.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from playaid_core_tpu.infer.pipeline import BatchedActionPipeline as JaxPipeline
from playaid_core_tpu.models.resnet import make_resnet
from playaid_core_tpu.models.resnet_transformer import (
    TransformerEncoderLayer as JaxEncoderLayer,
    time_encoding as jax_time_encoding,
)
from playaid_core_tpu.models.rnn_action_detector import StackedLSTM as JaxStackedLSTM
from playaid_core_torch.convert import (
    from_jax_resformer,
    from_jax_rnn,
    load_npz_tree,
    lstm_state,
    resnet_state_dict,
    to_state_dicts,
    transformer_layer_state,
)
from playaid_core_torch.infer.pipeline import BatchedActionPipeline
from playaid_core_torch.models.resnet import ResNet50
from playaid_core_torch.models.resnet_transformer import TransformerEncoderLayer, time_encoding
from playaid_core_torch.models.rnn_action_detector import StackedLSTM

torch.set_num_threads(2)

ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "playaid_core_tpu", "assets", "bench_cnn63.npz")

CROP = 64
EMBED_REL_TOL = 1e-3   # of max|ref|, as for the CNN family
LOG_PROB_TOL = 1e-4    # absolute


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _perturbed(tree, seed, sharpen=()):
    """Redraw every leaf that the Flax initialisers set to a constant, and
    scale the kernels of the named layers by 8."""
    rng = np.random.default_rng(seed)

    def walk(node, path):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            if k in ("scale", "var"):
                v = rng.uniform(0.5, 1.5, v.shape)
            elif k in ("bias", "mean"):
                v = rng.normal(0.0, 0.1, v.shape)
            elif k == "kernel" and path and path[-1] in sharpen:
                v = v * 8.0
            out[k] = np.asarray(v, np.float32)
        return out

    return walk(tree, ())


def _jax_init(module, seed, *inputs):
    return _numpy_tree(module.init(jax.random.PRNGKey(seed), *inputs))


def _rel_err(out, ref):
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def test_resnet50_pooled_features_match_jax():
    crops = np.random.default_rng(0).uniform(0, 1, (3, CROP, CROP, 3)).astype(np.float32)
    jax_net = make_resnet("resnet50", num_classes=0)
    tree = _perturbed(_jax_init(jax_net, 0, jnp.asarray(crops)), 1)
    ref = np.asarray(jax_net.apply(tree, jnp.asarray(crops)))
    net = ResNet50(num_classes=0).eval()
    net.load_state_dict(resnet_state_dict(tree["params"], tree["batch_stats"],
                                          "BottleneckBlock"))
    assert net.fc is None and net.layer1[0].conv2.stride == (1, 1)
    assert net.layer2[0].conv2.stride == (2, 2) and net.layer2[0].conv1.stride == (1, 1)
    with torch.no_grad():
        out = net(torch.from_numpy(crops).permute(0, 3, 1, 2)).numpy()
    assert out.shape == ref.shape == (3, 2048)
    assert _rel_err(out, ref) <= EMBED_REL_TOL


def test_time_encoding_matches_jax():
    x = np.linspace(0, 1, 7).reshape(-1, 1)
    np.testing.assert_array_equal(time_encoding(x, 4), jax_time_encoding(x, 4))
    assert time_encoding(x, 4).dtype == np.float64


def test_transformer_encoder_layer_matches_jax():
    x = np.random.default_rng(2).normal(0, 1, (5, 7, 256)).astype(np.float32)
    jax_layer = JaxEncoderLayer(256, 8)
    params = _perturbed(_jax_init(jax_layer, 2, jnp.asarray(x)), 3)["params"]
    ref = np.asarray(jax_layer.apply({"params": params}, jnp.asarray(x)))
    layer = TransformerEncoderLayer(256, 8).eval()
    layer.load_state_dict(transformer_layer_state(params))
    with torch.no_grad():
        out = layer(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_stacked_lstm_matches_jax():
    x = np.random.default_rng(4).normal(0, 1, (5, 7, 300)).astype(np.float32)
    jax_lstm = JaxStackedLSTM(512, 3)
    params = _perturbed(_jax_init(jax_lstm, 4, jnp.asarray(x)), 5)["params"]
    ref = np.asarray(jax_lstm.apply({"params": params}, jnp.asarray(x)))
    lstm = StackedLSTM(300, 512, 3).eval()
    lstm.load_state_dict(lstm_state(params))
    assert not lstm.bias_ih_l0.any()  # Flax's input kernels carry no bias
    with torch.no_grad():
        out = lstm(torch.from_numpy(x)).numpy()
    assert out.shape == (5, 7, 512)
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.fixture(scope="module", params=["resformer", "rnn"])
def family(request):
    name = request.param
    jax_pipe = JaxPipeline(family=name, crop_size=CROP)
    sharpen = ("classifier", "decoder_out")
    tree = _perturbed(_numpy_tree(jax_pipe.init(jax.random.PRNGKey(6))), 7, sharpen)
    port = BatchedActionPipeline(family=name, crop_size=CROP, device="cpu").load_variables(tree)
    return name, jax_pipe, tree, port


def test_family_embed_matches_jax(family):
    name, jax_pipe, tree, port = family
    rng = np.random.default_rng(8)
    crops = rng.uniform(0, 1, (4, CROP, CROP, 3)).astype(np.float32)
    ref = np.asarray(jax_pipe.embed_crops(tree, jnp.asarray(crops)))
    out = port.embed_crops(torch.from_numpy(crops)).numpy()
    assert out.shape == ref.shape == (4, port.embed_dim)
    assert _rel_err(out, ref) <= EMBED_REL_TOL
    yuv = rng.integers(0, 256, (2, CROP * CROP * 3 // 2), dtype=np.uint8)
    ref = np.asarray(jax_pipe.embed_crops_yuv(tree, jnp.asarray(yuv)))
    out = port.embed_crops_yuv(torch.from_numpy(yuv)).numpy()
    assert _rel_err(out, ref) <= EMBED_REL_TOL


@pytest.mark.parametrize("decode", ["argmax", "viterbi"])
def test_family_classify_matches_jax(family, decode):
    """From identical embeddings: per-window log-probs within 1e-4,
    identical labels, confidences within 1e-3 relative."""
    name, jax_pipe, tree, port = family
    rng = np.random.default_rng(9)
    true_len = 21
    buf = np.zeros((64, port.embed_dim), np.float32)
    buf[: true_len * 2] = rng.normal(0, 1.0, (true_len * 2, port.embed_dim))
    windows = buf[: true_len * 2].reshape(true_len, 2, -1)[
        np.clip(np.arange(true_len)[:, None] + np.arange(-3, 4), 0, true_len - 1)][:, :, 0]
    ref_lp = np.asarray(jax_pipe._head_apply(tree["head"], jnp.asarray(windows)))
    with torch.inference_mode():
        out_lp = port._head_apply(torch.from_numpy(windows)).numpy()
    assert out_lp.shape == ref_lp.shape == (true_len, 63)
    np.testing.assert_allclose(out_lp, ref_lp, atol=LOG_PROB_TOL)
    kw = dict(decode=decode, switch_cost=2.0)
    ref_l, ref_c = (np.asarray(a) for a in jax_pipe.classify_buffer(
        tree, jnp.asarray(buf), true_len, **kw))
    out_l, out_c = port.classify_buffer(torch.from_numpy(buf), true_len, **kw)
    assert out_l.numpy().tolist() == ref_l.tolist()
    np.testing.assert_allclose(out_c.numpy(), ref_c, rtol=1e-3)


def _monolithic(name, tree):
    """A trained monolithic model's tree, as the JAX package's models lay
    it out, built from a split one."""
    embed_p, embed_s, head_p = tree["embed"]["params"], tree["embed"]["batch_stats"], \
        tree["head"]["params"]
    if name == "cnn":
        return {"params": {"model": {"ResNet_0": embed_p["cnn2d"], **head_p}},
                "batch_stats": {"model": {"ResNet_0": embed_s["cnn2d"]}}}
    if name == "rnn":
        return {"params": {**embed_p, **head_p}, "batch_stats": embed_s}
    return {"params": {"model": {**embed_p, **head_p}}, "batch_stats": {"model": embed_s}}


def _same_tree(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same_tree(a[k], b[k]) for k in a)
    return np.array_equal(a, b)


@pytest.mark.parametrize("name", ["cnn", "resformer", "rnn"])
def test_from_monolithic_matches_jax(name):
    if name == "cnn":
        tree = load_npz_tree(ASSET)
    else:
        tree = _numpy_tree(JaxPipeline(family=name, crop_size=32).init(jax.random.PRNGKey(0)))
    mono = _monolithic(name, tree)
    port = BatchedActionPipeline(family=name, crop_size=32, device="cpu")
    split = port.from_monolithic(mono)
    assert _same_tree(split, JaxPipeline(family=name).from_monolithic(mono))
    assert _same_tree(split, tree)
    port.load_variables(split)  # strict: every parameter present, none left over
    assert port.initialized


@pytest.mark.parametrize("convert, tree_key", [(from_jax_resformer, "layer_0"),
                                               (from_jax_rnn, "lstm")])
def test_family_converters_refuse_unknown_leaves(convert, tree_key):
    name = "resformer" if convert is from_jax_resformer else "rnn"
    tree = _numpy_tree(JaxPipeline(family=name, crop_size=32).init(jax.random.PRNGKey(0)))
    state, ref = convert(tree), to_state_dicts(name, tree)
    assert all(torch.equal(state[p][k], ref[p][k]) for p in ref for k in ref[p])
    tree["head"]["params"]["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError):
        convert(tree)
    del tree["head"]["params"]["extra"]
    tree["head"]["params"][tree_key]["stray"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError):
        convert(tree)


@pytest.mark.parametrize("name", ["cnn", "resformer", "rnn"])
def test_init_is_seeded(name):
    a = BatchedActionPipeline(family=name, crop_size=32, device="cpu").init(3)
    b = BatchedActionPipeline(family=name, crop_size=32, device="cpu").init(3)
    c = BatchedActionPipeline(family=name, crop_size=32, device="cpu").init(4)
    for part in ("embed", "head"):
        sa, sb, sc = (getattr(p, part).state_dict() for p in (a, b, c))
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
        assert any(not torch.equal(sa[k], sc[k]) for k in sa if sa[k].dim() > 1)
    crops = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    emb = a.embed_crops(crops)
    assert torch.isfinite(emb).all() and emb.abs().max() > 0
