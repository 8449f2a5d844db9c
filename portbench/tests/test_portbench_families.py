"""The model families (``families/<family>.py``): a family added by a file
of a test's own, the committed families against their arithmetic written
out, and a family with no file."""

import json
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench import run
from portbench.catalog import Catalog
from portbench.reference import models
from portbench.reference.weights import load_flax_cnn, seeded
from portbench.tests.helpers import ROOT, benchmark

SEED = 2**31 + 79
CATALOG = Catalog(benchmark())

# The CNN family's functions, each call recorded.  Named ``cnn`` so that the
# port builds its program; the test's base directory comes first in the
# catalog's bases, so this file is the family the harness finds.
RECORDING_FAMILY = '''
from portbench.catalog import Catalog

committed = Catalog().family("cnn")
calls = []


def _recorded(name):
    def call(*args):
        calls.append(name)
        return getattr(committed, name)(*args)
    return call


weights, embed, head, embed_flops, head_flops, k2_blocks = map(_recorded, (
    "weights", "embed", "head", "embed_flops", "head_flops", "k2_blocks"))
'''


def test_family_added_by_a_file_of_its_own(tiny, tmp_path):
    """The tiny cell's traced run takes its weights, reference and counts
    from the family file in the test's base directory: correct, with
    ``mfu`` from that file's counts."""
    (tmp_path / "families").mkdir()
    (tmp_path / "families" / "cnn.py").write_text(RECORDING_FAMILY)
    family = tiny.family("cnn")
    assert family is not Catalog().family("cnn") and family.calls == []
    result = run.run_cell(tiny, "tiny.match", SEED, 0.5, 1, device="cpu")
    assert result["correct"], result["checks"]
    assert result["metrics"]["mfu"]["value"] > 0
    assert {"weights", "embed", "head", "embed_flops", "head_flops",
            "k2_blocks"} <= set(family.calls)


def test_family_without_a_file(tiny, tmp_path):
    """A configuration naming a family with no file stops the run before
    its set-up, naming the file it looked for; no other family stands in."""
    config = tiny.config("cnn63")
    config["family"] = "unwritten"
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs" / "unwritten.json").write_text(json.dumps(config))
    tiny.bench["configs"].append({"name": "unwritten",
                                  "file": str(tmp_path / "configs" / "unwritten.json")})
    tiny.bench["workloads"].append({"name": "unwritten.match", "config": "unwritten",
                                    "traffic": "tiny", "chips": 1, "why": "test"})
    with pytest.raises(FileNotFoundError, match="families/unwritten.py"):
        run.run_cell(tiny, "unwritten.match", SEED, 0.5, 0, device="cpu")
    with pytest.raises(FileNotFoundError, match="families/unwritten.py"):
        Catalog().family("unwritten")


def _cnn_head(windows, sd):
    y = torch.relu(F.linear(windows.reshape(windows.shape[0], -1), sd["temporal_dense.weight"],
                            sd["temporal_dense.bias"]))
    y = torch.relu(F.linear(y, sd["mlp_hidden.weight"], sd["mlp_hidden.bias"]))
    return torch.log_softmax(F.linear(y, sd["classifier.weight"], sd["classifier.bias"]), dim=1)


def _resformer_embed(crops, sd):
    feats = models.resnet(crops, sd, "resnet50", prefix="resnet.", fc=False)
    return F.linear(feats, sd["resnet_ffn.weight"], sd["resnet_ffn.bias"])


def _resformer_head(windows, sd, layers=3, heads=8):
    """The time encoding, post-norm encoder layers and centre step's
    log-softmax, operation for operation."""
    b, t, _ = windows.shape
    x = np.linspace(0, 1, t).reshape(-1, 1)
    cols = [x]
    for i in range(4):
        cols += [np.cos(np.pi * x * 2 ** i), np.sin(np.pi * x * 2 ** i)]
    enc = torch.from_numpy(np.concatenate(cols, axis=1).astype(np.float32))
    y = torch.cat([windows, enc.expand(b, -1, -1)], dim=2)
    e = y.shape[2]
    hd = e // heads
    for i in range(layers):
        p = f"layers.{i}."
        qkv = F.linear(y, sd[p + "self_attn.in_proj_weight"], sd[p + "self_attn.in_proj_bias"])
        q, k, v = qkv.reshape(b, t, 3, heads, hd).permute(2, 0, 3, 1, 4)
        att = torch.softmax(torch.matmul(q / math.sqrt(hd), k.transpose(-1, -2)), dim=-1)
        out = torch.matmul(att, v).transpose(1, 2).reshape(b, t, e)
        out = F.linear(out, sd[p + "self_attn.out_proj.weight"], sd[p + "self_attn.out_proj.bias"])
        y = F.layer_norm(y + out, (e,), sd[p + "norm1.weight"], sd[p + "norm1.bias"], 1e-6)
        ff = F.linear(torch.relu(F.linear(y, sd[p + "linear1.weight"], sd[p + "linear1.bias"])),
                      sd[p + "linear2.weight"], sd[p + "linear2.bias"])
        y = F.layer_norm(y + ff, (e,), sd[p + "norm2.weight"], sd[p + "norm2.bias"], 1e-6)
    lp = F.linear(y, sd["classifier.weight"], sd["classifier.bias"])
    return torch.log_softmax(lp, dim=2)[:, t // 2]


@pytest.mark.parametrize("name", ["cnn63", "resformer"])
def test_family_is_the_reference_bit_for_bit(name):
    """Each committed family's weights, embeddings and head log-probs are,
    bit for bit, what the shared parts and the arithmetic written out here
    give: the CNN's weights the ``.npz`` as read, the ResFormer's one draw
    from the seed over the port's own modules' names and shapes, in their
    order."""
    config = CATALOG.config(name)
    family = CATALOG.family(config["family"])
    sd = family.weights(config, SEED, "cpu", ROOT)
    if name == "cnn63":
        expected = load_flax_cnn(f"{ROOT}/{config['weights']}", "cpu")
    else:
        from playaid_core_torch.infer.pipeline import BatchedActionPipeline

        pipe = BatchedActionPipeline(family="resformer", device="cpu",
                                     num_actions=config["num_actions"])
        expected = seeded({g: [(k, tuple(v.shape)) for k, v in getattr(pipe, g).state_dict().items()]
                           for g in ("embed", "head")}, SEED, "cpu")
    for g in ("embed", "head"):
        assert list(sd[g]) == list(expected[g])
        assert all(torch.equal(sd[g][k], expected[g][k]) for k in sd[g])
    crops = torch.rand(2, 3, 128, 128, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        emb = family.embed(crops, sd["embed"], config)
        plain = (models.resnet(crops, sd["embed"], "resnet18") if name == "cnn63"
                 else _resformer_embed(crops, sd["embed"]))
        assert torch.equal(emb, plain)
        windows = torch.randn(3, 7, emb.shape[1], generator=torch.Generator().manual_seed(6))
        lp = family.head(windows, sd["head"], config)
        assert lp.shape == (3, 63)
        plain = (_cnn_head(windows, sd["head"]) if name == "cnn63"
                 else _resformer_head(windows, sd["head"]))
        assert torch.equal(lp, plain)
