"""The port's checkpoints and command line against the JAX package's, on
the CPU.

Reference Lightning ``.ckpt`` containers are built as
``tests/test_lightning_ckpt.py`` builds them: reference-shaped torch
modules (state-dict names ``model.cnn2d.*``, ``resnet.*``/``lstm.*``/
``action_decoder.*``, ``model.resnet.*``/``model.transformer.*``) saved with
``torch.save`` beside a custom hyper-parameter object, which
``torch.load(weights_only=True)`` refuses.  The command line runs on a
96-frame 270x480 mp4v clip with a synthetic ult_logger log.
"""

import csv
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn as tnn

cv2 = pytest.importorskip("cv2")

from playaid_core_tpu.infer import vod_pipeline as jax_vod  # noqa: E402
from playaid_core_tpu.infer.pipeline import BatchedActionPipeline as JaxPipeline  # noqa: E402
from playaid_core_tpu.models.lightning_ckpt import load_pipeline_from_ckpt  # noqa: E402
from playaid_core_torch.infer import vod_pipeline  # noqa: E402
from playaid_core_torch.infer.pipeline import BatchedActionPipeline  # noqa: E402
from playaid_core_torch.models.lightning_ckpt import (  # noqa: E402
    _RestrictedPickleModule,
    extract_state_dict,
    load_lightning_checkpoint,
)
from playaid_core_torch.ontology import CLASS_ID_TO_MOVE  # noqa: E402
from tests.synthlog import scripted_match, write_log  # noqa: E402
from tests.test_torch_port_log import private_jax_native  # noqa: E402,F401 (autouse)
from tests.test_torch_parity import TorchResNet18, _randomize_bn_stats  # noqa: E402
from tests.test_torch_parity_resformer import TorchResFormer  # noqa: E402
from tests.test_torch_port_vod import HEIGHT, NUM_FRAMES, WIDTH, _disc_frames  # noqa: E402

torch.set_num_threads(2)

NUM_ACTIONS, SEQ_LEN, CROP = 6, 3, 48


class _CustomHParams:
    """Stands in for Lightning's AttributeDict / user config objects that
    torch.load(weights_only=True) refuses."""

    def __init__(self):
        self.actions = ["Jab 1", "FTilt"]
        self.lr = 2e-4


def _reference_module(family, num_actions, seq_len):
    """A reference-shaped module of the family, seeded, batch-norm
    statistics randomised."""
    torch.manual_seed(11)
    holder = tnn.Module()
    if family == "cnn":
        class SpatialStreamCNN(tnn.Module):
            def __init__(self):
                super().__init__()
                self.cnn2d = TorchResNet18(num_classes=1000)
                self.cnn1d = tnn.Sequential(tnn.Conv1d(1000, 512, kernel_size=seq_len), tnn.ReLU())
                self.classifier = tnn.Sequential(tnn.Linear(512, 128), tnn.ReLU(),
                                                 tnn.Linear(128, num_actions))

        holder.model = SpatialStreamCNN()
    elif family == "rnn":
        holder.resnet = TorchResNet18(num_classes=1000)
        holder.resnet.fc = tnn.Sequential(tnn.Linear(512, 300))
        holder.lstm = tnn.LSTM(input_size=300, hidden_size=512, num_layers=3, batch_first=True)
        holder.action_decoder = tnn.Sequential(tnn.Linear(512, 128), tnn.ReLU(),
                                               tnn.Linear(128, num_actions))
    else:
        holder.model = TorchResFormer(num_actions, seq_len)
    with torch.no_grad():
        _randomize_bn_stats(holder)
    return holder.eval()


def _save_ckpt(path, module):
    torch.save({"epoch": 7, "global_step": 4242, "pytorch-lightning_version": "1.9.0",
                "state_dict": module.state_dict(),
                "hyper_parameters": {"cfg": _CustomHParams(), "lr": 2e-4},
                "optimizer_states": [{}], "lr_schedulers": []}, path)
    return str(path)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    return {family: _save_ckpt(d / f"{family}.ckpt",
                               _reference_module(family, NUM_ACTIONS, SEQ_LEN))
            for family in ("cnn", "rnn", "resformer")}


def test_ckpt_with_custom_objects_loads_through_the_port(ckpts):
    with pytest.raises(Exception, match="[Ww]eights only load failed"):
        torch.load(ckpts["cnn"], map_location="cpu", weights_only=True)
    ckpt = load_lightning_checkpoint(ckpts["cnn"])
    sd = extract_state_dict(ckpt)
    ref = _reference_module("cnn", NUM_ACTIONS, SEQ_LEN).state_dict()
    assert set(sd) == set(ref)
    for k in ref:
        assert torch.equal(sd[k], ref[k]), k
    assert repr(ckpt["hyper_parameters"]["cfg"]) == "<ckpt stub>"


@pytest.mark.parametrize("family", ["cnn", "rnn", "resformer"])
def test_load_checkpoint_matches_jax_bridge(ckpts, family):
    """The port's load_checkpoint against the JAX package's
    load_pipeline_from_ckpt followed by the port's convert: the same
    weights, so the same embeddings and log-probs."""
    kw = dict(family=family, num_actions=NUM_ACTIONS, sequence_length=SEQ_LEN, crop_size=CROP)
    variables = load_pipeline_from_ckpt(JaxPipeline(**kw), ckpts[family])
    bridged = BatchedActionPipeline(device="cpu", **kw).load_variables(variables)
    port = BatchedActionPipeline(device="cpu", **kw).load_checkpoint(ckpts[family])
    assert port.initialized
    for a, b in ((port.embed, bridged.embed), (port.head, bridged.head)):
        sa, sb = a.state_dict(), b.state_dict()
        assert set(sa) == set(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)
    crops = torch.from_numpy(np.random.default_rng(5).uniform(
        size=(2 * SEQ_LEN, CROP, CROP, 3)).astype(np.float32))
    emb, emb_ref = port.embed_crops(crops), bridged.embed_crops(crops)
    assert emb.shape == (2 * SEQ_LEN, port.embed_dim)
    torch.testing.assert_close(emb, emb_ref, rtol=0, atol=0)
    with torch.inference_mode():
        lp = port._window_log_probs(emb, 2 * SEQ_LEN, 0)
        lp_ref = bridged._window_log_probs(emb_ref, 2 * SEQ_LEN, 0)
    assert lp.shape == (2 * SEQ_LEN, NUM_ACTIONS) and torch.isfinite(lp).all()
    torch.testing.assert_close(lp, lp_ref, rtol=0, atol=0)


def test_save_checkpoint_round_trip(tmp_path):
    src = BatchedActionPipeline(device="cpu", crop_size=CROP).init(3)
    path = tmp_path / "port.pt"
    src.save_checkpoint(path)
    state = torch.load(path, map_location="cpu", weights_only=True)  # no custom objects
    assert set(state) == {"embed", "head"}
    dst = BatchedActionPipeline(device="cpu", crop_size=CROP).load_checkpoint(path)
    for a, b in ((src.embed, dst.embed), (src.head, dst.head)):
        sa, sb = a.state_dict(), b.state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_orbax_directory_raises(tmp_path):
    (tmp_path / "ckpt_0").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        BatchedActionPipeline(device="cpu").load_checkpoint(str(tmp_path / "ckpt_0"))


def test_malicious_pickle_does_not_execute(tmp_path):
    """A crafted container reducing through builtins.eval must load as
    inert stubs, never execute: through the restricted unpickler directly,
    through load_lightning_checkpoint, and through load_checkpoint (which
    then finds no weights)."""
    import pickle

    flag = tmp_path / "pwned"

    class Evil:
        def __reduce__(self):
            return (eval, (f"open({str(flag)!r}, 'w').write('x')",))

    class EvilGetattr:
        def __reduce__(self):
            return (getattr, (__builtins__, "eval"))

    raw = tmp_path / "evil.ckpt"
    with open(raw, "wb") as f:
        pickle.dump({"state_dict": {"w": Evil()}, "h": EvilGetattr()}, f)
    with open(raw, "rb") as f:
        loaded = _RestrictedPickleModule.load(f)
    assert repr(loaded["state_dict"]["w"]) == repr(loaded["h"]) == "<ckpt stub>"

    zipped = str(tmp_path / "evil2.ckpt")
    torch.save({"state_dict": {"w": torch.zeros(2), "e": Evil()}}, zipped)
    sd = extract_state_dict(load_lightning_checkpoint(zipped))
    assert repr(sd["e"]) == "<ckpt stub>" and torch.equal(sd["w"], torch.zeros(2))
    with pytest.raises(KeyError):
        BatchedActionPipeline(device="cpu").load_checkpoint(zipped)
    assert not flag.exists(), "the restricted unpickler executed attacker code"


def test_load_from_bytes_does_not_execute(tmp_path):
    """torch.storage._load_from_bytes unpickles its bytes with no
    restriction, so a container that reduces through it with an inner
    payload must load it as a stub, never run the payload."""
    import pickle

    flag = tmp_path / "pwned"

    class Payload:
        def __reduce__(self):
            return (eval, (f"open({str(flag)!r}, 'w').write('x')",))

    inner = pickle.dumps(Payload())

    class ThroughLoadFromBytes:
        def __reduce__(self):
            return (torch.storage._load_from_bytes, (inner,))

    path = str(tmp_path / "evil.ckpt")
    torch.save({"state_dict": {"w": torch.ones(3), "e": ThroughLoadFromBytes()}}, path)
    sd = extract_state_dict(load_lightning_checkpoint(path))
    assert repr(sd["e"]) == "<ckpt stub>" and torch.equal(sd["w"], torch.ones(3))
    with open(path.replace("evil", "evil_raw"), "wb") as f:
        pickle.dump({"e": ThroughLoadFromBytes()}, f)
    with open(path.replace("evil", "evil_raw"), "rb") as f:
        assert repr(_RestrictedPickleModule.load(f)["e"]) == "<ckpt stub>"
    assert not flag.exists(), "the restricted unpickler executed attacker code"


# ---- the command line ----


@pytest.fixture(scope="module")
def vod(tmp_path_factory):
    """An mp4, a log of the same length and a CNN-63 T=7 reference .ckpt."""
    d = tmp_path_factory.mktemp("cli")
    frames, _ = _disc_frames(NUM_FRAMES, HEIGHT, WIDTH, 65)
    video = str(d / "clip.mp4")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 60, (WIDTH, HEIGHT))
    for frame in frames:
        writer.write(frame)
    writer.release()
    log = str(d / "log.txt")
    write_log(log, scripted_match(NUM_FRAMES))
    ckpt = _save_ckpt(d / "cnn63.ckpt", _reference_module("cnn", 63, 7))
    return d, video, log, ckpt


def _read_csv(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_cli_matches_jax_cli(vod, monkeypatch, capsys):
    d, video, log, ckpt = vod
    args = ["-v", video, "-l", log, "-c", ckpt]
    monkeypatch.setattr(sys, "argv", ["playaid-analyze-vod", *args, "-o", str(d / "jax.csv")])
    with pytest.raises(SystemExit) as done:  # click's standalone mode
        jax_vod.main()
    assert done.value.code == 0
    capsys.readouterr()
    vod_pipeline.main([*args, "-o", str(d / "port.csv"), "--device", "cpu"])
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].startswith(f"{NUM_FRAMES} frames in ") and printed[0].endswith(" fps)")
    assert printed[1] == f"wrote {d / 'port.csv'}"

    ref, out = _read_csv(d / "jax.csv"), _read_csv(d / "port.csv")
    assert out[0] == ref[0] == ["frame", "p0_action", "p0_conf", "p1_action", "p1_conf"]
    assert len(out) == len(ref) == NUM_FRAMES + 1
    moves = set(CLASS_ID_TO_MOVE.values())
    for i, (row, ref_row) in enumerate(zip(out[1:], ref[1:])):
        assert row[0] == ref_row[0] == str(i)
        assert (row[1], row[3]) == (ref_row[1], ref_row[3]) and {row[1], row[3]} <= moves
        for k in (2, 4):
            assert abs(float(row[k]) - float(ref_row[k])) <= 0.01 + 1e-9, (i, row, ref_row)


def test_cli_defaults_to_the_card(vod, monkeypatch):
    _, video, log, _ = vod
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        vod_pipeline.main(["-v", video, "-l", log])
