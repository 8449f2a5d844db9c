"""The port's evaluation dashboards (playaid_core_torch.viz.eval_dashboard
and viz.vis_ai) against the JAX package's, on the CPU.

The port writes its PNGs with the standard library; here every PNG of both
packages is decoded with PIL and compared pixel for pixel, and the HTML
around the images must be identical.  Tolerances: predictions identical;
confidences (percentages) within 1e-2, i.e. probabilities within 1e-4;
vis_ai's confidences within 1e-3 relative, as the runner's recognition is
held in tests/test_torch_port_pixels.py.
"""

import base64
import io
import json
import os
import re
import sys
import types

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
from PIL import Image  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from playaid_core_tpu import constants as jax_constants  # noqa: E402
from playaid_core_tpu.infer.pipeline import BatchedActionPipeline as JaxPipeline  # noqa: E402
from playaid_core_tpu.infer.runner import AIRunner as JaxAIRunner  # noqa: E402
from playaid_core_tpu.train import train as jax_train  # noqa: E402
from playaid_core_tpu.viz import eval_dashboard as jax_dash  # noqa: E402
from playaid_core_tpu.viz import vis_ai as jax_vis_ai  # noqa: E402
from playaid_core_torch import constants  # noqa: E402
from playaid_core_torch.convert import monolithic_state_dict  # noqa: E402
from playaid_core_torch.infer.pipeline import BatchedActionPipeline  # noqa: E402
from playaid_core_torch.infer.runner import AIRunner  # noqa: E402
from playaid_core_torch.train.train import build_model  # noqa: E402
from playaid_core_torch.viz import eval_dashboard, vis_ai  # noqa: E402
from tests.test_torch_port_pixels import _load, _store  # noqa: E402

torch.set_num_threads(2)

CONF_TOL = 1e-2  # percent: probabilities within 1e-4
ACTIONS = ["A", "B", "C"]
_PNG = re.compile(r"data:image/png;base64,([A-Za-z0-9+/=]+)")


def _decode(b64):
    return np.array(Image.open(io.BytesIO(base64.b64decode(b64))))


def _split_html(text):
    """The HTML with each inline PNG replaced by a marker, and the PNGs
    decoded with PIL."""
    return _PNG.sub("data:image/png;base64,<png>", text), [_decode(b) for b in _PNG.findall(text)]


def _same_html(path, ref_path):
    with open(path, encoding="utf-8") as f, open(ref_path, encoding="utf-8") as g:
        (text, pngs), (ref_text, ref_pngs) = _split_html(f.read()), _split_html(g.read())
    assert text == ref_text
    assert len(pngs) == len(ref_pngs) > 0
    assert all(a.shape == b.shape and np.array_equal(a, b) for a, b in zip(pngs, ref_pngs))
    return pngs


# ---- the PNG writer ----


@pytest.mark.parametrize("shape", [(7, 5, 3), (1, 1, 3), (33, 17, 4), (2, 9, 4), (13, 9),
                                   (128, 128, 3)])
def test_png_decodes_to_the_pixels_of_pil(shape):
    """RGB, RGBA and grey at odd sizes, and a strided view: the same
    pixels as the JAX package's PIL PNG."""
    img = np.random.default_rng(len(shape) * 100 + shape[0]).integers(0, 256, shape,
                                                                      dtype=np.uint8)
    for view in (img, np.ascontiguousarray(np.repeat(img, 2, axis=1))[:, ::2]):
        ours, ref = _decode(eval_dashboard._png_b64(view)), _decode(jax_dash._png_b64(view))
        assert ours.shape == ref.shape == view.shape
        assert np.array_equal(ours, view) and np.array_equal(ref, view)


def test_png_refuses_what_it_does_not_write():
    for bad in (np.zeros((4, 4), np.float32), np.zeros((4, 4, 2), np.uint8),
                np.zeros((2, 4, 4, 3), np.uint8)):
        with pytest.raises(TypeError):
            eval_dashboard._png_b64(bad)


# ---- evaluate_samples, write_html_report, streamlit_app ----


class FakeDataset:
    """tests/test_viz_and_misc.py's dataset: 3 frames of 16 px, labels idx % 3;
    ``uint8`` gives the port dataset's wire format (the frames x 255)."""

    animations = ACTIONS

    def __init__(self, uint8=False):
        self.uint8 = uint8

    def __getitem__(self, idx):
        rng = np.random.default_rng(idx)
        frames = rng.uniform(size=(3, 16, 16, 3)).astype(np.float32)
        if self.uint8:
            frames = (frames * 255).astype(np.uint8)
        labels = np.array([idx % 3] * 3, np.int32)
        return frames, np.int32(0), labels, {"char": "Byleth", "actions": ["A"] * 3}


def _jax_fake_apply(frames):
    return jax.nn.log_softmax(jnp.full((1, 3, 3), -5.0).at[:, :, 1].set(0.0), axis=-1)


def _port_fake_apply(frames):
    logits = torch.full((1, 3, 3), -5.0)
    logits[:, :, 1] = 0.0
    return torch.log_softmax(logits, dim=-1)


@pytest.fixture(scope="module")
def tiny_cnn():
    """The JAX CNN family at 3 actions, T 3, from its seeded init, and the
    port's model carried across (eval mode, on the CPU)."""
    model, _ = jax_train.build_model("cnn", len(ACTIONS), 3)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 3, 16, 16, 3)))
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    port, _ = build_model("cnn", len(ACTIONS), 3)
    port.load_state_dict(monolithic_state_dict("cnn", variables))
    port.eval()

    def jax_apply(frames):
        return model.apply(variables, jnp.asarray(frames), train=False)

    def port_apply(frames):
        return port(frames.float() / 255.0 if frames.dtype == torch.uint8 else frames)

    return jax_apply, port_apply


def _compare_samples(records, agg, ref_records, ref_agg):
    assert {k: v for k, v in agg.items() if k != "mean_confidence"} == \
        {k: v for k, v in ref_agg.items() if k != "mean_confidence"}
    assert abs(agg["mean_confidence"] - ref_agg["mean_confidence"]) <= CONF_TOL
    for rec, ref in zip(records, ref_records, strict=True):
        assert rec["frames"].dtype == np.uint8 and np.array_equal(rec["frames"], ref["frames"])
        assert rec["correct"] == ref["correct"] and rec["meta"] == ref["meta"]
        assert abs(rec["confidence"] - ref["confidence"]) <= CONF_TOL
        # The mark, "Pred:" and the action; then the ground truth.
        assert rec["caption"].split(" ")[:3] == ref["caption"].split(" ")[:3]
        assert rec["caption"].split("|")[1:] == ref["caption"].split("|")[1:]


@pytest.mark.parametrize("model, center_supervised", [("fake", False), ("cnn", True),
                                                      ("cnn", False)])
def test_evaluate_samples_matches_jax(tiny_cnn, model, center_supervised):
    """Records (frames, captions, marks, meta) and aggregates against the JAX
    harness: the fake model of tests/test_viz_and_misc.py, and the tiny CNN
    carried across."""
    if model == "fake":
        jax_apply, port_apply = _jax_fake_apply, _port_fake_apply
    else:
        jax_apply, port_apply = tiny_cnn
    records, agg = eval_dashboard.evaluate_samples(port_apply, FakeDataset(), total=6,
                                                   center_supervised=center_supervised)
    ref_records, ref_agg = jax_dash.evaluate_samples(jax_apply, FakeDataset(), total=6,
                                                     center_supervised=center_supervised)
    _compare_samples(records, agg, ref_records, ref_agg)
    if model == "fake":
        assert records[1]["caption"] == ref_records[1]["caption"] == "✅ Pred: B 98.67%"
        assert abs(agg["accuracy"] - 2 / 6) < 1e-9


def test_evaluate_samples_takes_uint8_frames(tiny_cnn):
    """The port's datasets give uint8 frames: the records keep them, and the
    predictions are those of the JAX harness on the float frames."""
    jax_apply, port_apply = tiny_cnn
    records, agg = eval_dashboard.evaluate_samples(port_apply, FakeDataset(uint8=True), total=6)
    float_records, _ = eval_dashboard.evaluate_samples(port_apply, FakeDataset(), total=6)
    ref_records, ref_agg = jax_dash.evaluate_samples(
        lambda x: jax_apply(np.asarray(x, np.float32) / 255.0), FakeDataset(uint8=True), total=6)
    assert agg["preds"] == ref_agg["preds"] and agg["accuracy"] == ref_agg["accuracy"]
    for rec, ref in zip(records, float_records, strict=True):
        assert np.array_equal(rec["frames"], ref["frames"])


def test_write_html_report_matches_jax(tmp_path):
    """The same records -> identical HTML around the images, and every
    image (frames and the confusion matrix) the same pixels."""
    records, agg = jax_dash.evaluate_samples(_jax_fake_apply, FakeDataset(), total=6,
                                             center_supervised=False)
    path = eval_dashboard.write_html_report(str(tmp_path / "port" / "report.html"), records, agg,
                                            ACTIONS)
    ref = jax_dash.write_html_report(str(tmp_path / "jax" / "report.html"), records, agg, ACTIONS)
    pngs = _same_html(path, ref)
    assert len(pngs) == 6 * 3 + 1 and pngs[-1].shape == (600, 800, 3)
    with open(path, encoding="utf-8") as f:
        assert f.read().count("<div class='strip'>") == 6


def _metrics_jsonl(path):
    rng = np.random.default_rng(0)
    with open(path, "w") as f:
        for epoch in range(5):
            rec = {"epoch": epoch, "train_loss": float(rng.random()), "train_acc": epoch / 5,
                   "grad_norm": float(rng.random()), "param_norm": 10.0 + epoch,
                   "steps_per_sec": 3.0 + epoch}
            if epoch % 2 == 0:
                rec.update(val_loss=float(rng.random()), val_acc=0.2 * epoch)
            f.write(json.dumps(rec) + "\n\n")


def test_write_training_report_matches_jax(tmp_path):
    """Four panels (loss, accuracy, norms, throughput), drawn alike."""
    metrics = str(tmp_path / "metrics.jsonl")
    _metrics_jsonl(metrics)
    path = eval_dashboard.write_training_report(metrics, str(tmp_path / "port.html"))
    ref = jax_dash.write_training_report(metrics, str(tmp_path / "jax.html"))
    assert len(_same_html(path, ref)) == 4
    empty = tmp_path / "empty.jsonl"
    empty.write_text("\n")
    with pytest.raises(ValueError):
        eval_dashboard.write_training_report(str(empty), str(tmp_path / "x.html"))


def _recording_streamlit(calls):
    st = types.ModuleType("streamlit")
    st.title = lambda *a, **k: calls.append(("title", a, k))
    st.image = lambda *a, **k: calls.append(("image", a, k))
    st.write = lambda *a, **k: calls.append(("write", a, k))
    return st


def test_streamlit_app_makes_the_calls_of_jax(monkeypatch):
    """A recording stub in place of streamlit (not installed here): the same
    calls in the same order, with the same images."""
    calls = {"port": [], "jax": []}
    monkeypatch.setitem(sys.modules, "streamlit", _recording_streamlit(calls["port"]))
    eval_dashboard.streamlit_app(_port_fake_apply, FakeDataset(), total=4)
    monkeypatch.setitem(sys.modules, "streamlit", _recording_streamlit(calls["jax"]))
    jax_dash.streamlit_app(_jax_fake_apply, FakeDataset(), total=4)
    assert [c[0] for c in calls["port"]] == [c[0] for c in calls["jax"]]
    assert [c[0] for c in calls["port"]].count("image") == 4 + 1
    for (kind, args, kw), (_, ref_args, ref_kw) in zip(calls["port"], calls["jax"]):
        assert kw == ref_kw
        if kind == "image":
            a, b = args[0], ref_args[0]
            assert np.array_equal(np.asarray(a), np.asarray(b))
        else:
            assert args == ref_args


# ---- vis_ai over each package's runner (tests/test_vis_ai.py's clip) ----


class _Detector:
    """tests/test_ai_runner.py's FakeDetector (20 frames; Pikachu misses
    1-2 and 8-10 and has a duplicate on 5, Joker misses the tail), writing
    jpg crops for the JAX runner and .npy crops for the port's."""

    def __init__(self, jax_layout):
        self.jax_layout = jax_layout

    def run(self, input_video_path, exp_name):
        cache = jax_constants.AI_CACHE if self.jax_layout else constants.AI_CACHE
        base = os.path.join(cache, exp_name)
        if os.path.exists(os.path.join(base, "crops")):
            return exp_name
        video_name = os.path.splitext(os.path.basename(input_video_path))[0]
        rng = np.random.default_rng(0)
        for fighter in ("Pikachu", "Joker"):
            os.makedirs(os.path.join(base, "crops", fighter), exist_ok=True)
        os.makedirs(os.path.join(base, "labels"), exist_ok=True)
        for i in range(1, 21):
            lines = []
            for class_id, fighter in ((2, "Pikachu"), (3, "Joker")):
                if fighter == "Pikachu" and (8 <= i <= 10 or i <= 2):
                    continue
                if fighter == "Joker" and i > 17:
                    continue
                cx = 0.3 + 0.02 * i if fighter == "Pikachu" else 0.7 - 0.02 * i
                lines.append(f"{class_id} {cx} 0.5 0.2 0.3 0.9")
                if fighter == "Pikachu" and i == 5:
                    lines.append(f"{class_id} {cx + 0.3} 0.8 0.2 0.3 0.4")
                crop = rng.integers(0, 255, (128, 128, 3), dtype=np.uint8)
                stem = os.path.join(base, "crops", fighter, f"{video_name}_{i}")
                if self.jax_layout:
                    cv2.imwrite(stem + ".jpg", crop)
                else:
                    np.save(stem + ".npy", crop)
            with open(os.path.join(base, "labels", f"{video_name}_{i}.txt"), "w") as f:
                f.write("\n".join(lines) + ("\n" if lines else ""))
        return exp_name


@pytest.fixture(scope="module")
def runners(tmp_path_factory):
    """Both packages' completed runners on tests/test_vis_ai.py's clip, with
    the JAX pipeline's seeded init (CNN, 8 actions, T 3, delta 1, 32 px)
    carried into the port's.  The JAX crops are stored losslessly (an npy
    body under the jpg name), as in tests/test_torch_port_pixels.py, so
    both runners classify the same pixels."""
    d = tmp_path_factory.mktemp("vis_ai")
    video = str(d / "clip.mp4")
    w = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 60, (320, 180))
    for i in range(25):
        w.write(np.full((180, 320, 3), 60 + i, np.uint8))
    w.release()
    kw = dict(family="cnn", num_actions=8, sequence_length=3, frame_delta=1, crop_size=32)
    jax_pipe = JaxPipeline(**kw)
    variables = jax.tree_util.tree_map(np.asarray, jax_pipe.init(jax.random.PRNGKey(0)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cv2, "imwrite", _store)
        mp.setattr(cv2, "imread", _load)
        mp.setattr(jax_constants, "AI_CACHE", str(d / "jax_cache"))
        mp.setattr(constants, "AI_CACHE", str(d / "port_cache"))
        ref = JaxAIRunner(video, detector=_Detector(True), pipeline=jax_pipe, variables=variables)
        out = AIRunner(video, detector=_Detector(False),
                       pipeline=BatchedActionPipeline(device="cpu", **kw), variables=variables)
        for runner in (ref, out):
            runner.run_detection_setup()
            runner.run_action_recognition()
        yield ref, out, d


def _ground_truth(runner):
    f0, f1 = runner.fighters
    n = runner.max_frames - 1
    return {f0: [runner.ai_output_data[f0][i].action for i in range(n)],
            f1: ["__not_a_move__"] * n}


@pytest.mark.parametrize("gt", ["none", "dict", "array"])
def test_vis_records_match_jax(runners, gt):
    """Strips, actions, marks, ground truth and aggregates as the JAX
    package's; each crop is its own runner's crop file, RGB."""
    ref, out, _ = runners
    assert out.fighters == ref.fighters and out.max_frames == ref.max_frames == 20
    labels = {"none": None, "dict": _ground_truth(ref)}
    labels["array"] = np.stack([labels["dict"][f] for f in ref.fighters], axis=1) \
        if gt == "array" else None
    records, agg = vis_ai.collect_vis_records(out, labels[gt], sample_every=4)
    ref_records, ref_agg = jax_vis_ai.collect_vis_records(ref, labels[gt], sample_every=4)
    assert agg == ref_agg and len(records) == len(ref_records) == 5
    if gt != "none":
        assert agg["full_agreement"] == pytest.approx(0.5) and agg["sampled_agreement"] == 0.5
    for row, ref_row in zip(records, ref_records, strict=True):
        assert row["frame"] == ref_row["frame"]
        for f, r in zip(row["fighters"], ref_row["fighters"], strict=True):
            assert {k: f[k] for k in ("fighter", "action", "gt", "correct")} == \
                {k: r[k] for k in ("fighter", "action", "gt", "correct")}
            assert f["confidence"] == pytest.approx(r["confidence"], rel=1e-3)
            path = out.get_crop_path(f["fighter"], row["frame"])
            assert path.endswith(".npy")
            assert np.array_equal(f["crop"], np.load(path)[:, :, ::-1])
            ref_path = ref.get_crop_path(r["fighter"], row["frame"])
            assert np.array_equal(r["crop"], _load(ref_path)[:, :, ::-1])
            assert np.array_equal(f["crop"], r["crop"])


def test_vis_ai_report_matches_jax(runners):
    """The report of tests/test_vis_ai.py::test_report_with_gt: identical
    HTML around the images (but the video's path, the runner's own), and the
    crops' PNGs decode to their crop files' RGB pixels."""
    ref, out, d = runners
    gt = _ground_truth(ref)
    path, agg = vis_ai.write_vis_ai_report(str(d / "port" / "vis_ai.html"), out, gt,
                                           sample_every=3)
    ref_path, ref_agg = jax_vis_ai.write_vis_ai_report(str(d / "jax" / "vis_ai.html"), ref, gt,
                                                       sample_every=3)
    assert agg == ref_agg and agg["full_agreement"] == pytest.approx(0.5)
    with open(path, encoding="utf-8") as f, open(ref_path, encoding="utf-8") as g:
        text, pngs = _split_html(f.read())
        ref_text, ref_pngs = _split_html(g.read())
    assert "✅" in text and "❌" in text and "action agreement" in text
    assert re.sub(r"\(\d+%\)", "", text) == re.sub(r"\(\d+%\)", "", ref_text)
    frames = range(1, out.max_frames, 3)
    want = [np.load(out.get_crop_path(f, i))[:, :, ::-1] for i in frames for f in out.fighters]
    assert len(pngs) == len(ref_pngs) == len(want) == 14
    assert all(np.array_equal(a, b) and np.array_equal(a, c)
               for a, b, c in zip(pngs, ref_pngs, want))
