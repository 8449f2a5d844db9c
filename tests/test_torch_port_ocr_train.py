"""The port's OCR training half (playaid_core_torch.infer.ocr_conv), the
digit net's weight conversion both ways, the template reader and the
default reader (playaid_core_torch.infer.ocr) against the JAX package's,
on the CPU.

Tolerances: ``synth_batch`` bit for bit (patches and labels); the train
step, 3 steps at batch 16 from the JAX init, loss within 1e-5 relative
each step, in float32 every gradient within 1e-5 of its tensor's max|g|
and in float64 every parameter within 1e-5 of its tensor's max|p| after
each step; the weight conversion exact; the template reader's readings
identical and its confidence within 1e-6.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from playaid_core_tpu.constants import TEXT_FONT_PATH  # noqa: E402
from playaid_core_tpu.infer import ocr as jax_ocr  # noqa: E402
from playaid_core_tpu.infer import ocr_conv as jax_ocr_conv  # noqa: E402
from playaid_core_torch.convert import from_jax_digits, to_jax_digits  # noqa: E402
from playaid_core_torch.infer import ocr, ocr_conv  # noqa: E402

torch.set_num_threads(2)

LR = 2e-3
STEP_BATCH, STEPS = 16, 3
LOSS_REL_TOL = 1e-5
PARAM_REL_TOL = 1e-5  # of max|p| (float64) or max|g| (float32) of each tensor


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_synth_batch_matches_jax_bit_for_bit(seed):
    """The same draws from default_rng(seed): identical patches and labels
    (the segmentation's component count decides which renders are kept)."""
    fonts = ocr_conv.train_fonts()
    assert fonts == jax_ocr_conv.train_fonts() and len(fonts) >= 10
    x, y = ocr_conv.synth_batch(np.random.default_rng(seed), fonts, 8)
    ref_x, ref_y = jax_ocr_conv.synth_batch(np.random.default_rng(seed), fonts, 8)
    assert x.dtype == ref_x.dtype == np.float32 and y.dtype == ref_y.dtype == np.int32
    assert x.shape == (8, 48, 48, 1)
    assert np.array_equal(x, ref_x) and np.array_equal(y, ref_y)


def test_font_pools_and_render_match_jax():
    assert ocr_conv.heldout_fonts() == jax_ocr_conv.heldout_fonts()
    font = ocr_conv.heldout_fonts()[0]
    kw = dict(height=40, outline=3, shadow=1, rotation=5.0, damage=0.7, noise=9, blur=1, seed=4)
    assert np.array_equal(ocr_conv.render_hud_text("12.5", font, **kw),
                          jax_ocr_conv.render_hud_text("12.5", font, **kw))


def _jax_step(steps, dtype):
    """The JAX update as ocr_conv.train builds it, with its init (cast to
    ``dtype``) and a jitted gradient of the same loss."""
    model = jax_ocr_conv._make_model()
    tx = optax.adam(optax.cosine_decay_schedule(LR, steps, alpha=0.05))

    def loss_fn(p, x, y):
        logits = model.apply(p, x)
        loss = optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
        return loss, logits

    @jax.jit
    def step(params, opt_state, x, y):
        (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, x, y)
        updates, opt_state = tx.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        acc = (jnp.argmax(logits, -1) == y).mean()
        return params, opt_state, loss, acc

    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 48, 48, 1)))
    params = jax.tree_util.tree_map(lambda a: a.astype(dtype), params)
    grad = jax.jit(lambda p, x, y: jax.grad(lambda q: loss_fn(q, x, y)[0])(p))
    return params, tx.init(params), step, grad


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_train_step_matches_jax(dtype):
    """3 steps from the JAX init carried across, on the same batches, both
    sides in ``dtype``: each step's loss (1e-5 relative) and accuracy; in
    float32 the first step's gradients (1e-5 of max|g| of each tensor), in
    float64 the parameters after each step (1e-5 of max|p| of each tensor).

    The float32 parameters are not compared: Adam divides each gradient by
    its own magnitude, and where that is near eps (1e-8) the float32
    rounding of the sum, far below 1e-5 of max|g|, is amplified to a good
    part of a step (lr 2e-3), so the update is held in float64, as
    tests/test_torch_port_train_resformer.py holds its step.
    For the same reason the later float32 steps start from parameters a
    little apart, and only their losses are compared."""
    with jax.enable_x64(dtype == "float64"):
        params, opt_state, step, grad = _jax_step(STEPS, getattr(jnp, dtype))
        model = ocr_conv.DigitNet().to(getattr(torch, dtype))
        model.load_state_dict(from_jax_digits(_numpy_tree(params)))
        optimizer, scheduler = ocr_conv.make_optimizer(model, LR, STEPS)
        rng = np.random.default_rng(7)
        fonts = ocr_conv.train_fonts()
        for i in range(STEPS):
            x, y = ocr_conv.synth_batch(rng, fonts, STEP_BATCH)
            ref_grads = _leaves(grad(params, x.astype(dtype), y))
            params, opt_state, ref_loss, ref_acc = step(params, opt_state, x.astype(dtype), y)
            loss, acc = ocr_conv.train_step(model, optimizer, scheduler, x, y)
            assert abs(float(loss) - float(ref_loss)) <= LOSS_REL_TOL * abs(float(ref_loss)), i
            assert float(acc) == float(ref_acc), i
            if dtype == "float32" and i > 0:
                continue
            if dtype == "float32":
                got, want = _leaves(to_jax_digits({k: p.grad for k, p in
                                                   model.named_parameters()})), ref_grads
            else:
                got, want = _leaves(to_jax_digits(model.state_dict())), _leaves(params)
            assert sorted(got) == sorted(want)
            for key, ref in want.items():
                err = np.abs(got[key] - ref).max()
                assert err <= PARAM_REL_TOL * np.abs(ref).max(), (i, key, err)
    assert scheduler.last_epoch == STEPS


def test_cosine_decay_matches_optax():
    from playaid_core_torch.train.schedules import cosine_decay_schedule

    for steps in (1, 3, 1200):
        ours, ref = cosine_decay_schedule(LR, steps, 0.05), optax.cosine_decay_schedule(
            LR, steps, alpha=0.05)
        for count in (0, 1, 2, steps // 2, steps - 1, steps, steps + 5):
            assert abs(ours(count) - float(ref(count))) <= 1e-9


def test_digits_conversion_round_trips_exactly():
    params = jax_ocr_conv.load_params()
    back = to_jax_digits(from_jax_digits(params))
    assert _leaves(back).keys() == _leaves(params).keys()
    for key, value in _leaves(params).items():
        assert _leaves(back)[key].dtype == np.float32
        assert np.array_equal(_leaves(back)[key], value), key
    with pytest.raises(KeyError):
        to_jax_digits({**from_jax_digits(params), "extra.weight": torch.zeros(1)})


def _eval_crops(fonts, n_per_digit, seed):
    """tests/test_ocr_conv.py's styled eval crops (one component each)."""
    rng = np.random.default_rng(seed)
    crops, labels = [], []
    for d in range(10):
        made = 0
        while made < n_per_digit:
            crop = ocr_conv.render_hud_text(
                str(d), fonts[int(rng.integers(0, len(fonts)))],
                height=int(rng.integers(32, 60)), outline=int(rng.integers(1, 4)),
                shadow=int(rng.integers(1, 4)), rotation=float(rng.uniform(-8, 8)),
                damage=float(rng.uniform(0, 1)), noise=int(rng.integers(5, 22)),
                seed=int(rng.integers(0, 2**31)))
            if len(ocr.segment_digit_components(crop)[0]) != 1:
                continue
            crops.append(crop)
            labels.append(d)
            made += 1
    return crops, labels


@pytest.fixture(scope="module")
def trained():
    """tests/test_ocr_conv.py::test_training_smoke's run, by the port."""
    return ocr_conv.train(steps=25, batch=48, log_every=25, seed=3, device="cpu")


def test_training_smoke(trained):
    """A fresh 25-step run beats 0.4 on the training fonts (chance 0.1), as
    the JAX package's own smoke test asks of its train()."""
    params, history = trained
    assert [sorted(h) for h in history] == [["acc", "loss", "step"]]
    assert history[0]["step"] == 25 and np.isfinite(history[0]["loss"])
    reader = ocr_conv.ConvDigitOCR(params=params, device="cpu")
    crops, labels = _eval_crops(ocr_conv.train_fonts(), 2, 9)
    hits = sum(reader(crop)[1][1] == str(label) for crop, label in zip(crops, labels))
    assert hits / len(labels) > 0.4


def test_save_params_is_read_by_jax(trained, tmp_path):
    """The port's file has the committed file's keys; the JAX load_params
    reads it, and the JAX reader on it gives the port's readings."""
    params, _ = trained
    path = str(tmp_path / "assets" / "ocr_digits.npz")
    ocr_conv.save_params(params, path)
    with np.load(path) as ours, np.load(jax_ocr_conv.WEIGHTS_PATH) as committed:
        assert sorted(ours.files) == sorted(committed.files)
    loaded = jax_ocr_conv.load_params(path)
    for key, value in _leaves(params).items():
        assert np.array_equal(_leaves(loaded)[key], value)
    ref_reader = jax_ocr_conv.ConvDigitOCR(params=loaded)
    reader = ocr_conv.ConvDigitOCR(params=ocr_conv.load_params(path), device="cpu")
    crops, _ = _eval_crops(ocr_conv.heldout_fonts(), 1, 21)
    for crop in crops:
        ok, (value, raw, conf, details) = reader(crop)
        ok_ref, (value_ref, raw_ref, conf_ref, details_ref) = ref_reader(crop)
        assert (ok, value, raw, details) == (ok_ref, value_ref, raw_ref, details_ref)
        assert abs(conf - conf_ref) <= 1e-5


def test_train_defaults_to_cuda(monkeypatch):
    """device=None is the card: without one, train() raises before it renders."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(ocr_conv, "synth_batch", None)  # not reached
    with pytest.raises(RuntimeError, match="CUDA"):
        ocr_conv.train(steps=1, batch=4)


def test_main_writes_the_trained_params(tmp_path, monkeypatch):
    """main() trains for OCR_STEPS and saves to the weights path (a
    temporary one here: the committed asset is not written)."""
    seen = {}

    def fake_train(steps):
        seen["steps"] = steps
        return {"params": {}}, []

    monkeypatch.setenv("OCR_STEPS", "7")
    monkeypatch.setattr(ocr_conv, "WEIGHTS_PATH", str(tmp_path / "w.npz"))
    monkeypatch.setattr(ocr_conv, "train", fake_train)
    monkeypatch.setattr(ocr_conv, "save_params", lambda p: seen.setdefault("saved", p))
    ocr_conv.main()
    assert seen == {"steps": 7, "saved": {"params": {}}}


def test_fixture_batches_rerender_bit_for_bit():
    """The committed fixture of phase 14 (tools/torch_port_ocr_fixture.py):
    its provenance, and its first batch is synth_batch's first draw."""
    path = os.path.join(os.path.dirname(ocr_conv.WEIGHTS_PATH), "ocr_synth_batches.npz")
    with np.load(path) as z:
        x, y, prov = z["x"], z["y"], json.loads(str(z["provenance"]))
    assert x.shape == (8, 128, 48, 48, 1) and x.dtype == np.float32
    assert y.shape == (8, 128) and y.dtype == np.int32
    fonts = ocr_conv.train_fonts()
    assert prov["fonts"] == [os.path.basename(f) for f in fonts] and prov["seed"] == 0
    first_x, first_y = ocr_conv.synth_batch(np.random.default_rng(prov["seed"]), fonts, 128)
    assert np.array_equal(first_x, x[0]) and np.array_equal(first_y, y[0])


# ---- the template reader (tests/test_infer.py's crops) ----


def _text_crop(text):
    from PIL import Image, ImageDraw, ImageFont

    img = Image.new("RGB", (200, 64), (0, 0, 0))
    ImageDraw.Draw(img).text((10, 5), text, font=ImageFont.truetype(TEXT_FONT_PATH, 40),
                             fill=(255, 255, 255))
    return np.array(img)[:, :, ::-1].copy()


def _fragmented_143():
    bgr = _text_crop("143")
    h = bgr.shape[0]
    bgr[h // 2:h // 2 + 2, :] = 0
    return bgr


TEMPLATE_CROPS = {
    "42": lambda: _text_crop("42"),
    "117": lambda: _text_crop("117"),
    "0": lambda: _text_crop("0"),
    "empty": lambda: np.zeros((60, 130, 3), np.uint8),
    "fragmented_143": _fragmented_143,
    "styled_87.5": lambda: ocr_conv.render_hud_text("87.5", ocr_conv.train_fonts()[0], seed=2),
}


def test_digit_templates_match_jax():
    ours, ref = ocr.render_digit_templates(), jax_ocr.render_digit_templates()
    assert sorted(ours) == sorted(ref) == list("0123456789")
    assert all(np.array_equal(ours[d], ref[d]) for d in ref)


@pytest.mark.parametrize("name", sorted(TEMPLATE_CROPS))
def test_template_reader_matches_jax(name):
    crop = TEMPLATE_CROPS[name]()
    ok, (value, raw, conf, details) = ocr.TemplateDigitOCR()(crop)
    ok_ref, (value_ref, raw_ref, conf_ref, details_ref) = jax_ocr.TemplateDigitOCR()(crop)
    assert (ok, value, raw, details) == (ok_ref, value_ref, raw_ref, details_ref)
    assert abs(conf - conf_ref) <= 1e-6
    assert ocr.damage_crop_to_percent(crop, ocr.TemplateDigitOCR()) == \
        (ok, (value, raw, conf, details))
    if name in ("42", "117", "0", "fragmented_143"):
        assert ok and value == float(name.split("_")[-1])


# ---- the default reader: only a missing weights file falls back ----


def _weights_at(monkeypatch, module, path):
    """``module.ConvDigitOCR()`` reads its weights from ``path``."""
    monkeypatch.setattr(module, "load_params", functools.partial(module.load_params, path))


def test_default_reader_is_the_conv_reader():
    assert isinstance(ocr.default_reader(device="cpu"), ocr_conv.ConvDigitOCR)


def test_default_reader_falls_back_on_missing_weights_only(tmp_path, monkeypatch):
    _weights_at(monkeypatch, ocr_conv, str(tmp_path / "missing.npz"))
    assert isinstance(ocr.default_reader(device="cpu"), ocr.TemplateDigitOCR)


def test_default_reader_raises_on_broken_weights(tmp_path, monkeypatch):
    """The JAX reader warns and falls back here; the port raises."""
    broken = tmp_path / "broken.npz"
    broken.write_bytes(b"not an npz")
    _weights_at(monkeypatch, ocr_conv, str(broken))
    with pytest.raises(Exception) as err:
        ocr.default_reader(device="cpu")
    assert not isinstance(err.value, FileNotFoundError)
    _weights_at(monkeypatch, jax_ocr_conv, str(broken))
    assert isinstance(jax_ocr.default_reader(), jax_ocr.TemplateDigitOCR)  # the difference


def test_default_reader_without_cuda_raises(tmp_path, monkeypatch):
    """device=None is the card: without one the default reader raises, even
    with no weights file, and no reader runs on the CPU in its place."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ocr.default_reader()
    _weights_at(monkeypatch, ocr_conv, str(tmp_path / "missing.npz"))
    with pytest.raises(RuntimeError, match="CUDA"):
        ocr.default_reader()
