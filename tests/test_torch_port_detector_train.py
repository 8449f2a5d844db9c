"""The port's detector-training path against the JAX package's, on the CPU:
CenterNet targets and losses, ``DetectionDataset`` (jpg trees and their
``.npy`` twins), one train step (loss, gradients, batch statistics, AdamW),
``fit``, ``evaluate``, ``detect`` after training, the synthetic composite
generator and the command line.

Sizes: 64x96 input (from 180x320 sources), 2 classes, batch 2 (the
trunk's stride-32 map is 2x3).  Inputs are made from seeds with numpy; weights are the JAX
trainer's seeded init, perturbed where a step is compared, carried across
by ``convert.from_jax_detector`` (gradients too: the converter is linear).

Tolerances: targets bit-identical; losses 1e-6 relative in float64 (1e-5
in float32, the summation error of the JAX package's own float32); one step's loss
and parts 1e-5 relative, gradients 1e-4 of max|g| per tensor, updated batch
statistics 1e-5 of max; AdamW from the JAX gradients 1e-6 abs (parameters)
and 1e-6 of max (moments); ``fit``'s logged losses 1e-4 relative.
"""

import ast
import json
import os
import shutil

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from playaid_core_tpu.datagen import gen_synth_char_detection as jax_gen  # noqa: E402
from playaid_core_tpu.models import detector as jax_detector  # noqa: E402
from playaid_core_tpu.train import detector_train as jax_train  # noqa: E402
from playaid_core_torch.convert import from_jax_detector  # noqa: E402
from playaid_core_torch.datagen import gen_synth_char_detection as port_gen  # noqa: E402
from playaid_core_torch.models import detector  # noqa: E402
from playaid_core_torch.models.resnet import BasicBlock, BatchNorm2d  # noqa: E402
from playaid_core_torch.train.detector_train import (  # noqa: E402
    DetectionDataset,
    DetectorTrainer,
    main,
)
from tests.test_datagen import sprite_assets  # noqa: E402,F401 (fixture)
from tests.test_torch_port_families import _numpy_tree, _perturbed  # noqa: E402
from tests.test_torch_port_train import max_rel  # noqa: E402

torch.set_num_threads(2)

HW = (64, 96)
SRC_HW = (180, 320)
NUM_CLASSES = 2
BATCH = 2


def _write_tree(root, n, seed=0, hw=SRC_HW):
    """A YOLO tree of ``n`` jpgs: noise with 1-3 bright discs, labels with
    boxes at the edges and classes out of range among them."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "labels"))
    h, w = hw
    for i in range(n):
        img = rng.integers(0, 60, (h, w, 3), dtype=np.uint8)
        lines = []
        for k in range(int(rng.integers(1, 4))):
            cx, cy = rng.uniform(0.0, 1.0, 2)
            if k == 1:
                cx = float(rng.choice([0.0, 0.995, 0.5]))
            bw, bh = rng.uniform(0.05, 0.3, 2)
            cls = int(rng.integers(0, NUM_CLASSES + 1))  # NUM_CLASSES is invalid
            color = (250, 80, 80) if cls == 0 else (80, 250, 80)
            cv2.circle(img, (int(cx * w), int(cy * h)), int(bh * h / 2), color, -1)
            lines.append(f"{cls} {cx} {cy} {bw} {bh}\n")
        cv2.imwrite(os.path.join(root, "images", f"{i}.jpg"), img)
        with open(os.path.join(root, "labels", f"{i}.txt"), "w") as f:
            f.writelines(lines)
    return root


@pytest.fixture(scope="module")
def jpg_tree(tmp_path_factory):
    return _write_tree(str(tmp_path_factory.mktemp("det") / "train"), 10)


@pytest.fixture(scope="module")
def npy_tree(jpg_tree, tmp_path_factory):
    """The jpg tree with each image decoded by cv2.imread into a .npy."""
    root = str(tmp_path_factory.mktemp("det_npy") / "train")
    shutil.copytree(os.path.join(jpg_tree, "labels"), os.path.join(root, "labels"))
    os.makedirs(os.path.join(root, "images"))
    for name in os.listdir(os.path.join(jpg_tree, "images")):
        img = cv2.imread(os.path.join(jpg_tree, "images", name))
        np.save(os.path.join(root, "images", name[:-4] + ".npy"), img)
    return root


def _datasets(jax_root, port_root, seed, augment):
    kw = dict(input_hw=HW, num_classes=NUM_CLASSES, max_boxes=4, seed=seed,
              sample_augment=augment)
    return jax_train.DetectionDataset(jax_root, **kw), DetectionDataset(port_root, **kw)


def _targets(batch):
    """A batch of ``batches()`` as the port's step takes it."""
    images, targets = batch
    return torch.from_numpy(images), tuple(torch.from_numpy(t) for t in targets)


# ---- targets and losses ----


def test_gaussian_radius_and_build_targets_are_bit_identical():
    """About 200 images of 0-8 boxes on grids of several sizes: invalid
    boxes, boxes at the edges, centres off the grid, tiny and huge boxes."""
    rng = np.random.default_rng(0)
    for h, w in rng.uniform(0.05, 80.0, (100, 2)):
        assert detector.gaussian_radius(h, w) == jax_detector.gaussian_radius(h, w)
    for i in range(200):
        out_h, out_w = [(16, 24), (32, 48), (64, 112), (7, 9)][i % 4]
        m = int(rng.integers(0, 9))
        boxes = rng.uniform(-0.2, 1.2, (m, 4)).astype(np.float32)
        boxes[:, 2:] = rng.uniform(0.0, 1.5, (m, 2))
        if m:
            boxes[0, :2] = rng.choice([0.0, 0.999, 1.0], 2)
        classes = rng.integers(0, 3, m).astype(np.int32)
        valid = rng.random(m) < 0.8
        ref = jax_detector.build_targets(boxes, classes, valid, out_h, out_w, 3)
        out = detector.build_targets(boxes, classes, valid, out_h, out_w, 3)
        for a, b in zip(out, ref):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("num_boxes", [0, 1, 5])
def test_losses_match_jax(num_boxes):
    """Seeded logits and targets from build_targets, both sides in float64
    (1e-6 relative), and in float32 (1e-5: the focal loss sums about 6,000
    terms, and a float32 sum of them is good to a few 1e-6)."""
    rng = np.random.default_rng(num_boxes)
    targets = []
    for _ in range(BATCH):
        boxes = rng.uniform(0.1, 0.9, (max(num_boxes, 1), 4)).astype(np.float32)
        boxes[:, 2:] *= 0.3
        valid = np.arange(len(boxes)) < num_boxes
        classes = rng.integers(0, 3, len(boxes)).astype(np.int32)
        targets.append(detector.build_targets(boxes, classes, valid, 24, 40, 3))
    targets = tuple(np.stack(t) for t in zip(*targets))
    outputs = {"heatmap": rng.normal(-2.0, 3.0, (BATCH, 24, 40, 3)).astype(np.float32),
               "size": rng.normal(5.0, 3.0, (BATCH, 24, 40, 2)).astype(np.float32),
               "offset": rng.uniform(0, 1, (BATCH, 24, 40, 2)).astype(np.float32)}
    for dtype, tol in ((np.float64, 1e-6), (np.float32, 1e-5)):
        with jax.enable_x64(dtype == np.float64):
            ref_total, ref_parts = jax_detector.detector_loss(
                {k: jnp.asarray(v.astype(dtype)) for k, v in outputs.items()},
                tuple(jnp.asarray(t.astype(dtype)) for t in targets))
            ref = [float(ref_total)] + [float(ref_parts[k]) for k in ("heatmap", "size", "offset")]
        total, parts = detector.detector_loss(
            {k: torch.from_numpy(v.astype(dtype)) for k, v in outputs.items()},
            tuple(torch.from_numpy(t.astype(dtype)) for t in targets))
        assert total.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
        out = [float(total)] + [float(parts[k]) for k in ("heatmap", "size", "offset")]
        for a, b in zip(out, ref):
            assert abs(a - b) <= tol * abs(b), (dtype, out, ref)
    if num_boxes == 0:  # no centres: the regression losses are 0 over max(0, 1)
        assert float(parts["size"]) == float(parts["offset"]) == 0.0


# ---- the dataset ----


@pytest.mark.parametrize("augment", [False, True])
def test_dataset_matches_jax(jpg_tree, augment):
    """32 draws of one seed, through sample (uint8 and float32) and
    batches: images, targets and (boxes, classes, valid) bit-identical."""
    ref, port = _datasets(jpg_tree, jpg_tree, 3, augment)
    for i in range(16):
        uint8 = bool(i % 2)
        a, b = port.sample(uint8=uint8), ref.sample(uint8=uint8)
        assert a[0].dtype == b[0].dtype and a[0].shape == (*HW, 3)
        assert np.array_equal(a[0], b[0])
        for x, y in zip(a[1] + a[2], b[1] + b[2]):
            assert np.array_equal(x, y)
    for (a_img, a_t), (b_img, b_t) in zip(port.batches(4, 4), ref.batches(4, 4)):
        assert a_img.dtype == np.uint8 and np.array_equal(a_img, b_img)
        assert all(np.array_equal(x, y) for x, y in zip(a_t, b_t))


@pytest.mark.parametrize("augment", [False, True])
def test_npy_tree_matches_jax_on_jpg(jpg_tree, npy_tree, augment):
    ref, port = _datasets(jpg_tree, npy_tree, 5, augment)
    assert [os.path.basename(p)[:-4] for p in port.images] == \
        [os.path.basename(p)[:-4] for p in ref.images]
    for (a_img, a_t), (b_img, b_t) in zip(port.batches(4, 4), ref.batches(4, 4)):
        assert np.array_equal(a_img, b_img)
        assert all(np.array_equal(x, y) for x, y in zip(a_t, b_t))


# ---- one train step, fit, evaluate ----


class _JittedInit(jax_detector.CenterNetDetector):
    """The JAX detector with its init compiled as one program (about half
    the time of Flax's op-by-op init here); nothing else differs."""

    def init(self, *args, **kwargs):
        return jax.jit(super().init)(*args, **kwargs)


@pytest.fixture(scope="module")
def jax_trainer(jpg_tree):
    """The JAX trainer at the test size, from its seeded init, and its
    train step with the model in float64 (``train_step64``, for use under
    ``jax.enable_x64``)."""
    ds = jax_train.DetectionDataset(jpg_tree, input_hw=HW, num_classes=NUM_CLASSES, seed=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_train, "CenterNetDetector", _JittedInit)
        trainer = jax_train.DetectorTrainer(ds, num_classes=NUM_CLASSES, input_hw=HW)
    trainer.init_state = trainer.state
    trainer.train_step32 = trainer.train_step
    trainer.train_step64 = jax_train.make_detector_train_step(
        jax_detector.CenterNetDetector(num_classes=NUM_CLASSES, dtype=jnp.float64))
    return trainer


def _variables(state):
    """A JAX state's weights as plain dicts of numpy arrays (one tree
    structure for every state built from them, so each step compiles once)."""
    def plain(node):
        return {k: plain(v) for k, v in node.items()} if hasattr(node, "items") else node

    return {"params": plain(_numpy_tree(state.params)),
            "batch_stats": plain(_numpy_tree(state.batch_stats))}


def _jax_state(trainer, variables, dtype):
    """The JAX trainer's state holding ``variables`` in ``dtype``, AdamW's
    moments at zero; call under ``jax.enable_x64`` for float64."""
    params, stats = (jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), variables[k])
                     for k in ("params", "batch_stats"))
    state = trainer.init_state
    # The step as an int32 array, as every step returns it: a Python int
    # would compile the step a second time.
    return state.replace(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                         opt_state=state.tx.init(params))


@pytest.fixture(scope="module")
def step_case(jax_trainer, jpg_tree):
    """One JAX step from a perturbed init on one batch, in float32 and with
    the model, weights and optimiser in float64.  The gradients are read
    back from AdamW's first moment (``mu = 0.1 g``)."""
    init = _perturbed(_variables(jax_trainer.init_state), 1)
    batch = next(DetectionDataset(jpg_tree, input_hw=HW, num_classes=NUM_CLASSES,
                                  seed=7).batches(BATCH, 1))
    stats = init["batch_stats"]
    case = {"init": init, "batch": batch}
    for dtype, step, suffix in ((jnp.float32, jax_trainer.train_step32, ""),
                                (jnp.float64, jax_trainer.train_step64, "64")):
        with jax.enable_x64(dtype == jnp.float64):
            new, loss, parts = step(_jax_state(jax_trainer, init, dtype), jnp.asarray(batch[0]),
                                    tuple(jnp.asarray(t) for t in batch[1]))
            adam = new.opt_state[0]
            tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
            case.update({
                "loss" + suffix: float(loss),
                "parts" + suffix: {k: float(v) for k, v in parts.items()},
                "new" + suffix: from_jax_detector({"params": tree(new.params),
                                                   "batch_stats": tree(new.batch_stats)}),
                "grads" + suffix: from_jax_detector({"params": jax.tree_util.tree_map(
                    lambda m: np.asarray(m) / np.asarray(0.1, m.dtype), adam.mu),
                    "batch_stats": stats}),
                "mu" + suffix: from_jax_detector({"params": tree(adam.mu), "batch_stats": stats}),
                "nu" + suffix: from_jax_detector({"params": tree(adam.nu), "batch_stats": stats}),
            })
    return case


def _port_trainer(variables=None, dataset=None):
    trainer = DetectorTrainer(dataset, num_classes=NUM_CLASSES, input_hw=HW, device="cpu")
    return trainer if variables is None else trainer.load_variables(variables)


@pytest.fixture(scope="module")
def port_stepped(step_case):
    trainer = _port_trainer(step_case["init"])
    loss, parts = trainer.train_step(*_targets(step_case["batch"]))
    return trainer, float(loss), {k: float(v) for k, v in parts.items()}


def test_train_step_loss_matches_jax(step_case, port_stepped):
    _, loss, parts = port_stepped
    assert abs(loss - step_case["loss"]) <= 1e-5 * abs(step_case["loss"])
    assert parts.keys() == step_case["parts"].keys()
    for k, v in parts.items():
        assert abs(v - step_case["parts"][k]) <= 1e-5 * abs(step_case["parts"][k]), k


# A bias right before a batch norm in training mode has no gradient: the
# batch mean takes it out.  Both sides give rounding noise there.
PRE_NORM_BIASES = ("up.0.bias", "up.3.bias", "up.6.bias")


def _check_gradients(params, ref):
    assert params.keys() == {k for k in ref if not k.endswith(("running_mean", "running_var",
                                                                 "num_batches_tracked"))}
    errs = {k: max_rel(p.grad.numpy(), ref[k].numpy()) for k, p in params.items()
            if k not in PRE_NORM_BIASES}
    bad = {k: v for k, v in errs.items() if v > 1e-4}
    assert not bad, bad
    for k in PRE_NORM_BIASES:
        scale = float(ref[k.replace("bias", "weight")].abs().max())
        assert float(params[k].grad.abs().max()) <= 1e-5 * scale, k
        assert float(ref[k].abs().max()) <= 1e-5 * scale, k


def test_train_step_gradients_match_jax(step_case, port_stepped):
    """Float32 on both sides."""
    _check_gradients(dict(port_stepped[0].model.named_parameters()), step_case["grads"])


def test_train_step_matches_jax_in_float64(step_case):
    """The same step with both sides in float64 (the JAX model with dtype
    float64 under ``jax.enable_x64``, its heads still cast to float32; the
    port's model in ``.double()``): loss, gradients and statistics.  At a
    128x192 input this step's float32 gradients are ill-conditioned on the
    JAX side (up to 1.7e-2 of max|g| off its float64; ROADMAP queue 3
    entry 5), so float64 is the check that holds at any size."""
    trainer = _port_trainer(step_case["init"])
    trainer.model.double()
    images, targets = _targets(step_case["batch"])
    loss, _ = trainer.train_step(images, tuple(t.double() for t in targets))
    assert abs(float(loss) - step_case["loss64"]) <= 1e-5 * abs(step_case["loss64"])
    _check_gradients(dict(trainer.model.named_parameters()), step_case["grads64"])
    state = trainer.model.state_dict()
    for k, v in step_case["new64"].items():
        if k.endswith(("running_mean", "running_var")):
            assert max_rel(state[k].numpy(), v.numpy()) <= 1e-5, k


def test_adamw_from_jax_gradients_matches_optax(step_case):
    """The JAX gradients in ``.grad``, one fused AdamW step: the parameters
    (with optax's decoupled decay on every one) and the moments."""
    trainer = _port_trainer(step_case["init"])
    params = dict(trainer.model.named_parameters())
    for name, p in params.items():
        p.grad = step_case["grads"][name].clone()
    trainer.optimizer.step()
    for name, p in params.items():
        assert float((p.detach() - step_case["new"][name]).abs().max()) <= 1e-6, name
        moments = trainer.optimizer.state[p]
        assert max_rel(moments["exp_avg"].numpy(), step_case["mu"][name].numpy()) <= 1e-6, name
        assert max_rel(moments["exp_avg_sq"].numpy(), step_case["nu"][name].numpy()) <= 1e-6, name


def test_fit_matches_jax(jax_trainer, jpg_tree, tmp_path):
    """Three steps with log_every=1 from the JAX init on one seed's batches:
    the same record keys, the losses within 1e-4, the JSONL beside them.
    Both run in float64 (the model, the weights and AdamW; the targets stay
    float32): from the JAX init, two float32 runs drift apart beyond 1e-4
    within three AdamW updates (see the float64 step test)."""
    with jax.enable_x64(True):
        jax_trainer.state = _jax_state(jax_trainer, _variables(jax_trainer.init_state),
                                       jnp.float64)
        jax_trainer.train_step = jax_trainer.train_step64
        jax_trainer.metrics_log = []
        jax_trainer.dataset = jax_train.DetectionDataset(jpg_tree, input_hw=HW,
                                                         num_classes=NUM_CLASSES, seed=11)
        jax_trainer.fit(3, batch_size=BATCH, log_every=1)
    jax_trainer.train_step = jax_trainer.train_step32
    port = _port_trainer(_variables(jax_trainer.init_state), DetectionDataset(
        jpg_tree, input_hw=HW, num_classes=NUM_CLASSES, seed=11))
    port.model.double()
    log_path = str(tmp_path / "det.jsonl")
    port.fit(3, batch_size=BATCH, log_every=1, log_path=log_path)
    assert port.model.training
    assert len(port.metrics_log) == len(jax_trainer.metrics_log) == 3
    for a, b in zip(port.metrics_log, jax_trainer.metrics_log):
        assert list(a) == list(b) == ["step", "loss", "heatmap", "offset", "size", "seconds"]
        assert a["step"] == b["step"]
        for k in ("loss", "heatmap", "size", "offset"):
            assert abs(a[k] - b[k]) <= 1e-4 * abs(b[k]), (a, b)
    with open(log_path) as f:
        assert [json.loads(line) for line in f] == port.metrics_log


def test_evaluate_matches_jax(jax_trainer, jpg_tree, step_case):
    """Carried weights (the perturbed init with its prior restored), one
    seed's draws: the same dict."""
    init = {"params": dict(step_case["init"]["params"]),
            "batch_stats": step_case["init"]["batch_stats"]}
    init["params"]["heatmap_out"] = dict(init["params"]["heatmap_out"],
                                         bias=np.full((NUM_CLASSES,), -2.19, np.float32))
    jax_trainer.state = _jax_state(jax_trainer, init, jnp.float32)
    kw = dict(input_hw=HW, num_classes=NUM_CLASSES, seed=2)
    ref = jax_trainer.evaluate(jax_train.DetectionDataset(jpg_tree, **kw), num_images=8)
    out = _port_trainer(init).evaluate(DetectionDataset(jpg_tree, **kw), num_images=8)
    assert out == ref and ref["boxes"] > 0


def test_detect_after_fit_equals_the_fitted_state_loaded_fresh(jpg_tree):
    """Fused AdamW does not bump versions by itself: the trainer's hook
    makes layer4[1]'s kernel pack follow the weights, so detect after fit
    and its pack equal those of a fresh trainer loaded with the fitted
    state dict."""
    trainer = _port_trainer(dataset=DetectionDataset(jpg_tree, input_hw=HW,
                                                     num_classes=NUM_CLASSES, seed=4)).init(0)
    images = np.stack([DetectionDataset(jpg_tree, input_hw=HW, num_classes=NUM_CLASSES,
                                        seed=9).sample(uint8=True)[0] for _ in range(3)])
    block = trainer.model.trunk.layer4[1]
    trainer.model.eval()
    before = block.block_pack(torch.float32)
    trainer.fit(2, batch_size=BATCH, log_every=1)
    dets = trainer.detect(images, score_threshold=0.0)
    assert not trainer.model.training
    fresh = _port_trainer(trainer.model.state_dict())
    assert dets == fresh.detect(images, score_threshold=0.0)
    after = block.block_pack(torch.float32)
    ref = fresh.model.trunk.layer4[1].block_pack(torch.float32)
    assert not torch.equal(after.w1, before.w1)
    for name in ("w1", "s1", "b1", "w2", "s2", "b2"):
        assert torch.equal(getattr(after, name), getattr(ref, name)), name


def test_detect_builds_resize_tables_once_per_size():
    trainer = _port_trainer().init(0)
    frames = np.random.default_rng(0).integers(0, 256, (2, 90, 160, 3), dtype=np.uint8)
    first = trainer.detect(frames, score_threshold=0.0, classes=(1,))
    tables = trainer._resize_tables[(90, 160)]
    assert trainer.detect(frames, score_threshold=0.0, classes=(1,)) == first
    assert trainer._resize_tables[(90, 160)] is tables and len(trainer._resize_tables) == 1
    trainer.detect(frames[:, :80], score_threshold=0.0)
    assert set(trainer._resize_tables) == {(90, 160), (80, 160)}
    assert all(c == 1 for dets in first for c, _, _ in dets)


def test_init_draws_as_flax():
    """Seeded; lecun_normal with Flax's fan in, in * 16 for the transpose
    convs; Flax's batch norm in the upsampling stages; the heatmap prior."""
    trainer = _port_trainer().init(1)
    other = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    a = trainer.init(0).model
    sa, sb = a.state_dict(), _port_trainer().init(0).model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["up.0.weight"], other["up.0.weight"])
    for i in range(3):
        up, bn = a.up[3 * i], a.up[3 * i + 1]
        assert isinstance(up, torch.nn.ConvTranspose2d) and type(bn) is BatchNorm2d
        w = up.weight.detach()
        std = (1.0 / (w.shape[0] * 16)) ** 0.5
        assert float(w.abs().max()) <= 2.0 * std / 0.87962566103423978 * (1 + 1e-6)
        assert abs(float(w.std()) / std - 1.0) < 0.02, i
        assert not up.bias.any() and torch.all(bn.weight == 1.0)
    assert torch.all(a.heads["heatmap"][2].bias == -2.19)
    assert not a.heads["size"][2].bias.any()
    assert all(not m.bn2.weight.any() for m in a.modules() if isinstance(m, BasicBlock))


# ---- the synthetic composite generator ----


def test_gen_synth_char_detection_matches_jax(sprite_assets, tmp_path):
    stages, clean = sprite_assets
    kw = dict(seed=3, stages_dir=str(stages), clean_char_dir=str(clean), augment=True,
              identity_safe=True, degrade=0.5, hud_distractors=0.5)
    assert jax_gen.generate_stage_char_compositions(
        "train", 4, output_root=str(tmp_path / "jax"), **kw) == 4
    assert port_gen.generate_stage_char_compositions(
        "train", 4, output_root=str(tmp_path / "port"), **kw) == 4
    for i in range(4):
        a = cv2.imread(str(tmp_path / "port" / "train" / "images" / f"comp-{i}.jpg"))
        b = cv2.imread(str(tmp_path / "jax" / "train" / "images" / f"comp-{i}.jpg"))
        assert a.shape == (720, 1280, 3) and np.array_equal(a, b)
        labels = [(tmp_path / pkg / "train" / "labels" / f"comp-{i}.txt").read_text()
                  for pkg in ("port", "jax")]
        assert labels[0] == labels[1] and labels[0]


# ---- the command line and the device ----


def test_command_line_on_the_cpu(npy_tree, capsys):
    """The JAX command line's options and defaults (a 256x448 input), one
    step of batch 1 on the .npy tree, the last record printed."""
    assert main(["--data-root", npy_tree, "--num-steps", "1", "--batch-size", "1",
                 "--num-classes", "2", "--device", "cpu"]) == 0
    record = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["step"] == 0 and np.isfinite(record["loss"])


def test_trainer_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        DetectorTrainer()
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--data-root", "unused", "--num-steps", "1"])
