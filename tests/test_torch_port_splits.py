"""The port's image ops, augmentation and sprite splits against OpenCV, PIL
and the JAX package.

``imgproc``'s new ops are held against cv2 and PIL on every input value
where the domain allows (the HSV conversions both ways, Pillow's RGBA
blend) and on seeded images otherwise (box blur, nearest resize, crop,
paste, the premultiplied RGBA pad).  Then what is built on them, against
the JAX package with the same seeds: the augment pipelines at difficulty
1 and 2, the ``synth`` split over consecutive and middle-out windows,
difficulty 0-2, sprite fill and jitter, re-drawn and moving backgrounds
and the JPEG degrade (the port's uint8 frames / 255 are the JAX float32
frames exactly; labels, fighter ids and meta identical), the same split
over the ``.npy`` twin of the tree, the ``simple`` and ``manual`` splits
(tests/test_dataset_modes.py's assets) and ``gen_synth_video_actions``
(tests/test_datagen.py's case).  Last, what runs with cv2 and PIL
blocked, and what names them.
"""

import os
import sys

import cv2
import numpy as np
import pytest
from PIL import Image, ImageOps

from playaid_core_torch import imgproc
from playaid_core_torch.datagen import gen_synth_video_actions as gsva
from playaid_core_torch.train import augment
from playaid_core_torch.train.dataset import UltActionRecogDataset
from playaid_core_tpu.datagen import gen_synth_video_actions as jax_gsva
from playaid_core_tpu.datagen import skeletal_sprites as jax_sk
from playaid_core_tpu.train import augment as jax_augment
from playaid_core_tpu.train.dataset import UltActionRecogDataset as JaxDataset


def _every_triple(first=256):
    """Every (a, b, c) with a < first, b and c < 256, as rows of 256."""
    grid = np.meshgrid(np.arange(first), np.arange(256), np.arange(256), indexing="ij")
    return np.stack(grid, -1).astype(np.uint8).reshape(-1, 3)


# ---------------------------------------------------------------------------
# imgproc


@pytest.mark.parametrize("bgr", [False, True])
def test_rgb_to_hsv_every_value(bgr):
    img = _every_triple().reshape(4096, 4096, 3)
    code = cv2.COLOR_BGR2HSV if bgr else cv2.COLOR_RGB2HSV
    assert np.array_equal(imgproc.rgb_to_hsv(img, bgr=bgr), cv2.cvtColor(img, code))


@pytest.mark.parametrize("width,bgr", [(4096, False), (33, True), (1, False)])
def test_hsv_to_rgb_every_value(width, bgr):
    """Every H < 180, S, V: rows of 4096 (OpenCV's vector loop), 33 (one
    pixel in its scalar tail) and 1 (all in it)."""
    hsv = _every_triple(180)
    hsv = hsv[: len(hsv) // width * width].reshape(-1, width, 3)
    code = cv2.COLOR_HSV2BGR if bgr else cv2.COLOR_HSV2RGB
    out, ref = imgproc.hsv_to_rgb(hsv, bgr=bgr), cv2.cvtColor(hsv, code)
    assert np.array_equal(out, ref), (
        f"{int((out != ref).any(-1).sum())} pixels differ from OpenCV {cv2.__version__} "
        f"({cv2.getCPUFeaturesLine()}); the likely cause is a cv2 that converts in another "
        "vector width than its AVX2 code's 32-pixel block, which imgproc.hsv_to_rgb follows")


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_blur_matches_cv2(k):
    rng = np.random.default_rng(k)
    for shape in ((37, 41, 3), (128, 128, 3), (5, 3, 3), (2, 2, 3), (1, 6, 3), (7, 9)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        assert np.array_equal(imgproc.blur(img, (k, k)), cv2.blur(img, (k, k))), shape
    # Every window sum of a constant image.
    for v in range(256):
        img = np.full((k + 2, k + 2, 3), v, np.uint8)
        img[0, 0] = 255 - v
        assert np.array_equal(imgproc.blur(img, (k, k)), cv2.blur(img, (k, k))), v


def test_resize_nearest_matches_cv2():
    rng = np.random.default_rng(3)
    for sw, sh in ((128, 128), (100, 91), (37, 3), (1, 5), (120, 7)):
        img = rng.integers(0, 256, (sh, sw, 3), dtype=np.uint8)
        for dw, dh in ((128, 128), (91, 100), (64, 97), (7, 3), (1, 1), (300, 11)):
            assert np.array_equal(imgproc.resize_nearest(img, (dw, dh)),
                                  cv2.resize(img, (dw, dh), interpolation=cv2.INTER_NEAREST))
            assert np.array_equal(imgproc.resize_nearest(img[..., 0], (dw, dh)),
                                  cv2.resize(img[..., 0], (dw, dh),
                                             interpolation=cv2.INTER_NEAREST))


def test_crop_matches_pil():
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
    for _ in range(100):
        x0, y0 = (int(v) for v in rng.integers(-60, 60, 2))
        x1, y1 = x0 + int(rng.integers(1, 90)), y0 + int(rng.integers(1, 90))
        box = (x0, y0, x1, y1)
        assert np.array_equal(imgproc.crop(img, box), np.array(Image.fromarray(img).crop(box)))


def test_paste_every_blend_and_every_edge():
    """Every (destination, source, alpha) byte through Pillow's BLEND, then
    RGBA sprites pasted at boxes off every edge."""
    d = np.repeat(np.arange(256), 65536).reshape(4096, 4096).astype(np.uint8)
    s = np.tile(np.repeat(np.arange(256), 256), 256).reshape(4096, 4096).astype(np.uint8)
    a = np.tile(np.arange(256), 65536).reshape(4096, 4096).astype(np.uint8)
    dst = np.stack([d, s, 255 - d], -1)
    src = np.stack([s, d, 255 - s, a], -1)
    ref = Image.fromarray(dst)
    sprite = Image.fromarray(src, "RGBA")
    ref.paste(sprite, (0, 0), sprite)
    assert np.array_equal(imgproc.paste(dst.copy(), src, (0, 0)), np.array(ref))
    rng = np.random.default_rng(5)
    for _ in range(100):
        dst = rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
        src = rng.integers(0, 256, (int(rng.integers(1, 70)), int(rng.integers(1, 70)), 4),
                           dtype=np.uint8)
        box = tuple(int(v) for v in rng.integers(-70, 60, 2))
        ref = Image.fromarray(dst)
        sprite = Image.fromarray(src, "RGBA")
        ref.paste(sprite, box, sprite)
        assert np.array_equal(imgproc.paste(dst.copy(), src, box), np.array(ref)), box


def test_pad_rgba_matches_pil():
    """ImageOps.pad of RGBA: PIL resizes premultiplied by alpha."""
    rng = np.random.default_rng(6)
    for _ in range(60):
        h, w = (int(v) for v in rng.integers(1, 200, 2))
        img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        img[rng.random((h, w)) < 0.3, 3] = 0
        img[rng.random((h, w)) < 0.3, 3] = 255
        size = int(rng.integers(4, 160))
        ref = np.array(ImageOps.pad(Image.fromarray(img), (size, size), color=(0, 0, 0, 0)))
        assert np.array_equal(imgproc.pad(img, (size, size)), ref), (h, w, size)


# ---------------------------------------------------------------------------
# augment


def _sprite(seed):
    """A BGRA sprite with soft (partly transparent) edges."""
    rng = np.random.default_rng(seed)
    sprite = np.zeros((150, 96, 4), np.uint8)
    sprite[15:140, 10:85, :3] = rng.integers(30, 255, (125, 75, 3), dtype=np.uint8)
    sprite[15:140, 10:85, 3] = rng.integers(1, 256, (125, 75), dtype=np.uint8)
    sprite[40:120, 25:70, 3] = 255
    return sprite


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("level", [1, 2])
def test_augment_char_crop_matches_jax(level, seed):
    img = np.random.default_rng(seed).integers(0, 256, (96, 80, 3), dtype=np.uint8)
    kw = dict(output_size=128, **augment.SYNTH_DIFFICULTY_REAL[level])
    for draw in range(4):
        out = augment.augment_char_crop(img, rng=np.random.default_rng([seed, draw]), **kw)
        ref = jax_augment.augment_char_crop(img, rng=np.random.default_rng([seed, draw]), **kw)
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("identity_safe", [False, True])
@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("level", [1, 2])
def test_augment_synth_char_crop_matches_jax(level, seed, identity_safe):
    sprite = _sprite(seed)
    kw = dict(output_size=128, identity_safe=identity_safe,
              **augment.SYNTH_DIFFICULTY_SPRITE[level])
    for draw in range(4):
        out = augment.augment_synth_char_crop(sprite, rng=np.random.default_rng([seed, draw]),
                                              **kw)
        ref = jax_augment.augment_synth_char_crop(sprite,
                                                  rng=np.random.default_rng([seed, draw]), **kw)
        np.testing.assert_array_equal(out, ref)


# ---------------------------------------------------------------------------
# The sprite splits

ACTIONS = ["Jab", "Wait", "Shield", "Unknown"]
FIGHTERS = ["Byleth", "Pikachu"]


@pytest.fixture(scope="module")
def sprite_tree(tmp_path_factory):
    """A skeletal sprite tree (PNG, drawn by the JAX module with cv2) with
    moves outside ACTIONS ("Roll": the Unknown class), jpg stages (one
    smaller than the crop window), and the tree's .npy twin: sprites as
    cv2.imread(..., IMREAD_UNCHANGED) reads them, stages as PIL decodes
    them, in BGR."""
    root = tmp_path_factory.mktemp("sprite_splits")
    clean = root / "clean"
    jax_sk.generate_sprite_set(str(clean), fighters=FIGHTERS, moves=["Jab", "Wait", "Roll"],
                               frames_per_move=5, variant_seeds=(0,), seed=1)
    stages = root / "stages"
    stages.mkdir()
    rng = np.random.default_rng(0)
    cv2.imwrite(str(stages / "a.jpg"), rng.integers(0, 255, (200, 260, 3), dtype=np.uint8))
    cv2.imwrite(str(stages / "b.jpg"), rng.integers(0, 255, (80, 90, 3), dtype=np.uint8))
    twin = root / "npy"
    for d, _, files in os.walk(root):
        for f in files:
            src = os.path.join(d, f)
            dst = os.path.join(twin, os.path.relpath(src, root))[:-4] + ".npy"
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            if f.endswith(".png"):
                np.save(dst, cv2.imread(src, cv2.IMREAD_UNCHANGED))
            else:
                with Image.open(src) as im:
                    np.save(dst, np.array(im.convert("RGB"))[..., ::-1])
    return root, twin


def _splits(cls, root, split="synth", seed=0, **kw):
    none = str(root / "none")
    return cls(split=split, num_samples=8, img_dimension=96, anim_subset=ACTIONS,
               num_frames_per_sample=7, frame_delta=[3], char_subset=FIGHTERS, crop_size=96,
               seed=seed, gt_root_train=none, gt_root_val=none, gt_root_test=none,
               stages_dir=str(root / "stages"), clean_char_dir=str(root / "clean"), **kw)


def _same_sample(out, ref, meta_paths=True):
    frames, char_id, labels, meta = out
    assert frames.dtype == np.uint8
    np.testing.assert_array_equal(np.asarray(frames, np.float32) / 255.0, ref[0])
    assert char_id == ref[1] and np.array_equal(labels, ref[2])
    if meta_paths:
        assert meta == ref[3]
    else:
        assert meta["char"] == ref[3]["char"] and meta["actions"] == ref[3]["actions"]


SYNTH_CONFIGS = {
    "consecutive": dict(),
    "middleout": dict(synth_window="middleout"),
    "fill-jitter": dict(synth_sprite_fill=(0.7, 0.98), synth_center_jitter=10,
                        synth_window="middleout"),
    "difficulty1": dict(synth_difficulty=1, synth_sprite_fill=(0.7, 0.98),
                        synth_center_jitter=10, synth_window="middleout"),
    "difficulty2-redrawn-stage": dict(synth_difficulty=2, randomize_stage_background=True),
    "difficulty2-moving-stage": dict(synth_difficulty=2, move_stage_background=True,
                                     synth_window="middleout", synth_cycle_repeats=(1, 3)),
    "degrade": dict(synth_difficulty=1, synth_frame_degrade=0.5, synth_window="middleout"),
}


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("config", list(SYNTH_CONFIGS))
def test_synth_split_matches_jax(sprite_tree, config, seed):
    root, _ = sprite_tree
    port = _splits(UltActionRecogDataset, root, seed=seed, **SYNTH_CONFIGS[config])
    ref = _splits(JaxDataset, root, seed=seed, **SYNTH_CONFIGS[config])
    for idx in range(3):
        _same_sample(port[idx], ref[idx])


def _on_twin(port, ref, root, twin):
    """Give the port's dataset on the .npy twin the JAX dataset's listing
    order (directories list in the file system's order, which differs
    between the two trees), each path mapped to its twin."""
    def twin_path(p):
        return os.path.join(str(twin), os.path.relpath(p, str(root)))[:-4] + ".npy"

    def walk(node):
        return ([twin_path(p) for p in node] if isinstance(node, list)
                else {k: walk(v) for k, v in node.items()})

    port.stage_paths = [twin_path(p) for p in ref.stage_paths]
    port.char_anim_dict = walk(ref.char_anim_dict)
    return port


@pytest.mark.parametrize("config", ["middleout", "difficulty2-moving-stage"])
def test_synth_split_on_the_npy_twin_matches_jax(sprite_tree, config):
    """The card's tree: .npy sprites and stages give the JAX split's frames
    from the PNG/jpg tree, the listing in the same order."""
    root, twin = sprite_tree
    ref = _splits(JaxDataset, root, seed=1, **SYNTH_CONFIGS[config])
    port = _on_twin(_splits(UltActionRecogDataset, twin, seed=1, **SYNTH_CONFIGS[config]), ref,
                    root, twin)
    assert sorted(port.stage_paths) == sorted(
        _splits(UltActionRecogDataset, twin).stage_paths)
    for idx in range(3):
        _same_sample(port[idx], ref[idx], meta_paths=False)


def test_synth_batches_are_uint8(sprite_tree):
    root, _ = sprite_tree
    frames, chars, labels = next(_splits(UltActionRecogDataset, root, synth_difficulty=1)
                                 .batches(4, 1))
    assert frames.dtype == np.uint8 and frames.shape == (4, 7, 96, 96, 3)
    assert chars.shape == (4,) and labels.shape == (4, 7)
    assert labels.min() >= 0 and labels.max() < len(ACTIONS)


@pytest.fixture(scope="module")
def modes_assets(tmp_path_factory):
    """tests/test_dataset_modes.py's assets: two moves of plain sprites, a
    noise stage, a 30-frame mp4v clip and its annotation CSV."""
    root = tmp_path_factory.mktemp("modes")
    rng = np.random.default_rng(0)
    stages = root / "stages"
    stages.mkdir()
    cv2.imwrite(str(stages / "s.jpg"), rng.integers(0, 255, (720, 1280, 3), dtype=np.uint8))
    for move in ("ForwardSmash", "Jab"):
        d = root / "clean" / "Byleth" / move
        d.mkdir(parents=True)
        for i in range(8):
            sprite = np.zeros((96, 64, 4), np.uint8)
            sprite[10:80, 5:60, :3] = rng.integers(60, 255, 3, dtype=np.uint8)
            sprite[10:80, 5:60, 3] = 255
            cv2.imwrite(str(d / f"byleth_c00_{move.lower()}_frame_90_{i}.png"), sprite)
    video = root / "clip.mp4"
    writer = cv2.VideoWriter(str(video), cv2.VideoWriter_fourcc(*"mp4v"), 30, (640, 360))
    for i in range(30):
        frame = np.full((360, 640, 3), 30 + i * 5 % 200, np.uint8)
        frame[100:260, 250:390] = rng.integers(0, 255, (160, 140, 3), dtype=np.uint8)
        writer.write(frame)
    writer.release()
    csv_path = root / "labels.csv"
    with open(csv_path, "w") as f:
        f.write("frame,fighter,action,cx,cy,w,h\n")
        for i in range(30):
            f.write(f"{i},Byleth,{['ForwardSmash', 'Jab'][i % 2]},0.5,0.5,0.3,0.4\n")
    return root, video, csv_path


def _modes(cls, assets, split, **kw):
    root, video, csv_path = assets
    return cls(split=split, num_samples=8, img_dimension=96,
               anim_subset=["ForwardSmash", "Jab", "Wait", "Unknown"], num_frames_per_sample=3,
               frame_delta=[1], char_subset=["Byleth"], crop_size=64, seed=0,
               gt_root_train=str(root / "none"), gt_root_val=str(root / "none"),
               gt_root_test=str(root / "none"), stages_dir=str(root / "stages"),
               clean_char_dir=str(root / "clean"), manual_ground_truth_csv=str(csv_path),
               manual_ground_truth_video=str(video), **kw)


def test_simple_split_matches_jax(modes_assets):
    port, ref = _modes(UltActionRecogDataset, modes_assets, "simple"), _modes(
        JaxDataset, modes_assets, "simple")
    for idx in range(4):
        _same_sample(port[idx], ref[idx])


@pytest.mark.parametrize("manual_split", ["train", "validation", "test"])
def test_manual_split_matches_jax(modes_assets, manual_split):
    port = _modes(UltActionRecogDataset, modes_assets, "manual", manual_split=manual_split)
    ref = _modes(JaxDataset, modes_assets, "manual", manual_split=manual_split)
    assert port.manual_labels == ref.manual_labels
    assert port.manual_action_to_frames == ref.manual_action_to_frames
    for idx in range(3):
        _same_sample(port[idx], ref[idx])


def test_gen_synth_video_actions_matches_jax(sprite_tree, tmp_path):
    """tests/test_datagen.py:138's generator run, by both packages from one
    seed: the same annotation files and frame files, byte for byte; then
    from the .npy twin, the same annotations."""
    root, twin = sprite_tree
    outs = {}
    for name, module, assets in (("jax", jax_gsva, root), ("port", gsva, root),
                                 ("npy", gsva, twin)):
        out = tmp_path / name
        module.SynthVideoGenerator(
            {"train": 1, "validation": 1}, video_length=5, width=320, height=240, seed=3,
            output_root=str(out), stages_dir=str(assets / "stages"),
            clean_char_dir=str(assets / "clean"), char_list=FIGHTERS).generate()
        outs[name] = out
    files = sorted(os.path.relpath(os.path.join(d, f), outs["jax"])
                   for d, _, fs in os.walk(outs["jax"]) for f in fs)
    assert len([f for f in files if f.endswith(".jpg")]) == 10
    for rel in files:
        with open(outs["jax"] / rel, "rb") as a, open(outs["port"] / rel, "rb") as b:
            assert a.read() == b.read(), rel
    for rel in ("annotations/train.csv", "annotations/validation.csv", "frames/train.txt"):
        with open(outs["jax"] / rel) as a, open(outs["npy"] / rel) as b:
            assert a.read() == b.read(), rel
    with open(outs["jax"] / "annotations" / "train.csv") as f:
        assert len([r for r in f.read().splitlines() if r]) == 10


# ---------------------------------------------------------------------------
# Without cv2 and PIL


def test_splits_run_on_npy_without_cv2_and_pil(sprite_tree, monkeypatch):
    """With cv2 and PIL blocked: the synth split at difficulty 2 and the
    simple split run on the .npy twin and give the JAX frames; the JPEG
    degrade and a jpg stage raise an ImportError naming what they need; a
    PNG sprite reads through the port's own PNG codec, as cv2 reads it."""
    root, twin = sprite_tree
    jax_ds = _splits(JaxDataset, root, seed=2, **SYNTH_CONFIGS["difficulty2-moving-stage"])
    ref = jax_ds[0]
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    port = _on_twin(_splits(UltActionRecogDataset, twin, seed=2,
                            **SYNTH_CONFIGS["difficulty2-moving-stage"]), jax_ds, root, twin)
    _same_sample(port[0], ref, meta_paths=False)
    simple = _splits(UltActionRecogDataset, twin, split="simple")[1]
    assert simple[0].shape == (3, 96, 96, 3) and simple[0].dtype == np.uint8
    with pytest.raises(ImportError, match="cv2"):
        _splits(UltActionRecogDataset, twin, seed=0, synth_frame_degrade=1.0)[0]
    from playaid_core_torch.train import dataset as port_dataset

    port_dataset._load_stage_cached.cache_clear()
    with pytest.raises(ImportError, match="PIL"):
        _splits(UltActionRecogDataset, root, seed=0)[0]
    port_dataset._load_sprite_rgba_cached.cache_clear()
    sprite = next(os.path.join(d, f) for d, _, fs in os.walk(root / "clean") for f in fs)
    assert sprite.endswith(".png")
    assert np.array_equal(port_dataset._load_sprite_rgba(sprite),
                          cv2.imread(sprite, cv2.IMREAD_UNCHANGED))
