"""The port's training dataset and augmentation against the JAX package's.

A ground-truth tree of jpg crops is written as tests/test_train.py and
tests/test_dataset.py write theirs (cv2 exists here), with a twin of
lossless .npy crops (the decoded jpg pixels, BGR).  With the same seed the
port's UltActionRecogDataset gives the JAX one's batches bit for bit (its
uint8 frames / 255 are the JAX dataset's float32 frames), at
synth_difficulty 0 and, through the lazily imported cv2, 1 and 2; the .npy
twin indexes and samples exactly as the jpg tree, and needs no cv2.  The
ground-truth cases of tests/test_dataset.py:81-157 are ported.
"""

import os
import sys

import cv2
import numpy as np
import pytest

from playaid_core_tpu.timeline import cache_dataset as jax_cache_dataset
from playaid_core_tpu.train import augment as jax_augment
from playaid_core_tpu.train.dataset import UltActionRecogDataset as JaxDataset
from playaid_core_torch import imgproc
from playaid_core_torch.timeline import cache_dataset
from playaid_core_torch.train import augment
from playaid_core_torch.train.dataset import UltActionRecogDataset, middle_out_sample

ACTIONS = ["ForwardSmash", "Jab", "Wait", "NeutralAir", "Unknown"]


def _write_tree(root, npy=False):
    """gt_action_detection/<split>/<video>/<id>_<fighter>/{images,labels};
    crops of 128 px and of 96x80 (resized by the dataset)."""
    rng = np.random.default_rng(0)
    for split in ("train", "validation", "test"):
        for fid, fighter in ((0, "byleth"), (1, "pikachu")):
            base = root / split / "vid_a" / f"{fid}_{fighter}"
            (base / "images").mkdir(parents=True)
            (base / "labels").mkdir(parents=True)
            shape = (128, 128, 3) if fid == 0 else (96, 80, 3)
            for frame in range(30):
                img = rng.integers(0, 255, shape, dtype=np.uint8)
                path = str(base / "images" / f"{frame:06d}.jpg")
                cv2.imwrite(path, img)
                if npy:  # the decoded pixels, losslessly
                    np.save(path[:-4] + ".npy", cv2.imread(path))
                    os.remove(path)
                with open(base / "labels" / f"{frame:06d}.txt", "w") as f:
                    f.write(ACTIONS[frame % 3])
    return root


@pytest.fixture(scope="module")
def gt_tree(tmp_path_factory):
    return _write_tree(tmp_path_factory.mktemp("gt_action"))


@pytest.fixture(scope="module")
def npy_tree(tmp_path_factory):
    return _write_tree(tmp_path_factory.mktemp("gt_action_npy"), npy=True)


def _kwargs(root, **kw):
    base = dict(num_samples=16, img_dimension=128, anim_subset=ACTIONS, num_frames_per_sample=5,
                frame_delta=[1, 2], char_subset=["Byleth", "Pikachu"], seed=0,
                gt_root_train=str(root / "train"), gt_root_val=str(root / "validation"),
                gt_root_test=str(root / "test"))
    base.update(kw)
    return base


def _port(root, split="train", **kw):
    return UltActionRecogDataset(split=split, **_kwargs(root, **kw))


def _jax(root, split="train", **kw):
    return JaxDataset(split=split, stages_dir="/nonexistent", clean_char_dir="/nonexistent",
                      **_kwargs(root, **kw))


def _as_jax(frames):
    """The port's uint8 frames as the JAX dataset gives them."""
    assert frames.dtype == np.uint8
    return frames.astype(np.float32) / 255.0


def _assert_same_batches(a, b, batch_size=4, num_batches=3, b_is_jax=True):
    for (fa, ca, la), (fb, cb, lb) in zip(a.batches(batch_size, num_batches),
                                          b.batches(batch_size, num_batches), strict=True):
        assert fb.dtype == (np.float32 if b_is_jax else np.uint8)
        np.testing.assert_array_equal(_as_jax(fa) if b_is_jax else fa, fb)
        np.testing.assert_array_equal(ca, cb)
        np.testing.assert_array_equal(la, lb)


@pytest.mark.parametrize("difficulty", [0, 1, 2])
def test_batches_identical_to_jax(gt_tree, difficulty):
    _assert_same_batches(_port(gt_tree, synth_difficulty=difficulty),
                         _jax(gt_tree, synth_difficulty=difficulty))


@pytest.mark.parametrize("split", ["validation", "test"])
def test_samples_and_meta_identical_to_jax(gt_tree, split):
    port, ref = _port(gt_tree, split, num_frames_per_sample=[3, 5, 7]), \
        _jax(gt_tree, split, num_frames_per_sample=[3, 5, 7])
    for _ in range(3):
        f, c, a, meta = port[0]
        fr, cr, ar, meta_ref = ref[0]
        np.testing.assert_array_equal(_as_jax(f), fr)
        assert c == cr and a.tolist() == ar.tolist()
        np.testing.assert_array_equal(meta.pop("preceding_actions_ids"),
                                      meta_ref.pop("preceding_actions_ids"))
        assert meta == meta_ref
        port.switch_num_frames_per_sample()
        ref.switch_num_frames_per_sample()


def test_cache_dataset_matches_jax(gt_tree, npy_tree):
    for split in ("train", "test"):
        assert cache_dataset(str(gt_tree / split), ["Byleth", "Pikachu"]) == \
            jax_cache_dataset(str(gt_tree / split), ["Byleth", "Pikachu"])
    videos, moves = cache_dataset(str(npy_tree / "train"), ["Byleth"])
    ref_videos, ref_moves = jax_cache_dataset(str(gt_tree / "train"), ["Byleth"])
    assert moves == ref_moves
    for (p, label), (p_ref, label_ref) in zip(videos["vid_a"]["Byleth"],
                                              ref_videos["vid_a"]["Byleth"], strict=True):
        assert os.path.basename(p)[:-4] == os.path.basename(p_ref)[:-4] and p.endswith(".npy")
        assert os.path.basename(label) == os.path.basename(label_ref)


@pytest.mark.parametrize("difficulty", [0, 1])
def test_npy_twin_samples_as_the_jpg_tree(gt_tree, npy_tree, difficulty):
    _assert_same_batches(_port(npy_tree, synth_difficulty=difficulty),
                         _port(gt_tree, synth_difficulty=difficulty), b_is_jax=False)


def test_npy_tree_needs_no_cv2(gt_tree, npy_tree, monkeypatch):
    """The card's machine has no cv2 or PIL: the .npy tree reads, resizes
    and, at difficulty 1 and 2, augments without them, as the JAX dataset
    does on the jpg tree."""
    refs = [next(_jax(gt_tree, synth_difficulty=d).batches(2, 1)) for d in (0, 1, 2)]
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    for difficulty, (ref, _, ref_labels) in enumerate(refs):
        frames, chars, labels = next(_port(npy_tree, synth_difficulty=difficulty).batches(2, 1))
        assert frames.shape == (2, 5, 128, 128, 3)
        np.testing.assert_array_equal(_as_jax(frames), ref)
        np.testing.assert_array_equal(labels, ref_labels)


# ---- tests/test_dataset.py:81-157, ported ----


def test_ground_truth_sample_shapes(gt_tree):
    frames, char_id, labels, meta = _port(gt_tree)[0]
    assert frames.shape == (5, 128, 128, 3)
    assert frames.dtype == np.uint8  # the wire format; the train step normalises
    assert labels.shape == (5,)
    assert all(0 <= label < len(ACTIONS) for label in labels)
    assert meta["char"] in ("Byleth", "Pikachu")
    assert len(meta["preceding_actions"]) == 8


def test_ground_truth_labels_match_files(gt_tree):
    _, _, labels, meta = _port(gt_tree)[0]
    for label, action in zip(labels, meta["actions"]):
        expected = ACTIONS.index(action) if action in ACTIONS else ACTIONS.index("Unknown")
        assert label == expected


def test_augmented_ground_truth(gt_tree):
    frames, _, labels, _ = _port(gt_tree, synth_difficulty=1)[0]
    assert frames.shape == (5, 128, 128, 3)


def test_curriculum_hooks(gt_tree):
    ds = _port(gt_tree)
    assert ds.synth_difficulty == 0
    ds.make_synth_more_challenging()
    assert ds.synth_difficulty == 1
    ds.make_synth_more_challenging()
    ds.make_synth_more_challenging()
    assert ds.synth_difficulty == 2  # capped
    ds.switch_num_frames_per_sample()
    assert ds.num_frames_per_sample == 5


def test_batches_iterator(gt_tree):
    batches = list(_port(gt_tree).batches(4, num_batches=2))
    assert len(batches) == 2
    frames, chars, labels = batches[0]
    assert frames.shape == (4, 5, 128, 128, 3)
    assert chars.shape == (4,)
    assert labels.shape == (4, 5)


@pytest.mark.parametrize("split", ["synth", "simple", "manual"])
def test_sprite_splits_without_assets_raise_as_jax(gt_tree, split):
    """Without their sprite, stage or annotation assets the splits raise
    what the JAX dataset raises (RuntimeError for synth and manual;
    simple's StopIteration of an empty sprite tree).
    tests/test_torch_port_splits.py holds them against JAX on their
    assets."""
    ref = _jax(gt_tree, split)
    with pytest.raises(Exception) as jax_err:
        ref[0]
    port = _port(gt_tree, split, stages_dir="/nonexistent", clean_char_dir="/nonexistent")
    with pytest.raises(type(jax_err.value)) as port_err:
        port[0]
    assert str(port_err.value) == str(jax_err.value)


def test_middle_out_sample_host():
    assert middle_out_sample(10, 5, 1, 30) == [6, 9, 10, 11, 14]


def test_missing_tree_raises(tmp_path):
    ds = UltActionRecogDataset(
        split="train", num_samples=4, img_dimension=128, anim_subset=ACTIONS,
        char_subset=["Byleth"], seed=0, gt_root_train=str(tmp_path / "none"),
        gt_root_val=str(tmp_path / "none"), gt_root_test=str(tmp_path / "none"),
    )
    with pytest.raises(RuntimeError):
        ds[0]


# ---- augment ----


@pytest.mark.parametrize("seed", range(4))
def test_augment_char_crop_matches_jax(seed):
    img = np.random.default_rng(seed).integers(0, 256, (96, 80, 3), dtype=np.uint8)
    for level in (1, 2):
        kw = dict(output_size=128, **augment.SYNTH_DIFFICULTY_REAL[level])
        out = augment.augment_char_crop(img, rng=np.random.default_rng(seed), **kw)
        ref = jax_augment.augment_char_crop(img, rng=np.random.default_rng(seed), **kw)
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("seed", range(4))
def test_augment_synth_char_crop_matches_jax(seed):
    rng = np.random.default_rng(seed)
    sprite = np.zeros((96, 64, 4), np.uint8)
    sprite[20:80, 10:50, :3] = rng.integers(50, 255, (60, 40, 3), dtype=np.uint8)
    sprite[20:80, 10:50, 3] = 255
    for level in (1, 2):
        for identity_safe in (False, True):
            kw = dict(output_size=128, identity_safe=identity_safe,
                      **augment.SYNTH_DIFFICULTY_SPRITE[level])
            out = augment.augment_synth_char_crop(sprite, rng=np.random.default_rng(seed), **kw)
            ref = jax_augment.augment_synth_char_crop(sprite, rng=np.random.default_rng(seed),
                                                      **kw)
            np.testing.assert_array_equal(out, ref)


def test_augment_ops_match_jax():
    img = np.random.default_rng(9).integers(0, 256, (64, 48, 3), dtype=np.uint8)
    for name, args in (("hflip", ()), ("brightness_contrast", (None,)), ("blur", (None,)),
                       ("hue_saturation_value", (None,)), ("gauss_noise", (None,)),
                       ("pixel_dropout", (None, 0.2)), ("coarse_dropout", (None, 3, 8, 8)),
                       ("channel_dropout", (None,)), ("downscale", (None,)),
                       ("random_sized_crop", (None, 20, 40, 32))):
        a = [np.random.default_rng(1) if v is None else v for v in args]
        b = [np.random.default_rng(1) if v is None else v for v in args]
        np.testing.assert_array_equal(getattr(augment, name)(img, *a),
                                      getattr(jax_augment, name)(img, *b), err_msg=name)


def test_augment_ops_run_without_cv2_or_pil(monkeypatch):
    """The ops run through imgproc: with cv2 and PIL blocked they give the
    JAX ops' pixels, as does the letterbox pad of RGB crops and RGBA
    sprites."""
    img = np.random.default_rng(2).integers(0, 256, (16, 16, 3), dtype=np.uint8)
    rgba = np.random.default_rng(3).integers(0, 256, (8, 4, 4), dtype=np.uint8)
    ops = (augment.blur, augment.hue_saturation_value, augment.downscale)
    refs = [getattr(jax_augment, fn.__name__)(img, np.random.default_rng(0)) for fn in ops]
    pads = [jax_augment._letterbox_pad(x, 16, (0,) * x.shape[2]) for x in (img[:8, :4], rgba)]
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    for fn, ref in zip(ops, refs):
        np.testing.assert_array_equal(fn(img, np.random.default_rng(0)), ref)
    for x, ref in zip((img[:8, :4], rgba), pads):
        np.testing.assert_array_equal(imgproc.pad(x, (16, 16)), ref)
