"""The port's device-side synthesis (train/device_synth.py) against the JAX
package's, on the CPU.

Assets are built as tests/test_device_synth.py builds them: the JAX
package's skeletal sprites for 2 fighters x 4 moves x 4 frames (variant 0,
both facings) and two noise stage jpgs, with a twin tree of .npy files
(what cv2.imread gives for each file) that needs no cv2.

Tolerances: the sprite generator, the tree walk, both banks and the host
sampling (ints, floats, labels, fighter ids) are bit-identical;
_hue_sat_matrix 1e-6 abs; the bank resample 1e-4 abs on the 0-255 scale
(the same float32 taps, summed in another order); composited uint8 frames
at most 1 apart and identical in at least 99.9% of values (a float32 sum
in another order can move a value across an integer before truncation).
"""

import os

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from playaid_core_tpu.datagen import skeletal_sprites as jax_sk
from playaid_core_tpu.ops.preprocess import _crop_one
from playaid_core_tpu.train import device_synth as jax_ds
from playaid_core_tpu.train.dataset import (
    get_character_actions_animations_dict as jax_tree_walk,
)
from playaid_core_torch.datagen import skeletal_sprites as sk
from playaid_core_torch.ops.crop_kernel import bank_resize
from playaid_core_torch.ops.preprocess import batched_bank_resize
from playaid_core_torch.train import device_synth as ds
from playaid_core_torch.train.dataset import get_character_actions_animations_dict

FIGHTERS = ["Byleth", "Pikachu"]
MOVES = ["Wait", "Jab", "Run", "Shield"]
FRAME_TOL, SAME_MIN = 1, 0.999


def _write_assets(root):
    clean, stages = os.path.join(root, "clean"), os.path.join(root, "stages")
    os.makedirs(stages, exist_ok=True)
    jax_sk.generate_sprite_set(clean, fighters=FIGHTERS, moves=MOVES, frames_per_move=4,
                               variant_seeds=(0,))
    rng = np.random.default_rng(0)
    for i in range(2):
        img = rng.integers(0, 255, (300, 400, 3), dtype=np.uint8)
        cv2.imwrite(os.path.join(stages, f"stage_{i}.jpg"), img)
    return clean, stages


def _npy_twin(src, dst, flag):
    """The tree at src with each image file replaced by np.save of
    cv2.imread(file, flag)."""
    for dirpath, _, files in os.walk(src):
        out = os.path.join(dst, os.path.relpath(dirpath, src))
        os.makedirs(out, exist_ok=True)
        for name in files:
            stem = os.path.splitext(name)[0]
            np.save(os.path.join(out, stem + ".npy"), cv2.imread(os.path.join(dirpath, name), flag))
    return dst


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return _write_assets(str(tmp_path_factory.mktemp("synth_assets")))


@pytest.fixture(scope="module")
def npy_assets(assets, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth_assets_npy"))
    return (_npy_twin(assets[0], os.path.join(root, "clean"), cv2.IMREAD_UNCHANGED),
            _npy_twin(assets[1], os.path.join(root, "stages"), cv2.IMREAD_COLOR))


def dataset_args(clean, stages, **kw):
    args = dict(anim_subset=MOVES + ["Unknown"], characters=FIGHTERS, clean_char_dir=clean,
                stages_dir=stages, num_samples=64, num_frames_per_sample=5,
                synth_window="middleout", synth_cycle_repeats=(2, 3), synth_difficulty=1,
                seed=0, stage_patch=160)
    args.update(kw)
    return args


@pytest.fixture(scope="module")
def dataset(assets):
    return ds.DeviceSynthDataset(device="cpu", **dataset_args(*assets))


@pytest.fixture(scope="module")
def jax_dataset(assets):
    return jax_ds.DeviceSynthDataset(**dataset_args(*assets))


def _frames_close(out, ref):
    diff = np.abs(np.asarray(out, np.int32) - np.asarray(ref, np.int32))
    assert diff.max() <= FRAME_TOL and (diff == 0).mean() >= SAME_MIN, (
        diff.max(), (diff == 0).mean())


# ---------------------------------------------------------------------------
# The sprite generator and the tree walk


@pytest.mark.parametrize("fighter", FIGHTERS + ["Diddy Kong", "Joker"])
def test_render_sprite_matches_jax(fighter):
    for move, phase, facing, variant in (("Jab", 0.3, 1, 0), ("Shield", 0.7, -1, 5),
                                         ("Tumble", 0.1, 1, 17), ("SpotDodge", 0.5, -1, 0)):
        out = sk.render_sprite(fighter, move, phase, facing=facing, variant_seed=variant,
                               noise_rng=np.random.default_rng(1))
        ref = jax_sk.render_sprite(fighter, move, phase, facing=facing, variant_seed=variant,
                                   noise_rng=np.random.default_rng(1))
        assert np.array_equal(out, ref), (fighter, move)
        assert np.array_equal(sk.tight_crop(out), jax_sk.tight_crop(ref))


def test_generate_sprite_set_is_byte_identical(assets, tmp_path):
    n = sk.generate_sprite_set(str(tmp_path), fighters=FIGHTERS, moves=MOVES,
                               frames_per_move=4, variant_seeds=(0,), fmt="png")
    clean = assets[0]
    names = sorted(os.path.relpath(os.path.join(d, f), clean)
                   for d, _, files in os.walk(clean) for f in files)
    assert n == len(names) == 2 * 4 * 2 * 4
    assert names == sorted(os.path.relpath(os.path.join(d, f), tmp_path)
                           for d, _, files in os.walk(tmp_path) for f in files)
    for name in names:
        with open(os.path.join(clean, name), "rb") as a, open(tmp_path / name, "rb") as b:
            assert a.read() == b.read(), name


def test_tree_walk_matches_jax(assets, npy_assets):
    clean, _ = assets
    tree = get_character_actions_animations_dict(clean)
    assert tree == jax_tree_walk(clean)
    assert set(tree) == set(FIGHTERS) and set(tree["Byleth"]) == set(MOVES)
    # The .npy twin: the same nesting and order, the same sprite arrays.
    twin = get_character_actions_animations_dict(npy_assets[0])

    def walk(node):
        if isinstance(node, list):
            yield node
            return
        for key in sorted(node):
            yield from walk(node[key])

    assert twin.keys() == tree.keys()
    pairs = list(zip(walk(tree), walk(twin)))
    assert len(pairs) == 2 * 4 * 2
    for pngs, npys in pairs:
        assert [os.path.relpath(p, clean)[:-4] for p in pngs] == [
            os.path.relpath(p, npy_assets[0])[:-4] for p in npys]
        for p, q in zip(pngs, npys):
            assert np.array_equal(cv2.imread(p, cv2.IMREAD_UNCHANGED), np.load(q))
    assert get_character_actions_animations_dict(os.path.join(clean, "missing")) == {}


# ---------------------------------------------------------------------------
# The banks


@pytest.mark.parametrize("size", [64, 128])
def test_sprite_bank_matches_jax(assets, npy_assets, size):
    """64 shrinks every sprite (104-176 px tight), 128 shrinks most and
    enlarges some, both through imgproc's INTER_AREA."""
    ref = jax_ds.SpriteBank(assets[0], FIGHTERS, sprite_size=size)
    for clean in (assets[0], npy_assets[0]):
        bank = ds.SpriteBank(clean, FIGHTERS, sprite_size=size, device="cpu")
        assert bank.bank.dtype == torch.uint8
        assert np.array_equal(bank.bank.numpy(), np.asarray(ref.bank))
        assert bank.nbytes == ref.nbytes == bank.bank.numel()
        assert bank.by_char_move_body == ref.by_char_move_body
        assert bank.sequences == ref.sequences
        assert bank.chars() == ref.chars() and bank.moves_for("Pikachu") == ref.moves_for("Pikachu")


def test_stage_bank_matches_jax(assets, npy_assets, tmp_path):
    for patch, per_stage in ((160, 4), (192, 48)):
        ref = np.asarray(jax_ds.StageBank(assets[1], patch=patch, patches_per_stage=per_stage,
                                          seed=3).bank)
        for stages in (assets[1], npy_assets[1]):
            bank = ds.StageBank(stages, patch=patch, patches_per_stage=per_stage, seed=3,
                                device="cpu")
            assert np.array_equal(bank.bank.numpy(), ref)
            assert bank.num_patches == len(ref) and bank.nbytes == ref.nbytes
    # A texture no larger than the patch is resized to it (INTER_LINEAR).
    small = tmp_path / "small"
    small.mkdir()
    img = np.random.default_rng(4).integers(0, 255, (150, 210, 3), dtype=np.uint8)
    cv2.imwrite(str(small / "a.jpg"), img)
    ref = np.asarray(jax_ds.StageBank(str(small), patch=160, patches_per_stage=2).bank)
    assert np.array_equal(ds.StageBank(str(small), patch=160, patches_per_stage=2,
                                       device="cpu").bank.numpy(), ref)
    with pytest.raises(RuntimeError, match="no stage textures"):
        ds.StageBank(str(tmp_path / "none"), device="cpu")


def test_sprite_bank_layout(assets):
    bank = ds.SpriteBank(assets[0], FIGHTERS, sprite_size=64, device="cpu")
    # 2 fighters x 4 moves x 1 variant x 2 facings x 4 frames
    assert bank.num_sprites == 2 * 4 * 1 * 2 * 4
    assert bank.bank.shape == (bank.num_sprites, 64, 64, 4)
    for seq in bank.sequences:
        assert len(seq["rows"]) == 4
        assert seq["char"] in FIGHTERS
        assert seq["move"] in MOVES
    with pytest.raises(RuntimeError, match="no sprites"):
        ds.SpriteBank(assets[0], ["Joker"], device="cpu")


def test_stage_bank(assets):
    bank = ds.StageBank(assets[1], patch=160, patches_per_stage=4, device="cpu")
    assert bank.bank.shape == (8, 160, 160, 3)


def test_dataset_defaults_to_the_card(assets):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ds.DeviceSynthDataset(**dataset_args(*assets))


# ---------------------------------------------------------------------------
# Host sampling


def test_hue_sat_matrix_matches_jax():
    rng = np.random.default_rng(0)
    for hue, sat, contrast in rng.uniform((-np.pi, 0.7, 0.8), (np.pi, 1.3, 1.2), (20, 3)):
        np.testing.assert_allclose(ds._hue_sat_matrix(hue, sat, contrast),
                                   jax_ds._hue_sat_matrix(hue, sat, contrast), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def consecutive_pair(assets):
    kw = dataset_args(*assets, synth_window="consecutive")
    return ds.DeviceSynthDataset(device="cpu", **kw), jax_ds.DeviceSynthDataset(**kw)


@pytest.mark.parametrize("window", ["middleout", "consecutive"])
@pytest.mark.parametrize("degrade", [0.0, 0.5])
@pytest.mark.parametrize("identity_safe", [False, True])
@pytest.mark.parametrize("difficulty", [0, 1, 2])
def test_batch_params_match_jax(dataset, jax_dataset, consecutive_pair, window, degrade,
                                identity_safe, difficulty):
    port, ref = (dataset, jax_dataset) if window == "middleout" else consecutive_pair
    for d in (port, ref):
        d.rng = np.random.default_rng(11)
        d.synth_difficulty, d.identity_safe, d.synth_frame_degrade = (
            difficulty, identity_safe, degrade)
    for _ in range(2):
        out, want = port._sample_batch_params(9), ref._sample_batch_params(9)
        for key in ("ints", "floats", "labels", "chars"):
            assert out[key].dtype == want[key].dtype and np.array_equal(out[key], want[key]), key
    for d in (port, ref):
        d.synth_difficulty, d.identity_safe, d.synth_frame_degrade = 1, False, 0.0


# ---------------------------------------------------------------------------
# The bank resample (the plain version of K1's bank entry)


def _jax_bank_resize(bank, rows, origins, size, flip=None):
    spr = jnp.take(jnp.asarray(bank), jnp.asarray(rows), axis=0).astype(jnp.float32)
    if flip is not None:
        spr = jnp.where(jnp.asarray(flip, bool)[:, None, None, None], spr[:, :, ::-1, :], spr)
    o = jnp.asarray(origins)
    return np.asarray(jax.vmap(_crop_one, in_axes=(0, 0, 0, 0, None))(
        spr, o[:, 0], o[:, 1], jnp.maximum(o[:, 2], 1.0), size))


BANK_CASES = {
    # (y0, x0, side) per row: inside, negative origins, side < 1, side more
    # than ten times the source, a window wholly outside.
    "inside": [(2.0, 3.0, 14.0), (0.0, 0.0, 20.0), (5.5, 1.25, 9.75)],
    "negative": [(-6.0, -3.5, 30.0), (-30.0, 4.0, 40.0), (3.0, -12.25, 18.0)],
    "tiny_side": [(4.0, 6.0, 0.25), (10.0, 2.0, 0.0), (-0.5, -0.5, 0.9)],
    "huge_side": [(-150.0, -120.0, 320.0), (-400.0, -380.0, 900.0), (-20.0, -10.0, 250.0)],
    "outside": [(40.0, 3.0, 10.0), (2.0, -50.0, 20.0), (-80.0, -80.0, 30.0)],
}


@pytest.mark.parametrize("mirror", [False, True])
@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("case", sorted(BANK_CASES))
def test_bank_resize_plain_matches_crop_one(case, channels, mirror):
    rng = np.random.default_rng(len(case) * channels)
    bank = rng.integers(0, 256, (5, 24, 20, channels), dtype=np.uint8)  # H != W
    rows = np.array([3, 0, 4], np.int32)
    origins = np.array(BANK_CASES[case], np.float32)
    flip = np.array([1, 0, 1], np.int32) if mirror else None
    ref = _jax_bank_resize(bank, rows, origins, 16, flip)
    args = (torch.from_numpy(bank), torch.from_numpy(rows), torch.from_numpy(origins), 16,
            None if flip is None else torch.from_numpy(flip))
    before = bank_resize.launches
    for out in (batched_bank_resize(*args), bank_resize(*args)):
        assert out.dtype == torch.float32 and out.shape == (3, 16, 16, channels)
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)
    assert bank_resize.launches == before  # the CPU runs the plain version
    if case == "outside":
        assert not ref.any()


def test_bank_resize_row_out_of_range_reads_nothing():
    rng = np.random.default_rng(7)
    bank = torch.from_numpy(rng.integers(1, 256, (3, 12, 10, 4), dtype=np.uint8))
    rows = torch.tensor([-1, 1, 3, 2], dtype=torch.int32)
    origins = torch.tensor([(0.0, 0.0, 10.0)] * 4)
    out = bank_resize(bank, rows, origins, 8, torch.tensor([0, 1, 1, 0], dtype=torch.int32))
    assert not out[0].any() and not out[2].any()
    inside = batched_bank_resize(bank, rows[[1, 3]], origins[[1, 3]], 8,
                                 torch.tensor([1, 0], dtype=torch.int32))
    assert out[[1, 3]].min() > 0 and torch.equal(out[[1, 3]], inside)


def test_bank_resize_refuses_bad_shapes():
    bank = torch.zeros((2, 8, 8, 4), dtype=torch.uint8)
    rows, origins = torch.zeros(3, dtype=torch.int32), torch.zeros((3, 3))
    with pytest.raises(ValueError, match="bank"):
        bank_resize(bank[..., :2], rows, origins, 4)
    with pytest.raises(ValueError, match="origins"):
        bank_resize(bank, rows, origins[:2], 4)
    with pytest.raises(ValueError, match="flip"):
        bank_resize(bank, rows, origins, 4, torch.zeros(2, dtype=torch.int32))


# ---------------------------------------------------------------------------
# The composite and whole batches


def _jax_draws(key, b, s):
    k_noise, k_drop = jax.random.split(key)
    return (np.asarray(jax.random.normal(k_noise, (b, 1, s, s, 3))),
            np.asarray(jax.random.uniform(k_drop, (b, 1, s, s, 1))))


@pytest.mark.parametrize("difficulty", [0, 1, 2])
def test_synth_composite_matches_jax_with_the_same_draws(dataset, jax_dataset, difficulty):
    jax_dataset.rng = np.random.default_rng(difficulty)
    jax_dataset.synth_difficulty = difficulty
    p = jax_dataset._sample_batch_params(6)
    jax_dataset.synth_difficulty = 1
    p["ints"][1, -1] = 1  # a mirrored clip
    if difficulty == 2:
        p["floats"][:, -7:-3] = [[10, 20, 40, 30]] * 6  # a coarse hole in every clip
    key = jax.random.PRNGKey(difficulty)
    ref = np.asarray(jax_ds.synth_composite(jax_dataset.sprites.bank, jax_dataset.stages.bank,
                                            p["ints"], p["floats"], key, out_size=128, t=5))
    noise, drop_u = _jax_draws(key, 6, 128)
    out = ds.synth_composite(dataset.sprites.bank, dataset.stages.bank,
                             torch.from_numpy(p["ints"]), torch.from_numpy(p["floats"]), 128, 5,
                             noise=torch.from_numpy(noise.copy()),
                             drop_u=torch.from_numpy(drop_u.copy()))
    assert out.dtype == torch.uint8 and out.shape == (6, 5, 128, 128, 3)
    _frames_close(out.numpy(), ref)


def test_device_batches_match_jax_at_difficulty_0(assets):
    """At difficulty 0 the noise sigma and the dropout rate are 0, so the
    composite does not depend on the draws: whole batches match."""
    kw = dataset_args(*assets, synth_difficulty=0, seed=5)
    port = ds.DeviceSynthDataset(device="cpu", **kw)
    ref = jax_ds.DeviceSynthDataset(**kw)
    for (f, c, lab), (rf, rc, rlab) in zip(port.device_batches(4, 2), ref.device_batches(4, 2)):
        assert isinstance(f, torch.Tensor) and f.device.type == "cpu"
        _frames_close(f.numpy(), np.asarray(rf))
        assert np.array_equal(c, rc) and np.array_equal(lab, rlab)
    frames, chars, labels = next(port.batches(4, 1))
    assert isinstance(frames, np.ndarray) and frames.shape == (4, 5, 128, 128, 3)


# The cases of tests/test_device_synth.py.


def test_batch_shapes_and_labels(dataset):
    frames, chars, labels = next(dataset.device_batches(6))
    assert frames.shape == (6, 5, 128, 128, 3)
    assert frames.dtype == torch.uint8
    assert labels.shape == (6, 5)
    assert set(np.unique(labels)).issubset(set(range(len(MOVES) + 1)))
    assert chars.shape == (6,)
    assert set(np.unique(chars)).issubset({0, 1})


def test_sprite_actually_composited(dataset):
    frames = next(dataset.device_batches(8))[0].numpy()
    center = frames[:, :, 44:84, 44:84]
    border = frames[:, :, :12, :12]
    diff = np.abs(center.mean(axis=(2, 3, 4)) - border.mean(axis=(2, 3, 4)))
    assert (diff > 1.0).any()


def test_determinism_same_seed(assets):
    def make():
        return ds.DeviceSynthDataset(device="cpu", **dataset_args(
            *assets, num_samples=16, synth_difficulty=2, seed=7, synth_cycle_repeats=(1, 2)))

    f1, c1, l1 = next(make().device_batches(4))
    f2, c2, l2 = next(make().device_batches(4))
    assert torch.equal(f1, f2)
    assert np.array_equal(l1, l2)
    assert np.array_equal(c1, c2)


def test_fill_controls_sprite_extent(assets):
    def centre_std(fill):
        d = ds.DeviceSynthDataset(device="cpu", **dataset_args(
            *assets, anim_subset=MOVES, characters=FIGHTERS[:1], num_samples=8,
            num_frames_per_sample=3, synth_sprite_fill=(fill, fill), synth_center_jitter=0,
            synth_difficulty=0, seed=3, synth_cycle_repeats=(1, 2)))
        frames = next(d.device_batches(8))[0].numpy().astype(np.int32)
        return frames[:, :, :, 60:68].std(axis=(2, 3, 4)).mean()

    assert abs(centre_std(0.95) - centre_std(0.2)) > 0.5


def test_curriculum_hook(dataset):
    d0 = dataset.synth_difficulty
    dataset.make_synth_more_challenging()
    assert dataset.synth_difficulty == min(d0 + 1, 2)
    dataset.synth_difficulty = d0
    dataset.switch_num_frames_per_sample()
    assert dataset.num_frames_per_sample == 5 and len(dataset) == 64
