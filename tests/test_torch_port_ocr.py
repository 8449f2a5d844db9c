"""The port's damage OCR (playaid_core_torch.infer.{ocr, ocr_conv} and
``AIRunner.run_damage_detection``) against the JAX package's, on the CPU.

HUD crops are rendered with the JAX package's ``render_hud_text`` across
its style space (outline, shadow, rotation, noise, the white -> red damage
tint), in its training and held-out fonts, single digits and whole
readings such as "143.7".  The digit net runs with the committed
``ocr_digits.npz`` (the port reads its own copy of the file).
"""

import filecmp
import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp  # noqa: E402

from playaid_core_tpu import constants as jax_constants  # noqa: E402
from playaid_core_tpu.infer import ocr_conv as jax_ocr_conv  # noqa: E402
from playaid_core_tpu.infer.ocr import segment_digit_components as jax_segment  # noqa: E402
from playaid_core_tpu.infer.runner import AIRunner as JaxAIRunner  # noqa: E402
from playaid_core_torch import constants  # noqa: E402
from playaid_core_torch.convert import from_jax_digits  # noqa: E402
from playaid_core_torch.infer import ocr_conv  # noqa: E402
from playaid_core_torch.infer.ocr import PLAYER_DAMAGE_CROPS, segment_digit_components  # noqa: E402
from playaid_core_torch.infer.pipeline import BatchedActionPipeline  # noqa: E402
from playaid_core_torch.infer.runner import AIRunner  # noqa: E402

torch.set_num_threads(2)

LOGIT_TOL = 1e-4  # max abs, float32 nets on the same patches


def _styled_crops(fonts, n, seed, multi):
    """HUD crops across the style space of tests/test_ocr_conv.py, as
    (crop, text): single digits, or readings with a decimal part."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if multi:
            text = f"{int(rng.integers(0, 300))}.{int(rng.integers(0, 10))}"
        else:
            text = str(int(rng.integers(0, 10)))
        crop = jax_ocr_conv.render_hud_text(
            text, fonts[int(rng.integers(0, len(fonts)))],
            height=int(rng.integers(32, 60)),
            outline=int(rng.integers(1, 4)),
            shadow=int(rng.integers(1, 4)),
            rotation=float(rng.uniform(-8, 8)),
            damage=float(rng.uniform(0, 1)),
            noise=int(rng.integers(5, 22)),
            seed=int(rng.integers(0, 2**31)),
        )
        out.append((crop, text))
    return out


FONT_POOLS = {"train": jax_ocr_conv.train_fonts, "heldout": jax_ocr_conv.heldout_fonts}


@pytest.mark.parametrize("multi", [False, True], ids=["digits", "readings"])
@pytest.mark.parametrize("pool", sorted(FONT_POOLS))
def test_segmentation_matches_jax(pool, multi):
    """Identical grey image, component boxes and patches."""
    comps_seen = 0
    seed = 2 * sorted(FONT_POOLS).index(pool) + multi
    for crop, _ in _styled_crops(FONT_POOLS[pool](), 30, seed=seed, multi=multi):
        ref, ref_gray = jax_segment(crop)
        out, gray = segment_digit_components(crop)
        assert np.array_equal(gray, ref_gray)
        assert [(c["x"], c["y"], c["w"], c["h"]) for c in out] == \
            [(c["x"], c["y"], c["w"], c["h"]) for c in ref]
        for c, r in zip(out, ref):
            assert np.array_equal(c["mask"], r["mask"]) and np.array_equal(c["patch"], r["patch"])
        comps_seen += len(out)
    assert comps_seen >= 30


def test_digit_net_matches_jax():
    """The converted net on random patches: logits within LOGIT_TOL."""
    params = jax_ocr_conv.load_params()
    patches = np.random.default_rng(0).random((16, 48, 48, 1), np.float32)
    ref = np.asarray(jax_ocr_conv._make_model().apply(params, jnp.asarray(patches)))
    net = ocr_conv.DigitNet().eval()
    net.load_state_dict(from_jax_digits(params))
    with torch.no_grad():
        out = net(torch.from_numpy(patches)).numpy()
    assert np.abs(out - ref).max() <= LOGIT_TOL


def test_weights_are_a_byte_identical_copy():
    assert filecmp.cmp(ocr_conv.WEIGHTS_PATH, jax_ocr_conv.WEIGHTS_PATH, shallow=False)


def test_conv_ocr_matches_jax():
    """At least 50 crops of both font pools: the same patches, logits
    within LOGIT_TOL, identical readings (right or wrong: the JAX
    package's own tests hold the accuracy)."""
    ref_reader = jax_ocr_conv.ConvDigitOCR()
    reader = ocr_conv.ConvDigitOCR(device="cpu")
    crops = (_styled_crops(jax_ocr_conv.train_fonts(), 30, 11, multi=False)
             + _styled_crops(jax_ocr_conv.heldout_fonts(), 30, 12, multi=True))
    for crop, _ in crops:
        comps, _ = segment_digit_components(crop)
        if comps:
            patches = np.stack([ocr_conv.patch_from_component(c) for c in comps])[..., None]
            ref_patches = np.stack([jax_ocr_conv.patch_from_component(c)
                                    for c in jax_segment(crop)[0]])[..., None]
            assert np.array_equal(patches, ref_patches)
            assert np.abs(reader.logits(patches) - ref_reader._logits(ref_patches)).max() \
                <= LOGIT_TOL
        ok, (value, raw, conf, details) = reader(crop)
        ok_ref, (value_ref, raw_ref, conf_ref, details_ref) = ref_reader(crop)
        assert (ok, value, raw, details) == (ok_ref, value_ref, raw_ref, details_ref)
        assert abs(conf - conf_ref) <= 1e-5
    assert len(crops) >= 50


# ---- run_damage_detection on a clip with the HUD drawn in ----

NUM_FRAMES = 24
HUD_VALUES = [(0.0, 12.5), (0.0, 12.5), (7.4, 12.5), (7.4, 40.1), (23.0, 40.1), (23.0, 88.8)]


def _hud_clip(path):
    """1280x720 frames of noise with both damage counters at
    PLAYER_DAMAGE_CROPS; the values step every 4 frames."""
    font = jax_ocr_conv.train_fonts()[0]
    rng = np.random.default_rng(0)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 60, (1280, 720))
    for i in range(NUM_FRAMES):
        frame = rng.integers(0, 40, (720, 1280, 3), dtype=np.uint8)
        for player, value in enumerate(HUD_VALUES[i // 4]):
            p = PLAYER_DAMAGE_CROPS[player]
            x0 = int((p["center_x"] - p["crop_width"] / 2) * 1280)
            y0 = int((p["center_y"] - p["crop_height"] / 2) * 720)
            hud = jax_ocr_conv.render_hud_text(f"{value:.1f}", font, height=40, damage=value / 100,
                                               noise=4, seed=i)
            frame[y0:y0 + 60, x0:x0 + 133] = cv2.resize(hud, (133, 60),
                                                        interpolation=cv2.INTER_AREA)
        writer.write(frame)
    writer.release()


class FakeDetector:
    """Two fighters on every frame; player 0 (left) is Pikachu.  The JAX
    layout gets jpg crops, the port's npy crops."""

    def __init__(self, jax_layout):
        self.jax_layout = jax_layout

    def run(self, input_video_path, exp_name):
        cache = jax_constants.AI_CACHE if self.jax_layout else constants.AI_CACHE
        base = os.path.join(cache, exp_name)
        video_name = os.path.splitext(os.path.basename(input_video_path))[0]
        for fighter in ("Pikachu", "Joker"):
            os.makedirs(os.path.join(base, "crops", fighter), exist_ok=True)
        os.makedirs(os.path.join(base, "labels"), exist_ok=True)
        crop = np.zeros((128, 128, 3), np.uint8)
        for i in range(1, NUM_FRAMES + 1):
            for fighter in ("Pikachu", "Joker"):
                stem = os.path.join(base, "crops", fighter, f"{video_name}_{i}")
                if self.jax_layout:
                    cv2.imwrite(stem + ".jpg", crop)
                else:
                    np.save(stem + ".npy", crop)
            with open(os.path.join(base, "labels", f"{video_name}_{i}.txt"), "w") as f:
                f.write("2 0.3 0.5 0.2 0.3 0.9\n3 0.7 0.5 0.2 0.3 0.9\n")
        return exp_name


def test_damage_detection_matches_jax(tmp_path, monkeypatch):
    """Per-frame readings and the median-smoothed track: identical."""
    monkeypatch.setattr(jax_constants, "AI_CACHE", str(tmp_path / "jax_cache"))
    monkeypatch.setattr(constants, "AI_CACHE", str(tmp_path / "port_cache"))
    os.makedirs(tmp_path / "vids")
    video = str(tmp_path / "vids" / "hud.mp4")
    _hud_clip(video)
    ref = JaxAIRunner(video, detector=FakeDetector(jax_layout=True))
    out = AIRunner(video, detector=FakeDetector(jax_layout=False),
                   pipeline=BatchedActionPipeline(device="cpu"))
    tracks = {}
    for name, runner in (("jax", ref), ("port", out)):
        runner.run_detection_setup()
        confident = runner.run_damage_detection(smooth=0)
        raw = {f: [runner.ai_output_data[f][i].damage for i in range(NUM_FRAMES)]
               for f in ("Pikachu", "Joker")}
        runner.smooth_damage(window=5)
        smoothed = {f: [runner.ai_output_data[f][i].damage for i in range(NUM_FRAMES)]
                    for f in ("Pikachu", "Joker")}
        tracks[name] = (confident, raw, smoothed, dict(runner.player_id_to_fighter))
    assert tracks["port"] == tracks["jax"]
    confident, raw, smoothed, players = tracks["port"]
    assert players == {0: "Pikachu", 1: "Joker"} and confident == 2 * NUM_FRAMES
    assert all(len(set(track)) >= 2 for track in smoothed.values())  # the steps are read
