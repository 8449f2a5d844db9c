"""The port's pixels-only path against the JAX package's, on the CPU:
ResNet-18's feature map, the CenterNet detector and its decode, the
detector's ``detect`` and the character detector's cache, the crop
geometry (and the OpenCV/PIL operations under it), the video reader, the
label helpers, the YOLOv5 and projection detectors, and ``AIRunner``'s
cleanup, recognition, ``ai_output.yaml`` and command line.

Inputs are made from seeds with numpy.  The JAX package writes its crops
as jpg through cv2; jpg is lossy and the port keeps its crops without
loss, so during these tests cv2.imwrite/cv2.imread store the JAX crops
losslessly (an npy body under the jpg name), and both packages see the
same pixels.
"""

import os
import subprocess

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
yaml = pytest.importorskip("yaml")
from PIL import Image, ImageOps  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from playaid_core_tpu import constants as jax_constants  # noqa: E402
from playaid_core_tpu.geometry import YoloCrop as JaxYoloCrop  # noqa: E402
from playaid_core_tpu.infer import detection as jax_detection  # noqa: E402
from playaid_core_tpu.infer.detection import JaxCharacterDetector  # noqa: E402
from playaid_core_tpu.infer.pipeline import BatchedActionPipeline as JaxPipeline  # noqa: E402
from playaid_core_tpu.infer.runner import AIRunner as JaxAIRunner  # noqa: E402
from playaid_core_tpu.models import detector as jax_detector  # noqa: E402
from playaid_core_tpu.models.resnet import make_resnet  # noqa: E402
from playaid_core_tpu.train.detector_train import DetectorTrainer as JaxDetectorTrainer  # noqa: E402
from playaid_core_tpu.video.reader import VideoReader as JaxVideoReader  # noqa: E402
from playaid_core_torch import constants, imgproc  # noqa: E402
from playaid_core_torch.convert import load_npz_tree, resnet_state_dict  # noqa: E402
from playaid_core_torch.geometry import YoloCrop  # noqa: E402
from playaid_core_torch.infer import ai_output, detection  # noqa: E402
from playaid_core_torch.infer.detection import CharacterDetector  # noqa: E402
from playaid_core_torch.infer.pipeline import BatchedActionPipeline  # noqa: E402
from playaid_core_torch.infer.runner import AIRunner, main  # noqa: E402
from playaid_core_torch.models.detector import decode_detections  # noqa: E402
from playaid_core_torch.models.resnet import ResNet18  # noqa: E402
from playaid_core_torch.ontology import MOVE_TO_CLASS_ID  # noqa: E402
from playaid_core_torch.train.detector_train import DetectorTrainer  # noqa: E402
from playaid_core_torch.video.reader import VideoReader  # noqa: E402
from tests.synthlog import scripted_match, write_log  # noqa: E402
from tests.test_torch_port_log import private_jax_native  # noqa: E402,F401 (autouse)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(ROOT, "playaid_core_tpu", "assets", "bench_cnn63.npz")
REL_TOL = 1e-4  # of max|ref|, float32 networks
W, H, NUM_FRAMES = 320, 180, 22


def _rel_err(out, ref):
    return float(np.abs(np.asarray(out) - np.asarray(ref)).max() / np.abs(ref).max())


# ---- lossless jpg for the JAX package ----


def _store(path, img):
    with open(path, "wb") as f:
        np.save(f, np.asarray(img))
    return True


def _load(path, *flags):
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return np.load(f)


@pytest.fixture
def lossless_cv2(monkeypatch):
    monkeypatch.setattr(cv2, "imwrite", _store)
    monkeypatch.setattr(cv2, "imread", _load)


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """Separate AI caches for the two packages."""
    jax_cache, port_cache = str(tmp_path / "jax_cache"), str(tmp_path / "port_cache")
    monkeypatch.setattr(jax_constants, "AI_CACHE", jax_cache)
    monkeypatch.setattr(constants, "AI_CACHE", port_cache)
    return jax_cache, port_cache


# ---- ResNet-18 feature map and the detector ----


@pytest.fixture(scope="module")
def jax_trainer():
    return JaxDetectorTrainer(None)


@pytest.fixture(scope="module")
def det_tree(jax_trainer):
    state = jax_trainer.state
    to_np = lambda t: {k: to_np(v) if isinstance(v, dict) else np.asarray(v)  # noqa: E731
                       for k, v in t.items()}
    return {"params": to_np(state.params), "batch_stats": to_np(state.batch_stats)}


def test_resnet_feature_map_matches_jax(det_tree):
    """ResNet-18 with return_feature_map, the detector's trunk weights, at
    64x112: the stride-32 map [1, 2, 4, 512]."""
    model = make_resnet("resnet18", num_classes=0, return_feature_map=True)
    variables = {"params": det_tree["params"]["trunk"]["resnet"],
                 "batch_stats": det_tree["batch_stats"]["trunk"]["resnet"]}
    x = np.random.default_rng(0).random((1, 64, 112, 3), np.float32)
    ref = np.asarray(model.apply(variables, jnp.asarray(x)))
    net = ResNet18(num_classes=0, return_feature_map=True).eval()
    net.load_state_dict(resnet_state_dict(variables["params"], variables["batch_stats"]))
    with torch.no_grad():
        out = net(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert out.shape == ref.shape == (1, 2, 4, 512)
    assert _rel_err(out, ref) <= REL_TOL


@pytest.mark.parametrize("hw, batch", [((64, 112), 1), ((256, 448), 2)])
def test_centernet_matches_jax(jax_trainer, det_tree, hw, batch):
    """Full width (ResNet-18, 256/128/128, 6 classes) from the JAX
    trainer's seeded init: heatmap, size and offset."""
    x = np.random.default_rng(1).random((batch, *hw, 3), np.float32)
    ref = jax_trainer.model.apply(det_tree, jnp.asarray(x))
    port = DetectorTrainer(device="cpu").load_variables(det_tree)
    with torch.no_grad():
        out = port.model(torch.from_numpy(x))
    for name in ("heatmap", "size", "offset"):
        r = np.asarray(ref[name])
        assert out[name].shape == r.shape and out[name].dtype == torch.float32
        assert _rel_err(out[name].numpy(), r) <= REL_TOL, name


def _sharp_tree(det_tree):
    """The seeded tree with a heatmap head whose peaks stand apart (the
    seeded head is flat near its -2.19 prior) and boxes of a few cells."""
    tree = {"params": dict(det_tree["params"]), "batch_stats": det_tree["batch_stats"]}
    hm = dict(tree["params"]["heatmap_out"])
    hm["kernel"] = np.asarray(hm["kernel"]) * 400.0
    size = dict(tree["params"]["size_out"])
    size["bias"] = np.array([14.0, 20.0], np.float32)
    tree["params"]["heatmap_out"], tree["params"]["size_out"] = hm, size
    return tree


def _maps(jax_trainer, tree, x):
    ref = jax_trainer.model.apply(tree, jnp.asarray(x))
    return {k: np.asarray(v) for k, v in ref.items()}


def _plateau(maps):
    """Two neighbouring cells of one class share the image's top score
    (and have no offset, so their boxes name their cells)."""
    maps = {k: v.copy() for k, v in maps.items()}
    hm = maps["heatmap"]
    hm[0, 3, 5, 2] = hm[0, 3, 6, 2] = hm.max() + 1.0
    maps["offset"][0, 3, 5:7] = 0.0
    return maps


@pytest.mark.parametrize("case", ["all_classes", "class_mask", "plateau"])
def test_decode_matches_jax(jax_trainer, det_tree, case):
    x = np.random.default_rng(2).random((2, 64, 112, 3), np.float32)
    maps = _maps(jax_trainer, _sharp_tree(det_tree), x)
    if case == "plateau":
        maps = _plateau(maps)
    mask = np.array([0, 0, 1, 1, 0, 0], np.float32) if case == "class_mask" else None
    ref = jax_detector.decode_detections({k: jnp.asarray(v) for k, v in maps.items()}, max_det=8,
                                         class_mask=None if mask is None else jnp.asarray(mask))
    out = decode_detections({k: torch.tensor(v) for k, v in maps.items()}, max_det=8,
                            class_mask=None if mask is None else torch.from_numpy(mask))
    boxes, scores, cls = (np.asarray(r) for r in ref)
    assert out[2].numpy().tolist() == cls.tolist()
    np.testing.assert_allclose(out[0].numpy(), boxes, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out[1].numpy(), scores, rtol=0, atol=1e-6)
    if mask is not None:
        assert set(cls.ravel().tolist()) <= {2, 3}
    if case == "plateau":  # the tie goes to the lower flattened index, as lax.top_k
        assert out[2][0, :2].tolist() == [2, 2]
        width = maps["heatmap"].shape[2]
        np.testing.assert_allclose(out[0][0, :2, 0].numpy() * width, [5, 6], rtol=0, atol=1e-5)


def test_detect_matches_jax(jax_trainer, det_tree):
    """detect() on frames already at 256x448 (the resize is the identity in
    both), with the class restriction and a threshold these weights meet."""
    tree = _sharp_tree(det_tree)
    seeded = jax_trainer.state
    jax_trainer.state = seeded.replace(params=tree["params"])
    frames = np.random.default_rng(3).integers(0, 256, (2, 256, 448, 3), dtype=np.uint8)
    port = DetectorTrainer(device="cpu").load_variables(tree)
    refs = {}
    try:
        for classes in (None, (2, 3)):
            refs[classes] = jax_trainer.detect(frames, max_det=6, score_threshold=0.5,
                                               classes=classes)
    finally:
        jax_trainer.state = seeded
    for classes, ref in refs.items():
        out = port.detect(frames, max_det=6, score_threshold=0.5, classes=classes)
        assert [len(d) for d in out] == [len(d) for d in ref] and sum(map(len, ref)) > 0
        for d_out, d_ref in zip(out, ref):
            assert [c for c, _, _ in d_out] == [c for c, _, _ in d_ref]
            np.testing.assert_allclose([s for _, s, _ in d_out], [s for _, s, _ in d_ref],
                                       rtol=0, atol=1e-5)
            np.testing.assert_allclose([b for _, _, b in d_out], [b for _, _, b in d_ref],
                                       rtol=0, atol=1e-5)


# ---- the OpenCV and PIL operations ----


@pytest.mark.parametrize("kind", ["linear", "area", "area_float"])
def test_resize_matches_cv2(kind):
    """Bit for bit on random sizes (shrink, enlarge, mixed, 2x), 1 and 3
    channels; and the detector's 720p -> 256x448 on the torch path."""
    rng = np.random.default_rng(4)
    flag = cv2.INTER_LINEAR if kind == "linear" else cv2.INTER_AREA
    sizes = [(int(a), int(b), int(c), int(d)) for a, b, c, d in rng.integers(2, 260, (60, 4))]
    sizes += [(120, 200, 60, 100), (90, 60, 30, 20), (64, 64, 128, 128)]
    for i, (sh, sw, dh, dw) in enumerate(sizes):
        if kind == "area_float":
            img = (rng.random((sh, sw)) * 255).astype(np.float32)
        else:
            img = rng.integers(0, 256, (sh, sw, 3) if i % 2 else (sh, sw), dtype=np.uint8)
        ref = cv2.resize(img, (dw, dh), interpolation=flag)
        out = imgproc.resize(img, (dw, dh), "linear" if kind == "linear" else "area")
        assert out.dtype == ref.dtype and np.array_equal(out, ref), (sh, sw, dh, dw)
    frames = rng.integers(0, 256, (2, 720, 1280, 3), dtype=np.uint8)
    out = imgproc.resize_linear_u8(torch.from_numpy(frames), (256, 448)).numpy()
    for frame, o in zip(frames, out):
        assert np.array_equal(o, cv2.resize(frame, (448, 256)))


def test_pad_matches_pil():
    rng = np.random.default_rng(5)
    for sh, sw, size in rng.integers(1, 150, (80, 3)):
        img = rng.integers(0, 256, (int(sh), int(sw), 3), dtype=np.uint8)
        try:
            ref = np.array(ImageOps.pad(Image.fromarray(img), (int(size),) * 2, color="black"))
        except ValueError:
            with pytest.raises(ValueError):
                imgproc.pad(img, (int(size),) * 2)
            continue
        assert np.array_equal(imgproc.pad(img, (int(size),) * 2), ref)


@pytest.mark.parametrize("pad", [0, 30, 0.125, 7])
def test_square_crop_matches_jax(pad):
    """Random frames and boxes, edge boxes included, pixel padding and
    fractional padding: identical crops, identical refusals."""
    rng = np.random.default_rng([6, int(pad * 1000)])
    checked = 0
    for t in range(30):
        h, w = int(rng.integers(60, 300)), int(rng.integers(60, 400))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        box = (float(rng.uniform(-0.05, 1.05)), float(rng.uniform(0.0, 1.0)),
               float(rng.uniform(0.01, 0.6)), float(rng.uniform(0.01, 0.6)))
        size = [128, 64, 96][t % 3]
        ok_ref, ref = JaxYoloCrop(*box).square_crop(img, size, padding=pad)
        ok, out = YoloCrop(*box).square_crop(img, size, padding=pad)
        assert ok == ok_ref
        if ok:
            assert np.array_equal(out, ref), (h, w, box, pad, size)
            checked += 1
    assert checked > 20


def test_square_crop_below_the_frame_is_refused():
    """A window wholly below the frame: the port refuses it, (False,
    None), as the JAX function means to; the JAX function raises
    ZeroDivisionError inside ImageOps.pad first (ROADMAP.md, queue 3)."""
    img = np.zeros((100, 200, 3), np.uint8)
    box = (0.5, 1.3, 0.05, 0.05)
    with pytest.raises(ZeroDivisionError):
        JaxYoloCrop(*box).square_crop(img, 64, padding=0)
    assert YoloCrop(*box).square_crop(img, 64, padding=0) == (False, None)


def test_imgproc_refuses_what_it_does_not_compute():
    img = np.zeros((10, 12, 3), np.uint8)
    with pytest.raises(ValueError, match="interpolation"):
        imgproc.resize(img, (5, 5), "cubic")
    with pytest.raises(TypeError, match="uint8 or float32"):
        imgproc.resize(img.astype(np.float64), (5, 5))
    with pytest.raises(ValueError):
        imgproc.pad(img[:0], (8, 8))


def test_yolo_crop_string_and_interp():
    line = "3 0.25 0.5 0.1 0.2 0.87"
    a, ref = YoloCrop.from_string(line), JaxYoloCrop.from_string(line)
    assert str(a) == str(ref) == line
    b = YoloCrop(0.75, 0.25, 0.3, 0.1, confidence=0.5, class_id=3)
    rb = JaxYoloCrop(0.75, 0.25, 0.3, 0.1, confidence=0.5, class_id=3)
    for p in (0.0, 1 / 3, 0.5, 1.0):
        assert str(a.interp(b, p)) == str(ref.interp(rb, p))
    assert a.xyxy_pixels(1280, 720) == ref.xyxy_pixels(1280, 720)
    assert a.yolo_pixels(1280, 720) == ref.yolo_pixels(1280, 720)


# ---- a clip, and the detectors' caches ----


def _textured_frames(num_frames, seed=0):
    """BGR frames: a noise background and two coloured squares on smooth
    tracks (Pikachu from the left, Joker from the right)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 90, (H, W, 3), dtype=np.uint8)
    frames = np.repeat(base[None], num_frames, axis=0)
    for i in range(num_frames):
        for cx, colour in ((0.3 + 0.02 * i, (40, 220, 220)), (0.7 - 0.02 * i, (160, 40, 40))):
            x0, y0 = int(cx * W) - 14, int(0.5 * H) - 20
            frames[i, y0:y0 + 40, x0:x0 + 28] = colour
    return frames


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pixels") / "clips" / "clip.mp4")
    os.makedirs(os.path.dirname(path))
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 60, (W, H))
    for frame in _textured_frames(NUM_FRAMES + 3):
        writer.write(frame)
    writer.release()
    return path


class FakeTrainer:
    """A trained DetectorTrainer stand-in: two fixed detections."""

    def detect(self, images_rgb, max_det=4, score_threshold=0.3, classes=None):
        return [[(2, 0.9, (0.3, 0.5, 0.2, 0.3)), (3, 0.85, (0.7, 0.5, 0.2, 0.3))]
                for _ in range(images_rgb.shape[0])]


class PhantomTrainer:
    """Joker's true peak dips below a persistent phantom far away."""

    def __init__(self):
        self.frame = -1

    def detect(self, images_rgb, max_det=4, score_threshold=0.3, classes=None):
        out = []
        for _ in range(images_rgb.shape[0]):
            self.frame += 1
            cands = [(2, 0.50, (0.3, 0.5, 0.2, 0.3))]
            if self.frame < 2:
                cands.append((3, 0.60, (0.7, 0.5, 0.2, 0.3)))
            else:
                cands.append((3, 0.35, (0.71, 0.51, 0.2, 0.3)))
                cands.append((3, 0.45, (0.25, 0.85, 0.2, 0.3)))
            out.append(cands)
        return out


def _cache_files(base):
    labels = {n: open(os.path.join(base, "labels", n), "rb").read()
              for n in sorted(os.listdir(os.path.join(base, "labels")))}
    crops = {}
    for fighter in sorted(os.listdir(os.path.join(base, "crops"))):
        d = os.path.join(base, "crops", fighter)
        for n in os.listdir(d):
            crops[(fighter, os.path.splitext(n)[0])] = _load(os.path.join(d, n))
    return labels, crops


@pytest.mark.parametrize("case", ["plain", "tracking_prior"])
def test_character_detector_matches_jax(clip, caches, lossless_cv2, case):
    """Label files byte for byte, the same crops, pixel for pixel."""
    make = FakeTrainer if case == "plain" else PhantomTrainer
    kw = dict(batch_size=4) if case == "plain" else dict(batch_size=3, track_weight=1.0)
    exp = "vids/clip"
    JaxCharacterDetector(make(), **kw).run(clip, exp)
    CharacterDetector(make(), **kw).run(clip, exp)
    ref_labels, ref_crops = _cache_files(os.path.join(caches[0], exp))
    labels, crops = _cache_files(os.path.join(caches[1], exp))
    assert len(labels) == NUM_FRAMES + 3 and labels == ref_labels
    assert sorted(crops) == sorted(ref_crops)
    assert all(np.array_equal(crops[k], ref_crops[k]) for k in crops)
    if case == "tracking_prior":  # Joker's crop stays on the established track
        for i in range(3, 7):
            line = [ln for ln in labels[f"clip_{i}.txt"].decode().splitlines()
                    if ln.startswith("3 ")]
            assert line and abs(float(line[0].split()[1]) - 0.71) < 0.02


@pytest.mark.parametrize("pattern", ["forward", "backward", "far", "iter", "past_end", "missing"])
def test_video_reader_matches_jax(clip, monkeypatch, pattern):
    """The same frames, in the same order, through the capture seam; a
    jump past the forward budget seeks (``far`` shrinks the budget)."""
    if pattern == "missing":
        for reader in (JaxVideoReader, VideoReader):
            with pytest.raises(IOError):
                reader(clip[:-4] + "_missing.mp4")
        return
    if pattern == "far":
        monkeypatch.setattr(JaxVideoReader, "MAX_FORWARD_DECODE", 2)
        monkeypatch.setattr(VideoReader, "MAX_FORWARD_DECODE", 2)
    ref, out = JaxVideoReader(clip), VideoReader(clip)
    try:
        assert (out.fps, out.width, out.height, out.frame_count) == \
            (ref.fps, ref.width, ref.height, ref.frame_count) == (60.0, W, H, NUM_FRAMES + 3)
        if pattern == "iter":
            spans = [(4, 9), (0, 2), (NUM_FRAMES, None)]
            got = [f for a, b in spans for f in out.iter_frames(a, b)]
            want = [f for a, b in spans for f in ref.iter_frames(a, b)]
            assert [i for i, _ in got] == [i for i, _ in want] == \
                [4, 5, 6, 7, 8, 0, 1, NUM_FRAMES, NUM_FRAMES + 1, NUM_FRAMES + 2]
            assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(got, want))
            return
        reads = {"forward": [0, 1, 2, 5, 9], "backward": [6, 7, 2, 3], "far": [0, 9, 4, 12],
                 "past_end": [3, NUM_FRAMES + 10, 1]}[pattern]
        for i in reads:
            (ok, frame), (ok_ref, frame_ref) = out.read_at(i), ref.read_at(i)
            assert ok == ok_ref == (i < NUM_FRAMES + 3), i
            assert (frame is None and frame_ref is None) or np.array_equal(frame, frame_ref), i
    finally:
        out.release()
        ref.release()


def test_label_helpers_match_jax(tmp_path):
    path = str(tmp_path / "clip_12.txt")
    with open(path, "w") as f:
        f.write("3 0.7 0.5 0.2 0.3 0.9\n2 0.3 0.5 0.2 0.3 0.85\n2 0.6 0.8 0.2 0.3 0.4\n")
    assert [str(c) for c in detection.read_yolo_crops(path)] == \
        [str(c) for c in jax_detection.read_yolo_crops(path)]
    for fighter in ("Pikachu", "Joker", constants.CHAR_LIST[0]):
        assert str(detection.read_fighter_yolo_crop(path, fighter)) == \
            str(jax_detection.read_fighter_yolo_crop(path, fighter))
    for name in ("clip_12.txt", "a/b/vid_7.npy", "x_003.jpg"):
        assert detection.extract_number_from_filename(name) == \
            jax_detection.extract_number_from_filename(name)
    with pytest.raises(ValueError):
        detection.extract_number_from_filename("clip.txt")


def test_external_yolo_detector_matches_jax(tmp_path, monkeypatch):
    """The same YOLOv5 command line, and no run when the crops exist."""
    cache = str(tmp_path / "cache")
    monkeypatch.setattr(jax_constants, "AI_CACHE", cache)
    monkeypatch.setattr(constants, "AI_CACHE", cache)
    calls = []
    monkeypatch.setattr(subprocess, "run", lambda cmd, check: calls.append((cmd, check)))
    kw = dict(weights="w.pt", yolo_dir="yolov5", classes=(2, 3), max_det=2)
    for make in (jax_detection.ExternalYoloDetector, detection.ExternalYoloDetector):
        assert make(**kw).run("vids/clip.mp4", "vids/clip") == "vids/clip"
    assert len(calls) == 2 and calls[0] == calls[1] and calls[0][1] is True
    assert calls[0][0][:3] == ["python", os.path.join("yolov5", "detect.py"), "--weights"]
    os.makedirs(os.path.join(cache, "vids", "clip", "crops"))
    detection.ExternalYoloDetector(**kw).run("vids/clip.mp4", "vids/clip")
    assert len(calls) == 2


@pytest.mark.parametrize("log_offset", [0, 3])
def test_projection_detector_matches_jax(tmp_path, log_offset):
    path = str(tmp_path / "log.txt")
    write_log(path, scripted_match(40))
    ref = jax_detection.ProjectionDetector(path, log_offset=log_offset)
    out = detection.ProjectionDetector(path, log_offset=log_offset)
    assert len(out) == len(ref) == 40 - log_offset
    for i in range(len(ref)):
        a, b = out.crops_for_frame(i), ref.crops_for_frame(i)
        assert sorted(a) == sorted(b) and len(a) == 2
        for name in a:
            np.testing.assert_allclose(a[name].yolo_crop(), b[name].yolo_crop(), rtol=0, atol=1e-6)


# ---- AIRunner ----


def _fake_detector(write, defect):
    """A YOLOv5-style cache with the JAX tests' defects: Pikachu misses the
    head (1-2) and frames 8-10 and has a duplicate on frame 5; Joker misses
    the tail.  ``defect`` adds a centre jump, an identity swap or crops in
    the other fighter's colours."""

    class Detector:
        def run(self, input_video_path, exp_name):
            base = os.path.join(write.cache(), exp_name)
            if os.path.exists(os.path.join(base, "crops")):
                return exp_name
            video_name = os.path.splitext(os.path.basename(input_video_path))[0]
            rng = np.random.default_rng(0)
            for fighter in ("Pikachu", "Joker"):
                os.makedirs(os.path.join(base, "crops", fighter), exist_ok=True)
            os.makedirs(os.path.join(base, "labels"), exist_ok=True)
            for i in range(1, NUM_FRAMES + 1):
                lines = []
                for class_id, fighter in ((2, "Pikachu"), (3, "Joker")):
                    if fighter == "Pikachu" and (8 <= i <= 10 or i <= 2):
                        continue
                    if fighter == "Joker" and i > NUM_FRAMES - 3:
                        continue
                    cx = 0.3 + 0.02 * i if fighter == "Pikachu" else 0.7 - 0.02 * i
                    cid = class_id
                    if defect == "jump" and fighter == "Pikachu" and i in (12, 13, 14):
                        cx = 0.92
                    if defect == "swap":
                        cx = 0.15 + 0.005 * i if fighter == "Pikachu" else 0.85 - 0.005 * i
                        if 12 <= i <= 18:
                            cid = 5 - class_id
                    lines.append(f"{cid} {cx} 0.5 0.2 0.3 0.9")
                    if fighter == "Pikachu" and i == 5:
                        lines.append(f"{class_id} {cx + 0.3} 0.8 0.2 0.3 0.4")
                    crop = rng.integers(0, 255, (128, 128, 3), dtype=np.uint8)
                    if defect == "appearance":
                        colour = (160, 40, 40) if fighter == "Joker" or 10 <= i <= 14 \
                            else (40, 220, 220)
                        crop[32:96, 32:96] = colour
                    write(os.path.join(base, "crops", fighter, f"{video_name}_{i}"), crop)
                with open(os.path.join(base, "labels", f"{video_name}_{i}.txt"), "w") as f:
                    f.write("\n".join(lines) + ("\n" if lines else ""))
            return exp_name

    return Detector()


def _jax_writer(path, crop):
    cv2.imwrite(path + ".jpg", crop)


def _port_writer(path, crop):
    np.save(path + ".npy", crop)


_jax_writer.cache = lambda: jax_constants.AI_CACHE
_port_writer.cache = lambda: constants.AI_CACHE


@pytest.fixture(scope="module")
def bench_tree():
    return load_npz_tree(ASSET)


@pytest.fixture(scope="module")
def jax_pipe():
    return JaxPipeline(family="cnn", num_actions=63, sequence_length=7, frame_delta=3)


@pytest.fixture(scope="module")
def port_pipe(bench_tree):
    return BatchedActionPipeline(device="cpu").load_variables(bench_tree)


def _runners(clip, jax_pipe, port_pipe, bench_tree, defect, **kw):
    ref = JaxAIRunner(clip, detector=_fake_detector(_jax_writer, defect), pipeline=jax_pipe,
                      variables=bench_tree, **kw)
    out = AIRunner(clip, detector=_fake_detector(_port_writer, defect), pipeline=port_pipe, **kw)
    return ref, out


def _crops_by_frame(runner, fighter):
    return {int(os.path.splitext(p)[0].rsplit("_", 1)[1]): _load(p)
            for p in runner.get_crop_paths(fighter)}


@pytest.mark.parametrize("defect, kw", [("plain", {}), ("jump", {}),
                                        ("swap", {"fix_swaps": True}), ("appearance", {})])
def test_ai_runner_cleanup_matches_jax(clip, caches, lossless_cv2, jax_pipe, port_pipe,
                                       bench_tree, defect, kw):
    """Duplicates, the gap, head and tail fill, and the jump, swap and
    appearance filters: identical label files, and the same frames hold
    the same crops (interpolated ones re-cut from the video)."""
    ref, out = _runners(clip, jax_pipe, port_pipe, bench_tree, defect, **kw)
    ref.run_detection_setup()
    out.run_detection_setup()
    assert out.max_frames == ref.max_frames == NUM_FRAMES
    for i in range(1, NUM_FRAMES + 1):
        assert open(out.get_label_path(i)).read() == open(ref.get_label_path(i)).read(), i
    for fighter in ("Pikachu", "Joker"):
        a, b = _crops_by_frame(out, fighter), _crops_by_frame(ref, fighter)
        assert sorted(a) == sorted(b) and all(np.array_equal(a[i], b[i]) for i in a)
        assert all(p.endswith(".npy") for p in out.get_crop_paths(fighter))


@pytest.mark.parametrize("decode, smooth_radius", [("argmax", 0), ("viterbi", 2)])
def test_ai_runner_recognition_matches_jax(clip, caches, lossless_cv2, jax_pipe, port_pipe,
                                           bench_tree, decode, smooth_radius):
    """The bench weights at crop 128, sequence 7, delta 3: identical actions
    and action_raw, confidences within 1e-3 relative, and yaml.safe_load of
    the port's ai_output.yaml equals the JAX runner's dict."""
    kw = dict(decode=decode, smooth_radius=smooth_radius, switch_cost=16.0)
    ref, out = _runners(clip, jax_pipe, port_pipe, bench_tree, "plain", **kw)
    for runner in (ref, out):
        runner.run_detection_setup()
        runner.run_action_recognition()
        runner.write_output()
    want = ref.ai_output_data.to_dict()
    got = out.ai_output_data.to_dict()
    assert sorted(got) == sorted(want) == ["Joker", "Pikachu"]
    for fighter in want:
        assert sorted(got[fighter]) == sorted(want[fighter]) == list(range(NUM_FRAMES - 1))
        for i, rec in want[fighter].items():
            assert {k: v for k, v in got[fighter][i].items() if k != "predicted_action_confidence"} \
                == {k: v for k, v in rec.items() if k != "predicted_action_confidence"}
            np.testing.assert_allclose(got[fighter][i]["predicted_action_confidence"],
                                       rec["predicted_action_confidence"], rtol=1e-3)
        assert ("action_raw" in want[fighter][0]) == (decode == "viterbi")
    with open(out.ai_output_file) as f:
        loaded = yaml.safe_load(f)
    assert loaded == got
    # The cache is read back: a second runner skips recognition.
    again = AIRunner(clip, detector=_fake_detector(_port_writer, "plain"), pipeline=port_pipe)
    assert again.ai_output_data.to_dict() == got


def test_ai_output_emitter_round_trip(tmp_path):
    tree = {"Joker": {0: {"action": "Wait", "crop": "3 0.1 0.5 0.2 0.3 0.9",
                          "predicted_action_confidence": 12.5, "damage": 1e-05},
                      1: {"action": "null", "damage": -1, "x": float("inf"), "y": None,
                          "flag": True, "quote": 'say "hi"\n', "big": 1e20}},
             "Pikachu": {}}
    text = ai_output.dumps(tree)
    assert yaml.safe_load(text) == tree == ai_output.loads(text)
    path = str(tmp_path / "ai_output.yaml")
    ai_output.write(path, tree)
    assert ai_output.read(path) == tree


@pytest.mark.parametrize("text", [
    "\"Joker\":\n  0: 'Wait'\n",              # single-quoted scalar
    "\"Joker\":\n  0: Wait\n",                # plain string scalar
    "Joker:\n  0: 1\n",                       # plain string key
    "\"Joker\":\n  - 1\n",                    # a sequence
    "\"Joker\":\n   0: 1\n",                  # an odd indent
    "\"Joker\":\n\"Pikachu\": {}\n",          # a mapping head with nothing in it
    "\"Joker\": 1\n\"Joker\": 2\n",           # a key twice
    "\"Joker\":1\n",                          # no space after the colon
    "\"Joker\": {\"a\": 1}\n",                # a flow mapping
    "\"Joker\": 1.5e3\n",                     # not PyYAML's float spelling
])
def test_ai_output_reader_refuses_other_yaml(text):
    """The reader parses what the emitter writes and raises on the rest,
    rather than read YAML it does not understand into a different tree."""
    with pytest.raises(ValueError, match="ai_output"):
        ai_output.loads(text)


def test_ai_runner_command_line(clip, caches, capsys):
    """``python -m playaid_core_torch.infer.runner --video V --device cpu``
    over a cache the YOLOv5 seam finds in place: cleanup, recognition with
    seeded weights (and the warning that says so), OCR, ai_output.yaml."""
    _fake_detector(_port_writer, "plain").run(clip, "clips/clip")
    main(["--video", clip, "--device", "cpu"])
    captured = capsys.readouterr()
    assert captured.out.splitlines()[-1] == "COMPLETED" and "random initialization" in captured.err
    tree = ai_output.read(os.path.join(constants.AI_CACHE, "clips", "clip", "ai_output.yaml"))
    assert sorted(tree) == ["Joker", "Pikachu"]
    for frames in tree.values():
        assert sorted(frames) == list(range(NUM_FRAMES))
        assert all("damage" in frames[i] for i in frames)
        assert all(frames[i]["action"] in MOVE_TO_CLASS_ID for i in range(NUM_FRAMES - 1))


def test_ai_runner_defaults_to_cuda(clip, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        AIRunner(clip)
    with pytest.raises(RuntimeError, match="CUDA"):
        DetectorTrainer()


def _holds_numpy(obj):
    return any(isinstance(v, np.ndarray) for v in vars(obj).values())


def test_weights_load_once_into_the_modules(clip, caches, det_tree, bench_tree):
    """Action, detector and digit weights are in the modules on the device
    after construction, and nothing of the numpy trees is kept."""
    from playaid_core_torch.infer.ocr_conv import ConvDigitOCR, load_params

    pipe = BatchedActionPipeline(device="cpu")
    runner = AIRunner(clip, pipeline=pipe, variables=bench_tree,
                      detector=_fake_detector(_port_writer, "plain"))
    assert pipe.initialized and not _holds_numpy(runner) and not _holds_numpy(pipe)
    trainer = DetectorTrainer(device="cpu").load_variables(det_tree)
    digits = load_params()
    ocr = ConvDigitOCR(params=digits, device="cpu")
    for module, obj in ((trainer.model, trainer), (ocr.model, ocr)):
        assert not _holds_numpy(obj)
        assert all(isinstance(p, torch.nn.Parameter) and p.device == obj.device
                   for p in module.parameters())
    kernel = det_tree["params"]["heatmap_out"]["kernel"]
    w = trainer.model.heads["heatmap"][2].weight
    np.testing.assert_array_equal(w.detach().numpy(), np.asarray(kernel).transpose(3, 2, 0, 1))
    digits["params"]["c1"]["kernel"][...] = 0  # the tree is not shared with the modules
    assert ocr.model.c1.weight.abs().max() > 0
