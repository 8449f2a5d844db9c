"""The port stands alone: it imports nothing of JAX or of playaid_core_tpu,
its card-path modules (the log-driven VOD path, the pixels-only path, the
training path and its mesh, the sprite drawer and splits, device-side
synthesis and detector training) import no cv2,
PIL, yaml or click, the OCR, dashboard and annotated-match modules not
matplotlib either (nor tqdm), the ground-truth and char_loader modules not
pandas
(the card's machine has none of them), and chip_smoke.py refuses to run
without a CUDA device.

The import check runs in a subprocess, because tests/conftest.py imports
jax into the test process.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "playaid_core_tpu")

_IMPORT_ALL = f"""
import importlib, pkgutil, sys
for name in {BANNED!r}:
    sys.modules[name] = None
import playaid_core_torch
names = [m.name for m in pkgutil.walk_packages(playaid_core_torch.__path__,
                                               "playaid_core_torch.")]
for name in names:
    importlib.import_module(name)
print(" ".join(sorted(names)))
"""


# Modules the log-driven VOD path imports on the card.
CARD_PATH = ("constants", "ontology", "frame_data", "geometry", "fighter", "native", "timeline",
             "infer.vod_pipeline")
HOST_ONLY = ("cv2", "PIL", "yaml", "click")

_IMPORT_CARD_PATH = f"""
import importlib, sys
for name in {BANNED + HOST_ONLY!r}:
    sys.modules[name] = None
for name in {CARD_PATH!r}:
    importlib.import_module("playaid_core_torch." + name)
from playaid_core_torch.infer.vod_pipeline import boxes_from_log, main
print("ok")
"""

# Modules the pixels-only path (AIRunner, the detector, OCR) imports on the card.
PIXELS_PATH = ("imgproc", "imgcodec", "geometry", "models.detector", "train.detector_train",
               "video.reader", "infer.detection", "infer.ocr", "infer.ocr_conv",
               "infer.ai_output", "infer.runner")

_IMPORT_PIXELS_PATH = f"""
import importlib, os, sys, tempfile
for name in {BANNED + HOST_ONLY!r}:
    sys.modules[name] = None
for name in {PIXELS_PATH!r}:
    importlib.import_module("playaid_core_torch." + name)
from playaid_core_torch import imgcodec
from playaid_core_torch.infer import ai_output
from playaid_core_torch.infer.runner import AIRunner, main
tree = {{"Joker": {{0: {{"action": "Wait", "damage": 12.5}}}}}}
path = os.path.join(tempfile.mkdtemp(), "ai_output.yaml")
ai_output.write(path, tree)
assert ai_output.read(path) == tree  # no yaml: the emitter's own reader
try:
    imgcodec.read_crop(path[:-4] + "jpg")
except ImportError as e:
    assert "cv2" in str(e)
else:
    raise AssertionError("a jpg crop was read without cv2")
print("ok")
"""


# Modules the training path (Trainer.fit on a tree of .npy crops) imports on the card.
TRAIN_PATH = ("models.losses", "models.cnn_action_detector", "models.rnn_action_detector",
              "models.resnet_transformer", "parallel.staging", "profiling", "timeline",
              "train.augment", "train.dataset", "train.train", "datagen.skeletal_sprites",
              "train.device_synth", "parallel.mesh", "parallel.dryrun", "draw",
              "datagen.gen_synth_video_actions")

# The augment ops run without cv2 or PIL; the synth split's JPEG degrade and
# the video generator's jpg frames name cv2.
_IMPORT_TRAIN_PATH = f"""
import importlib, sys
import numpy as np
for name in {BANNED + HOST_ONLY!r}:
    sys.modules[name] = None
for name in {TRAIN_PATH!r}:
    importlib.import_module("playaid_core_torch." + name)
from playaid_core_torch.datagen import gen_synth_video_actions
from playaid_core_torch.train import augment, dataset
from playaid_core_torch.train.train import Trainer, main
rng = np.random.default_rng(0)
img = rng.integers(0, 256, (40, 30, 3), dtype=np.uint8)
sprite = rng.integers(0, 256, (50, 30, 4), dtype=np.uint8)
for level in (1, 2):
    out = augment.augment_char_crop(img, rng=rng, output_size=32,
                                    **augment.SYNTH_DIFFICULTY_REAL[level])
    assert out.shape == (32, 32, 3)
    out = augment.augment_synth_char_crop(sprite, rng=rng, output_size=32,
                                          **augment.SYNTH_DIFFICULTY_SPRITE[level])
    assert out.shape == (32, 32, 4)
for call in (lambda: dataset.jpeg_degrade(img, 50),
             lambda: gen_synth_video_actions._write_jpg("f.jpg", img)):
    try:
        call()
    except ImportError as e:
        assert "cv2" in str(e)
    else:
        raise AssertionError("a jpg was encoded without cv2")
print("ok")
"""


# Device-side synthesis on a .npy tree (BGRA sprites, BGR stages), as the
# card's machine runs it: banks, one composited batch; a sprite drawn and a
# tree written as .npy without cv2, the PNG writer's refusal.
_SYNTH_ON_NPY = f"""
import os, sys, tempfile
import numpy as np
for name in {BANNED + HOST_ONLY!r}:
    sys.modules[name] = None
from playaid_core_torch.datagen import skeletal_sprites
from playaid_core_torch.train.device_synth import DeviceSynthDataset
root = tempfile.mkdtemp()
rng = np.random.default_rng(0)
for move in ("Wait", "Jab"):
    d = os.path.join(root, "clean", "Byleth", move)
    os.makedirs(d)
    for i in range(3):
        sprite = rng.integers(0, 256, (110 + 20 * i, 104, 4), dtype=np.uint8)
        np.save(os.path.join(d, f"byleth_c00_{{move.lower()}}_frame_90_{{i}}.npy"), sprite)
os.makedirs(os.path.join(root, "stages"))
np.save(os.path.join(root, "stages", "a.npy"), rng.integers(0, 256, (200, 240, 3), dtype=np.uint8))
ds = DeviceSynthDataset(["Wait", "Jab", "Unknown"], ["Byleth"], os.path.join(root, "clean"),
                        os.path.join(root, "stages"), num_frames_per_sample=3, crop_size=32,
                        stage_patch=64, device="cpu")
frames, chars, labels = next(ds.device_batches(2))
assert tuple(frames.shape) == (2, 3, 32, 32, 3) and ds.sprites.num_sprites == 6
sprite = skeletal_sprites.render_sprite("Byleth", "Jab", 0.5, variant_seed=3)
assert sprite.shape == (176, 176, 4) and sprite[..., 3].any()
assert skeletal_sprites.generate_sprite_set(os.path.join(root, "drawn"), fighters=["Joker"],
                                            moves=["Jab"], frames_per_move=1, fmt="npy") == 2
try:
    skeletal_sprites.generate_sprite_set(os.path.join(root, "png"), fighters=["Joker"],
                                         moves=["Jab"], frames_per_move=1, fmt="png")
except ImportError as e:
    assert "cv2" in str(e)
else:
    raise AssertionError("a PNG sprite was written without cv2")
print("ok")
"""


# Modules the detector-training path imports on the card, and a run on a
# .npy tree there: a sample, the refusal of cv2's augmentation, a jpg read.
DETECTOR_TRAIN_PATH = ("models.detector", "train.detector_train", "train.dataset",
                       "datagen.gen_synth_char_detection")

_DETECTOR_TRAIN_ON_NPY = f"""
import importlib, os, sys, tempfile
import numpy as np
for name in {BANNED + HOST_ONLY!r}:
    sys.modules[name] = None
for name in {DETECTOR_TRAIN_PATH!r}:
    importlib.import_module("playaid_core_torch." + name)
from playaid_core_torch.train.detector_train import DetectionDataset, DetectorTrainer, main
root = tempfile.mkdtemp()
for sub in ("images", "labels"):
    os.makedirs(os.path.join(root, sub))
rng = np.random.default_rng(0)
np.save(os.path.join(root, "images", "a.npy"), rng.integers(0, 256, (72, 128, 3), dtype=np.uint8))
with open(os.path.join(root, "labels", "a.txt"), "w") as f:
    f.write("1 0.5 0.5 0.25 0.5\\n")
img, (heat, size, offset, mask), _ = DetectionDataset(root, input_hw=(64, 96), num_classes=2,
                                                      seed=0).sample(uint8=True)
assert img.shape == (64, 96, 3) and heat.shape == (16, 24, 2) and mask.sum() == 1
try:
    DetectionDataset(root, sample_augment=True)
except ImportError as e:
    assert "cv2" in str(e)
else:
    raise AssertionError("sample_augment=True was taken without cv2")
with open(os.path.join(root, "images", "b.jpg"), "wb") as f:
    f.write(b"not read")
ds = DetectionDataset(root, input_hw=(64, 96), num_classes=2)
ds.images = [os.path.join(root, "images", "b.jpg")]
try:
    ds.sample()
except ImportError as e:
    assert "cv2" in str(e)
else:
    raise AssertionError("a jpg was read without cv2")
print("ok")
"""


# The OCR and dashboard modules on the card: they import with matplotlib
# blocked too; a vis_ai-style PNG is written and read back with zlib, and
# evaluate_samples runs; rendering and the template reader name their
# package.
OCR_VIZ_PATH = ("infer.ocr", "infer.ocr_conv", "viz.eval_dashboard", "viz.vis_ai")

_OCR_VIZ_WITHOUT_HOST_PACKAGES = f"""
import base64, importlib, struct, sys, zlib
import numpy as np
import torch
for name in {BANNED + HOST_ONLY + ("matplotlib",)!r}:
    sys.modules[name] = None
for name in {OCR_VIZ_PATH!r}:
    importlib.import_module("playaid_core_torch." + name)
from playaid_core_torch.infer import ocr, ocr_conv
from playaid_core_torch.viz import vis_ai
from playaid_core_torch.viz.eval_dashboard import _png_b64, evaluate_samples
crop = np.random.default_rng(0).integers(0, 256, (37, 23, 3), dtype=np.uint8)
png = base64.b64decode(_png_b64(crop[:, :, ::-1].copy()))
w, h, depth, colour = struct.unpack(">IIBB", png[16:26])
(n,) = struct.unpack(">I", png[33:37])  # the IDAT chunk after the IHDR
rows = np.frombuffer(zlib.decompress(png[41:41 + n]), np.uint8).reshape(h, 1 + 3 * w)
assert (w, h, depth, colour) == (23, 37, 8, 2) and not rows[:, 0].any()
assert np.array_equal(rows[:, 1:].reshape(h, w, 3), crop[:, :, ::-1])

class Dataset:
    animations = ["A", "B"]
    def __getitem__(self, i):
        return np.full((3, 8, 8, 3), i, np.uint8), 0, np.array([i % 2] * 3), {{}}

records, agg = evaluate_samples(lambda x: torch.log_softmax(x.float().mean((2, 3, 4))[:, :2], -1),
                                Dataset(), total=4)
assert agg["total"] == 4 and records[1]["frames"].dtype == np.uint8
for call, package in ((lambda: ocr_conv.train_fonts(), "matplotlib"),
                      (lambda: ocr.TemplateDigitOCR(), "PIL"),
                      (lambda: ocr_conv.synth_batch(np.random.default_rng(0), ["f.ttf"]), "cv2")):
    try:
        call()
    except ImportError as e:
        assert package in str(e), e
    else:
        raise AssertionError(package + " was not asked for")
print("ok")
"""


# The annotated-match path: the modules import with every host package
# blocked; a render with graphs and summaries runs from in-memory frames;
# stats snapshots, the post-game report's PNGs and the charts need none of
# them; the mpl backend names matplotlib and the inspection report's JPEG
# names cv2.
MANUSCRIPT_PATH = ("time_utils", "geometry", "fighter", "timeline", "stats", "draw", "text",
                   "render.compositing", "render.fastcharts", "render.charts",
                   "render.annotator", "video.native_remux", "video.writer",
                   "video.native_encoder", "video.reader", "pipeline.manuscript",
                   "pipeline.multi", "viz.postgame_report", "viz.manuscript_vis",
                   "ops.preprocess")

_MANUSCRIPT_WITHOUT_HOST_PACKAGES = f"""
import importlib, os, sys, tempfile
import numpy as np
for name in {BANNED + HOST_ONLY + ("matplotlib", "tqdm")!r}:
    sys.modules[name] = None
for name in {MANUSCRIPT_PATH!r}:
    importlib.import_module("playaid_core_torch." + name)
from playaid_core_torch import stats
from playaid_core_torch.pipeline import manuscript
from playaid_core_torch.render import annotator, charts
from playaid_core_torch.viz import manuscript_vis, postgame_report
import chip_smoke
root = tempfile.mkdtemp()
log = os.path.join(root, "log.txt")
chip_smoke.write_match_log(log, 30)
frames = [np.full((180, 320, 3), i, np.uint8) for i in range(30)]

class Reader:
    fps, width, height, frame_count = 60.0, 320, 180, 30
    def __init__(self, path):
        pass
    def iter_frames(self, start=0, stop=None):
        for i in range(start, stop or 30):
            yield i, frames[i]
    def release(self):
        pass

class Writer:
    count = 0
    def __init__(self, path, fps, width, height, codec=None):
        assert (width, height) == (1120, 580)
    def write(self, frame, copy=True):
        Writer.count += 1
    def release(self):
        pass

manuscript.VideoReader = Reader
annotator.VideoWriter = Writer
annotator.Annotator.write_num_seconds = lambda self, n: self.write()
m = manuscript.Manuscript("v.mp4", os.path.join(root, "o.mp4"), ground_truth_path=log,
                          show_timer=True, include_audio=False, progress=False)
m.render()
assert Writer.count == 30 + 5
st = stats.Stats("v.mp4")
st.output_dir = os.path.join(root, "stats")
from playaid_core_torch.timeline import load_ground_truth_from_path
st.write_all_stats(load_ground_truth_from_path(log), [], interval=10)
assert st.load_stats(20) and st.stats.history
postgame_report.write_postgame_report(log, os.path.join(root, "r.html"))
for call, package in ((lambda: charts.set_chart_backend("mpl") or charts._move_pie_chart(1, 1, 1, 60),
                       "matplotlib"),
                      (lambda: manuscript_vis._jpeg_b64(frames[0]), "cv2")):
    try:
        call()
    except ImportError as e:
        assert package in str(e), e
    else:
        raise AssertionError(package + " was not asked for")
print("ok")
"""


# The ground-truth generators, the cleaner, char_loader and gap_report on
# the card: they import with pandas blocked too; a raw dump written as PNG
# by the port's codec is cleaned and read back as sprites, a frame tree of
# .npy and PNG files is loaded, the gap report runs, and a jpg names cv2.
DATAGEN_PATH = ("imgcodec", "char_loader", "datagen.raw_anim_cleaner",
                "datagen.gen_gt_action_detection", "datagen.gen_gt_char_detection",
                "datagen.gap_report")

_DATAGEN_WITHOUT_HOST_PACKAGES = f"""
import importlib, json, os, sys, tempfile
import numpy as np
for name in {BANNED + HOST_ONLY + ("pandas",)!r}:
    sys.modules[name] = None
for name in {DATAGEN_PATH!r}:
    importlib.import_module("playaid_core_torch." + name)
from playaid_core_torch import char_loader, imgcodec
from playaid_core_torch.datagen import gap_report, gen_gt_action_detection, raw_anim_cleaner
root = tempfile.mkdtemp()
rng = np.random.default_rng(0)
raw = os.path.join(root, "raw", "byleth", "c00attack1")
os.makedirs(raw)
img = np.zeros((60, 80, 3), np.uint8)
img[10:40, 20:70] = rng.integers(2, 256, (30, 50, 3), dtype=np.uint8)
imgcodec.write_image(os.path.join(raw, "frame_0.png"), img)
assert raw_anim_cleaner.clean_all_raw_fighter_anim_data(
    "byleth", raw_dir=os.path.join(root, "raw"), clean_dir=os.path.join(root, "clean")) == 1
sprite = imgcodec.read_sprite(os.path.join(root, "clean", "byleth", "Jab", "frame_0.png"))
assert sprite.shape == (30, 50, 4) and np.array_equal(sprite[..., :3], img[10:40, 20:70])
frames = os.path.join(root, "frames", "fox")
os.makedirs(frames)
np.save(os.path.join(frames, "a.npy"), rng.integers(0, 256, (720, 1280, 3), dtype=np.uint8))
imgcodec.write_image(os.path.join(frames, "b.png"), img)
table = char_loader.dataframe_from_directory(os.path.join(root, "frames"))
feature, label = char_loader.CharacterLoader(table, seed=0)[0]
assert len(table) == 2 and feature.shape == (120, 480, 3) and label == "fox"
with open(os.path.join(root, "req.json"), "w") as f:
    json.dump({{"r1": "a@x"}}, f)
gap_report.main(["--requests", os.path.join(root, "req.json"), "--store", root])
try:
    imgcodec.write_image(os.path.join(root, "c.jpg"), img)
except ImportError as e:
    assert "cv2" in str(e)
else:
    raise AssertionError("a jpg was written without cv2")
print("ok")
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_port_imports_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    imported = set(proc.stdout.split())
    for name in ("convert", "device", "infer.pipeline", "infer.vod_pipeline", "models.resnet",
                 "models.resnet_transformer", "models.rnn_action_detector", "ops._build",
                 "models.granite_hybrid", "ops.ssd_scan",
                 "ops.conv_block", "ops.crop_kernel", "ops.preprocess", "video.native_decoder",
                 "video.native_encoder", "adict", "models.lightning_ckpt",
                 "models.torch_convert", *CARD_PATH, *PIXELS_PATH, *TRAIN_PATH,
                 *DETECTOR_TRAIN_PATH, *OCR_VIZ_PATH, *MANUSCRIPT_PATH, *DATAGEN_PATH):
        assert f"playaid_core_torch.{name}" in imported


def test_card_path_imports_with_cv2_pil_yaml_click_blocked():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_CARD_PATH], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_pixels_path_imports_with_cv2_pil_yaml_click_blocked():
    """The pixels-only path on a machine without cv2, PIL, yaml or click:
    it imports, writes and reads ai_output.yaml, and names cv2 when asked
    for a jpg crop."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_PIXELS_PATH], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_train_path_imports_with_cv2_pil_yaml_click_blocked():
    """The training path on a machine without cv2, PIL, yaml or click: it
    imports, the augmentation runs at both difficulties, and the JPEG
    encoders (the synth split's degrade, the video generator's frames)
    name cv2."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_TRAIN_PATH], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_synth_path_runs_on_npy_with_cv2_pil_yaml_click_blocked():
    """Device-side synthesis on a machine without cv2 (the card's): the
    sprite and stage banks from .npy files, a composited batch, a sprite
    drawn and a .npy sprite tree written, and the PNG writer naming cv2."""
    proc = subprocess.run([sys.executable, "-c", _SYNTH_ON_NPY], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_detector_train_path_runs_on_npy_with_cv2_pil_yaml_click_blocked():
    """Detector training on a machine without cv2, PIL, yaml or click (the
    card's): the modules import, a .npy tree is sampled, and the constructor
    refuses cv2's augmentation and a jpg read names cv2."""
    proc = subprocess.run([sys.executable, "-c", _DETECTOR_TRAIN_ON_NPY], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_ocr_and_viz_run_with_cv2_pil_yaml_click_matplotlib_blocked():
    """OCR and the dashboards on a machine without cv2, PIL, yaml, click or
    matplotlib (the card's): the modules import, an inline PNG decodes with
    zlib to its crop, evaluate_samples runs, and the font pools, the
    template reader and synth_batch name the package they need."""
    proc = subprocess.run([sys.executable, "-c", _OCR_VIZ_WITHOUT_HOST_PACKAGES], cwd=ROOT,
                          env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_manuscript_path_runs_with_host_packages_blocked():
    """The annotated-match path on a machine without cv2, PIL, matplotlib,
    yaml, click, tqdm or JAX (the card's): every module imports, a render
    with graphs, summaries and the timer runs from in-memory frames, stats
    snapshots and the post-game report are written, and the two lazy
    functions name the package they need."""
    proc = subprocess.run([sys.executable, "-c", _MANUSCRIPT_WITHOUT_HOST_PACKAGES], cwd=ROOT,
                          env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr


_GRANITE_WITHOUT_HOST_PACKAGES = f"""
import sys
for name in {BANNED + HOST_ONLY!r}:
    sys.modules[name] = None
import torch
from playaid_core_torch.infer.pipeline import BatchedActionPipeline
from playaid_core_torch.models import granite_hybrid
from playaid_core_torch.ops.ssd_scan import ssd_scan
granite_hybrid.PUBLISHED = dict(  # a tiny head in place of the published 12 GB
    granite_hybrid.PUBLISHED, hidden_size=32, layer_types=["mamba", "attention"],
    shared_intermediate_size=32, mamba_n_heads=2, mamba_d_head=32, mamba_d_state=8,
    mamba_chunk_size=4, num_attention_heads=2, num_key_value_heads=1)
pipe = BatchedActionPipeline(family="granite_hybrid", device="cpu").init(0)
buf = pipe.make_embedding_buffer(6)
labels, conf = pipe.classify_buffer(buf, 6, decode="viterbi", switch_cost=16.0)
assert tuple(labels.shape) == (6, 2)
print("ok")
"""


def test_granite_head_runs_with_host_packages_blocked():
    """The Granite hybrid head and K6's wrapper (models/granite_hybrid.py,
    ops/ssd_scan.py) on a machine without cv2, PIL, yaml, click or JAX (the
    card's): they import, and a tiny head labels a buffer through its twin."""
    proc = subprocess.run([sys.executable, "-c", _GRANITE_WITHOUT_HOST_PACKAGES], cwd=ROOT,
                          env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


@pytest.mark.parametrize("module", ["infer.ocr_conv", "infer.runner"])
def test_inference_modules_import_without_the_trainer(module):
    """The digit reader and the runner that holds it sit below the training
    layer: importing them loads no trainer (the OCR schedule lives in
    train/schedules.py)."""
    code = (f"import importlib, sys\nimportlib.import_module('playaid_core_torch.{module}')\n"
            "print('playaid_core_torch.train.train' in sys.modules)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "False", proc.stderr


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_source_names_a_banned_module():
    """Lazy imports inside functions count too: every import statement of
    the package and of chip_smoke.py is checked."""
    files = sorted((ROOT / "playaid_core_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in files:
        assert not _imported_roots(path) & set(BANNED), path


def _imported_modules(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
            names.update(f"{node.module}.{a.name}" for a in node.names)
    return names


def test_video_and_parallel_import_nothing_of_infer():
    """Imports point one way, video/ <- parallel/ <- infer/: no module under
    video/ or parallel/ imports playaid_core_torch.infer, lazily or not.
    The one exception is parallel/dryrun.py, which runs the whole system,
    as its JAX counterpart does."""
    package = ROOT / "playaid_core_torch"
    allowed = package / "parallel" / "dryrun.py"
    files = sorted((package / "video").rglob("*.py")) + sorted(allowed.parent.rglob("*.py"))
    assert allowed in files
    for path in files:
        upward = {n for n in _imported_modules(path)
                  if n == "playaid_core_torch.infer" or n.startswith("playaid_core_torch.infer.")}
        assert path == allowed or not upward, (path, upward)


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a CUDA device (as here) the smoke exits non-zero and prints
    no result line."""
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, even on a machine that has one
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_datagen_runs_with_cv2_pil_yaml_click_pandas_blocked():
    """The ground-truth generators, the raw-animation cleaner, char_loader
    and gap_report on a machine without cv2, PIL, yaml, click or pandas
    (the card's): the modules import, a PNG dump is cleaned through the
    port's codec and read back as a sprite, char_loader reads .npy and PNG
    frames, the gap report prints, and a jpg names cv2."""
    proc = subprocess.run([sys.executable, "-c", _DATAGEN_WITHOUT_HOST_PACKAGES], cwd=ROOT,
                          env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr
