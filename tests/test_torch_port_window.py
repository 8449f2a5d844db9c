"""The port's window route against the JAX package's, on the CPU:
``batched_window_resize`` (the plain version of the crop kernel's window
entry), ``embed_windows`` and ``VodAnalyzer(host_resize=False)``.

The clip is ``test_torch_port_vod.py``'s: 96 frames of 270x480 mp4v, two
discs on a noise background, written with cv2, analyzed with the committed
bench weights (assets/bench_cnn63.npz) at 128-px crops.
"""

import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp  # noqa: E402

from playaid_core_tpu.infer.pipeline import BatchedActionPipeline as JaxPipeline  # noqa: E402
from playaid_core_tpu.infer.vod_pipeline import VodAnalyzer as JaxVodAnalyzer  # noqa: E402
from playaid_core_tpu.infer.vod_pipeline import extract_windows as jax_extract_windows  # noqa: E402
from playaid_core_tpu.ops.preprocess import batched_window_resize as jax_window_resize  # noqa: E402
from playaid_core_torch.convert import load_npz_tree  # noqa: E402
from playaid_core_torch.infer.pipeline import BatchedActionPipeline  # noqa: E402
from playaid_core_torch.infer.vod_pipeline import VodAnalyzer, extract_windows  # noqa: E402
from playaid_core_torch.ops.crop_kernel import window_resize  # noqa: E402
from playaid_core_torch.ops.preprocess import batched_window_resize  # noqa: E402
from playaid_core_torch.video import reader  # noqa: E402
from tests.test_torch_port_vod import BOX_PX, HEIGHT, NUM_FRAMES, WIDTH, _disc_frames  # noqa: E402

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(ROOT, "playaid_core_tpu", "assets", "bench_cnn63.npz")
CHUNK = 40
SWITCH_COST = 16.0

# Window-relative (y0, x0, side): inside, negative corners, a side wider
# than the window, side 0 (clamped to 1), fractional and far-out origins.
EDGE_ORIGINS = np.array([
    [0.0, 0.0, 60.0], [-7.0, -3.5, 40.0], [5.0, -20.0, 90.0], [0.0, 0.0, 0.0],
    [12.25, 3.75, 17.5], [-50.0, 70.0, 30.0], [30.0, 30.0, 63.0], [-1.0, -1.0, 66.0],
], np.float32)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    frames, boxes = _disc_frames(NUM_FRAMES, HEIGHT, WIDTH, BOX_PX)
    path = str(tmp_path_factory.mktemp("window") / "clip.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 60, (WIDTH, HEIGHT))
    for frame in frames:
        writer.write(frame)
    writer.release()
    return path, boxes


@pytest.fixture(scope="module")
def tree():
    return load_npz_tree(ASSET)


@pytest.fixture(scope="module")
def port(tree):
    return BatchedActionPipeline(device="cpu").load_variables(tree)


@pytest.mark.parametrize("normalize", [True, False])
def test_batched_window_resize_matches_jax(normalize):
    """At a power-of-two crop size, as the main path's 128: there the
    division by the size is exact, and XLA's rewrite of it into a product
    by the reciprocal moves no coordinate."""
    rng = np.random.default_rng(0)
    wins = rng.integers(0, 256, (len(EDGE_ORIGINS), 64, 64, 3), dtype=np.uint8)
    y0, x0, side = (EDGE_ORIGINS[:, i] for i in range(3))
    ref = np.asarray(jax_window_resize(jnp.asarray(wins), y0, x0, side, out_size=32,
                                       normalize=normalize))
    out = batched_window_resize(torch.from_numpy(wins), torch.from_numpy(y0),
                                torch.from_numpy(x0), torch.from_numpy(side), 32, normalize)
    assert out.shape == (len(EDGE_ORIGINS), 32, 32, 3) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6 * (1 if normalize else 255))


def test_window_wrapper_flips_and_counts_no_launch_on_cpu():
    """On a CPU tensor the wrapper runs the plain version (BGR flipped
    first, as the JAX route flips before the resample) and launches
    nothing."""
    rng = np.random.default_rng(1)
    wins = rng.integers(0, 256, (len(EDGE_ORIGINS), 48, 48, 3), dtype=np.uint8)
    ref = np.asarray(jax_window_resize(jnp.asarray(wins[..., ::-1]), *EDGE_ORIGINS.T,
                                       out_size=16))
    before = window_resize.launches
    out = window_resize(torch.from_numpy(wins), torch.from_numpy(EDGE_ORIGINS), 16,
                        bgr_to_rgb=True)
    assert window_resize.launches == before
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match=r"\[M, 3\]"):
        window_resize(torch.from_numpy(wins), torch.zeros(2, 3))
    # A tensor on neither the CPU nor a CUDA device is refused, never run
    # through the plain version.
    with pytest.raises(ValueError, match="CUDA device"):
        window_resize(torch.zeros((1, 8, 8, 3), dtype=torch.uint8, device="meta"),
                      torch.zeros((1, 3), device="meta"))


def test_extract_windows_matches_jax():
    """Boxes inside, across each edge, and one whose crop exceeds the
    window (shrunk around its centre)."""
    frame = np.random.default_rng(2).integers(0, 256, (90, 160, 3), dtype=np.uint8)
    boxes = np.array([[0.5, 0.5, 0.2, 0.3], [0.02, 0.98, 0.3, 0.3], [0.97, 0.03, 0.1, 0.4],
                      [0.5, 0.5, 1.2, 1.0]], np.float32)
    for window in (64, 96):
        out = extract_windows(frame, boxes, window, 6)
        ref = jax_extract_windows(frame, boxes, window, 6)
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, b)


def test_embed_windows_matches_jax(tree, port):
    rng = np.random.default_rng(3)
    wins = rng.integers(0, 256, (4, 160, 160, 3), dtype=np.uint8)
    origins = np.array([[0, 0, 150], [-10, 5, 120], [20, -30, 170], [3.5, 2.5, 0]], np.float32)
    jax_pipe = JaxPipeline(family="cnn", num_actions=63, sequence_length=7, frame_delta=3)
    ref = np.asarray(jax_pipe.embed_windows(tree, jnp.asarray(wins), jnp.asarray(origins)))
    out = port.embed_windows(torch.from_numpy(wins), torch.from_numpy(origins)).numpy()
    assert out.shape == ref.shape == (4, 1000)
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("decode", ["argmax", "viterbi"])
def test_window_route_matches_jax(clip, tree, port, decode):
    path, boxes = clip
    kw = dict(chunk=CHUNK, decode=decode, switch_cost=SWITCH_COST, host_resize=False)
    jax_pipe = JaxPipeline(family="cnn", num_actions=63, sequence_length=7, frame_delta=3)
    ref = JaxVodAnalyzer(jax_pipe, variables=tree, **kw).analyze(path, boxes)
    out = VodAnalyzer(port, **kw).analyze(path, boxes)
    assert out["labels"].shape == out["confidences"].shape == (NUM_FRAMES, 2)
    assert out["labels"].tolist() == ref["labels"].tolist()
    np.testing.assert_allclose(out["confidences"], ref["confidences"], rtol=1e-3)
    assert out["frames"] == ref["frames"] == NUM_FRAMES
    assert out["backend"] == ref["backend"] == "cv2"
    assert out["lowres"] == out["fast"] == 0


class _MemoryCapture:
    """Frames from memory behind the capture seam (video/reader.open_capture)."""

    def __init__(self, frames):
        self.frames = frames
        self.pos = 0

    def seek(self, index):
        self.pos = index

    def read(self):
        if self.pos >= len(self.frames):
            return False, None
        self.pos += 1
        return True, self.frames[self.pos - 1]

    def release(self):
        pass


def test_capture_seam_serves_the_window_route(clip, port, monkeypatch):
    """The decoded clip served from memory through the seam gives the
    labels of the cv2 capture, with several decode workers."""
    path, boxes = clip
    cap = cv2.VideoCapture(path)
    frames = [cap.read()[1] for _ in range(NUM_FRAMES)]
    cap.release()
    analyzer = VodAnalyzer(port, chunk=CHUNK, host_resize=False, decode_workers=3)
    from_file = analyzer.analyze(path, boxes)
    monkeypatch.setattr(reader, "open_capture", lambda p: _MemoryCapture(frames))
    from_memory = analyzer.analyze("not-a-file.mp4", boxes)
    assert from_memory["labels"].tolist() == from_file["labels"].tolist()
    np.testing.assert_array_equal(from_memory["confidences"], from_file["confidences"])


def test_window_route_rejects_yuv420(port, clip):
    with pytest.raises(ValueError, match="native"):
        VodAnalyzer(port, host_resize=False, transfer_format="yuv420").analyze(*clip)
