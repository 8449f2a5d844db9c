"""The port's VOD path (playaid_core_torch.infer.vod_pipeline and
video/native_{decoder,encoder}.py) against the JAX package's, on the CPU.

A 96-frame 270x480 mp4v clip of two discs on a noise background is written
with cv2; both packages decode it with their own build of
native/video_decoder.cpp (libavcodec) and analyze it with the committed
bench weights (assets/bench_cnn63.npz) at 128-px crops.  Both need cv2 and
the FFmpeg development libraries.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from playaid_core_tpu.infer.pipeline import BatchedActionPipeline as JaxPipeline
from playaid_core_tpu.infer.vod_pipeline import VodAnalyzer as JaxVodAnalyzer
from playaid_core_tpu.video import native_decoder as jax_native_decoder
from playaid_core_torch.convert import load_npz_tree
from playaid_core_torch.device import full_float32
from playaid_core_torch.infer.pipeline import BatchedActionPipeline
from playaid_core_torch.infer.vod_pipeline import VodAnalyzer, analyze_many
from playaid_core_torch.video import native_decoder
from playaid_core_torch.video.native_encoder import NativeVideoWriter
from tests.test_torch_port_log import private_jax_native  # noqa: F401 (autouse)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(ROOT, "playaid_core_tpu", "assets", "bench_cnn63.npz")
NUM_FRAMES, HEIGHT, WIDTH, BOX_PX = 96, 270, 480, 65
CHUNK = 40  # 96 frames: chunks of 40, 40 and a short last one of 16
SWITCH_COST = 16.0


def _disc_frames(num_frames, h, w, box_px):
    """BGR frames: noise background, two discs on the fighter trajectories."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, 60, (h, w, 3), dtype=np.uint8)
    frames = np.repeat(base[None], num_frames, axis=0)
    boxes = np.zeros((num_frames, 2, 4), np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    radius = box_px * 90 / 260
    for i in range(num_frames):
        x = 0.2 + 0.6 * (i / num_frames)
        boxes[i, 0] = (x, 0.5, box_px / w, box_px / h)
        boxes[i, 1] = (1.0 - x, 0.5 + 60 / 1080, box_px / w, box_px / h)
        for k, colour in enumerate(((0, 200, 255), (255, 80, 0))):
            cx, cy = boxes[i, k, 0] * w, boxes[i, k, 1] * h
            frames[i][(yy - cy) ** 2 + (xx - cx) ** 2 <= radius ** 2] = colour
    return frames, boxes


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    frames, boxes = _disc_frames(NUM_FRAMES, HEIGHT, WIDTH, BOX_PX)
    path = str(tmp_path_factory.mktemp("vod") / "clip.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 60, (WIDTH, HEIGHT))
    for frame in frames:
        writer.write(frame)
    writer.release()
    return path, boxes


@pytest.fixture(scope="module")
def tree():
    return load_npz_tree(ASSET)


@pytest.fixture(scope="module")
def jax_pipe():
    return JaxPipeline(family="cnn", num_actions=63, sequence_length=7, frame_delta=3)


@pytest.fixture(scope="module")
def port(tree):
    return BatchedActionPipeline(device="cpu").load_variables(tree)


# ---- decoder and encoder ----

DECODE_CASES = [(fmt, stride, dense) for fmt in ("bgr", "yuv420") for stride in (1, 2)
                for dense in (False, True)]


@pytest.mark.parametrize("fmt, stride, dense", DECODE_CASES)
def test_decoder_crops_equal_jax_decoder(clip, fmt, stride, dense):
    path, boxes = clip
    with jax_native_decoder.NativeVideoDecoder(path) as ref_dec, \
            native_decoder.NativeVideoDecoder(path) as dec:
        assert (dec.width, dec.height, dec.num_frames) == (WIDTH, HEIGHT, NUM_FRAMES)
        for start, stop in ((0, 40), (40, 96)):
            kw = dict(stride=stride, fmt=fmt, dense=dense)
            n_ref, ref = ref_dec.decode_crops(start, boxes[start:stop], 128, 30, **kw)
            n, out = dec.decode_crops(start, boxes[start:stop], 128, 30, **kw)
            assert n == n_ref == stop - start
            assert out.shape == ref.shape and out.any()
            np.testing.assert_array_equal(out, ref)


def test_decoder_lowres_crops_equal_jax_decoder(clip):
    path, boxes = clip
    with jax_native_decoder.NativeVideoDecoder(path, lowres=1) as ref_dec, \
            native_decoder.NativeVideoDecoder(path, lowres=1) as dec:
        assert dec.lowres == ref_dec.lowres == 1
        for fmt in ("bgr", "yuv420"):
            ref = ref_dec.decode_crops(0, boxes, 128, 30, fmt=fmt)
            out = dec.decode_crops(0, boxes, 128, 30, fmt=fmt)
            assert out[0] == ref[0] == NUM_FRAMES
            np.testing.assert_array_equal(out[1], ref[1])


def test_decoder_pool_and_probe(clip):
    path, _ = clip
    native_decoder.clear_pool()
    info = native_decoder.probe(path)
    assert (info["width"], info["height"], info["num_frames"]) == (WIDTH, HEIGHT, NUM_FRAMES)
    assert info["max_lowres"] > 0 and info["fast"] == 0  # mpeg4: lowres, no deblock
    dec = native_decoder.acquire(path, lowres=0, fast="auto")  # the probe's parked handle
    native_decoder.release(dec)
    assert native_decoder.acquire(path, lowres=0, fast="auto") is dec
    native_decoder.release(dec)
    native_decoder.clear_pool()
    assert dec._h is None
    with pytest.raises(ValueError, match="integer pixel padding"):
        native_decoder.NativeVideoDecoder(path).decode_crops(0, np.zeros((1, 1, 4)), 128, 0.5)


def test_encoder_writes_mpeg4_the_jax_decoder_reads(tmp_path):
    """Smooth content (a gradient and discs): 4:2:0 chroma and mpeg4 at
    quantiser 2 keep it within a few levels."""
    _, boxes = _disc_frames(24, 96, 160, 40)
    ramp = np.linspace(0, 200, 160, dtype=np.float32)[None, :, None]
    frames = np.repeat(np.broadcast_to(ramp, (96, 160, 3)).astype(np.uint8)[None], 24, axis=0)
    for i in range(24):
        frames[i, 30:60, 20 + 4 * i:50 + 4 * i] = (0, 200, 255)
    path = str(tmp_path / "port.mp4")
    with NativeVideoWriter(path, 30, (160, 96), codec="mpeg4", preset=None, crf=2) as writer:
        for frame in frames:
            writer.write(frame)
    with jax_native_decoder.NativeVideoDecoder(path) as dec:
        assert (dec.width, dec.height, dec.num_frames) == (160, 96, 24)
        n, crops = dec.decode_crops(0, boxes, 64, 4)
    assert n == 24
    cap = cv2.VideoCapture(path)
    read = [cap.read()[1] for _ in range(24)]
    cap.release()
    err = np.abs(np.stack(read).astype(np.int16) - frames.astype(np.int16))
    assert err.mean() < 4.0, err.mean()
    with pytest.raises(ValueError, match="even"):
        NativeVideoWriter(str(tmp_path / "odd.mp4"), 30, (161, 96), codec="mpeg4")


# ---- VodAnalyzer against the JAX VodAnalyzer ----

ROUTES = {
    "native_yuv420_stride1": dict(decode_backend="native", transfer_format="yuv420", stride=1),
    "native_yuv420_stride2": dict(decode_backend="native", transfer_format="yuv420", stride=2),
    "cv2_stride2": dict(decode_backend="cv2", stride=2),
}


@pytest.mark.parametrize("decode", ["argmax", "viterbi"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_analyze_matches_jax(clip, tree, jax_pipe, port, route, decode):
    path, boxes = clip
    kw = dict(chunk=CHUNK, decode=decode, switch_cost=SWITCH_COST, **ROUTES[route])
    ref = JaxVodAnalyzer(jax_pipe, variables=tree, **kw).analyze(path, boxes)
    out = VodAnalyzer(port, **kw).analyze(path, boxes)
    assert out["labels"].shape == out["confidences"].shape == (NUM_FRAMES, 2)
    assert out["labels"].tolist() == ref["labels"].tolist()
    np.testing.assert_allclose(out["confidences"], ref["confidences"], rtol=1e-3)
    assert out["frames"] == ref["frames"] == NUM_FRAMES
    assert out["backend"] == ref["backend"] == route.split("_")[0]
    assert (out["lowres"], out["fast"]) == (ref["lowres"], ref["fast"])
    assert out["fps"] > 0 and out["seconds"] > 0


@pytest.mark.parametrize("workers", [1, 3])
def test_short_last_chunk_keeps_every_label(clip, port, workers):
    """93 frames at stride 2 and chunk 40: the last chunk holds 13 frames
    (7 sampled), and the inline (1 worker) and sink (3 workers) routes
    both label all 93."""
    path, boxes = clip
    analyzer = VodAnalyzer(port, chunk=CHUNK, stride=2, decode_workers=workers)
    out = analyzer.analyze(path, boxes[:93])
    assert out["frames"] == 93 and out["labels"].shape == (93, 2)
    full = analyzer.analyze(path, boxes)
    assert full["labels"].shape == (NUM_FRAMES, 2)


def test_analyze_many_in_job_order(clip, port):
    path, boxes = clip
    jobs = [(path, boxes[:48]), (path, boxes, {"stride": 2}),
            (os.path.join(ROOT, "no_such_clip.mp4"), boxes)]
    results = analyze_many(jobs, pipeline=port, chunk=CHUNK)
    assert isinstance(results[2], FileNotFoundError)
    for (p, b, *rest), res in zip(jobs[:2], results[:2]):
        single = VodAnalyzer(port, chunk=CHUNK, **(rest[0] if rest else {})).analyze(p, b)
        assert res["labels"].tolist() == single["labels"].tolist()
        np.testing.assert_allclose(res["confidences"], single["confidences"], rtol=1e-5)
    assert results[0]["labels"].shape == (48, 2) and results[1]["labels"].shape == (96, 2)


def test_embed_error_stops_the_run(clip, tree, monkeypatch):
    """An error on the dispatcher thread reaches the caller, the decode
    stops, and no thread of the run is left behind."""
    path, boxes = clip
    pipe = BatchedActionPipeline(device="cpu").load_variables(tree)
    calls = []

    def failing(crops):
        calls.append(len(crops))
        raise ValueError("embed failed")

    monkeypatch.setattr(pipe, "embed_crops_yuv", failing)
    before = threading.active_count()
    for workers in (1, 3):
        with pytest.raises(ValueError, match="embed failed"):
            VodAnalyzer(pipe, chunk=8, decode_workers=workers).analyze(path, boxes)
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before
    assert len(calls) < 2 * NUM_FRAMES // 8  # stopped early, not after every chunk


# ---- weights, defaults and errors ----


def _holds_numpy(obj):
    return any(isinstance(v, np.ndarray) for v in vars(obj).values())


def test_weights_load_once_into_the_modules(tree):
    pipe = BatchedActionPipeline(device="cpu")
    assert not pipe.initialized
    analyzer = VodAnalyzer(pipe, variables=tree)
    assert pipe.initialized and not _holds_numpy(analyzer) and not _holds_numpy(pipe)
    params = list(pipe.embed.parameters()) + list(pipe.head.parameters())
    assert all(isinstance(p, torch.nn.Parameter) and p.device == pipe.device for p in params)
    kernel = tree["embed"]["params"]["cnn2d"]["BasicBlock_7"]["Conv_0"]["kernel"]
    w = pipe.embed.layer4[1].conv1.weight
    np.testing.assert_array_equal(w.detach().numpy(), kernel.transpose(3, 2, 0, 1))
    kernel[...] = 0  # the tree is not shared with the modules
    assert w.abs().max() > 0
    # State dicts load the same way.
    again = BatchedActionPipeline(device="cpu")
    VodAnalyzer(again, variables={"embed": pipe.embed.state_dict(),
                                  "head": pipe.head.state_dict()})
    assert torch.equal(again.embed.layer4[1].conv1.weight, w)


def test_random_weights_are_seeded(capsys):
    a, b = BatchedActionPipeline(device="cpu"), BatchedActionPipeline(device="cpu")
    VodAnalyzer(a)
    VodAnalyzer(b)
    assert "WARNING: no trained weights" in capsys.readouterr().err
    sa, sb = a.head.state_dict(), b.head.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    w = a.embed.conv1.weight.clone()
    VodAnalyzer(a)  # weights already there: kept, no warning
    assert torch.equal(a.embed.conv1.weight, w) and not capsys.readouterr().err


def test_analyzer_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        VodAnalyzer()


@pytest.mark.parametrize("kwargs", [{"host_resize": False, "stride": 2}, {"mesh": "cpu"},
                                    {"host_resize": False, "decode_backend": "native"}])
def test_unported_routes_raise(port, clip, kwargs):
    """The window route (host_resize=False) runs at stride 1 only and with
    frames from a capture, as in the JAX package.  mesh= runs: two replicas
    of the embed on a single-process mesh of two CPU positions give the
    labels of one (tests/test_torch_port_mesh.py holds it further)."""
    if "mesh" in kwargs:
        from playaid_core_torch.parallel.mesh import make_mesh

        kw = {"decode_backend": "cv2", "stride": 2}
        meshed = VodAnalyzer(port, mesh=make_mesh(devices=["cpu"] * 2), **kw).analyze(*clip)
        single = VodAnalyzer(port, **kw).analyze(*clip)
        np.testing.assert_array_equal(meshed["labels"], single["labels"])
        return
    expected = {"stride": (ValueError, "stride>1 requires host_resize"),
                "decode_backend": (ValueError, "native decoder makes")}
    error, match = next(expected[k] for k in kwargs if k in expected)
    with pytest.raises(error, match=match):
        VodAnalyzer(port, **kwargs)


def test_bad_arguments_raise(port, clip):
    with pytest.raises(ValueError, match="divisible"):
        VodAnalyzer(port, chunk=45, stride=2)
    with pytest.raises(ValueError, match="native"):
        VodAnalyzer(port, decode_backend="cv2", transfer_format="yuv420").analyze(*clip)


# ---- full_float32 across threads ----


def test_full_float32_holds_the_flags_across_threads(monkeypatch):
    """Thread A enters, thread B enters, A leaves while B is still inside,
    then B leaves: the flags stay off while either is inside, and the
    caller's flags come back after both have left."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    flags = lambda: (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)  # noqa: E731
    a_in, b_in, a_out, b_may_leave = (threading.Event() for _ in range(4))
    seen = {}

    def thread_a():
        with full_float32():
            seen["a inside"] = flags()
            a_in.set()
            b_in.wait(5)
        a_out.set()

    def thread_b():
        a_in.wait(5)
        with full_float32():
            b_in.set()
            a_out.wait(5)
            seen["b inside after a left"] = flags()
            b_may_leave.wait(5)

    threads = [threading.Thread(target=thread_a), threading.Thread(target=thread_b)]
    for t in threads:
        t.start()
    a_out.wait(5)
    time.sleep(0.05)
    seen["caller while b inside"] = flags()
    b_may_leave.set()
    for t in threads:
        t.join(5)
        assert not t.is_alive()
    assert seen == {"a inside": (False, False), "b inside after a left": (False, False),
                    "caller while b inside": (False, False)}
    assert flags() == (True, True)
