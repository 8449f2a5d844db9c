"""K1's channels-first crops, on the CPU.

On the card the crop kernel's frames and window entries write
``[.., 3, S, S]`` storage and return its ``[.., S, S, 3]`` view
(``ops/crop_kernel.py``); on the CPU the wrappers return the plain
versions' contiguous crops.  These tests give the port's consumers of
those crops (the three families' embeds, ``preprocess_frames`` followed by
``embed_crops``, ``embed_windows`` and the window route of
``VodAnalyzer``, the shared-frame route) such views, with the plain
versions' values, and hold the results to the contiguous crops' (which the
other port tests hold to the JAX package's) or to the JAX package's.  Inputs come from numpy seeds at
small sizes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from playaid_core_tpu.ops.pallas_kernels import pallas_square_crop_resize
from playaid_core_tpu.ops.preprocess import (
    batched_crop_resize_shared_frame as jax_shared_frame,
    batched_square_crop_resize as jax_crop,
    batched_window_resize as jax_window_resize,
)
from playaid_core_torch.infer import pipeline as pipeline_module
from playaid_core_torch.infer.pipeline import BatchedActionPipeline
from playaid_core_torch.ops.crop_kernel import _channels_first, square_crop_resize, window_resize
from playaid_core_torch.ops.preprocess import (
    batched_crop_resize_shared_frame,
    batched_square_crop_resize,
    batched_window_resize,
)

torch.set_num_threads(2)

# The same values through the CPU's NCHW or channels-last convolutions,
# whose sums run in other orders: 7.2e-07 (CNN, RNN) and 1.13e-06
# (ResNet-50) apart on embeddings of about 1 at these inputs.
EMBED_ATOL = 2e-6


def channels_first_view(x):
    """x ``[.., S, S, C]`` stored as ``[.., C, S, S]``: what K1 returns on
    the card."""
    return x.movedim(-1, -3).contiguous().movedim(-3, -1)


def test_channels_first_view_is_the_kernels_layout():
    for lead in ((5,), (4, 2)):
        out = _channels_first(torch.Size(lead), 8, "cpu")
        ref = torch.empty(lead + (3, 8, 8)).movedim(-3, -1)
        assert out.shape == ref.shape == lead + (8, 8, 3)
        assert out.stride() == ref.stride()
        assert out.movedim(-1, -3).is_contiguous() and not out.is_contiguous()
    crops = torch.from_numpy(np.random.default_rng(0).random((3, 2, 6, 6, 3), np.float32))
    view = channels_first_view(crops)
    assert torch.equal(view, crops) and view.movedim(-1, -3).is_contiguous()
    # phase 4's reshape of [N, 2, S, S, 3] to [2N, S, S, 3] stays a view
    flat = view.reshape(-1, 6, 6, 3)
    assert flat.data_ptr() == view.data_ptr() and flat.permute(0, 3, 1, 2).is_contiguous()


@pytest.fixture(scope="module", params=["cnn", "resformer", "rnn"])
def family_pipe(request):
    return BatchedActionPipeline(request.param, device="cpu", crop_size=32).init(seed=3)


def test_embed_takes_channels_first_view(family_pipe):
    crops = torch.from_numpy(np.random.default_rng(1).random((3, 32, 32, 3), np.float32))
    ref = family_pipe.embed_crops(crops)
    out = family_pipe.embed_crops(channels_first_view(crops))
    assert out.shape == ref.shape == (3, family_pipe.embed_dim)
    torch.testing.assert_close(out, ref, atol=EMBED_ATOL, rtol=0)


def _frames_and_boxes(seed=2, n=3, h=72, w=128):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    boxes = rng.uniform(0.2, 0.8, (n, 2, 4)).astype(np.float32)
    boxes[..., 2:] *= 0.5
    return frames, boxes


def card_layout(monkeypatch):
    """Make the pipeline's crop wrappers return the plain crops in the
    card's channels-first storage."""
    for name, wrapper in (("square_crop_resize", square_crop_resize),
                          ("window_resize", window_resize)):
        monkeypatch.setattr(pipeline_module, name,
                            lambda *a, _w=wrapper, **k: channels_first_view(_w(*a, **k)))


def test_preprocess_then_embed_on_channels_first_crops(family_pipe, monkeypatch):
    """Phase 4's consumer: preprocess_frames' [N, 2, S, S, 3] crops,
    reshaped to [2N, S, S, 3], into embed_crops."""
    frames, boxes = _frames_and_boxes()
    args = (torch.from_numpy(frames), torch.from_numpy(boxes))
    ref = family_pipe.embed_crops(family_pipe.preprocess_frames(*args, padding=4)
                                  .reshape(-1, 32, 32, 3))
    card_layout(monkeypatch)
    crops = family_pipe.preprocess_frames(*args, padding=4)
    assert not crops.is_contiguous() and crops.movedim(-1, -3).is_contiguous()
    out = family_pipe.embed_crops(crops.reshape(-1, 32, 32, 3))
    torch.testing.assert_close(out, ref, atol=EMBED_ATOL, rtol=0)


def test_embed_windows_on_channels_first_crops(family_pipe, monkeypatch):
    """The window route's consumer: embed_windows on window_resize's crops."""
    rng = np.random.default_rng(4)
    wins = torch.from_numpy(rng.integers(0, 256, (4, 48, 48, 3), dtype=np.uint8))
    origins = torch.tensor([[0, 0, 40], [-5, 3, 30], [6, -8, 52], [1.5, 2.5, 0]])
    ref = family_pipe.embed_windows(wins, origins)
    card_layout(monkeypatch)
    out = family_pipe.embed_windows(wins, origins)
    torch.testing.assert_close(out, ref, atol=EMBED_ATOL, rtol=0)


class _MemoryCapture:
    """Frames from memory behind the capture seam (video/reader.open_capture)."""

    def __init__(self, frames):
        self.frames, self.pos = frames, 0

    def seek(self, index):
        self.pos = index

    def read(self):
        if self.pos >= len(self.frames):
            return False, None
        self.pos += 1
        return True, self.frames[self.pos - 1]

    def release(self):
        pass


def test_window_route_on_channels_first_crops(monkeypatch):
    """VodAnalyzer(host_resize=False) end to end, its crops channels first,
    on frames served from memory: the labels and confidences of its run on
    contiguous crops (test_torch_port_window holds that run to JAX's)."""
    from playaid_core_torch.infer import vod_pipeline
    from playaid_core_torch.video import reader

    rng = np.random.default_rng(5)
    n = 40
    frames = [rng.integers(0, 256, (90, 160, 3), dtype=np.uint8) for _ in range(n)]
    boxes = np.tile(np.array([[0.3, 0.5, 0.2, 0.3], [0.7, 0.45, 0.25, 0.3]], np.float32),
                    (n, 1, 1))
    monkeypatch.setattr(reader, "open_capture", lambda p: _MemoryCapture(frames))
    port = BatchedActionPipeline(device="cpu", crop_size=32).init(seed=4)
    analyzer = vod_pipeline.VodAnalyzer(port, chunk=16, host_resize=False, window=64,
                                        padding=4, decode_workers=1)
    ref = analyzer.analyze("memory.mp4", boxes)
    card_layout(monkeypatch)
    out = analyzer.analyze("memory.mp4", boxes)
    assert out["labels"].shape == (n, 2)
    assert out["labels"].tolist() == ref["labels"].tolist()
    np.testing.assert_allclose(out["confidences"], ref["confidences"], rtol=0, atol=1e-6)


def test_shared_frame_crops_reshape_as_phase_16(monkeypatch):
    """The shared-frame route's consumer reshapes [M, S, S, 3] crops; a
    channels-first view goes through unchanged, and the values stay the
    JAX function's."""
    frames, boxes = _frames_and_boxes(seed=6, n=1)
    ref = np.asarray(jax_shared_frame(jnp.asarray(frames[0]), jnp.asarray(boxes[0]),
                                      out_size=32, padding=4, bgr_to_rgb=True))
    out = channels_first_view(batched_crop_resize_shared_frame(
        torch.from_numpy(frames[0]), torch.from_numpy(boxes[0]), 32, 4, True))
    np.testing.assert_allclose(out.reshape(2, 32, 32, 3).numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("strided", [False, True])
def test_plain_crops_match_jax_and_pallas(strided):
    """The plain versions on contiguous frames and on frames in another
    storage order, against the JAX functions (1e-5) and the Pallas kernel
    in interpret mode (1e-4), as test_torch_port_ops holds them."""
    frames, boxes = _frames_and_boxes(seed=7, n=2, h=90, w=160)
    boxes = boxes[:, 0]
    t_frames = torch.from_numpy(frames)
    if strided:
        t_frames = channels_first_view(t_frames)
    ref = np.asarray(jax_crop(jnp.asarray(frames), jnp.asarray(boxes), out_size=32, padding=4,
                              bgr_to_rgb=True))
    out = batched_square_crop_resize(t_frames, torch.from_numpy(boxes), 32, 4, True).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    pallas = np.asarray(pallas_square_crop_resize(
        jnp.asarray(frames), jnp.asarray(boxes), out_size=32, padding=4, win_h=96, win_w=160,
        bgr_to_rgb=True, interpret=True))
    np.testing.assert_allclose(out, pallas, rtol=0, atol=1e-4)
    wins = t_frames[:, :64, :64]
    origins = np.array([[2.0, -3.0, 50.0], [-4.5, 6.0, 70.0]], np.float32)
    wref = np.asarray(jax_window_resize(jnp.asarray(frames[:, :64, :64]), *origins.T,
                                        out_size=32))
    wout = batched_window_resize(wins, *torch.from_numpy(origins).T, 32).numpy()
    np.testing.assert_allclose(wout, wref, rtol=0, atol=1e-6)
