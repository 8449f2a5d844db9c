"""The port's ops (playaid_core_torch/ops) against the JAX package's.

The same numpy inputs go through the JAX function, run as the JAX tests
run it on the CPU (its plain version, or the Pallas kernel with
interpret=True), and through the port's plain PyTorch version.  The CUDA
kernels themselves are held against these plain versions on the card by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from playaid_core_tpu.ops.pallas_conv_block import pallas_residual_block, xla_residual_block
from playaid_core_tpu.ops.pallas_kernels import pallas_square_crop_resize
from playaid_core_tpu.ops.preprocess import (
    batched_square_crop_resize as jax_crop,
    middle_out_frame_indices as jax_middle_out,
)
from playaid_core_torch.ops.conv_block import (
    residual_block,
    residual_block_packed,
    residual_block_ref,
)
from playaid_core_torch.ops.crop_kernel import square_crop_resize
from playaid_core_torch.ops.preprocess import batched_square_crop_resize, middle_out_frame_indices

torch.set_num_threads(2)


def _gradient_frames(n, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    frame = np.stack([yy % 251, xx % 251, (yy + xx) % 251], axis=-1).astype(np.uint8)
    return np.repeat(frame[None], n, axis=0)


# (frames, boxes [N, 4], out_size, padding, bgr_to_rgb)
CROP_CASES = {
    "interior": (np.random.default_rng(2).integers(0, 255, (2, 180, 320, 3), dtype=np.uint8),
                 [[0.5, 0.5, 0.3, 0.25], [0.25, 0.4, 0.2, 0.3]], 64, 4, False),
    "bottom_right_edge": (_gradient_frames(2, 100, 320),
                          [[0.5, 0.85, 0.09, 0.3], [0.97, 0.5, 0.12, 0.2]], 48, 0, False),
    "past_every_edge": (np.random.default_rng(3).integers(0, 255, (6, 90, 160, 3), dtype=np.uint8),
                        [[0.0, 0.0, 0.4, 0.4], [1.0, 1.0, 0.5, 0.3], [0.5, 0.0, 0.2, 0.6],
                         [1.0, 0.5, 0.3, 0.3], [0.02, 0.98, 0.8, 0.8], [0.5, 0.5, 1.5, 1.2]],
                        32, 6, True),
    "degenerate_box": (np.random.default_rng(4).integers(0, 255, (1, 40, 60, 3), dtype=np.uint8),
                       [[0.5, 0.5, 0.0, 0.0]], 16, 0, True),
}


@pytest.mark.parametrize("case", sorted(CROP_CASES))
def test_crop_plain_matches_jax(case):
    frames, boxes, size, pad, flip = CROP_CASES[case]
    boxes = np.asarray(boxes, np.float32)
    ref = np.asarray(jax_crop(jnp.asarray(frames), jnp.asarray(boxes), out_size=size,
                              padding=pad, bgr_to_rgb=flip))
    out = batched_square_crop_resize(torch.from_numpy(frames), torch.from_numpy(boxes),
                                     size, pad, flip).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_crop_plain_several_boxes_per_frame():
    """[N, K, 4] boxes read each frame once for K crops; the result equals
    the one-box-per-frame call on repeated frames."""
    frames = np.random.default_rng(5).integers(0, 255, (3, 72, 128, 3), dtype=np.uint8)
    boxes = np.random.default_rng(6).uniform(0.1, 0.9, (3, 2, 4)).astype(np.float32)
    boxes[..., 2:] *= 0.4
    ref = np.asarray(jax_crop(jnp.asarray(np.repeat(frames, 2, axis=0)),
                              jnp.asarray(boxes.reshape(6, 4)), out_size=24, padding=3,
                              bgr_to_rgb=True))
    out = batched_square_crop_resize(torch.from_numpy(frames), torch.from_numpy(boxes),
                                     24, 3, True).numpy()
    assert out.shape == (3, 2, 24, 24, 3)
    np.testing.assert_allclose(out.reshape(ref.shape), ref, atol=1e-5)


@pytest.mark.parametrize("case,win", [("interior", (160, 320)), ("bottom_right_edge", (96, 256))])
def test_crop_plain_matches_pallas_interpret(case, win):
    frames, boxes, size, pad, flip = CROP_CASES[case]
    boxes = np.asarray(boxes, np.float32)
    ref = np.asarray(pallas_square_crop_resize(
        jnp.asarray(frames), jnp.asarray(boxes), out_size=size, padding=pad,
        win_h=win[0], win_w=win[1], bgr_to_rgb=flip, interpret=True))
    out = batched_square_crop_resize(torch.from_numpy(frames), torch.from_numpy(boxes),
                                     size, pad, flip).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)


def _block_inputs(dtype, b=4, c=32, seed=0, hw=(4, 4)):
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.normal(0, 1, (b, *hw, c)), 0).astype(np.float32)
    w1, w2 = (rng.normal(0, (2 / (9 * c)) ** 0.5, (3, 3, c, c)).astype(np.float32)
              for _ in range(2))
    s1, s2 = (rng.uniform(0.5, 1.5, c).astype(np.float32) for _ in range(2))
    b1, b2 = (rng.normal(0, 0.1, c).astype(np.float32) for _ in range(2))
    if dtype == "bfloat16":  # round x and weights to bf16 once, for both sides
        x, w1, w2 = (torch.from_numpy(a).bfloat16().float().numpy() for a in (x, w1, w2))
    return x, w1, s1, b1, w2, s2, b2


# (B, H, W, C): a narrow 4x4 block, and ResNet-18's identity blocks at
# 128-px crops, each of which runs on the kernel, at a small batch.
BLOCK_SHAPES = [(4, 4, 4, 32), (2, 32, 32, 64), (2, 16, 16, 128), (2, 8, 8, 256), (2, 4, 4, 512)]


@pytest.mark.parametrize("shape", BLOCK_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_residual_block_plain_matches_jax(dtype, shape):
    b, h, w, c = shape
    args = _block_inputs(dtype, b=b, c=c, hw=(h, w))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jargs = [jnp.asarray(a) for a in args]
    jargs[0] = jargs[0].astype(jdt)
    xla = np.asarray(xla_residual_block(*jargs).astype(jnp.float32))
    references = [xla]
    if (h, w) == (4, 4):  # the Pallas kernel is specialised to the 4x4 stage
        references.append(np.asarray(pallas_residual_block(*jargs, tile_b=2, interpret=True)
                                     .astype(jnp.float32)))
    targs = [torch.from_numpy(a) for a in args]
    targs[0] = targs[0].to(getattr(torch, dtype))
    out = residual_block_ref(*targs)
    assert out.dtype == targs[0].dtype
    out = out.float().numpy()
    if dtype == "float32":
        # Summation order differs; 1e-5 of the output's scale.
        atol = 1e-5 * np.abs(xla).max()
    else:
        # One bf16 rounding of the intermediate can flip at a tie.
        atol = 2e-2
    for reference in references:
        np.testing.assert_allclose(out, reference, atol=atol, rtol=0)


def test_residual_block_any_batch_on_cpu():
    """No tile_b restriction: a batch of 3 runs and matches per-sample calls."""
    args = [torch.from_numpy(a) for a in _block_inputs("float32", b=3, c=16, seed=1)]
    whole = residual_block(*args)
    parts = torch.cat([residual_block(args[0][i:i + 1], *args[1:]) for i in range(3)])
    torch.testing.assert_close(whole, parts, atol=1e-6, rtol=0)


@pytest.mark.parametrize("min_frame", [0, 1, 4])
@pytest.mark.parametrize("delta", [1, 3])
def test_middle_out_matches_jax(min_frame, delta):
    mids = np.array([0, 1, 5, 50, 295, 299])
    ref = np.asarray(jax_middle_out(jnp.asarray(mids), 7, delta, 300, min_frame=min_frame))
    out = middle_out_frame_indices(torch.from_numpy(mids), 7, delta, 300, min_frame=min_frame)
    assert out.tolist() == ref.tolist()
    for m in (1, 50):  # scalar middle frame
        scalar = middle_out_frame_indices(m, 7, delta, 300, min_frame=min_frame)
        assert scalar.tolist() == np.asarray(
            jax_middle_out(m, 7, delta, 300, min_frame=min_frame)).tolist()


def test_wrappers_use_plain_version_on_cpu():
    frames, boxes, size, pad, flip = CROP_CASES["past_every_edge"]
    frames, boxes = torch.from_numpy(frames), torch.tensor(boxes, dtype=torch.float32)
    crops_before = square_crop_resize.launches
    torch.testing.assert_close(square_crop_resize(frames, boxes, size, pad, flip),
                               batched_square_crop_resize(frames, boxes, size, pad, flip),
                               atol=0, rtol=0)
    args = [torch.from_numpy(a) for a in _block_inputs("float32")]
    blocks_before = residual_block_packed.launches
    torch.testing.assert_close(residual_block(*args), residual_block_ref(*args), atol=0, rtol=0)
    assert square_crop_resize.launches == crops_before
    assert residual_block_packed.launches == blocks_before


def test_wrappers_raise_off_cpu_and_cuda():
    """A tensor on neither the CPU nor a CUDA device is refused, never run
    through the plain version."""
    args = [torch.from_numpy(a).to("meta") for a in _block_inputs("float32")]
    with pytest.raises(ValueError):
        residual_block(*args)
    with pytest.raises(ValueError):
        square_crop_resize(torch.zeros((1, 8, 8, 3), dtype=torch.uint8, device="meta"),
                           torch.zeros((1, 4), device="meta"))
