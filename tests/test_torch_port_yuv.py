"""The port's YUV420 unpack (playaid_core_torch/ops/yuv.py) against the JAX
package's ``BatchedActionPipeline._embed_crops_yuv_impl``.

The JAX function fuses the unpack into the embed; here it runs with the
JAX pipeline instance's ``embed`` replaced by a stub whose ``apply``
returns the crops it is given, so its output is the unpack alone.  The
same numpy crops go through the port's wrapper, which runs its plain
version on a CPU tensor.  Tolerance: 1e-6 abs on values in [0, 1], above
the one float32 ulp (at most 6e-8) by which two correctly rounded
divisions by 255, or a division and a product with 1/255, can differ.
The CUDA kernel (csrc/yuv420_unpack.cu) is held against the plain version
on the card, bit for bit, by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from playaid_core_tpu.infer.pipeline import BatchedActionPipeline as JaxPipeline
from playaid_core_torch.ops.yuv import yuv420_to_rgb, yuv420_to_rgb_ref

torch.set_num_threads(2)

TOL = 1e-6


class _Identity:
    @staticmethod
    def apply(variables, crops):
        return crops


def _jax_unpack(crops, size):
    pipe = JaxPipeline(family="cnn", num_actions=63, sequence_length=7, frame_delta=3,
                       crop_size=size)
    pipe.embed = _Identity()
    return np.asarray(pipe._embed_crops_yuv_impl(None, jnp.asarray(crops)))


def _crops(seed, n, size):
    return np.random.default_rng(seed).integers(0, 256, (n, size * size * 3 // 2),
                                                dtype=np.uint8)


@pytest.mark.parametrize("n, size", [(1, 2), (3, 8), (4, 128)])
def test_unpack_matches_jax(n, size):
    crops = _crops(size, n, size)
    ref = _jax_unpack(crops, size)
    out = yuv420_to_rgb(torch.from_numpy(crops), size)
    assert tuple(out.shape) == ref.shape == (n, size, size, 3)
    assert out.dtype == torch.float32
    assert np.abs(out.numpy() - ref).max() <= TOL


def test_unpack_every_sample_value():
    """Every Y value against every U and V value across the crops (Y walks
    0..255 along a row, U and V take every value once per crop pair), so
    both clamps and every coefficient are exercised."""
    size = 32
    h = size // 2
    crops = np.zeros((16, size * size * 3 // 2), np.uint8)
    for k in range(16):
        crops[k, :size * size] = np.arange(size * size) % 256
        crops[k, size * size:size * size + h * h] = (np.arange(h * h) + 16 * k) % 256
        crops[k, size * size + h * h:] = (np.arange(h * h)[::-1] + 7 * k) % 256
    ref = _jax_unpack(crops, size)
    out = yuv420_to_rgb(torch.from_numpy(crops), size).numpy()
    assert out.min() == 0.0 and out.max() == 1.0
    assert np.abs(out - ref).max() <= TOL


def test_pipeline_embeds_the_unpack():
    """embed_crops_yuv hands the unpack's crops to the embed."""
    from playaid_core_torch.infer.pipeline import BatchedActionPipeline

    port = BatchedActionPipeline(crop_size=16, device="cpu")
    seen = []
    port.embed = lambda crops: seen.append(crops) or crops.sum(dim=(1, 2))
    crops = torch.from_numpy(_crops(2, 3, 16))
    port.embed_crops_yuv(crops)
    assert torch.equal(seen[0], yuv420_to_rgb_ref(crops, 16))


def test_wrapper_uses_plain_version_on_cpu():
    crops = torch.from_numpy(_crops(3, 2, 16))
    before = yuv420_to_rgb.launches
    out = yuv420_to_rgb(crops, 16)
    assert tuple(out.shape) == (2, 16, 16, 3)
    assert torch.equal(out, yuv420_to_rgb_ref(crops, 16))
    assert yuv420_to_rgb.launches == before


def test_wrapper_refuses_what_the_kernel_does_not_take():
    crops = torch.from_numpy(_crops(4, 2, 16))
    with pytest.raises(TypeError):
        yuv420_to_rgb(crops.to(torch.int16), 16)
    with pytest.raises(ValueError):
        yuv420_to_rgb(crops[:, :-1], 16)
    with pytest.raises(ValueError):
        yuv420_to_rgb(crops[0], 16)
    with pytest.raises(ValueError):
        yuv420_to_rgb(torch.zeros((2, 15 * 15 * 3 // 2), dtype=torch.uint8), 15)
    with pytest.raises(ValueError):
        yuv420_to_rgb(crops.to("meta"), 16)
