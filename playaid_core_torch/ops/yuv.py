"""YUV420 unpack: the CUDA kernel ``csrc/yuv420_unpack.cu``, its wrapper
and its plain version.

Counterpart of the unpack in ``playaid_core_tpu/infer/pipeline.py``
``BatchedActionPipeline._embed_crops_yuv_impl``, which XLA fused into the
stem's program on the TPU.  For a CUDA tensor :func:`yuv420_to_rgb`
launches the kernel or raises; for a CPU tensor it runs
:func:`yuv420_to_rgb_ref`.  It counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from playaid_core_torch.ops import _build

_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def yuv420_to_rgb_ref(crops_yuv, size):
    """Packed planar YUV420 uint8 crops ``[N, S*S*3//2]`` (Y, then U, then
    V) -> BT.601 limited-range RGB ``[N, S, S, 3]`` float32 in [0, 1].
    Chroma is upsampled 2x by nearest neighbour."""
    s = size
    n = crops_yuv.shape[0]
    yb, cb = s * s, (s // 2) * (s // 2)
    y = crops_yuv[:, :yb].reshape(n, s, s).float()
    u = crops_yuv[:, yb:yb + cb].reshape(n, s // 2, s // 2).float()
    v = crops_yuv[:, yb + cb:].reshape(n, s // 2, s // 2).float()
    u = u.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    v = v.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    yc = 1.164383 * (y - 16.0)
    r = yc + 1.596027 * (v - 128.0)
    g = yc - 0.391762 * (u - 128.0) - 0.812968 * (v - 128.0)
    b = yc + 2.017232 * (u - 128.0)
    rgb = torch.stack([r, g, b], dim=-1)
    return torch.clamp(rgb, 0.0, 255.0) / 255.0


def _library():
    fn = _build.load("yuv420_unpack").yuv420_unpack
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def yuv420_to_rgb(crops_yuv, size):
    """RGB crops ``[N, S, S, 3]`` float32 in [0, 1] of packed YUV420 uint8
    crops ``[N, S*S*3//2]``; see :func:`yuv420_to_rgb_ref`.  On the card
    the result is a view of channels-first storage ``[N, 3, S, S]``, so
    ``permute(0, 3, 1, 2)`` gives the stem a contiguous tensor."""
    if size % 2 or crops_yuv.dim() != 2 or crops_yuv.shape[1] != size * size * 3 // 2:
        raise ValueError(f"crops must be [N, {size * size * 3 // 2}] for an even size {size}, "
                         f"got {tuple(crops_yuv.shape)}")
    if crops_yuv.dtype != torch.uint8:
        raise TypeError(f"the kernel takes uint8 crops, got {crops_yuv.dtype}")
    if crops_yuv.device.type == "cpu":
        return yuv420_to_rgb_ref(crops_yuv, size)
    dev = crops_yuv.device
    if dev.type != "cuda":
        raise ValueError(f"crops must lie on the CPU or a CUDA device, not {dev}")
    crops_yuv = crops_yuv.contiguous()
    n = crops_yuv.shape[0]
    out = torch.empty((n, 3, size, size), dtype=torch.float32, device=dev)
    if n == 0:
        return out.permute(0, 2, 3, 1)
    status = _library()(crops_yuv.data_ptr(), out.data_ptr(), n, size,
                        _build.current_stream(dev))
    _build.check(status, "yuv420_unpack launch")
    _build.count_launch(yuv420_to_rgb)
    return out.permute(0, 2, 3, 1)


yuv420_to_rgb.launches = 0
