"""1x1 convolution with folded batch norm, an optional residual and an
optional ReLU at inference: the CUDA kernel ``csrc/conv1x1_gemm.cu`` (K5),
its wrapper, its weight pack and its plain version.

No TPU kernel stands behind it: the JAX package leaves ResNet-50's
convolutions to XLA.  The port runs every 1x1 convolution of a ResNet-50
``Bottleneck`` on it at inference on the card (``models/resnet.py``):
``conv1`` and ``conv3`` with the ReLU, ``conv3`` with the block's residual,
and the ``downsample`` projection (stride 1 or 2) without either.

:func:`pack_conv1x1` splits a conv's weight ``[C_out, C_in, 1, 1]`` once
into TF32 halves ``hi = tf32(w)`` and ``lo = tf32(w - hi)`` for the
kernel's 3xTF32 products, beside the folded scale and bias;
:func:`conv1x1_packed` launches the kernel on the pack in the tile shape and
depth split that :func:`launch_shape` reads off M, N and K.  The kernel
reads and writes NCHW maps, as cuDNN's 3x3 convolutions around it take
them.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from playaid_core_torch.device import full_float32
from playaid_core_torch.ops import _build
from playaid_core_torch.ops.conv_block import SMS, tf32_round

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p]

SLICE_CHANNELS = 32  # input channels of a depth slice (128 bytes of float32)
# (pixel rows, output channels) a tile, and the depth splits: a cluster of
# that many blocks shares a tile.
TILES = ((128, 128), (64, 128), (64, 64))
SPLITS = (1, 2, 4)
# The launch model's microseconds, fitted on the card to every launch at
# every 1x1 shape of ResNet-50 at 48, 24 and 7 crops (PERF.md, K5): a
# slice of a tile, a block's fixed cost, and a split's reduction.
SLICE_US = {(64, 64): 0.75, (64, 128): 1.2, (128, 128): 2.2}
BLOCK_US = 3.5
SPLIT_US = {1: 0.0, 2: 3.5, 4: 8.5}


def launch_smem(bm, bn):
    """Shared memory of a block of ``bm x bn`` tiles: 3 stages of a raw
    activation slice and the weights' hi and lo slices, and two buffers of
    the activations' hi and lo (128-byte slices)."""
    return 3 * (bm + 2 * bn) * 128 + 2 * 2 * bm * 128


def launch_us(m, n, k, bm, bn, split):
    """The modelled microseconds of a launch: the busiest SM's blocks (the
    grid over the 132 SMs, rounded up), each its fixed cost and its share
    of the depth's slices, and the split's reduction."""
    blocks = -(-m // bm) * (n // bn) * split
    slices = -(-k // (SLICE_CHANNELS * split))
    return -(-blocks // SMS) * (BLOCK_US + slices * SLICE_US[bm, bn]) + SPLIT_US[split]


@functools.lru_cache(maxsize=256)
def launch_shape(m, n, k):
    """The kernel's launch for ``m`` output pixels, ``n`` output channels
    and depth ``k`` (input channels): ``(tile rows, tile channels, depth
    split)``, the one :func:`launch_us` finds fastest (the earlier of
    :data:`TILES`, then the smaller split, on a tie).  A split keeps at
    least two slices a block.  At 48 crops of 128 px: 64 x 64 tiles for
    layer 1's 64-channel outputs, 128 x 128 where those tiles fill the card,
    smaller tiles and the depth split in two where they do not.  On the card
    the picks' times summed over ResNet-50's 16 kinds of 1x1 came 5.2%
    above the fastest launch of each at 48 crops, 11.1% at 24 and 9.3% at
    7, each launch timed once (PERF.md, K5).  Kept per shape: the model
    takes about 15 us of host time a call."""
    if n % TILES[-1][1] or k % SLICE_CHANNELS or m <= 0:
        raise ValueError(f"the kernel takes output channels that divide by {TILES[-1][1]} and "
                         f"input channels that divide by {SLICE_CHANNELS}, got {n} and {k}")
    launches = [(bm, bn, split) for bm, bn in TILES if n % bn == 0 for split in SPLITS
                if split == 1 or k // SLICE_CHANNELS >= 2 * split]
    return min(launches, key=lambda launch: launch_us(m, n, k, *launch))


def conv1x1_ref(x, w, scale, bias, stride=1, residual=None, relu=True):
    """Plain version: ``act(conv1x1(x, w, stride) * scale + bias [+
    residual])`` on NCHW ``x``, in full float32 (TF32 off).  ``w``
    ``[C_out, C_in]`` or ``[C_out, C_in, 1, 1]``; ``scale``, ``bias``
    ``[C_out]``."""
    w = w.reshape(w.shape[0], w.shape[1], 1, 1)
    with full_float32():
        y = F.conv2d(x.float(), w.float(), stride=stride)
        y = y * scale[:, None, None] + bias[:, None, None]
        if residual is not None:
            y = y + residual
        return torch.relu(y) if relu else y


@dataclass(frozen=True)
class Conv1x1Pack:
    """A 1x1 conv and its folded batch norm in the kernel's layout.

    w: ``[2, C_out, C_in]`` float32, TF32 hi then lo, K-major.  scale,
    bias: ``[C_out]`` float32.
    """

    w: torch.Tensor
    scale: torch.Tensor
    bias: torch.Tensor


def pack_conv1x1(weight, scale, bias):
    """A conv weight ``[C_out, C_in, 1, 1]`` (or ``[C_out, C_in]``) and its
    folded scale and bias ``[C_out]`` -> :class:`Conv1x1Pack` on the
    weight's device."""
    c_out, c_in = weight.shape[:2]
    if weight.numel() != c_out * c_in or tuple(scale.shape) != (c_out,) or \
            tuple(bias.shape) != (c_out,):
        raise ValueError(f"a 1x1 conv's weight [C_out, C_in, 1, 1] and scale and bias [C_out], "
                         f"got {tuple(weight.shape)}, {tuple(scale.shape)}, {tuple(bias.shape)}")
    with torch.no_grad():
        w = weight.float().reshape(c_out, c_in)
        hi = tf32_round(w)
        return Conv1x1Pack(torch.stack([hi, tf32_round(w - hi)]), scale.float().contiguous(),
                           bias.float().contiguous())


def _library():
    fn = _build.load("conv1x1_gemm").conv1x1_f32
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def conv1x1_packed(x, pack, stride=1, residual=None, relu=True):
    """``act(conv1x1(x, w, stride) * scale + bias [+ residual])`` at
    inference on a :class:`Conv1x1Pack`.

    x ``[B, C_in, H, W]`` float32; returns ``[B, C_out, H_out, W_out]``
    (``H_out = (H - 1) // stride + 1``); ``residual`` has the output's
    shape.  On CUDA the kernel takes NCHW maps (others are made contiguous
    first) with ``C_in`` divisible by 32 and ``C_out`` by 64, raises on
    other channel counts, and returns a contiguous map; on the CPU the
    plain version runs on the unpacked weights (hi + lo).  No gradient:
    inference only.
    """
    if x.dim() != 4:
        raise ValueError(f"x must be [B, C, H, W], got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"the kernel takes float32 maps, got {x.dtype}")
    b, c_in, h, w = x.shape
    c_out = pack.w.shape[1]
    if tuple(pack.w.shape) != (2, c_out, c_in) or not pack.w.is_contiguous():
        raise ValueError(f"packed weights must be contiguous [2, {c_out}, {c_in}], "
                         f"got {tuple(pack.w.shape)}")
    out_shape = (b, c_out, (h - 1) // stride + 1, (w - 1) // stride + 1)
    if residual is not None and tuple(residual.shape) != out_shape:
        raise ValueError(f"the residual must be {out_shape}, got {tuple(residual.shape)}")
    if x.device.type == "cpu":
        return conv1x1_ref(x, pack.w.sum(0), pack.scale, pack.bias, stride, residual, relu)
    if x.device.type != "cuda":
        raise ValueError(f"conv1x1 runs on CUDA or the CPU, not {x.device}")
    m = out_shape[0] * out_shape[2] * out_shape[3]
    if m == 0:
        return torch.empty(out_shape, dtype=x.dtype, device=x.device)
    launch = launch_shape(m, c_out, c_in)
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    if residual is not None:
        residual = residual.contiguous()
    if any(t.device != x.device for t in (pack.w, pack.scale, pack.bias)) or (
            residual is not None and residual.device != x.device):
        raise ValueError("x, the residual and the pack must lie on the same CUDA device")
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    status = _library()(
        x.data_ptr(), pack.w.data_ptr(), pack.scale.data_ptr(), pack.bias.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(), b, h, w, c_in,
        c_out, stride, *launch, int(relu), _build.current_stream(x.device))
    _build.check(status, "conv1x1 launch")
    _build.count_launch(conv1x1_packed)
    return out


conv1x1_packed.launches = 0
