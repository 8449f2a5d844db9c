"""Fused identity ResNet BasicBlock: the CUDA kernel
``csrc/residual_block.cu``, its wrappers, its weight pack and its plain
version.

Counterpart of ``playaid_core_tpu/ops/pallas_conv_block.py``.  The public
functions keep the JAX layouts: NHWC activations, HWIO weights, folded
batch-norm scale and bias ``[C]`` in float32.

The kernel reads each conv's weights as a K-major matrix ``[C_out, 9 *
C_in]`` (depth index ``tap * C_in + c_in``).  :func:`pack_block` builds
that layout once; in float32 it also splits each weight into TF32 halves
``hi = tf32(w)`` and ``lo = tf32(w - hi)`` for the kernel's 3xTF32
products.  :class:`BlockPack` holds the result, and
:func:`residual_block_packed` launches the kernel on it, in the tile shape
and depth split that :func:`launch_shape` reads off C and B * H * W.  The model
(``models/resnet.py``) caches its pack; :func:`residual_block` packs on
every call.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from playaid_core_torch.device import full_float32
from playaid_core_torch.ops import _build

_ENTRY = {torch.float32: "residual_block_f32", torch.bfloat16: "residual_block_bf16"}
# The kernel's tiles: 64 or 128 output channels a block, depth slices of 128
# bytes (32 float32 or 64 bfloat16 input channels of one tap).
CHANNEL_MULTIPLE = 64
SMS = 132  # streaming multiprocessors of an H100 SXM
SMEM_PER_SM = 232_448  # bytes of shared memory a block may take on one
# (pixel rows, channels) a tile, fewest bytes read out of L2 a product first:
# a tile reads its activation rows once and its weight rows twice (TF32 hi
# and lo), 4 * (2 / rows + 1 / channels) bytes a multiply-add.
TILES = ((128, 128), (64, 128), (64, 64))


def launch_smem(bm, bn):
    """Shared memory of a float32 block of ``bm x bn`` tiles: 3 stages of
    128-byte depth slices of its activation and weight rows, hi and lo."""
    return 3 * 2 * (bm + bn) * 128


def launch_shape(c, m):
    """The kernel's launch for ``c`` channels and ``m = B * H * W`` pixel
    rows: ``(tile rows, tile channels, depth split)``.

    The first tile of :data:`TILES` whose grid keeps more than half of the
    SMs busy, else 64 x 64.  A cluster of 2 blocks splits the depth of each
    tile where twice the tiles still fit on the card at once (a 64 x 64
    block leaves room for a second on its SM, the larger ones do not):
    48x4x4x512 runs 64 x 128 tiles split in two (96 blocks), 48x16x16x128
    128 x 128 tiles with the whole depth (96), 48x32x32x64 64 x 64 tiles
    with the whole depth (768), 7x8x8x256 64 x 64 tiles split in two (56).
    On the card this picked the fastest of every launch at 23 of the 24
    identity-block shapes the port's routes run; at 24x32x32x64 the split
    launch was 2-6% faster, where the rule keeps the short depth whole
    (PERF.md).
    """
    for bm, bn in TILES:
        if c % bn:
            continue
        tiles = -(-m // bm) * (c // bn)
        split = 2 if 2 * tiles < SMS * (SMEM_PER_SM // launch_smem(bm, bn)) else 1
        if tiles * split > SMS // 2 or (bm, bn) == TILES[-1]:
            return bm, bn, split
    raise ValueError(f"the kernel takes channel counts that divide by {CHANNEL_MULTIPLE}, "
                     f"got {c}")


def residual_block_ref(x, w1, s1, b1, w2, s2, b2):
    """Plain version: conv3x3, scale/bias, ReLU, round to ``x.dtype``,
    conv3x3, scale/bias, ``+ x``, ReLU, in ``x.dtype``.  Convolutions run
    in full float32 (TF32 off) on float32 copies of the inputs."""
    def conv(inp, w):
        out = F.conv2d(inp.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                       padding=1)
        return out.permute(0, 2, 3, 1)

    with full_float32():
        y = torch.relu(conv(x, w1) * s1 + b1)
        y = conv(y.to(x.dtype), w2) * s2 + b2
        return torch.relu(y + x.float()).to(x.dtype)


def tf32_round(t):
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds: add half of the 13
    dropped bits to the magnitude, then clear them."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


@dataclass(frozen=True)
class BlockPack:
    """Weights and folded batch norm of one block in the kernel's layout.

    w1, w2: ``[P, C, 9 * C]`` in ``dtype``, K-major; P = 2 for float32
    (TF32 hi, then lo) and 1 for bfloat16.  s1, b1, s2, b2: ``[C]``
    float32.
    """

    w1: torch.Tensor
    s1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    s2: torch.Tensor
    b2: torch.Tensor
    dtype: torch.dtype


def _check_params(c, w1, s1, b1, w2, s2, b2):
    for w in (w1, w2):
        if tuple(w.shape) != (3, 3, c, c):
            raise ValueError(f"weights must be [3, 3, {c}, {c}], got {tuple(w.shape)}")
    for v in (s1, b1, s2, b2):
        if tuple(v.shape) != (c,):
            raise ValueError(f"scale and bias must be [{c}], got {tuple(v.shape)}")


def _pack_weight(w, dtype):
    """HWIO ``[3, 3, C, C]`` -> ``[P, C_out, 9 * C_in]``."""
    c = w.shape[3]
    k_major = w.to(dtype).permute(3, 0, 1, 2).reshape(c, 9 * c)
    if dtype == torch.bfloat16:
        return k_major.contiguous()[None]
    hi = tf32_round(k_major)
    return torch.stack([hi, tf32_round(k_major - hi)])


def unpack_weight(packed):
    """``[P, C_out, 9 * C_in]`` -> HWIO ``[3, 3, C, C]``: the weight itself
    for bfloat16, hi + lo for float32."""
    c = packed.shape[1]
    w = packed.float().sum(0) if packed.shape[0] == 2 else packed[0]
    return w.reshape(c, 3, 3, c).permute(1, 2, 3, 0)


def pack_block(w1, s1, b1, w2, s2, b2, dtype=torch.float32):
    """HWIO weights ``[3, 3, C, C]`` and folded scale/bias ``[C]`` ->
    :class:`BlockPack` for activations of ``dtype`` (float32 or
    bfloat16), on the weights' device."""
    if dtype not in _ENTRY:
        raise TypeError(f"the block runs in float32 or bfloat16, not {dtype}")
    _check_params(w1.shape[3], w1, s1, b1, w2, s2, b2)
    with torch.no_grad():
        s1, b1, s2, b2 = (v.float().contiguous() for v in (s1, b1, s2, b2))
        return BlockPack(_pack_weight(w1, dtype), s1, b1, _pack_weight(w2, dtype), s2, b2,
                         dtype)


def _library(dtype):
    fn = getattr(_build.load("residual_block"), _ENTRY[dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def residual_block_packed(x, pack, channels_first=False):
    """Fused identity BasicBlock at inference on a :class:`BlockPack`.

    x ``[B, H, W, C]`` in ``pack.dtype``; returns ``[B, H, W, C]`` in
    ``x.dtype``, contiguous, or with ``channels_first`` a view of
    ``[B, C, H, W]`` storage (what a cuDNN convolution after the block
    takes without a conversion).  Any batch size and map size work.  On
    CUDA the kernel takes channel counts that divide by 64 (its depth
    slice) and raises on others, and launches in the shape
    :func:`launch_shape` picks; on the CPU the plain version runs on the
    unpacked weights.
    """
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C], got {tuple(x.shape)}")
    if x.dtype != pack.dtype:
        raise TypeError(f"x is {x.dtype} but the pack was built for {pack.dtype}")
    c = x.shape[3]
    halves = 2 if x.dtype == torch.float32 else 1
    for w in (pack.w1, pack.w2):
        if tuple(w.shape) != (halves, c, 9 * c) or w.dtype != x.dtype or not w.is_contiguous():
            raise ValueError(f"packed weights must be contiguous [{halves}, {c}, {9 * c}] "
                             f"{x.dtype}, got {tuple(w.shape)} {w.dtype}")
    if x.device.type == "cpu":
        out = residual_block_ref(x, unpack_weight(pack.w1), pack.s1, pack.b1,
                                 unpack_weight(pack.w2), pack.s2, pack.b2)
        return out.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1) if channels_first else out
    if x.device.type != "cuda":
        raise ValueError(f"residual_block runs on CUDA or the CPU, not {x.device}")
    if c % CHANNEL_MULTIPLE:
        raise ValueError(f"the kernel takes channel counts that divide by "
                         f"{CHANNEL_MULTIPLE}, got {c}")
    x = x.contiguous()
    args = (x, pack.w1, pack.s1, pack.b1, pack.w2, pack.s2, pack.b2)
    if any(t.device != x.device for t in args):
        raise ValueError("x and the pack must lie on the same CUDA device")
    b, h, w, _ = x.shape
    mid = torch.empty_like(x)
    if channels_first:
        out = torch.empty((b, c, h, w), dtype=x.dtype, device=x.device).permute(0, 2, 3, 1)
    else:
        out = torch.empty_like(x)
    status = _library(x.dtype)(
        *(t.data_ptr() for t in args), mid.data_ptr(), out.data_ptr(), b, h, w, c,
        *launch_shape(c, b * h * w), int(channels_first), _build.current_stream(x.device),
    )
    _build.check(status, "residual_block launch")
    _build.count_launch(residual_block_packed)
    return out


residual_block_packed.launches = 0


def residual_block(x, w1, s1, b1, w2, s2, b2):
    """Fused identity BasicBlock at inference, from the JAX layouts.

    x ``[B, H, W, C]`` float32 or bfloat16; w1, w2 ``[3, 3, C, C]`` (cast
    to ``x.dtype``, as the TPU kernel casts them); s1, b1, s2, b2 ``[C]``
    folded batch-norm scale and bias.  Returns ``[B, H, W, C]`` in
    ``x.dtype``.  On CUDA the weights are packed on every call (the model
    caches its pack instead) and C must divide by 64.  No gradient:
    inference only.
    """
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C], got {tuple(x.shape)}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    _check_params(x.shape[3], w1, s1, b1, w2, s2, b2)
    if x.device.type == "cpu":
        return residual_block_ref(x, w1.to(x.dtype), s1, b1, w2.to(x.dtype), s2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"residual_block runs on CUDA or the CPU, not {x.device}")
    return residual_block_packed(x, pack_block(w1, s1, b1, w2, s2, b2, x.dtype))
