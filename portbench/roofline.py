"""Operations and bytes of the cells' work, from shapes alone.

Each multiply-add of the algorithm counts as two operations, once, and each
input byte read and output byte written counts once, whatever an
implementation reads again or computes twice (K2's three TF32 passes are
one product here).  :func:`least_s` turns a count into the least time the
card could take; a roofline share is that time over the measured time.
"""

from __future__ import annotations

from portbench.constants import PEAK_HBM_BYTES, PEAK_TF32_FLOPS

F32 = 4


def least_s(flops, nbytes):
    """The least seconds: the larger of operations over the float32 peak
    and bytes over the memory bandwidth."""
    return max(flops / PEAK_TF32_FLOPS, nbytes / PEAK_HBM_BYTES)


def conv_flops(hw_out, c_in, c_out, k):
    return 2 * hw_out[0] * hw_out[1] * c_in * c_out * k * k


STAGES = {"resnet18": ((2, 2, 2, 2), False), "resnet50": ((3, 4, 6, 3), True)}


def _blocks(arch, size):
    """Each block of ResNet-18 (``resnet18``) or ResNet-50 (``resnet50``)
    at ``size`` x ``size`` pixels, in order: ``(in_planes, planes,
    out_planes, stride, side in, side out)``."""
    s = -(-size // 2)  # the 7x7/2 stem
    s = -(-s // 2)  # the max pool
    in_planes = 64
    stages, bottleneck = STAGES[arch]
    for i, blocks in enumerate(stages):
        planes = 64 * 2 ** i
        out_planes = planes * (4 if bottleneck else 1)
        for j in range(blocks):
            stride = 2 if i > 0 and j == 0 else 1
            s_out = -(-s // stride)
            yield in_planes, planes, out_planes, stride, s, s_out
            in_planes, s = out_planes, s_out


def resnet_flops(arch, size):
    """One crop's convolutions in ResNet-18 (``resnet18``) or ResNet-50
    (``resnet50``) at ``size`` x ``size`` pixels, to the pooled features."""
    s = -(-size // 2)
    total = conv_flops((s, s), 3, 64, 7)
    bottleneck = STAGES[arch][1]
    for in_planes, planes, out_planes, stride, s, s_out in _blocks(arch, size):
        if bottleneck:
            total += conv_flops((s, s), in_planes, planes, 1)
            total += conv_flops((s_out, s_out), planes, planes, 3)
            total += conv_flops((s_out, s_out), planes, out_planes, 1)
        else:
            total += conv_flops((s_out, s_out), in_planes, planes, 3)
            total += conv_flops((s_out, s_out), planes, planes, 3)
        if stride != 1 or in_planes != out_planes:
            total += conv_flops((s_out, s_out), in_planes, out_planes, 1)
    return total


def identity_blocks(arch, size):
    """``(channels, height, width)`` of each block of the trunk that keeps
    its input's shape (stride 1, channels unchanged), in order."""
    return [(o, s, s) for i, _, o, stride, s, _ in _blocks(arch, size) if stride == 1 and i == o]


def linear_flops(n_in, n_out, rows=1):
    return 2 * rows * n_in * n_out


def frame_flops(config, stride, family, fighters=2):
    """The model's operations a video frame: each sampled frame embeds one
    crop a fighter and runs one window a fighter through the head, by the
    counts of ``family``, the configuration's ``families/<family>.py``."""
    return fighters * (family.embed_flops(config) + family.head_flops(config)) / stride


def k2_counts(crops, channels, hw):
    """``(flops, bytes)`` of the fused identity block (conv 3x3, folded
    batch norm, ReLU, conv 3x3, folded batch norm, residual, ReLU) on
    ``crops`` float32 maps of ``hw`` x ``channels``."""
    positions = crops * hw[0] * hw[1]
    flops = 2 * conv_flops(hw, channels, channels, 3) * crops
    act = positions * channels * F32
    weights = 2 * 9 * channels * channels * F32 + 4 * channels * F32
    return flops, 2 * act + weights


def k4_bytes(crops, size):
    """The YUV420 unpack: packed uint8 crops in, float32 RGB out."""
    return crops * (size * size * 3 // 2 + 3 * size * size * F32)


def h2d_bytes_per_frame(size, stride, fighters=2):
    """The native route's host-to-device bytes a video frame: one packed
    YUV420 crop a fighter of each sampled frame."""
    return fighters * (size * size * 3 // 2) // stride
