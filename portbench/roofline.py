"""Operations and bytes of the cells' work, from shapes alone.

Each multiply-add of the algorithm counts as two operations, once, and each
input byte read and output byte written counts once, whatever an
implementation reads again or computes twice (K2's three TF32 passes are
one product here).  :func:`least_s` turns a count into the least time the
card could take; a roofline share is that time over the measured time.
"""

from __future__ import annotations

import numpy as np

from portbench.constants import PEAK_HBM_BYTES, PEAK_TF32_FLOPS

F32 = 4


def least_s(flops, nbytes):
    """The least seconds: the larger of operations over the float32 peak
    and bytes over the memory bandwidth."""
    return max(flops / PEAK_TF32_FLOPS, nbytes / PEAK_HBM_BYTES)


def conv_flops(hw_out, c_in, c_out, k):
    return 2 * hw_out[0] * hw_out[1] * c_in * c_out * k * k


def resnet_flops(arch, size):
    """One crop's convolutions in ResNet-18 (``resnet18``) or ResNet-50
    (``resnet50``) at ``size`` x ``size`` pixels, to the pooled features."""
    s = -(-size // 2)
    total = conv_flops((s, s), 3, 64, 7)
    s = -(-s // 2)  # max pool
    in_planes = 64
    stages, bottleneck = {"resnet18": ((2, 2, 2, 2), False),
                          "resnet50": ((3, 4, 6, 3), True)}[arch]
    for i, blocks in enumerate(stages):
        planes = 64 * 2 ** i
        out_planes = planes * (4 if bottleneck else 1)
        for j in range(blocks):
            stride = 2 if i > 0 and j == 0 else 1
            s_out = -(-s // stride)
            if bottleneck:
                total += conv_flops((s, s), in_planes, planes, 1)
                total += conv_flops((s_out, s_out), planes, planes, 3)
                total += conv_flops((s_out, s_out), planes, out_planes, 1)
            else:
                total += conv_flops((s_out, s_out), in_planes, planes, 3)
                total += conv_flops((s_out, s_out), planes, planes, 3)
            if stride != 1 or in_planes != out_planes:
                total += conv_flops((s_out, s_out), in_planes, out_planes, 1)
            in_planes, s = out_planes, s_out
    return total


def linear_flops(n_in, n_out, rows=1):
    return 2 * rows * n_in * n_out


def embed_flops(config):
    """One crop through the family's frame encoder."""
    size = config["crop_size"]
    if config["family"] == "cnn":
        return resnet_flops("resnet18", size) + linear_flops(512, config["embed_dim"])
    return resnet_flops("resnet50", size) + linear_flops(2048, config["embed_dim"])


def head_flops(config):
    """One window of ``sequence_length`` embeddings through the family's
    temporal head."""
    t, d, a = config["sequence_length"], config["embed_dim"], config["num_actions"]
    if config["family"] == "cnn":
        h = config["head"]
        return (linear_flops(t * d, h["dense"]) + linear_flops(h["dense"], h["hidden"])
                + linear_flops(h["hidden"], a))
    h = config["head"]
    e = d + 1 + 2 * h["time_freqs"]
    layer = (linear_flops(e, 3 * e, t) + 2 * 2 * t * t * e + linear_flops(e, e, t)
             + linear_flops(e, h["ffn"], t) + linear_flops(h["ffn"], e, t))
    return h["layers"] * layer + linear_flops(e, a, t)


def frame_flops(config, stride, fighters=2):
    """The model's operations a video frame: each sampled frame embeds one
    crop a fighter and runs one window a fighter through the head."""
    return fighters * (embed_flops(config) + head_flops(config)) / stride


def k2_counts(crops, channels=512, hw=(4, 4)):
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
