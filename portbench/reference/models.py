"""Reference networks as functions of a state dict (torchvision's names):
the parts that model families share.

* ResNet v1 (He et al. 2016, https://arxiv.org/abs/1512.03385): 7x7/2
  stem with padding 3, batch norm (eps 1e-5) on running statistics,
  ReLU, 3/2/1 max pool; BasicBlocks (ResNet-18, stages 2-2-2-2) or
  Bottlenecks with the stride on the 3x3 (ResNet-50, 3-4-6-3, expansion
  4); a 1x1 projection with batch norm where a block changes shape; mean
  pool; an optional dense layer.
* A dense layer of a state dict, and the sinusoidal time encoding.

Each family's frame encoder and head are in ``families/<family>.py``,
which import these parts.  Float32 with TF32 off unless inside
:func:`precision` ``("tf32")``.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
STAGES = {"resnet18": (2, 2, 2, 2), "resnet50": (3, 4, 6, 3)}


@contextlib.contextmanager
def precision(mode="float32"):
    """``float32``: products and convolutions in full float32; ``tf32``:
    in TF32, the next precision below (the control)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    tf32 = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _bn(x, sd, p):
    return F.batch_norm(x, sd[p + ".running_mean"], sd[p + ".running_var"], sd[p + ".weight"],
                        sd[p + ".bias"], False, 0.0, BN_EPS)


def _conv(x, sd, p, stride, padding):
    return F.conv2d(x, sd[p + ".weight"], stride=stride, padding=padding)


def resnet(x, sd, arch, prefix="", fc=True):
    """NCHW float32 crops -> pooled features (``fc=False``) or the dense
    layer's output."""
    bottleneck = arch == "resnet50"
    x = F.max_pool2d(torch.relu(_bn(_conv(x, sd, prefix + "conv1", 2, 3), sd, prefix + "bn1")),
                     3, 2, 1)
    for i, blocks in enumerate(STAGES[arch]):
        for j in range(blocks):
            stride = 2 if i > 0 and j == 0 else 1
            p = f"{prefix}layer{i + 1}.{j}."
            if bottleneck:
                y = torch.relu(_bn(_conv(x, sd, p + "conv1", 1, 0), sd, p + "bn1"))
                y = torch.relu(_bn(_conv(y, sd, p + "conv2", stride, 1), sd, p + "bn2"))
                y = _bn(_conv(y, sd, p + "conv3", 1, 0), sd, p + "bn3")
            else:
                y = torch.relu(_bn(_conv(x, sd, p + "conv1", stride, 1), sd, p + "bn1"))
                y = _bn(_conv(y, sd, p + "conv2", 1, 1), sd, p + "bn2")
            if p + "downsample.0.weight" in sd:
                x = _bn(_conv(x, sd, p + "downsample.0", stride, 0), sd, p + "downsample.1")
            x = torch.relu(x + y)
    x = x.mean(dim=(2, 3))
    if fc:
        x = F.linear(x, sd[prefix + "fc.weight"], sd[prefix + "fc.bias"])
    return x


def linear(x, sd, p):
    return F.linear(x, sd[p + ".weight"], sd[p + ".bias"])


def time_encoding(length, num_freq=4):
    """``[T, 1 + 2 num_freq]`` float32: positions linspace(0, 1, T), then
    cos and sin of pi x 2^i, computed in float64."""
    x = np.linspace(0, 1, length).reshape(-1, 1)
    cols = [x]
    for i in range(num_freq):
        cols += [np.cos(np.pi * x * 2 ** i), np.sin(np.pi * x * 2 ** i)]
    return torch.from_numpy(np.concatenate(cols, axis=1).astype(np.float32))
