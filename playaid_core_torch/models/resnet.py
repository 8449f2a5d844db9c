"""ResNet-18 in PyTorch, under torchvision's parameter names.

Counterpart of ``playaid_core_tpu/models/resnet.py`` (the BasicBlock
network; the Bottleneck and ResNet-50 come with the ResFormer family).
It keeps the Flax model's conventions: a 7x7/2 stem with padding 3, 3x3
convs with padding 1, a 1x1 stride-2 projection with no padding, a 3/2/1
max-pool padded with -inf, a mean pool, batch norm with eps 1e-5, and a
dense head to 1000 features.  Activations are NCHW inside the network.

At inference on a CUDA tensor, ``layer4[1]`` (the identity block of the
last stage, 4x4x512 at 128-px input) runs as the fused CUDA kernel of
``ops/conv_block.py`` with batch norm folded from its running statistics.
In training mode, or on the CPU, every block runs unfused.
"""

from __future__ import annotations

import torch
from torch import nn

from playaid_core_torch.ops.conv_block import residual_block

BN_EPS = 1e-5


def fold_batch_norm(bn: nn.BatchNorm2d):
    """Inference batch norm as ``y * scale + bias``."""
    scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    return scale, bn.bias - bn.running_mean * scale


class BasicBlock(nn.Module):
    """Two 3x3 convs with a residual; a 1x1 projection when the shape
    changes.  ``fused=True`` routes inference on CUDA through the fused
    kernel (identity blocks only)."""

    def __init__(self, in_planes, planes, stride=1, fused=False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes, eps=BN_EPS)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes, eps=BN_EPS)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride, bias=False),
                nn.BatchNorm2d(planes, eps=BN_EPS),
            )
        if fused and self.downsample is not None:
            raise ValueError("the fused kernel computes identity blocks only")
        self.fused = fused

    def forward(self, x):
        if self.fused and x.is_cuda and not self.training:
            return self._fused_forward(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(residual + y)

    def _fused_forward(self, x):
        s1, b1 = fold_batch_norm(self.bn1)
        s2, b2 = fold_batch_norm(self.bn2)
        out = residual_block(
            x.permute(0, 2, 3, 1),
            self.conv1.weight.permute(2, 3, 1, 0), s1, b1,
            self.conv2.weight.permute(2, 3, 1, 0), s2, b2,
        )
        return out.permute(0, 3, 1, 2)


class ResNet18(nn.Module):
    """ResNet-18 v1: NCHW float input -> ``[N, num_classes]`` float32."""

    def __init__(self, num_classes=1000):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=BN_EPS)
        self.maxpool = nn.MaxPool2d(3, 2, padding=1)
        widths = (64, 128, 256, 512)
        in_planes = 64
        for i, planes in enumerate(widths):
            stride = 1 if i == 0 else 2
            blocks = [BasicBlock(in_planes, planes, stride),
                      BasicBlock(planes, planes, 1, fused=(i == 3))]
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
            in_planes = planes
        self.fc = nn.Linear(512, num_classes)

    def forward(self, x):
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.fc(x.mean(dim=(2, 3))).float()
