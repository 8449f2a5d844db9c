"""ResNet-18 and ResNet-50 in PyTorch, under torchvision's parameter names.

Counterpart of ``playaid_core_tpu/models/resnet.py``.  It keeps the Flax
model's conventions: a 7x7/2 stem with padding 3, 3x3 convs with padding
1, a 1x1 projection with no padding wherever a block changes shape, a
3/2/1 max-pool padded with -inf, a mean pool, batch norm with eps 1e-5,
and a dense head (``num_classes=0`` returns the pooled features: 512 for
ResNet-18, 2048 for ResNet-50).  The Bottleneck block puts its stride on
the 3x3 conv.  Activations are NCHW inside the network.

At inference on a CUDA tensor, every identity BasicBlock of a ResNet-18
or ResNet-34 (stride 1, as many channels in as out: ResNet-18's
``layer1[0]``, ``layer1[1]``, ``layer2[1]``, ``layer3[1]`` and
``layer4[1]``, from 32x32x64 to 4x4x512 at the action model's 128-px
crops and from 64x112x64 to 8x14x512 in the detector's trunk at 256x448)
runs as the fused CUDA kernel of ``ops/conv_block.py`` with batch norm
folded from its running statistics, whatever ``num_classes`` is; blocks
with a projection and the stem run on cuDNN.  The kernel takes
channels-last maps: a run of fused blocks copies its input to that layout
once, passes it on from block to block, and its last block writes its
output channels first, as cuDNN takes it.  Each block packs its
weights and folded batch norm for the kernel once and keeps the pack until
a tensor it was built from changes.  In training mode, or on the CPU,
every block runs unfused.

ResNet-50 has no BasicBlock.  At inference on a CUDA float32 tensor each
of its Bottleneck blocks runs its three 1x1 convolutions (``conv1``,
``conv3`` and the ``downsample`` projection) on the 1x1 kernel of
``ops/conv1x1.py``, with batch norm folded from its running statistics and
the ReLU and the residual in the kernel's epilogue; its 3x3 ``conv2``, the
stem and the pool stay on cuDNN, NCHW throughout.  A Bottleneck keeps its
pack as a fused BasicBlock does.  In training mode, on the CPU and for
other types it runs unfused.

Training follows Flax: batch norm (:class:`BatchNorm2d`) normalises with
the biased batch variance and moves its running statistics by momentum 0.9
toward the batch mean and the *biased* batch variance (``nn.BatchNorm2d``
would take the unbiased one), and :func:`init_flax_` draws weights as the
Flax modules initialise them.  The fused kernel has no backward and never
runs in training mode.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from playaid_core_torch import profiling
from playaid_core_torch.ops.conv1x1 import Conv1x1Pack, conv1x1_packed, pack_conv1x1
from playaid_core_torch.ops.conv_block import pack_block, residual_block_packed
from playaid_core_torch.parallel.mesh import data_batch_norm

BN_EPS = 1e-5
FLAX_MOMENTUM = 0.1  # torch's convention: Flax's momentum 0.9


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (same parameters and buffers) whose training-mode
    update is Flax's ``BatchNorm(momentum=0.9)``: running mean and variance
    move by a tenth toward the batch mean and the biased batch variance.
    In eval mode it is ``nn.BatchNorm2d`` on the running statistics.

    On a mesh (``parallel.mesh.attach_mesh``) whose ``data`` axis splits the
    batch, the training-mode statistics span the whole batch
    (``mesh.data_batch_norm``), as under the JAX package's ``pjit``."""

    mesh = None

    def __init__(self, num_features, eps=BN_EPS):
        super().__init__(num_features, eps=eps, momentum=FLAX_MOMENTUM)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if self.mesh is not None and self.mesh.axis_size("data") > 1:
            y, mean, var = data_batch_norm(x, self.weight, self.bias, self.mesh, self.eps)
            self._update_running_stats(mean, var)
            return y
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        self._update_running_stats(mean, var)
        return y

    @torch.no_grad()
    def _update_running_stats(self, mean, var):
        self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
        self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
        self.num_batches_tracked.add_(1)


def at_least_float32(x):
    """float32 for lower precisions, as the JAX models cast their outputs;
    float64 stays float64 (a reference run in double precision)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def fold_batch_norm(bn: nn.BatchNorm2d):
    """Inference batch norm as ``y * scale + bias``."""
    scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    return scale, bn.bias - bn.running_mean * scale


class PackedBlock(nn.Module):
    """A block that keeps a kernel pack of its weights and folded batch norm.

    :meth:`kept_pack` builds it at the first call and keeps it while every
    tensor it reads (``_pack_sources``) is the same tensor at the same
    version: ``load_state_dict``, an in-place edit, a move to another device
    and the running statistics of a training step all change a version or a
    pointer and force a rebuild, and ``train()`` drops it.
    """

    def __init__(self):
        super().__init__()
        self._pack = None  # (key, pack) of the last fused call

    def _pack_sources(self):
        raise NotImplementedError

    def kept_pack(self, build, *key):
        """The pack ``build()`` made for ``key`` and the current sources,
        built anew (without autograd) when either changed."""
        key += tuple((t.data_ptr(), t.device, t._version) for t in self._pack_sources())
        if self._pack is None or self._pack[0] != key:
            with torch.no_grad():
                self._pack = (key, build())
        return self._pack[1]

    def train(self, mode=True):
        self._pack = None
        return super().train(mode)


class BasicBlock(PackedBlock):
    """Two 3x3 convs with a residual; a 1x1 projection when the shape
    changes.  ``fused=True`` routes inference on CUDA through the fused
    kernel (identity blocks only).  A fused block hands its output on
    channels first (NCHW storage) unless ``channels_first_out`` is False,
    which :class:`ResNet` sets where a fused block follows."""

    def __init__(self, in_planes, planes, stride=1, fused=False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, padding=1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, padding=1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride, bias=False),
                BatchNorm2d(planes),
            )
        if fused and self.downsample is not None:
            raise ValueError("the fused kernel computes identity blocks only")
        self.fused = fused
        self.channels_first_out = True

    def forward(self, x):
        if self.fused and x.is_cuda and not self.training:
            return self._fused_forward(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(residual + y)

    def _pack_sources(self):
        return (self.conv1.weight, self.bn1.weight, self.bn1.bias, self.bn1.running_mean,
                self.bn1.running_var, self.conv2.weight, self.bn2.weight, self.bn2.bias,
                self.bn2.running_mean, self.bn2.running_var)

    def block_pack(self, dtype):
        """The kernel's pack of this block for activations of ``dtype``,
        kept as :class:`PackedBlock` keeps it."""

        def build():
            return pack_block(self.conv1.weight.permute(2, 3, 1, 0), *fold_batch_norm(self.bn1),
                              self.conv2.weight.permute(2, 3, 1, 0), *fold_batch_norm(self.bn2),
                              dtype)

        return self.kept_pack(build, dtype)

    def _fused_forward(self, x):
        out = residual_block_packed(x.permute(0, 2, 3, 1), self.block_pack(x.dtype),
                                    channels_first=self.channels_first_out)
        profiling.count("k2_blocks", 1)
        return out.permute(0, 3, 1, 2)


def block_packs(module):
    """``(block, pack)`` for each block of ``module`` that holds a kernel
    pack now (a fused BasicBlock's or a Bottleneck's): what a CUDA graph
    captured from ``module`` reads besides its parameters and buffers."""
    return [(m, m._pack) for m in module.modules()
            if isinstance(m, PackedBlock) and m._pack is not None]


@dataclass(frozen=True)
class BottleneckPack:
    """A Bottleneck's 1x1 convolutions in the 1x1 kernel's layout, each with
    its folded batch norm; ``downsample`` None for an identity block."""

    conv1: Conv1x1Pack
    conv3: Conv1x1Pack
    downsample: Conv1x1Pack | None = None


class Bottleneck(PackedBlock):
    """1x1 -> 3x3 (carrying the stride) -> 1x1 with 4x expansion, and a
    residual; a 1x1 projection when the shape changes.  At inference on a
    CUDA float32 tensor the three 1x1 convolutions run on the 1x1 kernel
    (``ops/conv1x1.py``), batch norm folded, unless autograd would want a
    gradient through the block: the kernel has none."""

    expansion = 4

    def __init__(self, in_planes, planes, stride=1):
        super().__init__()
        out_planes = planes * self.expansion
        self.conv1 = nn.Conv2d(in_planes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, padding=1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, out_planes, 1, bias=False)
        self.bn3 = BatchNorm2d(out_planes)
        self.downsample = None
        if stride != 1 or in_planes != out_planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, out_planes, 1, stride, bias=False),
                BatchNorm2d(out_planes),
            )

    def forward(self, x):
        if self.runs_fused(x):
            return self._fused_forward(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(residual + y)

    def runs_fused(self, x):
        """Whether the block takes the 1x1 kernel for ``x``: a CUDA float32
        tensor in eval mode, with no gradient wanted (grad mode off, or
        neither ``x`` nor a parameter requires one)."""
        return (x.is_cuda and not self.training and x.dtype == torch.float32
                and not (torch.is_grad_enabled() and (
                    x.requires_grad or any(p.requires_grad for p in self.parameters()))))

    def _convs(self):
        pairs = [(self.conv1, self.bn1), (self.conv3, self.bn3)]
        return pairs + ([tuple(self.downsample)] if self.downsample is not None else [])

    def _pack_sources(self):
        return tuple(t for conv, bn in self._convs()
                     for t in (conv.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var))

    def block_pack(self):
        """The 1x1 kernel's pack of this block, kept as :class:`PackedBlock`
        keeps it."""
        return self.kept_pack(lambda: BottleneckPack(
            *(pack_conv1x1(conv.weight, *fold_batch_norm(bn)) for conv, bn in self._convs())))

    def _fused_forward(self, x):
        """The block with its 1x1 convolutions on the kernel: the projection
        (no ReLU), ``conv1`` with the ReLU, ``conv2`` -> ``bn2`` -> ReLU on
        cuDNN, ``conv3`` with the residual and the last ReLU."""
        pack = self.block_pack()
        residual = x
        if pack.downsample is not None:
            residual = conv1x1_packed(x, pack.downsample, self.downsample[0].stride[0],
                                      relu=False)
        y = conv1x1_packed(x, pack.conv1)
        y = torch.relu(self.bn2(self.conv2(y)))
        out = conv1x1_packed(y, pack.conv3, residual=residual)
        profiling.count("k5_convs", 2 if pack.downsample is None else 3)
        return out


class ResNet(nn.Module):
    """ResNet v1: NCHW float input -> ``[N, num_classes]`` float32 (float64
    for float64 weights and input), or the
    pooled features when ``num_classes=0``, or with ``return_feature_map``
    the stride-32 map ``[N, C, H/32, W/32]`` before the pool (the
    detector's trunk).  In a BasicBlock network every identity block (stride
    1, ``in_planes == planes``) is a fused kernel's block; in a Bottleneck
    network every block runs its 1x1s on the 1x1 kernel at inference on a
    CUDA float32 tensor."""

    def __init__(self, block, stage_sizes, num_classes=1000, return_feature_map=False):
        super().__init__()
        self.return_feature_map = return_feature_map
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, 2, padding=1)
        expansion = getattr(block, "expansion", 1)
        in_planes = 64
        for i, num_blocks in enumerate(stage_sizes):
            planes = 64 * 2 ** i
            blocks = []
            for j in range(num_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                if block is BasicBlock:
                    fused = stride == 1 and in_planes == planes
                    blocks.append(BasicBlock(in_planes, planes, stride, fused=fused))
                else:
                    blocks.append(block(in_planes, planes, stride))
                in_planes = planes * expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        chain = [m for m in self.modules() if isinstance(m, BasicBlock)]
        for block, after in zip(chain, chain[1:]):
            block.channels_first_out = not after.fused
        self.fc = nn.Linear(in_planes, num_classes) if num_classes else None

    def forward(self, x):
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.return_feature_map:
            return x
        x = x.mean(dim=(2, 3))
        if self.fc is not None:
            x = self.fc(x)
        return at_least_float32(x)


class ResNet18(ResNet):
    def __init__(self, num_classes=1000, return_feature_map=False):
        super().__init__(BasicBlock, (2, 2, 2, 2), num_classes, return_feature_map)


class ResNet34(ResNet):
    def __init__(self, num_classes=1000, return_feature_map=False):
        super().__init__(BasicBlock, (3, 4, 6, 3), num_classes, return_feature_map)


class ResNet50(ResNet):
    def __init__(self, num_classes=1000):
        super().__init__(Bottleneck, (3, 4, 6, 3), num_classes)


FEATURE_DIMS = {"resnet18": 512, "resnet34": 512, "resnet50": 2048}


def make_resnet(arch: str, num_classes: int = 1000, return_feature_map=False, s2d_stem=False):
    """``resnet18``, ``resnet34`` or ``resnet50``.  ``s2d_stem`` is accepted
    for the JAX signature: its space-to-depth stem computes the same 7x7/2
    convolution from the same kernel, and the port runs the plain stem."""
    del s2d_stem
    if arch == "resnet50":
        if return_feature_map:
            raise ValueError("the port's ResNet-50 returns pooled features or logits")
        return ResNet50(num_classes)
    return {"resnet18": ResNet18, "resnet34": ResNet34}[arch](num_classes, return_feature_map)


# Flax's lecun_normal: a normal truncated at two standard deviations,
# rescaled so that the truncated draw has variance 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(weight, generator=None, fan_in=None):
    """Flax's ``lecun_normal()`` on a torch weight.  ``fan_in`` defaults to
    everything but the first axis (OIHW conv, ``[out, in]`` Linear); a
    ``ConvTranspose2d`` weight is ``[in, out, kh, kw]`` and its fan in, as
    Flax's ``ConvTranspose`` kernel ``(kh, kw, in, out)`` counts it, is
    ``in * kh * kw``."""
    fan_in = weight[0].numel() if fan_in is None else fan_in
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


@torch.no_grad()
def init_flax_(module, generator=None):
    """Initialise ``module``'s convolutions (transposed ones included),
    linear layers and norms in place as the Flax modules do: lecun_normal
    kernels, zero biases, unit norm scales, running mean 0 and variance 1,
    and a zero scale on each residual block's last batch norm (``bn2`` of a
    BasicBlock, ``bn3`` of a Bottleneck).  Draws in module order from
    ``generator``."""
    for m in module.modules():
        if isinstance(m, nn.ConvTranspose2d):
            lecun_normal_(m.weight, generator, m.weight.shape[0] * m.weight[0, 0].numel())
        elif isinstance(m, (nn.Conv2d, nn.Linear)):
            lecun_normal_(m.weight, generator)
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, nn.BatchNorm2d):
                m.reset_running_stats()
    for m in module.modules():
        if isinstance(m, BasicBlock):
            m.bn2.weight.zero_()
        elif isinstance(m, Bottleneck):
            m.bn3.weight.zero_()
    return module
