"""The weights a cell runs: read from a Flax-layout ``.npz`` (the committed
trained CNN-63) or drawn from the seed on the device, as each family's
``families/<family>.py`` chooses.

Both give ``{"embed": state dict, "head": state dict}`` under torchvision's
and ``nn.TransformerEncoderLayer``'s names.  The harness hands the drawn
weights to the program and the same tensors to the reference; the
``.npz`` is read by each side on its own.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from portbench.reference.models import STAGES

_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _flax_block_key(block, part, leaf):
    """``BasicBlock_<k>``, ``Conv_0`` etc. of a Flax ResNet-18 -> torchvision."""
    k = int(block.split("_")[1])
    stage = 0
    for stage, size in enumerate(STAGES["resnet18"]):
        if k < size:
            break
        k -= size
    names = {"conv_proj": "downsample.0", "norm_proj": "downsample.1"}
    m = re.fullmatch(r"(Conv|BatchNorm)_(\d)", part)
    name = names.get(part) or f"{'conv' if m.group(1) == 'Conv' else 'bn'}{int(m.group(2)) + 1}"
    return f"layer{stage + 1}.{k}.{name}.{'weight' if leaf == 'kernel' else _BN[leaf]}"


def _tensor(value, kernel_4d=False, dense=False):
    value = np.asarray(value, np.float32)
    if kernel_4d:
        value = value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    elif dense:
        value = value.T
    return torch.from_numpy(np.ascontiguousarray(value))


def load_flax_cnn(path, device):
    """The CNN family's ``{embed, head}`` from a Flax-layout ``.npz``
    (keys ``embed/params/cnn2d/...``, ``embed/batch_stats/cnn2d/...``,
    ``head/params/<layer>/{kernel, bias}``)."""
    embed, head = {}, {}
    with np.load(path) as z:
        for key in z.files:
            parts = key.split("/")
            value = z[key]
            if parts[0] == "head":
                layer, leaf = parts[2], parts[3]
                head[f"{layer}.{'weight' if leaf == 'kernel' else 'bias'}"] = _tensor(
                    value, dense=leaf == "kernel")
                continue
            module, leaf = parts[3:-1], parts[-1]
            if module[0] == "conv_init":
                embed["conv1.weight"] = _tensor(value, kernel_4d=True)
            elif module[0] == "bn_init":
                embed[f"bn1.{_BN[leaf]}"] = _tensor(value)
            elif module[0] == "head":
                embed[f"fc.{'weight' if leaf == 'kernel' else 'bias'}"] = _tensor(
                    value, dense=leaf == "kernel")
            else:
                embed[_flax_block_key(module[0], module[1], leaf)] = _tensor(
                    value, kernel_4d=value.ndim == 4)
    return {"embed": {k: v.to(device) for k, v in embed.items()},
            "head": {k: v.to(device) for k, v in head.items()}}


def resnet_spec(arch, prefix, fc_out):
    """``(name, shape)`` of a ResNet's parameters and batch-norm buffers."""
    spec = [(prefix + "conv1.weight", (64, 3, 7, 7))] + _bn_spec(prefix + "bn1", 64)
    bottleneck = arch == "resnet50"
    expansion = 4 if bottleneck else 1
    in_planes = 64
    for i, blocks in enumerate(STAGES[arch]):
        planes = 64 * 2 ** i
        for j in range(blocks):
            stride = 2 if i > 0 and j == 0 else 1
            p = f"{prefix}layer{i + 1}.{j}."
            if bottleneck:
                convs = [("conv1", (planes, in_planes, 1, 1)), ("conv2", (planes, planes, 3, 3)),
                         ("conv3", (planes * 4, planes, 1, 1))]
            else:
                convs = [("conv1", (planes, in_planes, 3, 3)), ("conv2", (planes, planes, 3, 3))]
            for n, (conv, shape) in enumerate(convs):
                spec.append((f"{p}{conv}.weight", shape))
                spec += _bn_spec(f"{p}bn{n + 1}", shape[0])
            if stride != 1 or in_planes != planes * expansion:
                spec.append((p + "downsample.0.weight", (planes * expansion, in_planes, 1, 1)))
                spec += _bn_spec(p + "downsample.1", planes * expansion)
            in_planes = planes * expansion
    if fc_out:
        spec += [(prefix + "fc.weight", (fc_out, in_planes)), (prefix + "fc.bias", (fc_out,))]
    return spec


def _bn_spec(p, c):
    return [(f"{p}.weight", (c,)), (f"{p}.bias", (c,)), (f"{p}.running_mean", (c,)),
            (f"{p}.running_var", (c,)), (f"{p}.num_batches_tracked", ())]


def linear_spec(p, n_in, n_out):
    return [(f"{p}.weight", (n_out, n_in)), (f"{p}.bias", (n_out,))]


@torch.no_grad()
def seeded(spec, seed, device):
    """Weights of ``spec`` from ``seed``, made on ``device`` in one draw:
    matrices and kernels ~ N(0, 1/fan_in), biases 0, norm scales 1,
    running means 0, running variances 1, counters 0."""
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    drawn = [(g, n, s) for g in spec for n, s in spec[g] if len(s) >= 2]
    flat = torch.randn(sum(int(np.prod(s)) for _, _, s in drawn), generator=gen, device=device)
    out = {g: {} for g in spec}
    at = 0
    for g, name, shape in drawn:
        size = int(np.prod(shape))
        fan_in = size // shape[0]
        out[g][name] = flat[at:at + size].view(shape).mul_(fan_in ** -0.5)
        at += size
    for g in spec:
        for name, shape in spec[g]:
            if name in out[g]:
                continue
            if name.endswith("num_batches_tracked"):
                out[g][name] = torch.zeros((), dtype=torch.int64, device=device)
            elif name.endswith(("running_var", "weight")):
                out[g][name] = torch.ones(shape, device=device)
            else:
                out[g][name] = torch.zeros(shape, device=device)
        out[g] = {name: out[g][name] for name, _ in spec[g]}
    return out
