"""Carry weights from the JAX package's parameter trees into the port.

A tree is a nested dict of numpy arrays, as ``BatchedActionPipeline.init``
in the JAX package returns it or as :func:`load_npz_tree` reads a saved
one: ``{"embed": {"params": ..., "batch_stats": ...}, "head": {"params":
...}}``.  :func:`from_jax_cnn` turns the CNN family's tree into the
port's state dicts.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_BLOCK_PARTS = {
    "Conv_0": "conv1", "BatchNorm_0": "bn1", "Conv_1": "conv2", "BatchNorm_1": "bn2",
    "conv_proj": "downsample.0", "norm_proj": "downsample.1",
}
_BN_FIELDS = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
_HEAD_LAYERS = ("temporal_dense", "mlp_hidden", "classifier")


def load_npz_tree(path):
    """Read an ``.npz`` whose keys are '/'-joined tree paths into a nested
    dict of float32 arrays (float16 arrays are stored to halve the file)."""
    tree = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = np.asarray(z[key], np.float32)
    return tree


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _resnet_key(path):
    """('conv_init', 'kernel') etc. -> the torchvision parameter name."""
    module, leaf = path[:-1], path[-1]
    if module[0] == "conv_init":
        return "conv1.weight"
    if module[0] == "bn_init":
        return f"bn1.{_BN_FIELDS[leaf]}"
    if module[0] == "head":
        return f"fc.{'weight' if leaf == 'kernel' else 'bias'}"
    match = re.fullmatch(r"BasicBlock_(\d+)", module[0])
    if match is None or len(module) != 2 or module[1] not in _BLOCK_PARTS:
        raise KeyError(f"no ResNet-18 parameter for {'/'.join(path)}")
    k = int(match.group(1))
    part = _BLOCK_PARTS[module[1]]
    name = "weight" if leaf == "kernel" else _BN_FIELDS[leaf]
    return f"layer{k // 2 + 1}.{k % 2}.{part}.{name}"


def _tensor(key, value):
    value = np.asarray(value, np.float32)
    if key.endswith("weight") and value.ndim == 4:  # HWIO -> OIHW
        value = value.transpose(3, 2, 0, 1)
    elif key.endswith("weight") and value.ndim == 2:  # Dense kernel -> Linear weight
        value = value.T
    return torch.from_numpy(np.ascontiguousarray(value))


def from_jax_cnn(variables):
    """Split ``{embed, head}`` CNN tree -> ``{"embed": ResNet-18 state
    dict, "head": CNNTemporalHead state dict}``.  Every leaf of the tree
    maps to exactly one entry; an unknown leaf raises ``KeyError``."""
    embed = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables["embed"].get(collection, {})):
            if path[0] != "cnn2d":
                raise KeyError(f"no ResNet-18 parameter for {'/'.join(path)}")
            key = _resnet_key(path[1:])
            if key in embed:
                raise KeyError(f"two leaves map to {key}")
            embed[key] = _tensor(key, value)
    for key in [k for k in embed if k.endswith("running_var")]:
        embed[key.replace("running_var", "num_batches_tracked")] = torch.tensor(0)

    head = {}
    for path, value in _flatten(variables["head"]["params"]):
        if len(path) != 2 or path[0] not in _HEAD_LAYERS or path[1] not in ("kernel", "bias"):
            raise KeyError(f"no temporal-head parameter for {'/'.join(path)}")
        key = f"{path[0]}.{'weight' if path[1] == 'kernel' else 'bias'}"
        head[key] = _tensor(key, value)
    return {"embed": embed, "head": head}
