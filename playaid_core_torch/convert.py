"""Carry weights from the JAX package's parameter trees into the port.

A tree is a nested dict of numpy arrays, as ``BatchedActionPipeline.init``
in the JAX package returns it or as :func:`load_npz_tree` reads a saved
one: ``{"embed": {"params": ..., "batch_stats": ...}, "head": {"params":
...}}``.  :func:`from_jax_cnn`, :func:`from_jax_resformer` and
:func:`from_jax_rnn` turn a family's tree into the port's state dicts;
:func:`to_state_dicts` picks the right one, or passes state dicts
through.  A monolithic model of the JAX package (``{"params": ...,
"batch_stats": ...}`` of ``CNNActionDetector``, ``RNNActionDetector`` or
``ResnetTransformerDetector``) is split into that form by
:func:`split_monolithic`, and :func:`monolithic_state_dict` gives the port
detector's whole state dict; it also maps an optax Adam state's ``mu`` or
``nu`` tree (the structure of ``params``) onto the port's names.  Every leaf of a tree maps to exactly one entry; a leaf with no
counterpart raises ``KeyError``.

Layouts: conv HWIO -> OIHW; Dense ``[in, out]`` -> Linear ``[out, in]``;
batch norm scale/bias/mean/var -> weight/bias/running_mean/running_var;
Flax attention query/key/value ``[E, heads, head_dim]`` -> the rows of
torch's packed ``in_proj_weight``, its out kernel ``[heads, head_dim, E]``
-> ``out_proj``; Flax LSTM gates i, f, g, o -> ``nn.LSTM``'s row blocks,
the hidden-side biases in ``bias_hh`` and ``bias_ih`` at zero.  These are
the inverses of ``playaid_core_tpu/models/torch_convert.py``.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_BN_FIELDS = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
_HEAD_LAYERS = ("temporal_dense", "mlp_hidden", "classifier")
_STAGES = {"BasicBlock": (2, 2, 2, 2), "BottleneckBlock": (3, 4, 6, 3)}
_LSTM_GATES = ("i", "f", "g", "o")


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


def _block_part(name):
    """'Conv_1' -> 'conv2', 'BatchNorm_0' -> 'bn1', 'conv_proj' ->
    'downsample.0', 'norm_proj' -> 'downsample.1'; None for others."""
    if name == "conv_proj":
        return "downsample.0"
    if name == "norm_proj":
        return "downsample.1"
    match = re.fullmatch(r"(Conv|BatchNorm)_([0-2])", name)
    if match is None:
        return None
    return f"{'conv' if match.group(1) == 'Conv' else 'bn'}{int(match.group(2)) + 1}"


def _resnet_key(path, block="BasicBlock"):
    """('conv_init', 'kernel') etc. -> the torchvision parameter name."""
    module, leaf = path[:-1], path[-1]
    if module[0] == "conv_init":
        return "conv1.weight"
    if module[0] == "bn_init":
        return f"bn1.{_BN_FIELDS[leaf]}"
    if module[0] == "head":
        return f"fc.{'weight' if leaf == 'kernel' else 'bias'}"
    match = re.fullmatch(rf"{block}_(\d+)", module[0])
    part = _block_part(module[1]) if len(module) == 2 else None
    if match is None or part is None or (block == "BasicBlock" and part in ("conv3", "bn3")):
        raise KeyError(f"no ResNet parameter for {'/'.join(path)}")
    k = int(match.group(1))
    for stage, size in enumerate(_STAGES[block]):
        if k < size:
            break
        k -= size
    else:
        raise KeyError(f"no ResNet parameter for {'/'.join(path)}")
    name = "weight" if leaf == "kernel" else _BN_FIELDS[leaf]
    return f"layer{stage + 1}.{k}.{part}.{name}"


def _tensor(key, value):
    value = np.array(value, np.float32)  # a copy: nothing of the caller's tree is kept
    if key.endswith("weight") and value.ndim == 4:  # HWIO -> OIHW
        value = value.transpose(3, 2, 0, 1)
    elif key.endswith("weight") and value.ndim == 2:  # Dense kernel -> Linear weight
        value = value.T
    return torch.from_numpy(np.ascontiguousarray(value))


def _put(state, key, value):
    if key in state:
        raise KeyError(f"two leaves map to {key}")
    state[key] = value


def resnet_state_dict(params, batch_stats, block="BasicBlock", prefix=""):
    """One Flax ResNet's ``params`` and ``batch_stats`` trees -> the
    torchvision-named state dict of the port's ResNet, keys under
    ``prefix``.  ``block`` is "BasicBlock" (ResNet-18) or "BottleneckBlock"
    (ResNet-50)."""
    state = {}
    for tree in (params, batch_stats or {}):
        for path, value in _flatten(tree):
            key = _resnet_key(path, block)
            _put(state, prefix + key, _tensor(key, value))
    for key in [k for k in state if k.endswith("running_var")]:
        state[key.replace("running_var", "num_batches_tracked")] = torch.tensor(0)
    return state


def _dense(state, name, node):
    """A Flax Dense ``{kernel, bias}`` -> ``name.weight``, ``name.bias``."""
    if set(node) != {"kernel", "bias"}:
        raise KeyError(f"{name} must hold exactly a kernel and a bias, got {sorted(node)}")
    _put(state, f"{name}.weight", _tensor("weight", node["kernel"]))
    _put(state, f"{name}.bias", _tensor("bias", node["bias"]))


def _embed_state(embed, trunk, block, projection):
    """``{params: {trunk: ResNet, projection: Dense}, batch_stats: {trunk:
    ...}}`` -> ``resnet.*`` and ``projection.*``."""
    params = dict(embed["params"])
    stats = dict(embed.get("batch_stats", {}))
    resnet_params = params.pop(trunk)
    resnet_stats = stats.pop(trunk, {})
    proj = params.pop(projection)
    if params or stats:
        raise KeyError(f"no embed parameter for {sorted(params) + sorted(stats)}")
    state = resnet_state_dict(resnet_params, resnet_stats, block, prefix="resnet.")
    _dense(state, projection, proj)
    return state


def from_jax_cnn(variables):
    """Split ``{embed, head}`` CNN tree -> ``{"embed": ResNet-18 state
    dict, "head": CNNTemporalHead state dict}``."""
    embed = variables["embed"]
    for tree in (embed.get("params", {}), embed.get("batch_stats", {})):
        if set(tree) - {"cnn2d"}:
            raise KeyError(f"no ResNet-18 parameter for {sorted(set(tree) - {'cnn2d'})}")
    embed_state = resnet_state_dict(embed.get("params", {}).get("cnn2d", {}),
                                    embed.get("batch_stats", {}).get("cnn2d", {}))
    head = {}
    for path, value in _flatten(variables["head"]["params"]):
        if len(path) != 2 or path[0] not in _HEAD_LAYERS or path[1] not in ("kernel", "bias"):
            raise KeyError(f"no temporal-head parameter for {'/'.join(path)}")
        key = f"{path[0]}.{'weight' if path[1] == 'kernel' else 'bias'}"
        head[key] = _tensor(key, value)
    return {"embed": embed_state, "head": head}


def _attention_state(state, prefix, node):
    """Flax MultiHeadDotProductAttention -> torch's packed in_proj and
    out_proj."""
    if set(node) != {"query", "key", "value", "out"}:
        raise KeyError(f"no attention parameter for {sorted(node)}")
    rows, biases = [], []
    for part in ("query", "key", "value"):
        kernel = np.asarray(node[part]["kernel"], np.float32)  # [E, heads, head_dim]
        e = kernel.shape[0]
        rows.append(kernel.reshape(e, e).T)
        biases.append(np.asarray(node[part]["bias"], np.float32).reshape(e))
    out = np.asarray(node["out"]["kernel"], np.float32)  # [heads, head_dim, E]
    _put(state, f"{prefix}.in_proj_weight", torch.from_numpy(np.concatenate(rows)))
    _put(state, f"{prefix}.in_proj_bias", torch.from_numpy(np.concatenate(biases)))
    _put(state, f"{prefix}.out_proj.weight",
         torch.from_numpy(np.ascontiguousarray(out.reshape(e, e).T)))
    _put(state, f"{prefix}.out_proj.bias", _vector(node["out"]["bias"]))


def _vector(value):
    return torch.from_numpy(np.array(value, np.float32, order="C"))


def _layer_norm(state, name, node):
    if set(node) != {"scale", "bias"}:
        raise KeyError(f"{name} must hold exactly a scale and a bias, got {sorted(node)}")
    _put(state, f"{name}.weight", _vector(node["scale"]))
    _put(state, f"{name}.bias", _vector(node["bias"]))


def transformer_layer_state(node, prefix=""):
    """One Flax ``TransformerEncoderLayer``'s params -> the port's
    ``TransformerEncoderLayer`` state dict, keys under ``prefix``."""
    if set(node) != {"self_attn", "norm1", "norm2", "ffn_in", "ffn_out"}:
        raise KeyError(f"no transformer-layer parameter for {sorted(node)}")
    state = {}
    _attention_state(state, f"{prefix}self_attn", node["self_attn"])
    for part in ("norm1", "norm2"):
        _layer_norm(state, f"{prefix}{part}", node[part])
    _dense(state, f"{prefix}linear1", node["ffn_in"])
    _dense(state, f"{prefix}linear2", node["ffn_out"])
    return state


def lstm_state(node, prefix=""):
    """A Flax ``StackedLSTM``'s params (``lstm_<layer>`` cells of
    ``OptimizedLSTMCell``) -> the port's ``StackedLSTM`` state dict."""
    state = {}
    expected = {f"{side}{g}" for side in "ih" for g in _LSTM_GATES}
    for cell_name, cell in node.items():
        match = re.fullmatch(r"lstm_(\d+)", cell_name)
        if (match is None or set(cell) != expected
                or any(set(cell[f"i{g}"]) != {"kernel"} for g in _LSTM_GATES)):
            raise KeyError(f"no LSTM parameter for {cell_name}")
        layer = match.group(1)
        w_ih = np.concatenate([np.asarray(cell[f"i{g}"]["kernel"], np.float32).T
                               for g in _LSTM_GATES])
        w_hh = np.concatenate([np.asarray(cell[f"h{g}"]["kernel"], np.float32).T
                               for g in _LSTM_GATES])
        b_hh = np.concatenate([np.asarray(cell[f"h{g}"]["bias"], np.float32)
                               for g in _LSTM_GATES])
        _put(state, f"{prefix}weight_ih_l{layer}", _vector(w_ih))
        _put(state, f"{prefix}weight_hh_l{layer}", _vector(w_hh))
        _put(state, f"{prefix}bias_ih_l{layer}", torch.zeros(w_ih.shape[0]))
        _put(state, f"{prefix}bias_hh_l{layer}", _vector(b_hh))
    return state


def from_jax_resformer(variables):
    """``{embed, head}`` ResFormer tree -> ``{"embed": ResFormerEmbed state
    dict, "head": ResFormerTemporalHead state dict}``."""
    embed = _embed_state(variables["embed"], "ResNet_0", "BottleneckBlock", "resnet_ffn")
    head = {}
    for name, node in variables["head"]["params"].items():
        match = re.fullmatch(r"layer_(\d+)", name)
        if name == "classifier":
            _dense(head, name, node)
        elif match is not None:
            head.update(transformer_layer_state(node, f"layers.{match.group(1)}."))
        else:
            raise KeyError(f"no transformer-head parameter for {name}")
    return {"embed": embed, "head": head}


def from_jax_rnn(variables):
    """``{embed, head}`` RNN tree -> ``{"embed": RNNEmbed state dict,
    "head": RNNTemporalHead state dict}``."""
    embed = _embed_state(variables["embed"], "ResNet_0", "BasicBlock", "encoder_proj")
    head = {}
    for name, node in variables["head"]["params"].items():
        if name in ("decoder_hidden", "decoder_out"):
            _dense(head, name, node)
        elif name == "lstm":
            head.update(lstm_state(node, "lstm."))
        else:
            raise KeyError(f"no LSTM-head parameter for {name}")
    return {"embed": embed, "head": head}


_FROM_JAX = {"cnn": from_jax_cnn, "resformer": from_jax_resformer, "rnn": from_jax_rnn}


def _conv(state, name, node, transpose=False):
    """A Flax Conv (or ConvTranspose, ``transpose=True``) ``{kernel, bias}``
    -> ``name.weight``, ``name.bias``.  A ConvTranspose kernel ``[kh, kw,
    in, out]`` is flipped in space and becomes ``[in, out, kh, kw]``: Flax
    does not transpose the kernel (``transpose_kernel=False``), torch
    does."""
    if set(node) != {"kernel", "bias"}:
        raise KeyError(f"{name} must hold exactly a kernel and a bias, got {sorted(node)}")
    kernel = np.asarray(node["kernel"], np.float32)
    if transpose:
        weight = torch.from_numpy(np.ascontiguousarray(kernel[::-1, ::-1].transpose(2, 3, 0, 1)))
    else:
        weight = _tensor("weight", kernel)
    _put(state, f"{name}.weight", weight)
    _put(state, f"{name}.bias", _vector(node["bias"]))


def _batch_norm(state, name, params, stats):
    if set(params) != {"scale", "bias"} or set(stats) != {"mean", "var"}:
        raise KeyError(f"{name} must hold a scale, a bias, a mean and a var")
    for field, value in (*params.items(), *stats.items()):
        _put(state, f"{name}.{_BN_FIELDS[field]}", _vector(value))
    _put(state, f"{name}.num_batches_tracked", torch.tensor(0))


def from_jax_detector(variables):
    """A ``CenterNetDetector``'s Flax ``{params, batch_stats}`` tree, as the
    JAX ``DetectorTrainer`` holds it -> the port's ``CenterNetDetector``
    state dict.  ``trunk/resnet/...`` is the ResNet-18; ``up_{i}`` and
    ``up_bn_{i}`` the upsampling stages (``up.{3i}``, ``up.{3i + 1}``);
    ``{heatmap,size,offset}_{conv,out}`` the heads."""
    params = dict(variables["params"])
    stats = dict(variables.get("batch_stats") or {})
    trunk_p, trunk_s = params.pop("trunk"), stats.pop("trunk", {})
    if set(trunk_p) != {"resnet"} or set(trunk_s) - {"resnet"}:
        raise KeyError(f"the detector's trunk must hold one ResNet, got {sorted(trunk_p)}")
    state = resnet_state_dict(trunk_p["resnet"], trunk_s.get("resnet", {}), prefix="trunk.")
    for i in range(3):
        _conv(state, f"up.{3 * i}", params.pop(f"up_{i}"), transpose=True)
        _batch_norm(state, f"up.{3 * i + 1}", params.pop(f"up_bn_{i}"), stats.pop(f"up_bn_{i}"))
    for head in ("heatmap", "size", "offset"):
        _conv(state, f"heads.{head}.0", params.pop(f"{head}_conv"))
        _conv(state, f"heads.{head}.2", params.pop(f"{head}_out"))
    if params or stats:
        raise KeyError(f"no detector parameter for {sorted(params) + sorted(stats)}")
    return state


def from_jax_digits(params):
    """The digit net's tree as ``ocr_digits.npz`` stores it (``params/{c1,
    c2, c3, d1, out}``) -> the port's ``DigitNet`` state dict.  The port
    flattens its last feature map in NHWC order, as Flax does, so ``d1``'s
    rows keep their order."""
    node = dict(params.get("params", params))
    state = {}
    for name in ("c1", "c2", "c3"):
        _conv(state, name, node.pop(name))
    for name in ("d1", "out"):
        _dense(state, name, node.pop(name))
    if node:
        raise KeyError(f"no digit-net parameter for {sorted(node)}")
    return state


def to_jax_digits(state_dict):
    """The inverse of :func:`from_jax_digits`: a ``DigitNet`` state dict ->
    ``{"params": {c1, c2, c3, d1, out: {kernel, bias}}}`` of float32 numpy
    arrays (HWIO conv kernels, ``[in, out]`` dense kernels), the tree that
    ``ocr_digits.npz`` stores."""
    node = {}
    for name in ("c1", "c2", "c3", "d1", "out"):
        weight = state_dict[f"{name}.weight"].detach().cpu().numpy().astype(np.float32)
        kernel = weight.transpose(2, 3, 1, 0) if weight.ndim == 4 else weight.T
        node[name] = {"kernel": np.ascontiguousarray(kernel),
                      "bias": state_dict[f"{name}.bias"].detach().cpu().numpy().astype(np.float32)}
    extra = set(state_dict) - {f"{n}.{f}" for n in node for f in ("weight", "bias")}
    if extra:
        raise KeyError(f"no digit-net parameter for {sorted(extra)}")
    return {"params": node}


def to_state_dicts(family, variables):
    """Weights as the port's ``{"embed", "head"}`` state dicts: a JAX-layout
    tree of the family is converted, state dicts (tensor leaves) pass
    through."""
    if all(isinstance(v, torch.Tensor)
           for part in ("embed", "head") for v in variables[part].values()):
        return {"embed": variables["embed"], "head": variables["head"]}
    return _FROM_JAX[family](variables)


def split_monolithic(family, variables):
    """A monolithic model's numpy tree (``{"params": ..., "batch_stats":
    ...}`` of the JAX package's models) -> the family's ``{embed, head}``
    trees, split as the JAX pipeline splits it."""
    params = variables["params"]
    stats = variables.get("batch_stats") or {}
    if family == "cnn":
        inner_p = params["model"]
        inner_s = stats.get("model", {})
        embed = {"params": {"cnn2d": inner_p["ResNet_0"]},
                 "batch_stats": {"cnn2d": inner_s.get("ResNet_0", {})}}
        head = {"params": {k: inner_p[k] for k in _HEAD_LAYERS}}
    elif family == "rnn":
        embed = {"params": {"ResNet_0": params["ResNet_0"],
                            "encoder_proj": params["encoder_proj"]},
                 "batch_stats": {"ResNet_0": stats.get("ResNet_0", {})}}
        head = {"params": {k: params[k] for k in ("lstm", "decoder_hidden", "decoder_out")}}
    elif family == "resformer":
        inner_p = params["model"]
        inner_s = stats.get("model", {})
        embed = {"params": {"ResNet_0": inner_p["ResNet_0"],
                            "resnet_ffn": inner_p["resnet_ffn"]},
                 "batch_stats": {"ResNet_0": inner_s.get("ResNet_0", {})}}
        head_keys = [k for k in inner_p if k.startswith("layer_")] + ["classifier"]
        head = {"params": {k: inner_p[k] for k in head_keys}}
    else:
        raise ValueError(f"no model family {family!r}")
    return {"embed": embed, "head": head}


def monolithic_state_dict(family, variables):
    """A monolithic model's ``{"params", "batch_stats"}`` tree -> the state
    dict of the port's detector of that family (keys ``embed.*`` and
    ``head.*``).  Given ``{"params": mu}`` (an optax ``ScaleByAdamState``'s
    ``mu`` or ``nu``), it maps the moments onto the parameters' names; the
    LSTM's ``bias_ih_l*``, which Flax does not have, come out as zeros."""
    split = to_state_dicts(family, split_monolithic(family, variables))
    return {f"{part}.{k}": v for part in ("embed", "head") for k, v in split[part].items()}
