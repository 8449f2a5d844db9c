"""Torch -> Flax weight conversion.

The port's own copy of ``playaid_core_tpu/models/torch_convert.py`` (numpy
only): the name maps that read a reference checkpoint's state dict into
the JAX package's parameter layout, which ``playaid_core_torch/convert.py``
then maps into the port's modules.  Both packages go through the same
mapping.

The reference's checkpoints are torch/torchvision state dicts
(reference: models/cnn_action_detector.py:16, ai_runner.py:164).  Parity
with externally-trained weights means mapping those tensors into this
framework's Flax parameter trees.

Semantics caveat: the converters assume the *time-axis* recurrence /
attention this framework implements.  The reference's RNN and ResFormer
ran torch recurrent/attention modules without ``batch_first`` on
batch-first inputs, so those modules actually operated across the batch
axis (see docs/PARITY.md); checkpoints trained under that transposed
semantics will produce different (correct-axis) outputs here rather than
reproducing the reference's buggy ones.  The CNN family and the ResNet
backbones have no such axis dependence and convert with exact logit
parity.

Covered:

* torchvision-style ResNet-18/34/50 state dicts ->
  :class:`playaid_core_tpu.models.resnet.ResNet` params/batch_stats;
* the CNN family's temporal head (Conv1d(kernel=T) + MLP,
  reference: models/cnn_action_detector.py:22-27) -> the equivalent
  dense-over-flattened-time parameters.

Conventions: torch conv weights [out, in, kh, kw] -> flax [kh, kw, in,
out]; linear [out, in] -> [in, out]; BatchNorm weight/bias ->
scale/bias with running stats into ``batch_stats``.
"""

from __future__ import annotations

import numpy as np


def _t(x):
    return np.asarray(x)


def _conv(w):
    return _t(w).transpose(2, 3, 1, 0)


def _linear(w):
    return _t(w).transpose(1, 0)


def convert_resnet_state_dict(state_dict, stage_sizes, bottleneck):
    """torchvision ResNet state dict -> (params, batch_stats) dicts for
    :class:`playaid_core_tpu.models.resnet.ResNet`."""
    params = {}
    stats = {}

    def put_bn(flax_name, torch_prefix):
        params[flax_name] = {
            "scale": _t(state_dict[f"{torch_prefix}.weight"]),
            "bias": _t(state_dict[f"{torch_prefix}.bias"]),
        }
        stats[flax_name] = {
            "mean": _t(state_dict[f"{torch_prefix}.running_mean"]),
            "var": _t(state_dict[f"{torch_prefix}.running_var"]),
        }

    params["conv_init"] = {"kernel": _conv(state_dict["conv1.weight"])}
    put_bn("bn_init", "bn1")

    block_cls = "BottleneckBlock" if bottleneck else "BasicBlock"
    convs_per_block = 3 if bottleneck else 2
    flat_idx = 0
    for stage, num_blocks in enumerate(stage_sizes):
        for block in range(num_blocks):
            tp = f"layer{stage + 1}.{block}"
            name = f"{block_cls}_{flat_idx}"
            block_params = {}
            block_stats = {}
            for c in range(convs_per_block):
                block_params[f"Conv_{c}"] = {
                    "kernel": _conv(state_dict[f"{tp}.conv{c + 1}.weight"])
                }
                block_params[f"BatchNorm_{c}"] = {
                    "scale": _t(state_dict[f"{tp}.bn{c + 1}.weight"]),
                    "bias": _t(state_dict[f"{tp}.bn{c + 1}.bias"]),
                }
                block_stats[f"BatchNorm_{c}"] = {
                    "mean": _t(state_dict[f"{tp}.bn{c + 1}.running_mean"]),
                    "var": _t(state_dict[f"{tp}.bn{c + 1}.running_var"]),
                }
            if f"{tp}.downsample.0.weight" in state_dict:
                block_params["conv_proj"] = {
                    "kernel": _conv(state_dict[f"{tp}.downsample.0.weight"])
                }
                block_params["norm_proj"] = {
                    "scale": _t(state_dict[f"{tp}.downsample.1.weight"]),
                    "bias": _t(state_dict[f"{tp}.downsample.1.bias"]),
                }
                block_stats["norm_proj"] = {
                    "mean": _t(state_dict[f"{tp}.downsample.1.running_mean"]),
                    "var": _t(state_dict[f"{tp}.downsample.1.running_var"]),
                }
            params[name] = block_params
            stats[name] = block_stats
            flat_idx += 1

    if "fc.weight" in state_dict:
        params["head"] = {
            "kernel": _linear(state_dict["fc.weight"]),
            "bias": _t(state_dict["fc.bias"]),
        }
    return params, stats


def convert_temporal_conv1d(conv_weight, conv_bias):
    """torch Conv1d(F -> H, kernel=T) over [B, F, T] -> dense kernel over
    the t-major flattened [B, T*F] features.

    torch: out[b, h] = sum_f sum_t w[h, f, t] * x[b, f, t] + b[h]
    flax:  out[b, h] = sum_k kernel[k, h] * flat[b, k],  k = t * F + f
    """
    w = _t(conv_weight)  # [H, F, T]
    h, f, t = w.shape
    kernel = w.transpose(2, 1, 0).reshape(t * f, h)
    return kernel, _t(conv_bias)


def convert_lstm(state_dict, prefix, num_layers):
    """torch nn.LSTM params -> flax StackedLSTM (OptimizedLSTMCell) params.

    torch fuses gates as [4H, ...] blocks in (i, f, g, o) order with two
    bias vectors; flax keeps one dense per gate (input side ii/if/ig/io
    without bias, hidden side hi/hf/hg/ho carrying the summed bias).
    """
    gates = ("i", "f", "g", "o")
    params = {}
    for layer in range(num_layers):
        w_ih = _t(state_dict[f"{prefix}.weight_ih_l{layer}"])  # [4H, in]
        w_hh = _t(state_dict[f"{prefix}.weight_hh_l{layer}"])  # [4H, H]
        b = _t(state_dict[f"{prefix}.bias_ih_l{layer}"]) + _t(
            state_dict[f"{prefix}.bias_hh_l{layer}"]
        )
        h = w_hh.shape[1]
        cell = {}
        for gi, gate in enumerate(gates):
            sl = slice(gi * h, (gi + 1) * h)
            cell[f"i{gate}"] = {"kernel": w_ih[sl].transpose(1, 0)}
            cell[f"h{gate}"] = {"kernel": w_hh[sl].transpose(1, 0), "bias": b[sl]}
        params[f"lstm_{layer}"] = cell
    return params


def convert_rnn_action_detector(state_dict, num_layers=3):
    """Reference RNNActionDetector state dict -> variables for
    :class:`playaid_core_tpu.models.rnn_action_detector.RNNActionDetector`.

    Expects the reference's module names: resnet.* (torchvision resnet18
    whose fc was replaced by Sequential(Linear(512, 300))), lstm.*,
    action_decoder.{0,2}.* (reference: models/rnn_action_detector.py:53-65).
    """
    resnet_sd = {
        k[len("resnet."):]: v for k, v in state_dict.items()
        if k.startswith("resnet.") and not k.startswith("resnet.fc.")
    }
    resnet_params, resnet_stats = convert_resnet_state_dict(
        resnet_sd, stage_sizes=[2, 2, 2, 2], bottleneck=False
    )
    params = {
        "ResNet_0": resnet_params,
        "encoder_proj": {
            "kernel": _linear(state_dict["resnet.fc.0.weight"]),
            "bias": _t(state_dict["resnet.fc.0.bias"]),
        },
        "lstm": convert_lstm(state_dict, "lstm", num_layers),
        "decoder_hidden": {
            "kernel": _linear(state_dict["action_decoder.0.weight"]),
            "bias": _t(state_dict["action_decoder.0.bias"]),
        },
        "decoder_out": {
            "kernel": _linear(state_dict["action_decoder.2.weight"]),
            "bias": _t(state_dict["action_decoder.2.bias"]),
        },
    }
    return {"params": params, "batch_stats": {"ResNet_0": resnet_stats}}


def convert_transformer_encoder_layer(state_dict, prefix, d_model, num_heads):
    """torch nn.TransformerEncoderLayer params -> flax
    TransformerEncoderLayer (models/resnet_transformer.py) params."""
    head_dim = d_model // num_heads
    in_w = _t(state_dict[f"{prefix}.self_attn.in_proj_weight"])  # [3E, E]
    in_b = _t(state_dict[f"{prefix}.self_attn.in_proj_bias"])  # [3E]
    out_w = _t(state_dict[f"{prefix}.self_attn.out_proj.weight"])  # [E, E]
    out_b = _t(state_dict[f"{prefix}.self_attn.out_proj.bias"])

    def qkv(idx):
        w = in_w[idx * d_model : (idx + 1) * d_model]  # [E, E] (out, in)
        b = in_b[idx * d_model : (idx + 1) * d_model]
        return {
            "kernel": w.transpose(1, 0).reshape(d_model, num_heads, head_dim),
            "bias": b.reshape(num_heads, head_dim),
        }

    return {
        "self_attn": {
            "query": qkv(0),
            "key": qkv(1),
            "value": qkv(2),
            "out": {
                # flax out kernel: [heads, head_dim, E]; torch [E_out, E_in].
                "kernel": out_w.transpose(1, 0).reshape(num_heads, head_dim, d_model),
                "bias": out_b,
            },
        },
        "norm1": {
            "scale": _t(state_dict[f"{prefix}.norm1.weight"]),
            "bias": _t(state_dict[f"{prefix}.norm1.bias"]),
        },
        "norm2": {
            "scale": _t(state_dict[f"{prefix}.norm2.weight"]),
            "bias": _t(state_dict[f"{prefix}.norm2.bias"]),
        },
        "ffn_in": {
            "kernel": _linear(state_dict[f"{prefix}.linear1.weight"]),
            "bias": _t(state_dict[f"{prefix}.linear1.bias"]),
        },
        "ffn_out": {
            "kernel": _linear(state_dict[f"{prefix}.linear2.weight"]),
            "bias": _t(state_dict[f"{prefix}.linear2.bias"]),
        },
    }


def convert_resformer_detector(state_dict, num_layers=3, d_model=256, num_heads=8):
    """Reference ResnetTransformerDetector state dict -> variables for
    :class:`playaid_core_tpu.models.resnet_transformer.ResnetTransformerDetector`.

    Expects the reference's module names: model.resnet.* (timm resnet50,
    num_classes=0), model.resnet_ffn.*, model.transformer.layers.N.*,
    model.classifier.* (reference: models/resnet_transformer_detector.py:25-93).
    """
    resnet_sd = {
        k[len("model.resnet."):]: v for k, v in state_dict.items()
        if k.startswith("model.resnet.")
    }
    resnet_params, resnet_stats = convert_resnet_state_dict(
        resnet_sd, stage_sizes=[3, 4, 6, 3], bottleneck=True
    )
    inner = {
        "ResNet_0": resnet_params,
        "resnet_ffn": {
            "kernel": _linear(state_dict["model.resnet_ffn.weight"]),
            "bias": _t(state_dict["model.resnet_ffn.bias"]),
        },
        "classifier": {
            "kernel": _linear(state_dict["model.classifier.weight"]),
            "bias": _t(state_dict["model.classifier.bias"]),
        },
    }
    for i in range(num_layers):
        inner[f"layer_{i}"] = convert_transformer_encoder_layer(
            state_dict, f"model.transformer.layers.{i}", d_model, num_heads
        )
    return {
        "params": {"model": inner},
        "batch_stats": {"model": {"ResNet_0": resnet_stats}},
    }


def convert_cnn_action_detector(state_dict, sequence_length):
    """Reference CNNActionDetector state dict -> params/batch_stats for
    :class:`playaid_core_tpu.models.cnn_action_detector.CNNActionDetector`.

    Expects the reference's module names (model.cnn2d.* for the resnet,
    model.cnn1d.0.* for the temporal conv, model.classifier.{0,2}.* for
    the MLP — reference: models/cnn_action_detector.py:16-27).
    """
    resnet_sd = {
        k[len("model.cnn2d."):]: v for k, v in state_dict.items()
        if k.startswith("model.cnn2d.")
    }
    resnet_params, resnet_stats = convert_resnet_state_dict(
        resnet_sd, stage_sizes=[2, 2, 2, 2], bottleneck=False
    )

    kernel, bias = convert_temporal_conv1d(
        state_dict["model.cnn1d.0.weight"], state_dict["model.cnn1d.0.bias"]
    )
    inner_params = {
        "ResNet_0": resnet_params,
        "temporal_dense": {"kernel": kernel, "bias": bias},
        "mlp_hidden": {
            "kernel": _linear(state_dict["model.classifier.0.weight"]),
            "bias": _t(state_dict["model.classifier.0.bias"]),
        },
        "classifier": {
            "kernel": _linear(state_dict["model.classifier.2.weight"]),
            "bias": _t(state_dict["model.classifier.2.bias"]),
        },
    }
    params = {"model": inner_params}
    batch_stats = {"model": {"ResNet_0": resnet_stats}}
    return {"params": params, "batch_stats": batch_stats}
