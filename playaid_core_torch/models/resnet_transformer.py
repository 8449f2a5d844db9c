"""The ResFormer family: the sinusoidal time encoding, a post-norm
transformer encoder layer, and the trainable whole (:class:`ResFormer`,
:class:`ResnetTransformerDetector`).

Counterpart of ``playaid_core_tpu/models/resnet_transformer.py``.  The
layer keeps the parameter names of torch's ``nn.TransformerEncoderLayer``
(``self_attn.in_proj_weight``, ``self_attn.out_proj``, ``linear1``,
``linear2``, ``norm1``, ``norm2``) and the Flax layer's numerics: layer
norm with eps 1e-6, the query scaled by 1/sqrt(head_dim) before the
product, ReLU in a 2048-wide feed-forward.  In training mode it drops out
at rate 0.1 where the Flax layer does: the attention weights (one
``[1, 1, T, T]`` mask shared by the batch and the heads, Flax's
``broadcast_dropout``), the attention output, the feed-forward's ReLU and
its output.  The masks are drawn from the layer's ``generator`` (a
``torch.Generator`` on the activations' device, or None for the default
one).  In eval mode there is no dropout.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from playaid_core_torch.models.resnet import init_flax_, lecun_normal_
from playaid_core_torch.parallel.mesh import is_column_split, parallel_linear, to_model

LAYER_NORM_EPS = 1e-6  # flax nn.LayerNorm's default


def time_encoding(x: np.ndarray, num_freq: int) -> np.ndarray:
    """``[T, 1]`` positions -> ``[T, 1 + 2 * num_freq]`` sin/cos features,
    in numpy float64 as the JAX package computes them (the caller casts)."""
    out = [x]
    for i in range(num_freq):
        out.append(np.cos(np.pi * x * (2**i)))
        out.append(np.sin(np.pi * x * (2**i)))
    return np.concatenate(out, axis=1)


def dropout(x, rate, generator=None, mask_shape=None):
    """Flax's train-mode ``Dropout``: keep each entry with probability ``1 -
    rate`` and scale it by ``1 / (1 - rate)``; ``mask_shape`` (broadcast
    against ``x``) shares one draw across the axes of size 1."""
    keep = 1.0 - rate
    shape = x.shape if mask_shape is None else mask_shape
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


class SelfAttention(nn.Module):
    """Multi-head self-attention over ``[B, T, E]`` with torch's packed
    ``in_proj`` (query, key, value rows) and ``out_proj``.

    On a mesh (``parallel.mesh.attach_mesh``) that splits ``model``, the
    module holds whole heads: the same rows of each of the q, k and v
    blocks of ``in_proj`` and the matching columns of ``out_proj``; the
    output projection's partial sums are summed over ``model``."""

    mesh = None

    def __init__(self, d_model, num_heads):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} does not divide into {num_heads} heads")
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x, drop=None):
        """``drop``: applied to the attention weights ``[B, heads, T, T]``
        with a mask shape, in training."""
        b, t, e = x.shape
        head_dim = e // self.num_heads
        qkv = F.linear(to_model(x, self.mesh), self.in_proj_weight, self.in_proj_bias)
        heads = qkv.shape[-1] // (3 * head_dim)  # this rank's heads
        q, k, v = qkv.reshape(b, t, 3, heads, head_dim).permute(2, 0, 3, 1, 4)
        q = q / math.sqrt(head_dim)
        weights = torch.softmax(torch.matmul(q, k.transpose(-1, -2)), dim=-1)
        if drop is not None:
            weights = drop(weights, (1, 1, t, t))
        out = torch.matmul(weights, v).transpose(1, 2).reshape(b, t, heads * head_dim)
        return parallel_linear(self.out_proj, out, self.mesh)


class TransformerEncoderLayer(nn.Module):
    """Post-LN encoder layer: ``x = norm1(x + attn(x))``, then
    ``norm2(x + linear2(relu(linear1(x))))``, with dropout in training.

    On a mesh that splits ``model`` the feed-forward is Megatron's:
    ``linear1`` holds rows (this rank's hidden columns), ``linear2`` the
    matching columns, and one sum over ``model`` ends it.  Dropout masks
    are drawn at the whole batch's shape (and the whole hidden width) from
    the layer's generator, the same on every rank, and each rank keeps its
    ``batch_rows`` (and hidden columns): the meshed step draws what one
    device draws."""

    mesh = None

    def __init__(self, d_model, num_heads, dim_feedforward=2048, dropout_rate=0.1):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.generator = None
        self.batch_rows = (0, 1)  # (this rank's index, count) of the batch's row blocks
        self.self_attn = SelfAttention(d_model, num_heads)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)

    def _drop(self, x, mask_shape=None, hidden=False):
        """Dropout of ``x``; ``hidden``: ``x`` is the feed-forward's hidden
        activation, of which this rank may hold columns."""
        if mask_shape is not None:  # shared by the batch: nothing to split
            return dropout(x, self.dropout_rate, self.generator, mask_shape)
        index, count = self.batch_rows
        b, w = x.shape[0], x.shape[-1]
        col, width = 0, w
        if hidden and is_column_split(self.linear1):
            col, width = self.mesh.index("model"), self.linear1.out_features
        keep = 1.0 - self.dropout_rate
        mask = torch.rand((b * count,) + x.shape[1:-1] + (width,), generator=self.generator,
                          device=x.device) < keep
        mask = mask[index * b:(index + 1) * b, ..., col * w:(col + 1) * w]
        return torch.where(mask, x / keep, 0.0)

    def _feed_forward(self, x, drop):
        y = torch.relu(parallel_linear(self.linear1, x, self.mesh))
        if drop:
            y = self._drop(y, hidden=True)
        return parallel_linear(self.linear2, y, self.mesh)

    def forward(self, x):
        if not self.training or not self.dropout_rate:
            x = self.norm1(x + self.self_attn(x))
            return self.norm2(x + self._feed_forward(x, False))
        x = self.norm1(x + self._drop(self.self_attn(x, self._drop)))
        return self.norm2(x + self._drop(self._feed_forward(x, True)))


class ResFormer(nn.Module):
    """ResNet-50 (2048-d) -> ``resnet_ffn`` (247) -> time encoding (9) ->
    3 post-norm transformer layers (d_model 256, 8 heads) -> per-step
    logits: ``[B, T, H, W, 3]`` in [0, 1] -> ``[B, T, num_actions]``.

    Counterpart of ``ResFormer`` in
    ``playaid_core_tpu/models/resnet_transformer.py``, built from the
    pipeline's ``ResFormerEmbed`` (``.embed``) and
    ``ResFormerTemporalHead`` (``.head``).  T is fixed by the time
    encoding.  :meth:`set_dropout_generator` gives every layer the
    generator of its train-mode dropout masks.
    """

    def __init__(self, num_actions=61, sequence_length=7):
        super().__init__()
        # Imported here: the pipeline imports this module for the layer.
        from playaid_core_torch.infer.pipeline import ResFormerEmbed, ResFormerTemporalHead

        self.embed = ResFormerEmbed()
        self.head = ResFormerTemporalHead(num_actions, sequence_length)

    def forward(self, frames):
        b, t = frames.shape[0], frames.shape[1]
        feats = self.embed(frames.reshape((b * t,) + frames.shape[2:])).reshape(b, t, -1)
        return self.head.logits(feats)

    def set_dropout_generator(self, generator):
        for layer in self.head.layers:
            layer.generator = generator
        return self

    def init_weights(self, generator=None):
        """Flax's initialisers: ``init_flax_`` for the ResNet, the dense
        layers and the norms; lecun_normal for each of the query, key and
        value kernels, zero biases."""
        init_flax_(self, generator)
        with torch.no_grad():
            for layer in self.head.layers:
                attn = layer.self_attn
                e = attn.in_proj_weight.shape[1]
                for part in range(3):
                    lecun_normal_(attn.in_proj_weight[part * e:(part + 1) * e], generator)
                attn.in_proj_bias.zero_()
        return self


class ResnetTransformerDetector(ResFormer):
    """Forward = log_softmax over the per-step action logits ``[B, T, A]``."""

    def __init__(self, num_actions, sequence_length=7):
        super().__init__(num_actions, sequence_length)

    def forward(self, frames):
        return torch.log_softmax(super().forward(frames), dim=2)
