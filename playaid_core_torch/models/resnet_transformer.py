"""The ResFormer family's temporal pieces: the sinusoidal time encoding and
a post-norm transformer encoder layer.

Counterpart of ``playaid_core_tpu/models/resnet_transformer.py``.  The
layer keeps the parameter names of torch's ``nn.TransformerEncoderLayer``
(``self_attn.in_proj_weight``, ``self_attn.out_proj``, ``linear1``,
``linear2``, ``norm1``, ``norm2``) and the Flax layer's numerics: layer
norm with eps 1e-6, the query scaled by 1/sqrt(head_dim) before the
product, ReLU in a 2048-wide feed-forward, dropout absent (inference).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LAYER_NORM_EPS = 1e-6  # flax nn.LayerNorm's default


def time_encoding(x: np.ndarray, num_freq: int) -> np.ndarray:
    """``[T, 1]`` positions -> ``[T, 1 + 2 * num_freq]`` sin/cos features,
    in numpy float64 as the JAX package computes them (the caller casts)."""
    out = [x]
    for i in range(num_freq):
        out.append(np.cos(np.pi * x * (2**i)))
        out.append(np.sin(np.pi * x * (2**i)))
    return np.concatenate(out, axis=1)


class SelfAttention(nn.Module):
    """Multi-head self-attention over ``[B, T, E]`` with torch's packed
    ``in_proj`` (query, key, value rows) and ``out_proj``."""

    def __init__(self, d_model, num_heads):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} does not divide into {num_heads} heads")
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x):
        b, t, e = x.shape
        head_dim = e // self.num_heads
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = qkv.reshape(b, t, 3, self.num_heads, head_dim).permute(2, 0, 3, 1, 4)
        q = q / math.sqrt(head_dim)
        weights = torch.softmax(torch.matmul(q, k.transpose(-1, -2)), dim=-1)
        out = torch.matmul(weights, v).transpose(1, 2).reshape(b, t, e)
        return self.out_proj(out)


class TransformerEncoderLayer(nn.Module):
    """Post-LN encoder layer: ``x = norm1(x + attn(x))``, then
    ``norm2(x + linear2(relu(linear1(x))))``."""

    def __init__(self, d_model, num_heads, dim_feedforward=2048):
        super().__init__()
        self.self_attn = SelfAttention(d_model, num_heads)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)

    def forward(self, x):
        x = self.norm1(x + self.self_attn(x))
        return self.norm2(x + self.linear2(torch.relu(self.linear1(x))))
