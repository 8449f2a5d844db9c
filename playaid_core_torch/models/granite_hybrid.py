"""IBM Granite 4.0-H Micro's decoder stack as a temporal head over a whole
VOD: a hybrid of Mamba-2 and grouped-query attention layers.

The published configuration is :data:`PUBLISHED` (the keys of the model's
``config.json``, https://huggingface.co/ibm-granite/granite-4.0-h-micro):
hidden size 2,048, 40 layers, each one token mixer and a shared SwiGLU MLP
of 8,192.  The mixers are Mamba-2 (expand 2, 64 heads of 64, state 128,
one group, a causal depthwise convolution of 4, chunk 256, a gated
RMSNorm) except at indices 5, 15, 25 and 35, which are causal attention
with 32 query and 8 key/value heads of 64, no positional encoding and the
scale ``attention_multiplier``.  Every layer is pre-norm (RMSNorm, eps
1e-5) with ``residual_multiplier`` on both branches; the input is scaled
by ``embedding_multiplier`` and the output divided by ``logits_scaling``.
The layer equations follow the transformers library's
``granitemoehybrid`` modelling code (its ``torch_forward`` for Mamba-2).

In place of the token embedding and the tied output over 100,352 ids, a
frame projection (``frame_proj``, the frame encoder's 512 features to the
hidden size) feeds the stack, and ``output`` maps the hidden size to the
action classes.  The head is causal: position t reads positions 0 to t.

The Mamba-2 scan runs on K6 (``ops/ssd_scan.py``) on the card; the input
projection, the convolution, SiLU, the gated RMSNorm and the output
projection stay in PyTorch.  Each Mamba-2 mixer runs inside the span
``playaid.ssm``, each attention layer inside ``playaid.attention``; the
head's call adds ``ssd_layers`` to the enclosing span, the Mamba-2 layers
whose scan K6's wrapper launched (0 on the CPU, where the twin runs).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from playaid_core_torch import profiling
from playaid_core_torch.device import full_float32
from playaid_core_torch.ops import _build
from playaid_core_torch.ops.ssd_scan import ssd_scan

ATTENTION_AT = (5, 15, 25, 35)
PUBLISHED = {
    "hidden_size": 2048, "num_hidden_layers": 40,
    "layer_types": ["attention" if i in ATTENTION_AT else "mamba" for i in range(40)],
    "shared_intermediate_size": 8192, "hidden_act": "silu",
    "mamba_expand": 2, "mamba_n_heads": 64, "mamba_d_head": 64, "mamba_d_state": 128,
    "mamba_n_groups": 1, "mamba_d_conv": 4, "mamba_chunk_size": 256,
    "mamba_conv_bias": True, "mamba_proj_bias": False,
    "num_attention_heads": 32, "num_key_value_heads": 8, "attention_bias": False,
    "attention_multiplier": 0.015625, "position_embedding_type": "nope",
    "embedding_multiplier": 12, "residual_multiplier": 0.22, "logits_scaling": 8,
    "rms_norm_eps": 1e-5,
}
FRAME_FEATURES = 512  # ResNet-18's pooled features


class RMSNorm(nn.Module):
    def __init__(self, size, eps):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(size))
        self.eps = eps

    def forward(self, x):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) * self.weight


class SharedMLP(nn.Module):
    """SwiGLU: ``output_linear(silu(gate) * up)``, gate and up the two halves
    of ``input_linear``'s output."""

    def __init__(self, hidden, width):
        super().__init__()
        self.input_linear = nn.Linear(hidden, 2 * width, bias=False)
        self.output_linear = nn.Linear(width, hidden, bias=False)

    def forward(self, x):
        gate, up = self.input_linear(x).chunk(2, dim=-1)
        return self.output_linear(F.silu(gate) * up)


class Attention(nn.Module):
    """Causal grouped-query attention, no positional encoding, scale
    ``attention_multiplier``, on ``F.scaled_dot_product_attention``."""

    def __init__(self, c):
        super().__init__()
        d, bias = c["hidden_size"], c["attention_bias"]
        self.heads, self.kv_heads = c["num_attention_heads"], c["num_key_value_heads"]
        self.head_dim = d // self.heads
        self.scale = c["attention_multiplier"]
        self.q_proj = nn.Linear(d, self.heads * self.head_dim, bias=bias)
        self.k_proj = nn.Linear(d, self.kv_heads * self.head_dim, bias=bias)
        self.v_proj = nn.Linear(d, self.kv_heads * self.head_dim, bias=bias)
        self.o_proj = nn.Linear(self.heads * self.head_dim, d, bias=bias)

    def forward(self, x):
        with profiling.span("playaid.attention"):
            b, length, _ = x.shape
            q = self.q_proj(x).view(b, length, self.heads, self.head_dim).transpose(1, 2)
            k = self.k_proj(x).view(b, length, self.kv_heads, self.head_dim).transpose(1, 2)
            v = self.v_proj(x).view(b, length, self.kv_heads, self.head_dim).transpose(1, 2)
            rep = self.heads // self.kv_heads
            k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
            y = F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=self.scale)
            return self.o_proj(y.transpose(1, 2).reshape(b, length, -1))


class Mamba2Mixer(nn.Module):
    """Mamba-2: ``in_proj`` to the gate ``z``, ``xBC`` and ``dt``; a causal
    depthwise convolution and SiLU over ``xBC``; ``dt = softplus(dt +
    dt_bias)``, ``A = -exp(A_log)``; the SSD scan (K6 on the card); the
    gated RMSNorm ``norm(y silu(z))``; ``out_proj``."""

    def __init__(self, c):
        super().__init__()
        d = c["hidden_size"]
        self.inner = c["mamba_expand"] * d
        self.heads, self.head_dim = c["mamba_n_heads"], c["mamba_d_head"]
        self.groups, self.state = c["mamba_n_groups"], c["mamba_d_state"]
        self.chunk, self.eps = c["mamba_chunk_size"], c["rms_norm_eps"]
        self.conv_dim = self.inner + 2 * self.groups * self.state
        self.in_proj = nn.Linear(d, self.inner + self.conv_dim + self.heads,
                                 bias=c["mamba_proj_bias"])
        self.conv1d = nn.Conv1d(self.conv_dim, self.conv_dim, c["mamba_d_conv"],
                                groups=self.conv_dim, padding=c["mamba_d_conv"] - 1,
                                bias=c["mamba_conv_bias"])
        self.dt_bias = nn.Parameter(torch.ones(self.heads))
        self.A_log = nn.Parameter(torch.log(torch.arange(1, self.heads + 1, dtype=torch.float32)))
        self.D = nn.Parameter(torch.ones(self.heads))
        self.norm = RMSNorm(self.inner, self.eps)
        self.out_proj = nn.Linear(self.inner, d, bias=c["mamba_proj_bias"])

    def forward(self, x):
        with profiling.span("playaid.ssm"):
            b, length, _ = x.shape
            z, xbc, dt = self.in_proj(x).split([self.inner, self.conv_dim, self.heads], dim=-1)
            # Row-major [b, L, conv_dim] before the SiLU, so that K6 reads
            # x, B and C in place.
            xbc = F.silu(self.conv1d(xbc.transpose(1, 2))[..., :length].transpose(1, 2)
                         .contiguous())
            xs, bm, cm = xbc.split([self.inner, self.groups * self.state,
                                    self.groups * self.state], dim=-1)
            y = ssd_scan(xs.view(b, length, self.heads, self.head_dim),
                         F.softplus(dt + self.dt_bias), -torch.exp(self.A_log),
                         bm.view(b, length, self.groups, self.state),
                         cm.view(b, length, self.groups, self.state), self.D, self.chunk)
            y = self.norm(y.reshape(b, length, self.inner) * F.silu(z))
            return self.out_proj(y)


class DecoderLayer(nn.Module):
    def __init__(self, c, kind):
        super().__init__()
        d, eps = c["hidden_size"], c["rms_norm_eps"]
        self.input_layernorm = RMSNorm(d, eps)
        self.post_attention_layernorm = RMSNorm(d, eps)
        self.residual_multiplier = c["residual_multiplier"]
        if kind == "mamba":
            self.mamba = Mamba2Mixer(c)
        else:
            self.self_attn = Attention(c)
        self.shared_mlp = SharedMLP(d, c["shared_intermediate_size"])

    @property
    def is_mamba(self):
        return hasattr(self, "mamba")

    def forward(self, x):
        mixer = self.mamba if self.is_mamba else self.self_attn
        x = x + mixer(self.input_layernorm(x)) * self.residual_multiplier
        return x + self.shared_mlp(self.post_attention_layernorm(x)) * self.residual_multiplier


class GraniteHybridHead(nn.Module):
    """Frame embeddings ``[B, L, 512]`` -> per-position log-probs ``[B, L,
    A]``, causal, in full float32 whatever the caller's TF32 flags.
    ``config`` holds the keys of :data:`PUBLISHED` (the default)."""

    def __init__(self, num_actions, config=None):
        super().__init__()
        c = dict(PUBLISHED if config is None else config)
        self.config = c
        d = c["hidden_size"]
        self.frame_proj = nn.Linear(FRAME_FEATURES, d)
        self.layers = nn.ModuleList(DecoderLayer(c, kind) for kind in c["layer_types"])
        self.norm = RMSNorm(d, c["rms_norm_eps"])
        self.output = nn.Linear(d, num_actions)

    @property
    def chunk(self):
        return self.config["mamba_chunk_size"]

    def forward(self, seq):
        c = self.config
        with full_float32():
            x = self.frame_proj(seq) * c["embedding_multiplier"]
            # K6's wrapper counts ssd_layers where it launches, inside each
            # mixer's span; the head adds them to its caller's span.
            with profiling.tally() as held:
                for layer in self.layers:
                    x = layer(x)
            profiling.count("ssd_layers", held.pop("ssd_layers", 0))
            _build.recount(held)
            logits = self.output(self.norm(x)) / c["logits_scaling"]
            return torch.log_softmax(logits, dim=-1)


def padded_length(rows, chunk):
    """``rows`` rounded up to whole SSD chunks (at least one)."""
    return max(1, math.ceil(rows / chunk)) * chunk
