"""The Granite 4.0-H hybrid family (IBM Granite 4.0-H Micro's decoder stack,
https://huggingface.co/ibm-granite/granite-4.0-h-micro/blob/main/config.json,
``model_type`` ``granitemoehybrid``) as a causal head over a whole VOD:
ResNet-18's pooled 512 features a frame, ``frame_proj`` to the hidden size
times ``embedding_multiplier``, the 40 layers (Mamba-2 or NoPE grouped-query
attention, each with the shared SwiGLU MLP, pre-norm, ``residual_multiplier``
on both branches), the final RMSNorm, ``output`` to the classes divided by
``logits_scaling``, log-softmax.  Frame t's row is labelled from rows 0 to t.

The equations are those of the transformers library's ``granitemoehybrid``
modelling code, written here in plain ``torch`` and float32 (TF32 off
outside :func:`~portbench.reference.models.precision` ``("tf32")``),
importing no kernel of the port:

* Mamba-2 (Dao and Gu 2024, https://arxiv.org/abs/2405.21060): ``in_proj``
  to ``z``, ``xBC`` and ``dt``; a causal depthwise convolution of
  ``mamba_d_conv`` taps with bias, then SiLU; ``dt = softplus(dt +
  dt_bias)``, ``A = -exp(A_log)``; the SSD scan ``h_t = exp(dt_t A) h_{t-1}
  + dt_t B_t x_t^T``, ``y_t = C_t h_t + D x_t`` from a zero state; the gated
  RMSNorm ``norm(y silu(z))`` over the whole inner width; ``out_proj``.  On
  the card the scan is the paper's chunked closed form
  (``ssd_minimal_discrete``: exact segment sums, chunk ``mamba_chunk_size``)
  in blocks of heads; on the CPU it is the step-by-step recurrence.
* Attention: 32 query and 8 key/value heads of 64, no positional encoding,
  scores scaled by ``attention_multiplier`` (not 1/sqrt(64)), causal,
  softmax, in blocks of queries.

Weights are drawn from the seed (no trained Granite head for Smash actions
exists): kernels N(0, 1/fan_in), biases 0, norm scales 1, and, as Mamba-2
initialises them, ``A`` uniform in [1, 16], ``dt`` log-uniform in [0.001,
0.1] through the inverse softplus into ``dt_bias``, and ``D`` 1.
"""

import math

import torch
import torch.nn.functional as F

from portbench import k6, roofline
from portbench.reference.models import linear, resnet
from portbench.reference.weights import linear_spec, resnet_spec, seeded

TRUNK = "resnet18"
FEATURES = 512            # ResNet-18's pooled features
QUERY_BLOCK = 1024        # attention queries a block
HEAD_BLOCK = 16           # SSD heads a block of the chunked form
A_RANGE = (1.0, 16.0)     # Mamba-2's A_init_range
DT_RANGE = (0.001, 0.1)   # Mamba-2's dt_min, dt_max


def _dims(c):
    d = c["hidden_size"]
    inner = c["mamba_expand"] * d
    gn = c["mamba_n_groups"] * c["mamba_d_state"]
    return d, inner, inner + 2 * gn, c["mamba_n_heads"]


def spec(config):
    """``{"embed": [(name, shape)], "head": [...]}`` at the configuration's
    widths, under the port's names and in its order."""
    c = config
    d, inner, conv_dim, heads = _dims(c)
    q = c["num_attention_heads"]
    head_dim = d // q
    kv = c["num_key_value_heads"] * head_dim
    head = linear_spec("frame_proj", FEATURES, d)
    for i, kind in enumerate(c["layer_types"]):
        p = f"layers.{i}."
        head += [(p + "input_layernorm.weight", (d,)), (p + "post_attention_layernorm.weight", (d,))]
        if kind == "mamba":
            m = p + "mamba."
            head += [(m + "dt_bias", (heads,)), (m + "A_log", (heads,)), (m + "D", (heads,)),
                     (m + "in_proj.weight", (inner + conv_dim + heads, d)),
                     (m + "conv1d.weight", (conv_dim, 1, c["mamba_d_conv"])),
                     (m + "conv1d.bias", (conv_dim,)), (m + "norm.weight", (inner,)),
                     (m + "out_proj.weight", (d, inner))]
        else:
            a = p + "self_attn."
            head += [(a + "q_proj.weight", (q * head_dim, d)), (a + "k_proj.weight", (kv, d)),
                     (a + "v_proj.weight", (kv, d)), (a + "o_proj.weight", (d, q * head_dim))]
        f = c["shared_intermediate_size"]
        head += [(p + "shared_mlp.input_linear.weight", (2 * f, d)),
                 (p + "shared_mlp.output_linear.weight", (d, f))]
    head += [("norm.weight", (d,))] + linear_spec("output", d, c["num_actions"])
    return {"embed": resnet_spec(TRUNK, "resnet.", 0), "head": head}


@torch.no_grad()
def weights(config, seed, device, root):
    """``{"embed", "head"}`` state dicts drawn from ``seed`` on ``device``:
    :func:`~portbench.reference.weights.seeded`, then each Mamba-2 layer's
    ``A_log``, ``dt_bias`` and ``D`` as Mamba-2 initialises them, from a
    second generator of the same seed."""
    sd = seeded(spec(config), seed, device)
    gen = torch.Generator(device=device).manual_seed((seed + 1) % 2**63)
    lo, hi = DT_RANGE
    for i, kind in enumerate(config["layer_types"]):
        if kind != "mamba":
            continue
        m = f"layers.{i}.mamba."
        heads = sd["head"][m + "D"].shape[0]
        u = torch.rand(2, heads, generator=gen, device=device)
        a = A_RANGE[0] + (A_RANGE[1] - A_RANGE[0]) * u[0]
        dt = torch.exp(u[1] * (math.log(hi) - math.log(lo)) + math.log(lo))
        sd["head"][m + "A_log"].copy_(torch.log(a))
        sd["head"][m + "dt_bias"].copy_(dt + torch.log(-torch.expm1(-dt)))
        sd["head"][m + "D"].fill_(1.0)
    return sd


def embed(crops, sd, config):
    """NCHW RGB crops in [0, 1] -> ResNet-18's pooled features ``[N, 512]``."""
    return resnet(crops, sd, TRUNK, prefix="resnet.", fc=False)


def rms_norm(x, weight, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * weight


def causal_conv(x, weight, bias):
    """Depthwise causal convolution over ``[B, L, C]``: ``out[t] = bias +
    sum_k weight[:, 0, k] x[t - K + 1 + k]``, zeros before the first row."""
    k = weight.shape[-1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = bias.expand_as(x).clone()
    for j in range(k):
        out = out + xp[:, j:j + x.shape[1]] * weight[:, 0, j]
    return out


def ssd_recurrence(x, dt, A, B, C, D):
    """The scan step by step: ``x`` ``[b, L, H, P]``, ``dt`` ``[b, L, H]``,
    ``A``, ``D`` ``[H]``, ``B``, ``C`` ``[b, L, G, N]`` -> ``[b, L, H, P]``."""
    b, length, heads, p = x.shape
    rep = heads // B.shape[2]
    B, C = B.repeat_interleave(rep, dim=2), C.repeat_interleave(rep, dim=2)
    h = x.new_zeros(b, heads, p, B.shape[-1])
    out = []
    for t in range(length):
        h = (torch.exp(dt[:, t] * A)[..., None, None] * h
             + (dt[:, t, :, None] * x[:, t])[..., None] * B[:, t, :, None, :])
        out.append((h * C[:, t, :, None, :]).sum(-1) + D[:, None] * x[:, t])
    return torch.stack(out, dim=1)


def segsum(a):
    """``[..., T]`` -> ``[..., T, T]``: ``sum_{s < j <= l} a_j`` at ``[l, s]``
    for ``s <= l``, -inf above the diagonal (exact segment sums)."""
    t = a.shape[-1]
    x = a[..., None].expand(*a.shape, t)
    below = torch.tril(torch.ones(t, t, dtype=torch.bool, device=a.device), -1)
    x = torch.cumsum(x.masked_fill(~below, 0), dim=-2)
    return x.masked_fill(~torch.tril(torch.ones_like(below), 0), float("-inf"))


def ssd_chunked(x, dt, A, B, C, D, chunk):
    """The scan in the paper's chunked closed form (``ssd_minimal_discrete``
    of https://arxiv.org/abs/2405.21060), ``HEAD_BLOCK`` heads at a time;
    the same shapes as :func:`ssd_recurrence`."""
    b, length, heads, p = x.shape
    rep = heads // B.shape[2]
    pad = -length % chunk
    cut = lambda t: F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)).reshape(  # noqa: E731
        b, -1, chunk, *t.shape[2:])
    out = []
    for h0 in range(0, heads, HEAD_BLOCK):
        hs = slice(h0, min(h0 + HEAD_BLOCK, heads))
        xs = cut(x[:, :, hs] * dt[:, :, hs, None])                     # [b, c, l, h, p]
        a = cut(dt[:, :, hs] * A[hs]).permute(0, 3, 1, 2)              # [b, h, c, l]
        groups = torch.arange(hs.start, hs.stop, device=x.device) // rep
        bs, cs = cut(B[:, :, groups]), cut(C[:, :, groups])            # [b, c, l, h, n]
        a_cum = torch.cumsum(a, dim=-1)
        decay = torch.exp(segsum(a))                                   # [b, h, c, l, s]
        scores = torch.einsum("bclhn,bcshn->bhcls", cs, bs) * decay
        y_diag = torch.einsum("bhcls,bcshp->bclhp", scores, xs)
        decay_states = torch.exp(a_cum[..., -1:] - a_cum)              # [b, h, c, l]
        states = torch.einsum("bclhn,bhcl,bclhp->bchpn", bs, decay_states, xs)
        states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
        decay_chunk = torch.exp(segsum(F.pad(a_cum[..., -1], (1, 0))))  # [b, h, c+1, c+1]
        states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)[:, :-1]
        y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", cs, states, torch.exp(a_cum))
        out.append((y_diag + y_off).reshape(b, -1, hs.stop - hs.start, p)[:, :length])
    return torch.cat(out, dim=2) + D[:, None] * x


def mamba(x, sd, m, c):
    """One Mamba-2 mixer on ``[B, L, d]``; its weights under prefix ``m``."""
    b, length, _ = x.shape
    _, inner, conv_dim, heads = _dims(c)
    gn = c["mamba_n_groups"] * c["mamba_d_state"]
    z, xbc, dt = F.linear(x, sd[m + "in_proj.weight"]).split([inner, conv_dim, heads], dim=-1)
    xbc = F.silu(causal_conv(xbc, sd[m + "conv1d.weight"], sd[m + "conv1d.bias"]))
    xs, bm, cm = xbc.split([inner, gn, gn], dim=-1)
    dt = F.softplus(dt + sd[m + "dt_bias"])
    A = -torch.exp(sd[m + "A_log"])
    shape = (b, length, c["mamba_n_groups"], c["mamba_d_state"])
    args = (xs.reshape(b, length, heads, -1), dt, A, bm.reshape(shape), cm.reshape(shape),
            sd[m + "D"])
    y = ssd_chunked(*args, c["mamba_chunk_size"]) if x.is_cuda else ssd_recurrence(*args)
    y = rms_norm(y.reshape(b, length, inner) * F.silu(z), sd[m + "norm.weight"],
                 c["rms_norm_eps"])
    return F.linear(y, sd[m + "out_proj.weight"])


def attention(x, sd, a, c):
    """Causal grouped-query attention without positional encoding on
    ``[B, L, d]``; its weights under prefix ``a``."""
    b, length, d = x.shape
    heads, kv = c["num_attention_heads"], c["num_key_value_heads"]
    hd = d // heads
    q = F.linear(x, sd[a + "q_proj.weight"]).reshape(b, length, heads, hd).transpose(1, 2)
    k = F.linear(x, sd[a + "k_proj.weight"]).reshape(b, length, kv, hd).transpose(1, 2)
    v = F.linear(x, sd[a + "v_proj.weight"]).reshape(b, length, kv, hd).transpose(1, 2)
    k, v = k.repeat_interleave(heads // kv, dim=1), v.repeat_interleave(heads // kv, dim=1)
    pos = torch.arange(length, device=x.device)
    out = []
    for q0 in range(0, length, QUERY_BLOCK):
        qb = q[:, :, q0:q0 + QUERY_BLOCK]
        scores = torch.matmul(qb, k.transpose(-1, -2)) * c["attention_multiplier"]
        later = pos[None, :] > pos[q0:q0 + qb.shape[2], None]
        out.append(torch.matmul(torch.softmax(scores.masked_fill(later, float("-inf")), -1), v))
    y = torch.cat(out, dim=2).transpose(1, 2).reshape(b, length, heads * hd)
    return F.linear(y, sd[a + "o_proj.weight"])


def sequence_head(seq, sd, config):
    """``[B, L, 512]`` frame features -> log-probs ``[B, L, A]``; row t from
    rows 0 to t."""
    c = config
    eps, rm = c["rms_norm_eps"], c["residual_multiplier"]
    x = linear(seq, sd, "frame_proj") * c["embedding_multiplier"]
    for i, kind in enumerate(c["layer_types"]):
        p = f"layers.{i}."
        h = rms_norm(x, sd[p + "input_layernorm.weight"], eps)
        h = mamba(h, sd, p + "mamba.", c) if kind == "mamba" else attention(
            h, sd, p + "self_attn.", c)
        x = x + h * rm
        h = rms_norm(x, sd[p + "post_attention_layernorm.weight"], eps)
        gate, up = F.linear(h, sd[p + "shared_mlp.input_linear.weight"]).chunk(2, dim=-1)
        x = x + F.linear(F.silu(gate) * up, sd[p + "shared_mlp.output_linear.weight"]) * rm
    x = rms_norm(x, sd["norm.weight"], eps)
    return torch.log_softmax(linear(x, sd, "output") / c["logits_scaling"], dim=-1)


def head(windows, sd, config):
    """``[B, T, 512]`` -> the last row's log-probs ``[B, A]``: a window read
    as a sequence of its own (the window route's form; the cell runs
    :func:`sequence_head` over whole VODs)."""
    return sequence_head(windows, sd, config)[:, -1]


def embed_flops(config):
    """One crop through the frame encoder, to its pooled features."""
    return roofline.resnet_flops(TRUNK, config["crop_size"])


def head_flops(config):
    """The head's linear work a row (a sampled frame of one fighter): the
    frame projection; in each Mamba-2 layer the input and output
    projections, the convolution's taps and the SSD's products a row
    (``portbench/k6.py``: the chunked form's causal half of ``C B^T`` and
    of its product with ``dt x``, the chunk state, the output from the
    state, the state pass's share and the D skip); in each attention layer
    the four projections; the shared MLP of every layer; the output layer.
    Attention's length-dependent products (``Q K^T`` and the weights times
    ``V``, about 1.5% of the head at 5,400 rows) are left out, as are the
    norms and activations.  The count is of the work, whatever implements
    it."""
    c = config
    d, inner, conv_dim, heads = _dims(c)
    q = c["num_attention_heads"]
    hd = d // q
    mlp = roofline.linear_flops(d, 2 * c["shared_intermediate_size"]) + roofline.linear_flops(
        c["shared_intermediate_size"], d)
    mixer = {
        "mamba": (roofline.linear_flops(d, inner + conv_dim + heads)
                  + 2 * c["mamba_d_conv"] * conv_dim + k6.ssd_flops_per_row(c)
                  + roofline.linear_flops(inner, d)),
        "attention": (2 * roofline.linear_flops(d, q * hd)
                      + 2 * roofline.linear_flops(d, c["num_key_value_heads"] * hd)),
    }
    return (roofline.linear_flops(FEATURES, d) + sum(mixer[k] + mlp for k in c["layer_types"])
            + roofline.linear_flops(d, c["num_actions"]))


def k2_blocks(config):
    """``(channels, height, width)`` of each block the port runs on K2:
    every identity block of ResNet-18, as in the CNN and RNN families."""
    return roofline.identity_blocks(TRUNK, config["crop_size"])
