"""The ResFormer family (``models/resnet_transformer_detector.py`` of the
source repo): ResNet-50's pooled features through a dense layer to the
embedding; the head joins a window's features with a sinusoidal time
encoding of 9 (position, then cos and sin at 4 frequencies), runs post-norm
transformer layers (query scaled by 1/sqrt(head_dim) before the product,
layer norm eps 1e-6, a ReLU feed-forward) and a per-step dense classifier,
log-softmax; the centre step labels the window.  Its weights are drawn
from the seed (no trained ResFormer is in the repo).  The port runs
ResNet-50 on cuDNN: no block on K2."""

import math

import torch
import torch.nn.functional as F

from portbench import roofline
from portbench.reference.models import linear, resnet, time_encoding
from portbench.reference.weights import linear_spec, resnet_spec, seeded

TRUNK = "resnet50"
LN_EPS = 1e-6


def spec(config):
    """``{"embed": [(name, shape)], "head": [...]}`` at the configuration's
    widths, under torchvision's and ``nn.TransformerEncoderLayer``'s names."""
    h = config["head"]
    d_model = config["embed_dim"] + 1 + 2 * h["time_freqs"]
    embed = (resnet_spec(TRUNK, "resnet.", 0)
             + linear_spec("resnet_ffn", 2048, config["embed_dim"]))
    head = []
    for i in range(h["layers"]):
        p = f"layers.{i}."
        head += [(p + "self_attn.in_proj_weight", (3 * d_model, d_model)),
                 (p + "self_attn.in_proj_bias", (3 * d_model,))]
        head += linear_spec(p + "self_attn.out_proj", d_model, d_model)
        head += linear_spec(p + "linear1", d_model, h["ffn"])
        head += linear_spec(p + "linear2", h["ffn"], d_model)
        for norm in ("norm1", "norm2"):
            head += [(f"{p}{norm}.weight", (d_model,)), (f"{p}{norm}.bias", (d_model,))]
    head += linear_spec("classifier", d_model, config["num_actions"])
    return {"embed": embed, "head": head}


def weights(config, seed, device, root):
    """``{"embed", "head"}`` state dicts drawn from ``seed`` on ``device``."""
    return seeded(spec(config), seed, device)


def embed(crops, sd, config):
    """NCHW RGB crops in [0, 1] -> ``[N, embed_dim]``."""
    return linear(resnet(crops, sd, TRUNK, prefix="resnet.", fc=False), sd, "resnet_ffn")


def _encoder_layer(x, sd, p, heads):
    b, t, e = x.shape
    hd = e // heads
    qkv = F.linear(x, sd[p + "self_attn.in_proj_weight"], sd[p + "self_attn.in_proj_bias"])
    q, k, v = qkv.reshape(b, t, 3, heads, hd).permute(2, 0, 3, 1, 4)
    att = torch.softmax(torch.matmul(q / math.sqrt(hd), k.transpose(-1, -2)), dim=-1)
    out = torch.matmul(att, v).transpose(1, 2).reshape(b, t, e)
    x = F.layer_norm(x + linear(out, sd, p + "self_attn.out_proj"), (e,),
                     sd[p + "norm1.weight"], sd[p + "norm1.bias"], LN_EPS)
    ff = linear(torch.relu(linear(x, sd, p + "linear1")), sd, p + "linear2")
    return F.layer_norm(x + ff, (e,), sd[p + "norm2.weight"], sd[p + "norm2.bias"], LN_EPS)


def head(windows, sd, config):
    """``[B, T, D]`` -> the centre step's log-probs ``[B, A]``."""
    b, t, _ = windows.shape
    enc = time_encoding(t).to(windows.device)
    y = torch.cat([windows, enc.expand(b, -1, -1)], dim=2)
    for i in range(config["head"]["layers"]):
        y = _encoder_layer(y, sd, f"layers.{i}.", config["head"]["heads"])
    return torch.log_softmax(linear(y, sd, "classifier"), dim=2)[:, t // 2]


def embed_flops(config):
    """One crop through the frame encoder."""
    return (roofline.resnet_flops(TRUNK, config["crop_size"])
            + roofline.linear_flops(2048, config["embed_dim"]))


def head_flops(config):
    """One window of ``sequence_length`` embeddings through the head."""
    t, d, a = config["sequence_length"], config["embed_dim"], config["num_actions"]
    h = config["head"]
    e = d + 1 + 2 * h["time_freqs"]
    layer = (roofline.linear_flops(e, 3 * e, t) + 2 * 2 * t * t * e
             + roofline.linear_flops(e, e, t) + roofline.linear_flops(e, h["ffn"], t)
             + roofline.linear_flops(h["ffn"], e, t))
    return h["layers"] * layer + roofline.linear_flops(e, a, t)


def k2_blocks(config):
    """No block runs on K2: the port runs ResNet-50 on cuDNN."""
    return []
