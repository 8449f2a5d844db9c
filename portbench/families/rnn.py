"""The RNN family (``models/rnn_action_detector.py`` of the source repo,
``RNNActionDetector``): ResNet-18's pooled features through a dense layer
(``encoder_proj``) to the embedding; the head runs a stacked LSTM over the
window (gates i, f, g, o; ``bias_ih + bias_hh``; a zero initial state),
then dense 128, ReLU, dense to the classes and log-softmax at every step;
the centre step labels the window.  Its weights are drawn from the seed
(no trained RNN is in the repo).  The port runs the LSTM on ``nn.LSTM``
(cuDNN on the card) and every identity block of its trunk on K2; the
reference here writes the LSTM out by its gate equations."""

import torch
import torch.nn.functional as F

from portbench import roofline
from portbench.reference.models import linear, resnet
from portbench.reference.weights import linear_spec, resnet_spec, seeded

TRUNK = "resnet18"
FEATURES = 512  # ResNet-18's pooled features


def spec(config):
    """``{"embed": [(name, shape)], "head": [...]}`` at the configuration's
    widths, under the port's names (``nn.LSTM``'s for the recurrence)."""
    h = config["head"]
    embed = resnet_spec(TRUNK, "resnet.", 0) + linear_spec("encoder_proj", FEATURES,
                                                           config["embed_dim"])
    head = []
    n_in = config["embed_dim"]
    for k in range(h["layers"]):
        head += [(f"lstm.weight_ih_l{k}", (4 * h["hidden"], n_in)),
                 (f"lstm.weight_hh_l{k}", (4 * h["hidden"], h["hidden"])),
                 (f"lstm.bias_ih_l{k}", (4 * h["hidden"],)),
                 (f"lstm.bias_hh_l{k}", (4 * h["hidden"],))]
        n_in = h["hidden"]
    head += linear_spec("decoder_hidden", h["hidden"], h["decoder"])
    head += linear_spec("decoder_out", h["decoder"], config["num_actions"])
    return {"embed": embed, "head": head}


def weights(config, seed, device, root):
    """``{"embed", "head"}`` state dicts drawn from ``seed`` on ``device``."""
    return seeded(spec(config), seed, device)


def embed(crops, sd, config):
    """NCHW RGB crops in [0, 1] -> ``[N, embed_dim]``."""
    return linear(resnet(crops, sd, TRUNK, prefix="resnet.", fc=False), sd, "encoder_proj")


def lstm(x, sd, layers):
    """``[B, T, F]`` -> the last layer's hidden states ``[B, T, H]``, step
    by step: per layer and step, ``gates = x_t W_ih^T + h_{t-1} W_hh^T +
    b_ih + b_hh`` split into i, f, g, o; ``c_t = sigmoid(f) c_{t-1} +
    sigmoid(i) tanh(g)``, ``h_t = sigmoid(o) tanh(c_t)``; ``h_0 = c_0 =
    0``."""
    b, t, _ = x.shape
    for k in range(layers):
        w_ih, w_hh = sd[f"lstm.weight_ih_l{k}"], sd[f"lstm.weight_hh_l{k}"]
        bias = sd[f"lstm.bias_ih_l{k}"] + sd[f"lstm.bias_hh_l{k}"]
        h = c = x.new_zeros(b, w_hh.shape[1])
        out = []
        for s in range(t):
            i, f, g, o = (F.linear(x[:, s], w_ih) + F.linear(h, w_hh) + bias).chunk(4, dim=1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            out.append(h)
        x = torch.stack(out, dim=1)
    return x


def head(windows, sd, config):
    """``[B, T, D]`` -> the centre step's log-probs ``[B, A]``, every step
    computed as published."""
    y = torch.relu(linear(lstm(windows, sd, config["head"]["layers"]), sd, "decoder_hidden"))
    return torch.log_softmax(linear(y, sd, "decoder_out"), dim=2)[:, windows.shape[1] // 2]


def embed_flops(config):
    """One crop through the frame encoder."""
    return (roofline.resnet_flops(TRUNK, config["crop_size"])
            + roofline.linear_flops(FEATURES, config["embed_dim"]))


def head_flops(config):
    """The work the centre step's log-probs need in one window.  The LSTM
    is causal: step ``T // 2`` reads steps 0 to ``T // 2`` alone.  So each
    layer counts the input products of those ``T // 2 + 1`` steps and the
    recurrent products of steps 1 to ``T // 2`` (``h_0`` is 0), and the
    decoder runs at the centre step only.  A change that stops the head at
    the centre step then reads as the same work, not as less."""
    t, d, a = config["sequence_length"], config["embed_dim"], config["num_actions"]
    h = config["head"]
    steps = t // 2 + 1
    flops, n_in = 0, d
    for _ in range(h["layers"]):
        flops += (roofline.linear_flops(n_in, 4 * h["hidden"], steps)
                  + roofline.linear_flops(h["hidden"], 4 * h["hidden"], steps - 1))
        n_in = h["hidden"]
    return (flops + roofline.linear_flops(h["hidden"], h["decoder"])
            + roofline.linear_flops(h["decoder"], a))


def k2_blocks(config):
    """``(channels, height, width)`` of each block the port runs on K2:
    every identity block of ResNet-18 at the configuration's crop size, as
    in the CNN family."""
    return roofline.identity_blocks(TRUNK, config["crop_size"])
