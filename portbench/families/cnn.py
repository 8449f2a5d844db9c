"""The CNN family (``models/cnn_action_detector.py`` of the source repo):
ResNet-18 to the embedding; the head flattens a window of embeddings
time-major, then dense 512, ReLU, dense 128, ReLU, dense to the classes,
log-softmax.  Its weights are the trained ``.npz`` the configuration
names, in the Flax layout.  The port runs every identity block of its
trunk on K2."""

import torch

from portbench import roofline
from portbench.reference.models import linear, resnet
from portbench.reference.weights import load_flax_cnn

TRUNK = "resnet18"


def weights(config, seed, device, root):
    """``{"embed", "head"}`` state dicts, read from the configuration's
    ``.npz`` (the same whatever ``seed``)."""
    return load_flax_cnn(f"{root}/{config['weights']}", device)


def embed(crops, sd, config):
    """NCHW RGB crops in [0, 1] -> ``[N, embed_dim]``."""
    return resnet(crops, sd, TRUNK)


def head(windows, sd, config):
    """``[B, T, D]`` -> log-probs ``[B, A]``."""
    y = torch.relu(linear(windows.reshape(windows.shape[0], -1), sd, "temporal_dense"))
    y = torch.relu(linear(y, sd, "mlp_hidden"))
    return torch.log_softmax(linear(y, sd, "classifier"), dim=1)


def embed_flops(config):
    """One crop through the frame encoder."""
    return (roofline.resnet_flops(TRUNK, config["crop_size"])
            + roofline.linear_flops(512, config["embed_dim"]))


def head_flops(config):
    """One window of ``sequence_length`` embeddings through the head."""
    t, d, a = config["sequence_length"], config["embed_dim"], config["num_actions"]
    h = config["head"]
    return (roofline.linear_flops(t * d, h["dense"])
            + roofline.linear_flops(h["dense"], h["hidden"])
            + roofline.linear_flops(h["hidden"], a))


def k2_blocks(config):
    """``(channels, height, width)`` of each block the port runs on K2:
    every identity block of ResNet-18 (stride 1, channels unchanged) at the
    configuration's crop size."""
    return roofline.identity_blocks(TRUNK, config["crop_size"])
