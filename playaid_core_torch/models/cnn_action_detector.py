"""CNN action detector: per-frame ResNet-18 + temporal dense head.

Counterpart of ``playaid_core_tpu/models/cnn_action_detector.py``.  Each
frame of a ``[B, T, H, W, 3]`` window in [0, 1] goes through a ResNet-18
(1000-d), the window's features flatten t-major to ``[B, T * 1000]``, and
a dense head (512, 128, then the actions) classifies the window's centre
frame.  The modules are the inference pipeline's own, ``CNNEmbed`` as
``.embed`` and ``CNNTemporalHead`` as ``.head``, so ``{"embed":
model.embed.state_dict(), "head": model.head.state_dict()}`` is a
checkpoint that ``BatchedActionPipeline.load_checkpoint`` reads.
"""

from __future__ import annotations

import torch
from torch import nn

from playaid_core_torch.infer.pipeline import CNNEmbed, CNNTemporalHead
from playaid_core_torch.models.resnet import init_flax_


class SpatialStreamCNN(nn.Module):
    """``[B, T, H, W, 3]`` -> action logits ``[B, num_actions]``."""

    def __init__(self, num_actions, sequence_length, resnet_features=1000):
        super().__init__()
        self.embed = CNNEmbed(num_classes=resnet_features)
        self.head = CNNTemporalHead(num_actions, sequence_length, resnet_features)

    def features(self, x):
        b, t = x.shape[0], x.shape[1]
        return self.embed(x.reshape((b * t,) + x.shape[2:])).reshape(b, t, -1)

    def forward(self, x):
        return self.head.logits(self.features(x))

    def init_weights(self, generator=None):
        """Flax's initialisers (``models/resnet.py::init_flax_``)."""
        return init_flax_(self, generator)


class CNNActionDetector(SpatialStreamCNN):
    """Forward = log_softmax over the centre frame's action logits."""

    def __init__(self, num_actions, sequence_length=4):
        super().__init__(num_actions, sequence_length)

    def forward(self, x):
        return torch.log_softmax(super().forward(x), dim=1)
