"""The RNN family's recurrence: a stacked LSTM over time.

Counterpart of ``StackedLSTM`` in
``playaid_core_tpu/models/rnn_action_detector.py``, on ``nn.LSTM`` (cuDNN
on the card) with the batch first, so the recurrence runs over the time
axis as in the JAX package.  Flax's ``OptimizedLSTMCell`` has input
kernels without a bias and hidden kernels with one, gates in the order
i, f, g, o and a zero initial state: that is ``nn.LSTM`` with
``bias_ih`` at zero and the Flax biases in ``bias_hh`` (``convert.py``
writes them so).  :class:`RNNActionDetector` is the trainable whole.
"""

from __future__ import annotations

import torch
from torch import nn

from playaid_core_torch.models.resnet import init_flax_, lecun_normal_


class StackedLSTM(nn.LSTM):
    """``[B, T, F]`` -> ``[B, T, hidden]``: the last layer's outputs."""

    def __init__(self, input_size, hidden_size=512, num_layers=3):
        super().__init__(input_size, hidden_size, num_layers, batch_first=True)

    def forward(self, x):
        return super().forward(x)[0]


def _init_lstm_(lstm, generator=None):
    """Flax's ``OptimizedLSTMCell`` initialisers: lecun_normal input
    kernels, orthogonal recurrent kernels (one per gate), zero biases."""
    h = lstm.hidden_size
    with torch.no_grad():
        for layer in range(lstm.num_layers):
            w_ih = getattr(lstm, f"weight_ih_l{layer}")
            w_hh = getattr(lstm, f"weight_hh_l{layer}")
            for g in range(4):
                lecun_normal_(w_ih[g * h:(g + 1) * h], generator)
                nn.init.orthogonal_(w_hh[g * h:(g + 1) * h], generator=generator)
            getattr(lstm, f"bias_ih_l{layer}").zero_()
            getattr(lstm, f"bias_hh_l{layer}").zero_()


class RNNActionDetector(nn.Module):
    """ResNet-18 encoder (300-d) + 3-layer LSTM (hidden 512) + MLP decoder:
    ``[B, T, H, W, 3]`` in [0, 1] -> per-frame log-probs ``[B * T,
    num_actions]`` (the reference's flattened shape).

    Counterpart of ``RNNActionDetector`` in
    ``playaid_core_tpu/models/rnn_action_detector.py``, built from the
    pipeline's ``RNNEmbed`` (``.embed``) and ``RNNTemporalHead``
    (``.head``).  Flax's LSTM cell has one bias per gate, ``nn.LSTM`` two:
    the input-side ``bias_ih_l*`` stay at zero and do not train
    (``requires_grad`` off), so no optimizer updates them and they count
    in no gradient norm.  The graph does not depend on T.
    """

    def __init__(self, num_actions, encoder_features=300, hidden_size=512, num_layers=3):
        super().__init__()
        # Imported here: the pipeline imports this module for StackedLSTM.
        from playaid_core_torch.infer.pipeline import RNNEmbed, RNNTemporalHead

        self.embed = RNNEmbed(encoder_features)
        self.head = RNNTemporalHead(num_actions, encoder_features, hidden_size, num_layers)
        for name, p in self.head.lstm.named_parameters():
            if name.startswith("bias_ih"):
                p.requires_grad_(False)
                with torch.no_grad():
                    p.zero_()

    def forward(self, x):
        b, t = x.shape[0], x.shape[1]
        feats = self.embed(x.reshape((b * t,) + x.shape[2:])).reshape(b, t, -1)
        log_probs = self.head(feats)
        return log_probs.reshape(b * t, -1)

    def init_weights(self, generator=None):
        """Flax's initialisers: ``init_flax_`` for the ResNet and the dense
        layers, the LSTM cell's own for the recurrence."""
        init_flax_(self, generator)
        _init_lstm_(self.head.lstm, generator)
        return self
