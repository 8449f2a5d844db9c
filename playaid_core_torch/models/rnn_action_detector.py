"""The RNN family's recurrence: a stacked LSTM over time.

Counterpart of ``StackedLSTM`` in
``playaid_core_tpu/models/rnn_action_detector.py``, on ``nn.LSTM`` (cuDNN
on the card) with the batch first, so the recurrence runs over the time
axis as in the JAX package.  Flax's ``OptimizedLSTMCell`` has input
kernels without a bias and hidden kernels with one, gates in the order
i, f, g, o and a zero initial state: that is ``nn.LSTM`` with
``bias_ih`` at zero and the Flax biases in ``bias_hh`` (``convert.py``
writes them so).
"""

from __future__ import annotations

from torch import nn


class StackedLSTM(nn.LSTM):
    """``[B, T, F]`` -> ``[B, T, hidden]``: the last layer's outputs."""

    def __init__(self, input_size, hidden_size=512, num_layers=3):
        super().__init__(input_size, hidden_size, num_layers, batch_first=True)

    def forward(self, x):
        return super().forward(x)[0]
