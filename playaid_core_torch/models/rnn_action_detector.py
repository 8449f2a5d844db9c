"""The RNN family's recurrence: a stacked LSTM over time.

Counterpart of ``StackedLSTM`` in
``playaid_core_tpu/models/rnn_action_detector.py``, on ``nn.LSTM`` (cuDNN
on the card) with the batch first, so the recurrence runs over the time
axis as in the JAX package.  Flax's ``OptimizedLSTMCell`` has input
kernels without a bias and hidden kernels with one, gates in the order
i, f, g, o and a zero initial state: that is ``nn.LSTM`` with
``bias_ih`` at zero and the Flax biases in ``bias_hh`` (``convert.py``
writes them so).  On a mesh that splits ``model`` the stack is stepped by
hand on this rank's gate rows (:meth:`StackedLSTM.stepped`).
:class:`RNNActionDetector` is the trainable whole.
"""

from __future__ import annotations

import torch
from torch import nn

from playaid_core_torch.models.resnet import init_flax_, lecun_normal_
from playaid_core_torch.parallel.mesh import gather_model, to_model


class StackedLSTM(nn.LSTM):
    """``[B, T, F]`` -> ``[B, T, hidden]``: the last layer's outputs.

    On a mesh that splits ``model`` (``parallel.mesh.attach_mesh`` sets
    ``mesh`` and replaces ``weight_ih_l*``/``weight_hh_l*`` by this rank's
    rows of each of the i, f, g, o blocks, as the JAX rules shard the
    cell's kernels' hidden columns), the recurrence runs hand-stepped
    (:meth:`stepped`); otherwise it is ``nn.LSTM`` (cuDNN on the card).
    """

    mesh = None

    def __init__(self, input_size, hidden_size=512, num_layers=3):
        super().__init__(input_size, hidden_size, num_layers, batch_first=True)

    @property
    def sharded(self):
        """True when this module holds a slice of its gate rows."""
        return self.weight_hh_l0.shape[0] < 4 * self.hidden_size

    def flatten_parameters(self):
        # cuDNN's flat buffer holds whole gate blocks; a rank's rows have none.
        if not self.sharded:
            super().flatten_parameters()

    def forward(self, x):
        if self.sharded:
            return self.stepped(x)
        return super().forward(x)[0]

    def stepped(self, x):
        """The stacked LSTM stepped by hand over time on this rank's gate
        rows, with ``h`` all-gathered over ``model`` at every step (on no
        mesh, or one of ``model`` 1, the whole cell: equal to ``nn.LSTM``).

        Per layer: the input's gates for all T in one matmul; per step the
        recurrent matmul, this rank's slice of the bias, the gate
        nonlinearities on ``[B, 4 H/m]`` and ``c`` kept as ``[B, H/m]``.
        The gathered ``h`` feeds the next step and the next layer, which
        use all of it for this rank's gate columns, so their gradient of it
        is summed over ``model`` (``to_model``); the decoder after the last
        layer is replicated, and its gradient is taken as it is."""
        mesh = self.mesh
        m = mesh.axis_size("model") if mesh is not None else 1
        index = mesh.index("model") if mesh is not None else 0
        hidden = self.hidden_size
        if hidden % m:
            raise ValueError(f"the LSTM's hidden size {hidden} does not split over "
                             f"model={m}")
        h_local = hidden // m
        if self.weight_hh_l0.shape[0] != 4 * h_local:
            raise ValueError(f"the LSTM holds {self.weight_hh_l0.shape[0]} gate rows; "
                             f"model={m} gives a rank {4 * h_local}")
        rows = slice(index * h_local, (index + 1) * h_local)
        b = x.shape[0]
        for layer in range(self.num_layers):
            w_ih = getattr(self, f"weight_ih_l{layer}")
            w_hh = getattr(self, f"weight_hh_l{layer}")
            bias = to_model(getattr(self, f"bias_ih_l{layer}")
                            + getattr(self, f"bias_hh_l{layer}"), mesh)
            bias = bias.view(4, hidden)[:, rows].reshape(4 * h_local)
            gates_x = torch.matmul(to_model(x, mesh), w_ih.t()) + bias
            h_whole, c = None, x.new_zeros(b, h_local)
            outputs = []
            for t in range(x.shape[1]):
                gates = gates_x[:, t]
                if h_whole is not None:
                    gates = gates + torch.matmul(to_model(h_whole, mesh), w_hh.t())
                i, f, g, o = gates.chunk(4, 1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h_whole = gather_model(torch.sigmoid(o) * torch.tanh(c), mesh)
                outputs.append(h_whole)
            x = torch.stack(outputs, 1)
        return x


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
