"""Losses and metrics of the action-recognition model families.

Counterpart of ``playaid_core_tpu/models/losses.py``: center-frame NLL for
the CNN family, per-frame NLL for the RNN and ResFormer families.  Model
forwards return log-probabilities, so the loss is a plain NLL gather.
"""

from __future__ import annotations

import torch


def nll_loss(log_probs, labels):
    """Mean negative log-likelihood. log_probs ``[N, C]``, labels ``[N]``."""
    picked = torch.gather(log_probs, -1, labels[:, None].long())[:, 0]
    return -picked.mean()


def center_frame_loss(log_probs, action_labels):
    """CNN-family supervision: the label of the window's middle frame.
    log_probs ``[B, C]``, action_labels ``[B, T]``."""
    return nll_loss(log_probs, action_labels[:, action_labels.shape[1] // 2])


def per_frame_loss(log_probs, action_labels):
    """RNN/ResFormer supervision over every timestep.
    log_probs ``[B, T, C]`` or ``[B * T, C]``, action_labels ``[B, T]``."""
    flat_labels = action_labels.reshape(-1)
    return nll_loss(log_probs.reshape(flat_labels.shape[0], -1), flat_labels)


def accuracy(log_probs, labels):
    """Fraction of argmax matches; ties go to the first index, as in
    ``jnp.argmax``.  Shapes broadcast like the losses."""
    flat_labels = labels.reshape(-1)
    preds = torch.argmax(log_probs.reshape(flat_labels.shape[0], -1), dim=-1)
    return (preds == flat_labels).float().mean()
