"""One train step of the port's RNN family (ResNet-18 + 3-layer LSTM +
MLP decoder, per-frame loss) against the JAX trainer's, on the CPU at
batch 2, T 3, 32-px crops, from the same perturbed init carried across by
convert.monolithic_state_dict; tolerances as in test_torch_port_train_cnn.py.

nn.LSTM has an input-side bias that Flax's LSTM cell does not: it stays at
zero, outside the optimizer and the gradient norm.
"""

import torch

from playaid_core_torch.train.train import build_model, create_train_state, make_train_step
from tests.test_torch_port_train import StepParity, T


class TestRNNStep(StepParity):
    family = "rnn"

    def test_input_bias_stays_zero_and_out_of_the_optimizer(self, case, stepped):
        model, state, _ = stepped
        biases = {name: p for name, p in model.named_parameters() if ".bias_ih_l" in name}
        assert len(biases) == 3
        in_optimizer = {id(p) for group in state.optimizer.param_groups for p in group["params"]}
        for name, p in biases.items():
            assert not p.requires_grad and p.grad is None, name
            assert not p.any(), name
            assert id(p) not in in_optimizer, name
        assert {id(p) for p in state.params} == in_optimizer


def test_rnn_graph_does_not_depend_on_t():
    model, loss_fn = build_model("rnn", 5, T)
    model.init_weights(torch.Generator().manual_seed(0))
    state = create_train_state(model, 1e-3, warmup_steps=0)
    step = make_train_step(model, loss_fn)
    for t in (2, 5):
        frames = torch.randint(0, 256, (2, t, 32, 32, 3), dtype=torch.uint8)
        labels = torch.randint(0, 5, (2, t), dtype=torch.int32)
        loss, acc, gnorm, pnorm = step(state, frames, labels)
        assert torch.isfinite(loss) and model(frames.float() / 255).shape == (2 * t, 5)
    assert not any(p.any() for n, p in model.named_parameters() if ".bias_ih_l" in n)
