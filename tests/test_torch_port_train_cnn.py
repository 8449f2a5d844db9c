"""One train step of the port's CNN family (ResNet-18 + dense head,
center-frame loss) against the JAX trainer's, on the CPU at batch 2, T 3,
32-px crops, from the same perturbed init carried across by
convert.monolithic_state_dict.

Tolerances: loss 1e-5 abs; every gradient 2e-4 of max|g_jax| of its
tensor (1.12e-4 measured on layer4[1].conv2, the rest below 1e-4: at 32 px
layer4 is 1x1, so its train-mode batch norm averages six values, and its
backward subtracts terms that nearly cancel; Flax also takes the variance
as E[x^2] - E[x]^2); updated batch statistics 1e-5 of max|jax|; parameters after Adam
from the JAX gradients 1e-6 abs, its moments 1e-6 of max|jax|; eval
log-probs 1e-4 abs.
"""

from tests.test_torch_port_train import StepParity


class TestCNNStep(StepParity):
    family = "cnn"
    grad_rel_tol = 2e-4
