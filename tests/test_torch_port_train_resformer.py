"""The port's ResFormer family (ResNet-50 + time encoding + 3 post-norm
transformer layers, per-frame loss) against the JAX trainer's, on the CPU
at batch 2, T 3, 32-px crops, from the same perturbed init carried across
by convert.monolithic_state_dict.

At this input ResNet-50's gradients and batch statistics are
ill-conditioned in float32: the port's own float32 and float64 gradients
differ by 1.86e-3 of max|g| on layer1[1].conv3, and Flax's batch variance
(E[x^2] - E[x]^2 in float32) errs by up to 0.79% at layer4.  So the
gradients and the updated statistics are held with both sides in float64
(the JAX model built with dtype float64 under ``jax.enable_x64``, the
port's model in ``.double()``), where the only float32 step left is the
JAX model's cast of its ResNet features and logits to float32.  Measured:
gradients 1.65e-7 of max|g|, statistics 5.2e-8 of max, loss 1.6e-7.

Dropout draws differ between the two (JAX's PRNG against a
torch.Generator), so the loss and gradients are held in eval mode on both
sides, and the train step (dropout on) only for the batch statistics,
which the trunk computes before any dropout.  Dropout itself is checked
for what the Flax layer does: rate 0.1 in four places, the attention mask
shared by the batch and the heads, masks drawn from the layer's generator.

Tolerances: float64 loss 1e-6 abs, every gradient 1e-6 of max|g_jax| of
its tensor, updated running statistics 1e-6 of max|jax|; in float32, Adam
from the JAX train step's gradients 1e-6 and eval log-probs 1e-4 abs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playaid_core_torch.models.resnet_transformer import (
    ResnetTransformerDetector,
    TransformerEncoderLayer,
    dropout,
)
from playaid_core_torch.train.train import create_train_state, make_train_step
from playaid_core_tpu.train import train as jax_train
from tests.test_torch_port_train import (
    LR,
    T,
    check_adam_from_jax_gradients,
    check_batch_stats,
    check_eval,
    jax_step_case,
    max_rel,
    named,
    port_model,
)

GRAD_REL_TOL = 1e-6
STATS_REL_TOL = 1e-6
LOSS_TOL = 1e-6


@pytest.fixture(scope="module")
def case():
    """The float32 train step's case, plus in float64: the eval-mode loss
    and gradients, and the running statistics after a train-mode forward."""
    case = jax_step_case("resformer")
    with jax.enable_x64(True):
        model, loss_fn = jax_train.build_model("resformer", case["num_actions"], T, jnp.float64)
        params, stats = (jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                                case["init"][k])
                         for k in ("params", "batch_stats"))
        x = jnp.asarray(case["frames"], jnp.float64) / 255.0
        y = jnp.asarray(case["labels"])

        def eval_loss(p):
            return loss_fn(model.apply({"params": p, "batch_stats": stats}, x, train=False), y)

        def train_stats(p):
            _, updates = model.apply({"params": p, "batch_stats": stats}, x, train=True,
                                     mutable=["batch_stats"],
                                     rngs={"dropout": jax.random.PRNGKey(3)})
            return updates["batch_stats"]

        loss, grads = jax.jit(jax.value_and_grad(eval_loss))(params)
        case["f64"] = {
            "loss": float(loss),
            "grads": jax.tree_util.tree_map(np.asarray, grads),
            "new": {"params": case["init"]["params"],
                    "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                          jax.jit(train_stats)(params))},
        }
    return case


def _frames64(case):
    return torch.from_numpy(case["frames"]).double() / 255.0


def test_train_step_batch_stats_match_jax(case):
    """Dropout on, on both sides, in float64: the trunk's statistics match."""
    model, loss_fn = port_model(case)
    model.double().set_dropout_generator(torch.Generator().manual_seed(0))
    state = create_train_state(model, LR, warmup_steps=0)
    loss, acc, gnorm, pnorm = make_train_step(model, loss_fn)(
        state, _frames64(case), torch.from_numpy(case["labels"]))
    assert torch.isfinite(loss) and float(gnorm) > 0
    assert all(v.dtype == torch.float64 for v in model.state_dict().values()
               if v.is_floating_point())
    check_batch_stats(dict(case, new=case["f64"]["new"]), model, STATS_REL_TOL, STATS_REL_TOL)


def test_eval_mode_loss_and_gradients_match_jax(case):
    model, loss_fn = port_model(case)
    model.double().eval()
    loss = loss_fn(model(_frames64(case)), torch.from_numpy(case["labels"]))
    loss.backward()
    assert abs(loss.item() - case["f64"]["loss"]) <= LOSS_TOL
    ref = named(case, case["f64"]["grads"])
    bad = {name: max_rel(p.grad.numpy(), ref[name].numpy())
           for name, p in model.named_parameters()}
    assert set(bad) == set(ref)
    bad = {k: v for k, v in bad.items() if v > GRAD_REL_TOL}
    assert not bad, bad


def test_adam_from_jax_gradients_matches_jax(case):
    check_adam_from_jax_gradients(case)


def test_eval_matches_jax(case):
    check_eval(case)


def _layer(seed=0):
    layer = TransformerEncoderLayer(16, 4, dim_feedforward=32)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(seed)) * 0.3)
    return layer


def test_dropout_is_seeded_by_the_generator():
    layer = _layer().train()
    x = torch.randn(3, T, 16, generator=torch.Generator().manual_seed(1))

    def run(seed):
        layer.generator = torch.Generator().manual_seed(seed)
        return layer(x)

    a, b, c = run(7), run(7), run(8)
    assert torch.equal(a, b)
    assert not torch.allclose(a, c)
    layer.eval()
    assert torch.equal(layer(x), layer(x))  # no dropout in eval mode


def test_dropout_places_and_attention_mask():
    """Four dropouts at rate 0.1; the one on the attention weights has a
    [1, 1, T, T] mask, shared by the batch and the heads."""
    layer = _layer().train()
    calls = []
    drop = layer._drop

    def spy(x, mask_shape=None, **kw):
        out = drop(x, mask_shape, **kw)
        calls.append((x, mask_shape, out))
        return out

    layer._drop = spy
    layer.generator = torch.Generator().manual_seed(3)
    x = torch.randn(4, 5, 16, generator=torch.Generator().manual_seed(2))
    layer(x)
    assert [c[1] for c in calls] == [(1, 1, 5, 5), None, None, None]
    weights, _, dropped = calls[0]
    assert weights.shape == (4, 4, 5, 5)
    kept = dropped != 0  # softmax weights are positive: zero means dropped
    assert torch.equal(kept, kept[:1, :1].expand_as(kept))
    torch.testing.assert_close(dropped[kept], weights[kept] / 0.9)
    assert layer.dropout_rate == 0.1

    big = torch.ones(200_000)
    out = dropout(big, 0.1, torch.Generator().manual_seed(0))
    assert abs(float((out == 0).float().mean()) - 0.1) < 0.005
    assert torch.all((out == 0) | (out == torch.tensor(1.0) / 0.9))


def test_detector_dropout_generator_reaches_every_layer():
    model = ResnetTransformerDetector(5, T).init_weights(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    model.set_dropout_generator(gen)
    assert all(layer.generator is gen for layer in model.head.layers)
    x = torch.rand(2, T, 32, 32, 3, generator=torch.Generator().manual_seed(2))
    model.eval()
    with torch.no_grad():
        ref = model(x)
        # Eval mode is the serving path: the pipeline's head on the embeddings.
        emb = model.embed(x.reshape(-1, 32, 32, 3)).reshape(2, T, -1)
        assert torch.equal(model.head(emb), ref)
