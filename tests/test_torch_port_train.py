"""The port's training path (playaid_core_torch.train and what it imports)
against the JAX package's, on the CPU.

Losses, accuracy (ties included) and the learning-rate schedules are held
against the JAX functions and optax; batch norm's training update against
Flax's (biased batch variance); staging, profiling and the Trainer's loop,
checkpoints and command line are ported from the JAX package's own tests
(tests/test_parallel.py, test_viz_and_misc.py, test_models.py,
test_train.py) at their tiny sizes.  The per-family step parity lives in
test_torch_port_train_{cnn,rnn,resformer}.py and uses the helpers here:
the JAX trainer's own ``create_train_state`` / ``make_train_step`` on a
perturbed init, carried across by ``convert.monolithic_state_dict``.

Tolerances: losses and accuracy 1e-6 abs; schedules 1e-7 abs at lr 3e-4
(optax computes in float32, the port in float64).
"""

import json
import os
import threading
import time
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from playaid_core_tpu.models import losses as jax_losses
from playaid_core_tpu.train import train as jax_train
from playaid_core_torch import profiling
from playaid_core_torch.convert import monolithic_state_dict
from playaid_core_torch.infer.pipeline import BatchedActionPipeline
from playaid_core_torch.models import losses
from playaid_core_torch.models.cnn_action_detector import CNNActionDetector
from playaid_core_torch.models.resnet import (
    FEATURE_DIMS,
    BasicBlock,
    BatchNorm2d,
    Bottleneck,
    init_flax_,
    make_resnet,
)
from playaid_core_torch.models.resnet_transformer import ResnetTransformerDetector, time_encoding
from playaid_core_torch.models.rnn_action_detector import RNNActionDetector
from playaid_core_torch.parallel import dryrun
from playaid_core_torch.parallel.staging import BackgroundIterator, device_prefetch
from playaid_core_torch.train import train as port_train
from playaid_core_torch.train.dataset import UltActionRecogDataset
from playaid_core_torch.train.train import (
    Trainer,
    TrainerConfig,
    build_model,
    create_train_state,
    make_eval_step,
    make_schedule,
    make_train_step,
)
from tests.test_torch_port_families import _numpy_tree, _perturbed

torch.set_num_threads(2)

LR = 1e-3
CROP = 32
T = 3
B = 2
ACTIONS = ["ForwardSmash", "Jab", "Wait", "Unknown"]


# ---------------------------------------------------------------------------
# Step-parity helpers (used by the per-family files).


def jax_step_case(family, num_actions=5, seed=0):
    """One step of the JAX trainer from a perturbed init: the init, the
    batch, and what the step returns, as numpy trees.  The gradients are
    read back from Adam's first moment after the update (``mu = 0.1 g``,
    exact to about 1e-7 of g), so no second program is compiled."""
    model, loss_fn = jax_train.build_model(family, num_actions, T)
    sample = jnp.zeros((1, T, CROP, CROP, 3), jnp.float32)
    # The model's init compiled as one program (about half the time of the
    # op-by-op init here); create_train_state calls only init and apply.
    jitted = types.SimpleNamespace(init=jax.jit(model.init), apply=model.apply)
    state = jax_train.create_train_state(jitted, jax.random.PRNGKey(seed), sample, LR,
                                         warmup_steps=0)
    init = _perturbed({"params": _numpy_tree(state.params),
                       "batch_stats": _numpy_tree(state.batch_stats)}, seed + 1)
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, init["params"]),
                          batch_stats=jax.tree_util.tree_map(jnp.asarray, init["batch_stats"]))
    rng = np.random.default_rng(seed + 2)
    frames = rng.integers(0, 256, (B, T, CROP, CROP, 3), dtype=np.uint8)
    labels = rng.integers(0, num_actions, (B, T)).astype(np.int32)
    step = jax_train.make_train_step(model, loss_fn)
    new_state, loss, acc, gnorm, pnorm = step(state, jnp.asarray(frames), jnp.asarray(labels),
                                               jax.random.PRNGKey(seed + 3))
    adam = new_state.opt_state[0]
    mu, nu = _numpy_tree(adam.mu), _numpy_tree(adam.nu)
    return {
        "family": family, "num_actions": num_actions, "model": model, "loss_fn": loss_fn,
        "init": init, "frames": frames, "labels": labels,
        "new": {"params": _numpy_tree(new_state.params),
                "batch_stats": _numpy_tree(new_state.batch_stats)},
        "loss": float(loss), "acc": float(acc), "gnorm": float(gnorm), "pnorm": float(pnorm),
        "grads": jax.tree_util.tree_map(lambda m: m / np.float32(0.1), mu),
        "mu": mu, "nu": nu,
    }


def port_model(case, variables=None):
    """The port's detector of the case's family, holding ``variables`` (the
    case's init by default), with its loss."""
    model, loss_fn = build_model(case["family"], case["num_actions"], T)
    model.load_state_dict(monolithic_state_dict(case["family"], variables or case["init"]))
    return model, loss_fn


def named(case, tree):
    """A params-shaped numpy tree of the case (grads, mu, nu) under the
    port's parameter names."""
    return monolithic_state_dict(case["family"], {"params": tree})


def max_rel(out, ref):
    """max |out - ref| / max |ref| (0 when both are 0)."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    err = np.abs(out - ref).max()
    return 0.0 if err == 0 else float(err / scale) if scale else float("inf")


def check_gradients(case, model, rel_tol=1e-4):
    ref = named(case, case["grads"])
    trained = {k for k, p in model.named_parameters() if p.requires_grad}
    assert trained == {k for k in ref if not k.split(".")[-1].startswith("bias_ih")}
    worst = {}
    for name, p in model.named_parameters():
        if p.requires_grad:
            worst[name] = max_rel(p.grad.numpy(), ref[name].numpy())
    bad = {k: v for k, v in worst.items() if v > rel_tol}
    assert not bad, bad
    return worst


def check_batch_stats(case, model, rel_tol=1e-5, var_rel_tol=1e-5):
    ref = monolithic_state_dict(case["family"], case["new"])
    state = model.state_dict()
    keys = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        tol = var_rel_tol if k.endswith("running_var") else rel_tol
        assert max_rel(state[k].numpy(), ref[k].numpy()) <= tol, k


def check_adam_from_jax_gradients(case, tol=1e-6):
    """The JAX gradients in the port's ``.grad``, one fused Adam step: the
    parameters and the moments against the JAX trainer's."""
    model, _ = port_model(case)
    state = create_train_state(model, LR, warmup_steps=0)
    grads = named(case, case["grads"])
    params = dict(model.named_parameters())
    for name, p in params.items():
        if p.requires_grad:
            p.grad = grads[name].clone(memory_format=torch.contiguous_format)
    state.optimizer.step()
    new = monolithic_state_dict(case["family"], case["new"])
    mu, nu = named(case, case["mu"]), named(case, case["nu"])
    for name, p in params.items():
        if not p.requires_grad:
            continue
        assert float((p.detach() - new[name]).abs().max()) <= tol, name
        moments = state.optimizer.state[p]
        assert max_rel(moments["exp_avg"].numpy(), mu[name].numpy()) <= tol, name
        assert max_rel(moments["exp_avg_sq"].numpy(), nu[name].numpy()) <= tol, name
    return model


def jax_eval_log_probs(case, variables, frames):
    x = jnp.asarray(frames).astype(jnp.float32) / 255.0
    return np.asarray(case["model"].apply(
        {"params": variables["params"], "batch_stats": variables["batch_stats"]}, x,
        train=False))


def check_eval(case, log_prob_tol=1e-4):
    """The JAX trainer's state after its step, carried across: eval-mode
    log-probs, and the port's eval_step loss and accuracy against the JAX
    losses on the JAX log-probs."""
    model, loss_fn = port_model(case, case["new"])
    ref = jax_eval_log_probs(case, case["new"], case["frames"])
    frames, labels = torch.from_numpy(case["frames"]), torch.from_numpy(case["labels"])
    state = create_train_state(model, LR, warmup_steps=0)
    loss, acc = make_eval_step(model, loss_fn)(state, frames, labels)
    assert not model.training
    with torch.no_grad():
        out = model(frames.float() / 255.0).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=log_prob_tol)
    jax_loss_fn = case["loss_fn"]
    ref_labels = jax_train._match_labels(jnp.asarray(ref), jnp.asarray(case["labels"]))
    assert abs(float(loss) - float(jax_loss_fn(jnp.asarray(ref), jnp.asarray(case["labels"])))) <= 1e-5
    assert float(acc) == float(jax_losses.accuracy(jnp.asarray(ref), ref_labels))


class StepParity:
    """One train step of the family against the JAX trainer's, from the same
    init on the same uint8 batch: loss, accuracy, norms, every gradient,
    the updated batch statistics, Adam from the JAX gradients, eval."""

    family = None
    grad_rel_tol = 1e-4

    @pytest.fixture(scope="class")
    def case(self, request):
        return jax_step_case(request.cls.family)

    @pytest.fixture(scope="class")
    def stepped(self, case):
        model, loss_fn = port_model(case)
        state = create_train_state(model, LR, warmup_steps=0)
        out = make_train_step(model, loss_fn)(state, torch.from_numpy(case["frames"]),
                                              torch.from_numpy(case["labels"]))
        return model, state, [float(v) for v in out]

    def test_loss_accuracy_and_norms_match_jax(self, case, stepped):
        _, state, (loss, acc, gnorm, pnorm) = stepped
        assert abs(loss - case["loss"]) <= 1e-5
        assert acc == case["acc"]
        assert abs(gnorm - case["gnorm"]) <= 1e-5 * case["gnorm"]
        assert abs(pnorm - case["pnorm"]) <= 1e-5 * case["pnorm"]
        assert state.step == 1

    def test_gradients_match_jax(self, case, stepped):
        check_gradients(case, stepped[0], self.grad_rel_tol)

    def test_batch_stats_match_jax(self, case, stepped):
        check_batch_stats(case, stepped[0])

    def test_adam_from_jax_gradients_matches_jax(self, case):
        check_adam_from_jax_gradients(case)

    def test_eval_matches_jax(self, case):
        check_eval(case)


# ---------------------------------------------------------------------------
# Losses, accuracy, schedules.


def _log_probs(shape, seed, ties=True):
    x = np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)
    if ties:  # equal maxima: argmax takes the first
        flat = x.reshape(-1, shape[-1])
        flat[::2, 1] = flat[::2, 3] = flat[::2].max(axis=1) + 1.0
    return np.asarray(jax.nn.log_softmax(jnp.asarray(x), axis=-1))


def test_losses_and_accuracy_match_jax():
    lp2 = _log_probs((6, 5), 0)
    lp3 = _log_probs((2, 3, 5), 1)
    labels = np.random.default_rng(2).integers(0, 5, (2, 3)).astype(np.int32)
    labels6 = np.array([1, 3, 0, 1, 3, 2], np.int32)
    cases = [
        (losses.nll_loss, jax_losses.nll_loss, lp2, labels6),
        (losses.center_frame_loss, jax_losses.center_frame_loss, lp2[:2], labels),
        (losses.per_frame_loss, jax_losses.per_frame_loss, lp3, labels),
        (losses.per_frame_loss, jax_losses.per_frame_loss, lp3.reshape(6, 5), labels),
        (losses.accuracy, jax_losses.accuracy, lp2, labels6),
        (losses.accuracy, jax_losses.accuracy, lp3, labels),
    ]
    for fn, ref_fn, lp, lab in cases:
        out = float(fn(torch.from_numpy(lp), torch.from_numpy(lab)))
        ref = float(ref_fn(jnp.asarray(lp), jnp.asarray(lab)))
        assert abs(out - ref) <= 1e-6, fn.__name__
    # Ties go to the first index: label 1 matches on the tied rows, 3 never.
    tied = lp2[::2]
    assert float(losses.accuracy(torch.from_numpy(tied), torch.ones(3, dtype=torch.int32))) == 1.0
    assert float(losses.accuracy(torch.from_numpy(tied), torch.full((3,), 3))) == 0.0


def test_losses_ported_cases():
    """tests/test_models.py::test_losses and ::test_center_and_per_frame_losses."""
    logp = torch.log(torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1]]))
    labels = torch.tensor([0, 1])
    assert np.isclose(float(losses.nll_loss(logp, labels)),
                      -(np.log(0.7) + np.log(0.8)) / 2, rtol=1e-4)
    assert float(losses.accuracy(logp, labels)) == 1.0
    gen = torch.Generator().manual_seed(0)
    logp3 = torch.log_softmax(torch.randn(2, 5, 4, generator=gen), dim=-1)
    zeros = torch.zeros((2, 5), dtype=torch.int32)
    assert losses.per_frame_loss(logp3, zeros).shape == ()
    center = torch.log_softmax(torch.randn(2, 4, generator=gen), dim=-1)
    assert np.isclose(float(losses.center_frame_loss(center, zeros)),
                      float(-center[:, 0].mean()), rtol=1e-6)


SCHEDULES = {
    "constant": dict(warmup_steps=0, decay_steps=None),
    "linear_warmup": dict(warmup_steps=200, decay_steps=None),
    "warmup_cosine": dict(warmup_steps=20, decay_steps=120),
}


def _optax_schedule(lr, warmup_steps, decay_steps):
    """The schedule JAX's create_train_state builds (train.py:80-92)."""
    if decay_steps:
        return optax.warmup_cosine_decay_schedule(
            init_value=lr * 0.05, peak_value=lr, warmup_steps=warmup_steps or 1,
            decay_steps=decay_steps, end_value=lr * 0.1)
    if warmup_steps:
        return optax.linear_schedule(init_value=lr * 0.05, end_value=lr,
                                     transition_steps=warmup_steps)
    return lambda count: lr


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_optax(name):
    """At counts 0, 1, warmup - 1, warmup, the decay's end and past it, the
    port's schedule and the learning rate its optimizer runs at update n
    (LambdaLR stepped after each update) equal optax's at count n."""
    lr = 3e-4
    kw = SCHEDULES[name]
    ref = _optax_schedule(lr, **kw)
    warmup = kw["warmup_steps"] or 1
    end = kw["decay_steps"] or 2 * warmup
    counts = sorted({0, 1, warmup - 1, warmup, end - 1, end, end + 5})
    schedule = make_schedule(lr, **kw)
    for c in counts:
        assert abs(schedule(c) - float(ref(jnp.asarray(c, jnp.int32)))) <= 1e-7, c
    state = create_train_state(torch.nn.Linear(1, 1), lr, **kw)
    used = []
    for c in range(max(counts) + 1):
        used.append(state.optimizer.param_groups[0]["lr"])
        state.optimizer.step()
        state.scheduler.step()
    for c in counts:
        assert abs(used[c] - float(ref(jnp.asarray(c, jnp.int32)))) <= 1e-7, c


def test_optax_counts_before_the_increment():
    """optax's first update uses the schedule at count 0: the JAX state's
    Adam count is 1 after one step, its schedule was read at 0."""
    sched = optax.linear_schedule(0.05, 1.0, 10)
    tx = optax.adam(sched)
    params = {"w": jnp.ones(3)}
    opt_state = tx.init(params)
    updates, _ = tx.update({"w": jnp.ones(3)}, opt_state, params)
    # First Adam direction is g / (|g| + eps) = 1: the update is -lr(0).
    np.testing.assert_allclose(np.asarray(updates["w"]), -0.05, rtol=1e-5)
    state = create_train_state(torch.nn.Linear(3, 1, bias=False), 1.0, warmup_steps=10)
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(0.05)


# ---------------------------------------------------------------------------
# Batch norm, init, the fused kernel's pack.


def test_batch_norm_train_update_matches_flax():
    """Biased batch variance, momentum 0.9, as Flax's BatchNorm; the
    built-in nn.BatchNorm2d (unbiased) does not match."""
    import flax.linen as fnn

    x = np.random.default_rng(0).normal(0.3, 1.5, (2, 1, 1, 4)).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    y_ref, upd = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    port = BatchNorm2d(4).train()
    y = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), atol=1e-5)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]), rtol=1e-5)
    builtin = torch.nn.BatchNorm2d(4, eps=1e-5, momentum=0.1).train()
    builtin(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert not np.allclose(builtin.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                           rtol=1e-3)
    port.eval()  # eval mode: the running statistics, as nn.BatchNorm2d
    builtin.load_state_dict(port.state_dict())
    builtin.eval()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    assert torch.equal(port(xt), builtin(xt))


def test_resnet_batchnorm_train_mode_updates_stats():
    """tests/test_models.py:47: a train-mode forward moves the statistics."""
    net = make_resnet("resnet18", num_classes=0)
    init_flax_(net, torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in net.state_dict().items() if "running" in k}
    net.train()(torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(1)))
    after = net.state_dict()
    assert all(not torch.equal(before[k], after[k]) for k in before)
    assert int(after["bn1.num_batches_tracked"]) == 1


def test_make_resnet():
    for arch, blocks in (("resnet18", (2, 2, 2, 2)), ("resnet34", (3, 4, 6, 3)),
                         ("resnet50", (3, 4, 6, 3))):
        net = make_resnet(arch, num_classes=0, s2d_stem=True).eval()
        assert tuple(len(getattr(net, f"layer{i}")) for i in range(1, 5)) == blocks
        with torch.no_grad():
            assert net(torch.zeros(1, 3, 32, 32)).shape == (1, FEATURE_DIMS[arch])
        head = make_resnet(arch, num_classes=7)
        assert head.fc.out_features == 7
    assert isinstance(make_resnet("resnet34").layer4[2], BasicBlock)
    assert make_resnet("resnet34").layer4[2].fused  # the last identity block
    with pytest.raises(KeyError):
        make_resnet("resnet101")


@pytest.mark.parametrize("family", ["cnn", "rnn", "resformer"])
def test_flax_init(family):
    """Seeded, and as Flax draws: lecun_normal kernels (truncated at 2
    standard deviations of the underlying normal, variance 1 / fan_in),
    zero biases, unit norm scales, zero scale on each block's last batch
    norm, orthogonal LSTM recurrent kernels."""
    def make(seed):
        model, _ = build_model(family, 5, T)
        return model.init_weights(torch.Generator().manual_seed(seed))

    a, b, c = make(0), make(0), make(1)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert any(not torch.equal(sa[k], sc[k]) for k in sa if sa[k].dim() > 1)
    last_bn = {id(m.bn2.weight) for m in a.modules() if isinstance(m, BasicBlock)}
    last_bn |= {id(m.bn3.weight) for m in a.modules() if isinstance(m, Bottleneck)}
    assert last_bn
    for name, p in a.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if "bias" in leaf:
            assert not p.any(), name
        elif p.dim() == 1:  # batch-norm and layer-norm scales
            assert torch.all(p == (0.0 if id(p) in last_bn else 1.0)), name
        elif leaf.startswith("weight_hh"):
            h = p.shape[1]
            for g in range(4):
                w = p[g * h:(g + 1) * h]
                assert torch.allclose(w @ w.T, torch.eye(h), atol=1e-4), name
        else:
            fan_in = p[0].numel()
            std = (1.0 / fan_in) ** 0.5
            bound = 2.0 * std / 0.87962566103423978
            assert float(p.abs().max()) <= bound * (1 + 1e-6), name
            if p.numel() >= 4096:
                assert abs(float(p.std()) / std - 1.0) < 0.1, name
    for name, buf in a.named_buffers():
        if name.endswith("running_mean"):
            assert not buf.any()
        elif name.endswith("running_var"):
            assert torch.all(buf == 1.0)


def test_fused_pack_rebuilt_after_a_fused_adam_step():
    """K2 never trains, and its pack follows the weights: a fused Adam step
    bumps their versions, so the next eval call packs the new weights; and
    BasicBlock.train() drops the pack."""
    model = CNNActionDetector(5, T).init_weights(torch.Generator().manual_seed(0))
    block = model.embed.layer4[1]
    assert block.fused
    with torch.no_grad():
        block.bn2.weight.fill_(0.5)
    model.eval()
    pack = block.block_pack(torch.float32)
    assert block.block_pack(torch.float32) is pack  # cached while nothing changes
    state = create_train_state(model, LR, warmup_steps=0)
    assert state.optimizer.defaults["fused"]
    x = torch.rand(2, T, CROP, CROP, 3, generator=torch.Generator().manual_seed(1))
    labels = torch.zeros(2, T, dtype=torch.int32)
    losses.center_frame_loss(model(x), labels).backward()
    state.optimizer.step()
    fresh = block.block_pack(torch.float32)
    assert fresh is not pack
    assert not torch.equal(fresh.w1, pack.w1) and not torch.equal(fresh.s2, pack.s2)
    make_train_step(model, losses.center_frame_loss)(state, x, labels)
    assert model.training and block._pack is None  # train() dropped it


def test_time_encoding_ported_case():
    """tests/test_models.py::test_time_encoding_matches_reference_shape."""
    enc = time_encoding(np.linspace(0, 1, 7).reshape(-1, 1), 4)
    assert enc.shape == (7, 9)
    assert np.isclose(enc[0, 0], 0.0) and np.isclose(enc[-1, 0], 1.0)
    assert np.allclose(enc[0, 1::2], 1.0)


def test_gradients_flow():
    """tests/test_models.py::test_gradients_flow, and the output shapes of
    the three detectors (their log-probs sum to 1)."""
    gen = torch.Generator().manual_seed(0)
    model = CNNActionDetector(5, 3).init_weights(gen)
    x = torch.rand(2, 3, CROP, CROP, 3, generator=gen)
    loss = losses.center_frame_loss(model.eval()(x), torch.tensor([[1, 1, 1], [2, 2, 2]]))
    loss.backward()
    assert any(float(p.grad.abs().sum()) > 0 for p in model.parameters())
    for m, shape in ((model, (2, 5)), (RNNActionDetector(8).init_weights(gen), (6, 8)),
                     (ResnetTransformerDetector(63, 3).init_weights(gen), (2, 3, 63))):
        with torch.no_grad():
            out = m.eval()(x)
        assert out.shape == shape
        np.testing.assert_allclose(out.exp().sum(-1).numpy(), 1.0, rtol=1e-5)


def test_monolithic_state_dict_is_strict():
    """Every leaf of a JAX monolithic tree maps to one port entry; a stray
    leaf raises; the moment trees map onto the trained parameters."""
    model, _ = jax_train.build_model("cnn", 5, T)
    variables = _numpy_tree(jax.jit(model.init)(jax.random.PRNGKey(0),
                                                jnp.zeros((1, T, CROP, CROP, 3))))
    state = monolithic_state_dict("cnn", variables)
    port = CNNActionDetector(5, T)
    assert set(state) == set(port.state_dict())
    port.load_state_dict(state)
    moments = monolithic_state_dict("cnn", {"params": variables["params"]})
    assert set(moments) == {k for k, _ in port.named_parameters()}
    variables["params"]["model"]["classifier"]["stray"] = np.zeros(2, np.float32)
    with pytest.raises(KeyError):
        monolithic_state_dict("cnn", variables)
    with pytest.raises(ValueError):
        monolithic_state_dict("lstm", variables)


# ---------------------------------------------------------------------------
# Staging and profiling (tests/test_parallel.py:80-119,
# tests/test_viz_and_misc.py:11 and :129).


def test_device_prefetch_order():
    items = [(np.full((2, 2), i), np.full(3, -i)) for i in range(5)]
    out = list(device_prefetch(items, size=2, device="cpu"))
    assert len(out) == 5
    for i, (x, y) in enumerate(out):
        assert isinstance(x, torch.Tensor) and float(x[0, 0]) == i and float(y[0]) == -i


def test_device_prefetch_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        list(device_prefetch([(np.zeros(2),)], size=1))


def test_background_iterator():
    out = list(BackgroundIterator(range(10), maxsize=3))
    assert out == list(range(10))


def test_background_iterator_slow_consumer_terminates():
    """The end-of-iteration sentinel reaches a consumer slower than the
    producer, even when the queue was full when the producer finished."""
    it = BackgroundIterator(range(3), maxsize=2)
    time.sleep(0.5)  # let the producer fill the queue and reach its finally
    out = []

    def consume():
        for x in it:
            out.append(x)
            time.sleep(0.05)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=10.0)
    assert not t.is_alive(), "consumer deadlocked waiting for the sentinel"
    assert out == [0, 1, 2]


def test_background_iterator_propagates_errors():
    def gen():
        yield 1
        raise ValueError("boom")

    it = iter(BackgroundIterator(gen()))
    assert next(it) == 1
    with pytest.raises(ValueError, match="boom"):
        list(it)


def test_background_iterator_close_unblocks_the_producer():
    bg = BackgroundIterator(iter(range(1000)), maxsize=2)
    time.sleep(0.3)  # the producer blocks on the full queue
    bg.close()
    assert not bg._thread.is_alive()


def test_stage_timer():
    t = profiling.StageTimer()
    with t.stage("decode"):
        pass
    t.add("infer", 0.5)
    s = t.summary()
    assert s["infer"]["total_s"] == 0.5
    assert s["decode"]["count"] == 1
    assert "decode" in t.report()


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.span("stage1"):
            torch.ones(8, 8).sum()
    path = tmp_path / "trace" / profiling.TRACE_FILE
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "stage1" for e in events)
    spans = json.loads((tmp_path / "trace" / profiling.SPANS_FILE).read_text())
    assert [s["name"] for s in spans["spans"]] == ["stage1"]


# ---------------------------------------------------------------------------
# The Trainer (tests/test_train.py:54-107 at its tiny size, device="cpu").


@pytest.fixture(scope="module")
def tiny_gt_tree(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("gt_tiny")
    rng = np.random.default_rng(0)
    for split in ("train", "validation"):
        base = root / split / "vid" / "0_byleth"
        (base / "images").mkdir(parents=True)
        (base / "labels").mkdir(parents=True)
        for frame in range(20):
            img = rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)
            cv2.imwrite(str(base / "images" / f"{frame:06d}.jpg"), img)
            with open(base / "labels" / f"{frame:06d}.txt", "w") as f:
                f.write(ACTIONS[frame % 2])
    return root


def tiny_dataset(root, split, num_frames_per_sample=3):
    return UltActionRecogDataset(
        split=split, num_samples=8, img_dimension=32, anim_subset=ACTIONS,
        num_frames_per_sample=num_frames_per_sample, frame_delta=[1], char_subset=["Byleth"],
        crop_size=32, seed=0, gt_root_train=str(root / "train"),
        gt_root_val=str(root / "validation"), gt_root_test=str(root / "validation"),
    )


def tiny_config(**kw):
    base = dict(family="cnn", num_actions=len(ACTIONS), sequence_length=3, batch_size=4,
                learning_rate=1e-3, num_samples=8, crop_size=32, device="cpu")
    base.update(kw)
    return TrainerConfig(**base)


def test_trainer_fit_and_eval(tiny_gt_tree, tmp_path):
    config = tiny_config(log_path=str(tmp_path / "metrics.jsonl"), warmup_steps=0)
    trainer = Trainer(config, tiny_dataset(tiny_gt_tree, "train"),
                      tiny_dataset(tiny_gt_tree, "validation"))
    trainer.fit(num_epochs=2, steps_per_epoch=2)
    assert len(trainer.metrics_log) == 2
    rec = trainer.metrics_log[0]
    jax_keys = {"epoch", "train_loss", "train_acc", "grad_norm", "grad_norm_last", "param_norm",
                "seconds", "steps_per_sec", "crops_per_sec", "synth_difficulty", "val_loss",
                "val_acc"}
    assert set(rec) == jax_keys
    assert np.isfinite(rec["train_loss"]) and rec["grad_norm"] > 0 and rec["param_norm"] > 0
    with open(config.log_path) as f:
        assert [json.loads(line) for line in f] == trainer.metrics_log
    assert trainer.state.step == 4
    metrics = trainer.evaluate(tiny_dataset(tiny_gt_tree, "validation"), num_batches=1)
    assert 0.0 <= metrics["acc"] <= 1.0


def test_trainer_loss_decreases_on_fixed_batch(tiny_gt_tree):
    """Overfit sanity: repeated steps on one batch reduce the loss."""
    train_ds = tiny_dataset(tiny_gt_tree, "train")
    trainer = Trainer(tiny_config(batch_size=2), train_ds)
    trainer.init_state()
    frames, _, labels = next(train_ds.batches(2, 1))
    frames, labels = torch.from_numpy(frames), torch.from_numpy(labels)
    losses_seen = []
    for _ in range(8):
        loss, acc, gnorm, pnorm = trainer.train_step(trainer.state, frames, labels)
        losses_seen.append(float(loss))
        assert float(gnorm) > 0.0 and float(pnorm) > 0.0
    assert losses_seen[-1] < losses_seen[0], losses_seen


def test_trainer_resamples_t_for_the_rnn(tiny_gt_tree):
    train_ds = tiny_dataset(tiny_gt_tree, "train", num_frames_per_sample=[2, 3, 5])
    trainer = Trainer(tiny_config(family="rnn", batch_size=2, warmup_steps=0), train_ds)
    seen = []
    orig = trainer.train_step

    def spy(state, frames, labels):
        assert frames.dtype == torch.uint8  # the wire format
        seen.append(frames.shape[1])
        return orig(state, frames, labels)

    trainer.train_step = spy
    trainer.fit(num_epochs=4, steps_per_epoch=1)
    assert len(set(seen)) > 1 and set(seen) <= {2, 3, 5}
    for rec, t in zip(trainer.metrics_log, seen):
        assert rec["crops_per_sec"] == round(2 * t / rec["seconds"], 1)


def test_checkpoint_roundtrip_and_pipeline_load(tiny_gt_tree, tmp_path):
    """step_<epoch>.pt is {"embed", "head"}; restoring brings back the
    weights, Adam's moments, the schedule and the generator; the file
    loads into BatchedActionPipeline.load_checkpoint and gives the
    trainer model's eval log-probs."""
    config = tiny_config(batch_size=2, checkpoint_dir=str(tmp_path / "ckpts"), warmup_steps=5)
    train_ds = tiny_dataset(tiny_gt_tree, "train")
    trainer = Trainer(config, train_ds)
    trainer.fit(num_epochs=1, steps_per_epoch=3)
    path = os.path.join(config.checkpoint_dir, "step_0.pt")
    assert os.path.exists(path) and os.path.exists(path[:-3] + ".trainer.pt")
    saved = torch.load(path, weights_only=True)
    assert set(saved) == {"embed", "head"}
    model = trainer.model
    model.eval()
    x = torch.rand(3, T, CROP, CROP, 3, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        ref = model(x)
    pipe = BatchedActionPipeline("cnn", len(ACTIONS), T, crop_size=CROP,
                                 device="cpu").load_checkpoint(path)
    with torch.inference_mode():
        emb = pipe.embed_crops(x.reshape(-1, CROP, CROP, 3)).reshape(3, T, -1)
        out = pipe.head(emb)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)

    opt_before = {k: v.clone() for k, v in
                  trainer.state.optimizer.state[trainer.state.params[0]].items()}
    gen_before = trainer.generator.get_state()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    other = Trainer(config, train_ds)
    other.restore_checkpoint(path)
    assert other.state.step == 3
    assert other.state.optimizer.param_groups[0]["lr"] == trainer.state.optimizer.param_groups[0]["lr"]
    for k, v in other.state.optimizer.state[other.state.params[0]].items():
        assert torch.equal(v, opt_before[k]), k
    assert torch.equal(other.generator.get_state(), gen_before)
    for part in ("embed", "head"):
        restored = getattr(other.model, part).state_dict()
        assert all(torch.equal(restored[k], v) for k, v in saved[part].items()), part


def test_trainer_defaults_to_cuda_and_refuses_unported_options(tiny_gt_tree):
    ds = tiny_dataset(tiny_gt_tree, "train")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(tiny_config(device=None), ds)

    # A dataset with device_batches is no longer refused: its frames go
    # into the step as they come, and only its labels are copied.
    frames = torch.zeros((2, 3, CROP, CROP, 3), dtype=torch.uint8)
    batch = (frames, np.zeros(2, np.int32), np.zeros((2, 3), np.int32))

    class DeviceSynth:
        device = torch.device("cpu")
        device_batches = staticmethod(lambda batch_size, steps: iter([batch]))

    (got, _, labels), = Trainer(tiny_config(), DeviceSynth())._epoch_batches(1)
    assert got is frames and isinstance(labels, torch.Tensor) and labels.shape == (2, 3)

    # Its device must be the trainer's: a mismatch is named at once.
    DeviceSynth.device = torch.device("meta")
    with pytest.raises(ValueError, match="meta.*cpu"):
        Trainer(tiny_config(), DeviceSynth())


def test_train_cli(tiny_gt_tree, tmp_path, monkeypatch, capsys):
    """python -m playaid_core_torch.train.train on --device cpu: the
    ground-truth splits at the constants' paths, checkpoints and the JSONL
    log under the run's name, then the test split's metrics."""
    from playaid_core_torch import constants

    for name, split in (("ACTION_GROUND_TRUTH_TRAIN", "train"),
                        ("ACTION_GROUND_TRUTH_VAL", "validation"),
                        ("ACTION_GROUND_TRUTH_TEST", "validation")):
        monkeypatch.setattr(constants, name, str(tiny_gt_tree / split))
    monkeypatch.setattr(constants, "SAVED_ACTION_MODELS", str(tmp_path / "models"))
    monkeypatch.setattr(constants, "ACTION_RECOG_OUTPUT_DIR", str(tmp_path / "logs"))
    argv = ["--family", "cnn", "--fighters", "Byleth", "--batch_size", "2", "--num_epochs", "1",
            "--num_samples", "2", "--num_frames_per_sample", "3", "--frame_delta", "1",
            "--name", "tiny", "--device", "cpu"]
    monkeypatch.setattr(port_train.UltActionRecogDataset, "__init__", _small_crops(
        port_train.UltActionRecogDataset.__init__))
    assert port_train.main(argv) == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert "loss" in out and "acc" in out
    assert os.path.exists(tmp_path / "models" / "tiny" / "step_0.pt")
    with open(tmp_path / "logs" / "tiny" / "metrics.jsonl") as f:
        assert json.loads(f.readline())["epoch"] == 0
    assert port_train.main(argv + ["--ckpt", str(tmp_path / "models" / "tiny" / "step_0.pt")]) == 0
    with pytest.raises(NotImplementedError, match="north star"):
        port_train.main(argv + ["--bf16"])
    # --model_parallel 2 runs on a mesh of two gloo ranks (128-px crops: the
    # spawned ranks see the command line's own dataset, not the patch above).
    tree = tmp_path / "data" / "ult_dataset" / "gt_action_detection"
    tree.mkdir(parents=True)
    for split, source in (("train", "train"), ("validation", "validation"),
                          ("test", "validation")):
        os.symlink(tiny_gt_tree / source, tree / split)
    monkeypatch.setenv("PLAYAID_DATA_ROOT", str(tmp_path / "data"))
    mp_argv = argv + ["--model_parallel", "2", "--num_samples", "2"]
    assert dryrun.spawn_ranks(port_train.main, 2, (mp_argv,), timeout_s=300) == [0, 0]
    assert os.path.exists(tmp_path / "data" / "models" / "action" / "tiny" / "step_0.pt")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_train.main(argv[:-2])


def _small_crops(init):
    """The command line's crops are 128 px; 32 keeps the CPU run short."""
    def wrapped(self, *args, **kw):
        init(self, *args, **dict(kw, crop_size=CROP))
    return wrapped
