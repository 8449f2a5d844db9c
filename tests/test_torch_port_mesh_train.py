"""The port's meshed Trainer step on a (2, 2) mesh of four gloo ranks
against the JAX trainer's ``make_train_step`` on a (2, 2) mesh of four of
the eight virtual CPU devices, and against the port's own one-process
step; then ``train.main --model_parallel 2`` on four ranks under torchrun.

Same numpy inputs from a seed on both sides: a perturbed Flax init
(``tests/test_torch_port_families._perturbed``) carried across by
``convert.monolithic_state_dict``, uint8 frames of 32 px, T 3, batch 4.
The RNN's LSTM holds this rank's rows of each gate block and is stepped by
hand (``StackedLSTM.stepped``), its 63 classes whole.  The ResFormer runs
with dropout on: the JAX side's dropout draws
(``jax.random.bernoulli``, called by Flax's ``Dropout`` and its attention)
are replaced, while its step is traced, by the masks the port draws from
its dropout generator at the whole batch's shape, in the same order.  The
CNN has no dropout; its 64 classes split the classifier over ``model``,
the ResFormer's 5 keep it whole.

Tolerances: with both sides in float64 (``jax.enable_x64``, the JAX model
built in float64; the port's model ``.double()``; frames / 255 in float64
on both), loss 1e-6 abs, grad and param norms 1e-6 relative, every
gradient (the JAX side's read from Adam's first moment, 0.1 g) and every
updated parameter and batch statistic within 1e-6 of its tensor's max.
The JAX model casts its features and logits to float32 (ROADMAP queue 3
entry 5), so its gradients carry float32 rounding (about 1e-7 of max|g|);
Adam's first update, lr * g / (|g| + eps), turns that rounding into a
different step wherever |g| is near it, so the updated parameters are
held on the elements whose gradient is at least 1e-5 of its tensor's
max|g|, and the rest through their gradients.  In float32 the meshed step
against the one-process step: loss, grad norm and param norm within 2e-4
relative (the JAX dry run's bound).
"""

import os
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import OptimizedLSTMCell

from playaid_core_torch.convert import monolithic_state_dict
from playaid_core_torch.parallel import dryrun
from playaid_core_tpu.parallel import mesh as jax_mesh
from playaid_core_tpu.train import train as jax_train
from tests.test_torch_port_families import _numpy_tree, _perturbed

torch.set_num_threads(2)

T, CROP, B, LR, SEED = 3, 32, 4, 1e-4, 0
FAMILIES = {"resformer": 5, "cnn": 64, "rnn": 63}
SPAWN_TIMEOUT_S = 300
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64_TOL = 1e-6
GRAD_FLOOR = 1e-5  # of max|g|: 100 times the JAX float64 model's float32 noise
F32_REL_TOL = 2e-4


def _split(state):
    """A monolithic state dict -> the port's {"embed", "head"} state dicts."""
    return {part: {k[len(part) + 1:]: v for k, v in state.items() if k.startswith(part + ".")}
            for part in ("embed", "head")}


def _dropout_masks(seed):
    """``jax.random.bernoulli`` as the port's layers draw their masks: from a
    CPU torch.Generator seeded ``seed``, in call order."""
    gen = torch.Generator().manual_seed(seed)

    def bernoulli(key, p=0.5, shape=None):
        return jnp.asarray((torch.rand(tuple(shape), generator=gen) < p).numpy())

    return bernoulli


def _float64_carry(initialize_carry):
    """Flax's ``OptimizedLSTMCell`` makes its zero carry in its
    ``param_dtype`` (float32), and ``nn.RNN``'s scan then refuses the
    float64 carry its step returns: the zeros are made float64 (no value
    changes) while the JAX step is traced."""

    def carry(self, rng, input_shape):
        return jax.tree_util.tree_map(lambda c: c.astype(jnp.float64),
                                      initialize_carry(self, rng, input_shape))

    return carry


def _jax_meshed_step(family, num_actions, init, frames, labels):
    """One JAX train step in float64 on a (2, 2) mesh of four devices."""
    with jax.enable_x64(True):
        model, loss_fn = jax_train.build_model(family, num_actions, T, jnp.float64)
        params, stats = (jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), init[k])
                         for k in ("params", "batch_stats"))
        mesh = jax_mesh.make_mesh(devices=jax.devices()[:4], model_parallel=2)
        import optax

        state = jax_train.TrainState.create(apply_fn=model.apply, params=params,
                                            batch_stats=stats, tx=optax.adam(LR))
        step = jax_train.make_train_step(model, loss_fn)
        with mesh:
            state = state.replace(params=jax.tree_util.tree_map(
                jax.device_put, state.params, jax_mesh.param_shardings(mesh, state.params)))
            bsh = jax_mesh.batch_sharding(mesh)
            x = jax.device_put(jnp.asarray(frames, jnp.float64) / 255.0, bsh)
            y = jax.device_put(jnp.asarray(labels, jnp.int32), bsh)
            real = jax.random.bernoulli, OptimizedLSTMCell.initialize_carry
            jax.random.bernoulli = _dropout_masks(SEED + 1)
            OptimizedLSTMCell.initialize_carry = _float64_carry(real[1])
            try:
                new, loss, acc, gnorm, pnorm = step(state, x, y, jax.random.PRNGKey(3))
            finally:
                jax.random.bernoulli, OptimizedLSTMCell.initialize_carry = real
        # Adam's first moment after one step is 0.1 g, exactly in float64.
        grads = jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1, new.opt_state[0].mu)
        return {"loss": float(loss), "gnorm": float(gnorm), "pnorm": float(pnorm),
                "grads": monolithic_state_dict(family, {"params": grads}),
                "new": monolithic_state_dict(family, {
                    "params": jax.tree_util.tree_map(np.asarray, new.params),
                    "batch_stats": jax.tree_util.tree_map(np.asarray, new.batch_stats)})}


def _init(family, num_actions):
    model, _ = jax_train.build_model(family, num_actions, T)
    variables = jax.jit(model.init)(jax.random.PRNGKey(SEED),
                                    jnp.zeros((1, T, CROP, CROP, 3), jnp.float32))
    return _perturbed({"params": _numpy_tree(variables["params"]),
                       "batch_stats": _numpy_tree(variables["batch_stats"])}, SEED + 1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per family: the JAX meshed step (float64) and the port's (2, 2) step
    in float64 from the perturbed init; the port's (2, 2) and one-process
    steps in float32 from the Trainer's own Flax init (``init_state``), as
    the JAX dry run starts (one spawn of four ranks for all four).  At the
    perturbed init the ResFormer's float32 forward is itself off float64's
    (the batch norm's cancellation at layer4's 1x1 maps, ROADMAP queue 3
    entry 5): ReLU inputs in layer4 and in the encoder's feed-forward take
    the other sign, and two float32 runs that sum in another order can
    differ beyond 2e-4 there; float64 holds them at that init."""
    work = tmp_path_factory.mktemp("mesh_train")
    rng = np.random.default_rng(SEED + 2)
    out = {}
    cases = []
    for family, num_actions in FAMILIES.items():
        init = _init(family, num_actions)
        frames = rng.integers(0, 256, (B, T, CROP, CROP, 3), dtype=np.uint8)
        labels = rng.integers(0, num_actions, (B, T)).astype(np.int64)
        base = {"family": family, "num_actions": num_actions, "sequence_length": T,
                "crop_size": CROP, "device": "cpu", "seed": SEED, "lr": LR, "frames": frames,
                "labels": labels, "init": _split(monolithic_state_dict(family, init)),
                "model_parallel": 2}
        f64_path = str(work / f"{family}_f64.pt")
        cases += [dict(base, double=True, out=f64_path), dict(base, init=None)]
        out[family] = {"jax": _jax_meshed_step(family, num_actions, init, frames, labels),
                       "one": dryrun.run_train_case(dict(base, init=None, model_parallel=1)),
                       "f64_path": f64_path}
    ranks = dryrun.spawn_ranks(dryrun.run_train_cases, 4, (cases,), timeout_s=SPAWN_TIMEOUT_S)
    for k, family in enumerate(FAMILIES):
        out[family]["f64"], out[family]["f32"] = ranks[0][2 * k:2 * k + 2]
        out[family]["ranks"] = [r[2 * k + 1] for r in ranks]
    return out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_meshed_step_matches_jax_meshed_step_in_float64(runs, family):
    run = runs[family]
    ref, got = run["jax"], run["f64"]
    assert tuple(got["mesh"]) == (2, 2)
    assert abs(got["losses"][0] - ref["loss"]) <= F64_TOL
    assert abs(got["grad_norms"][0] - ref["gnorm"]) <= F64_TOL * ref["gnorm"]
    assert abs(got["param_norms"][0] - ref["pnorm"]) <= F64_TOL * ref["pnorm"]
    whole = torch.load(run["f64_path"], weights_only=True)
    new = {f"{part}.{k}": v for part in ("embed", "head") for k, v in whole[part].items()}
    ref_new = {k: v for k, v in ref["new"].items() if not k.endswith("num_batches_tracked")}
    assert {k for k in new if not k.endswith("num_batches_tracked")} == set(ref_new)
    assert set(whole["grads"]) == {k for k, g in ref["grads"].items() if "bias_ih" not in k}
    bad = {}
    for name, value in ref_new.items():
        scale = float(value.abs().max())
        if scale == 0:  # the LSTM's input-side biases: zero, and never trained
            assert float(new[name].abs().max()) == 0, name
            continue
        err = (new[name] - value.double()).abs()
        if name in ref["grads"]:
            # Adam's first step moves an element by lr * g / (|g| + eps): where
            # |g| is under the JAX gradient's float32 noise, its direction is
            # noise too.  Those elements are held through the gradient below.
            g = ref["grads"][name].abs()
            err = err[g >= GRAD_FLOOR * float(g.max())]
        if float(err.max()) > F64_TOL * scale:
            bad[name] = float(err.max()) / scale
    for name, g in whole["grads"].items():
        ref_g = ref["grads"][name].double()
        err = float((g - ref_g).abs().max()) / float(ref_g.abs().max())
        if err > F64_TOL:
            bad[f"grad {name}"] = err
    assert not bad, bad


@pytest.mark.parametrize("family", list(FAMILIES))
def test_meshed_step_matches_one_process_in_float32(runs, family):
    run = runs[family]
    one = run["one"]
    for rank, got in enumerate(run["ranks"]):
        for key in ("losses", "grad_norms", "param_norms"):
            a, b = got[key][0], one[key][0]
            assert abs(a - b) <= F32_REL_TOL * abs(b), (rank, key, a, b)
    # The collectives that ran: gradients over data, the heads' partial
    # sums over model (and, for the CNN, the gathered widths; for the RNN,
    # h gathered at every step of every layer).
    moved, calls = run["f32"]["bytes"], run["f32"]["calls"]
    assert moved["all_reduce/data"] > 0 and moved["all_reduce/model"] > 0
    assert ("all_gather/model" in moved) == (family in ("cnn", "rnn"))
    if family == "rnn":
        assert calls["all_gather/model"] == 3 * T  # 3 layers x T steps


def test_model_parallel_through_main_under_torchrun(tmp_path):
    """``torchrun --nproc-per-node 4 -m playaid_core_torch.train.train
    --model_parallel 2 --backend gloo --device cpu``: main joins torchrun's
    ranks to a gloo group (from the environment), a (2, 2) mesh; rank 0
    alone writes the JSONL record, prints the test metrics and writes the
    checkpoint, whose tensors are whole."""
    root = tmp_path / "ult_dataset" / "gt_action_detection"
    rng = np.random.default_rng(0)
    for split in ("train", "validation", "test"):
        base = root / split / "vid" / "0_byleth"
        (base / "images").mkdir(parents=True)
        (base / "labels").mkdir(parents=True)
        for frame in range(12):
            cv2.imwrite(str(base / "images" / f"{frame:06d}.jpg"),
                        rng.integers(0, 255, (32, 32, 3), dtype=np.uint8))
            (base / "labels" / f"{frame:06d}.txt").write_text(("Jab", "Wait")[frame % 2])
    env = dict(os.environ, PLAYAID_DATA_ROOT=str(tmp_path), OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
           "-m", "playaid_core_torch.train.train", "--family", "cnn", "--fighters", "Byleth",
           "--batch_size", "2", "--num_epochs", "1", "--num_samples", "2",
           "--num_frames_per_sample", "3", "--frame_delta", "1", "--name", "tiny",
           "--device", "cpu", "--model_parallel", "2", "--backend", "gloo"]
    proc = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=SPAWN_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    printed = [line for line in proc.stdout.splitlines() if "'loss'" in line]
    assert len(printed) == 1 and "'acc'" in printed[0]
    ckpt = tmp_path / "models" / "action" / "tiny" / "step_0.pt"
    assert os.path.exists(ckpt) and os.path.exists(str(ckpt)[:-3] + ".trainer.pt")
    lines = (tmp_path / "logs" / "action_recog" / "tiny" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 1
    state = torch.load(ckpt, weights_only=True)
    assert state["head"]["temporal_dense.weight"].shape == (512, 3 * 1000)
