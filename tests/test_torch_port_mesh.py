"""The port's mesh (playaid_core_torch/parallel/mesh.py) on the CPU: the
mesh's shapes and sharding rules against the JAX package's, the collectives
inside the model at gloo world size 2 (ranks spawned by
``parallel/dryrun.spawn_ranks``, which import only torch and the port),
``VodAnalyzer(mesh=)`` on a single-process mesh of four CPU positions, and
a checkpoint written on a (2, 2) mesh and continued on three others.

Tolerances: the tensor-parallel transformer layer against the whole layer
1e-5 of max|ref| (float32; the sharded products sum in another order);
batch norm over the data axis against one process on the whole batch
1e-10 (float64); VOD labels identical, confidences 1e-4 (as the JAX
package's tests/test_sharded_inference.py); checkpoint continuation
losses 2e-4 relative (the JAX dry run's bound).
"""

import cv2
import jax
import numpy as np
import pytest
import torch

from playaid_core_torch.convert import monolithic_state_dict
from playaid_core_torch.infer.pipeline import BatchedActionPipeline
from playaid_core_torch.infer.vod_pipeline import VodAnalyzer
from playaid_core_torch.models.resnet import BatchNorm2d
from playaid_core_torch.models.resnet_transformer import TransformerEncoderLayer
from playaid_core_torch.models.rnn_action_detector import StackedLSTM
from playaid_core_torch.parallel import dryrun
from playaid_core_torch.parallel.mesh import (
    REPLICATED,
    Mesh,
    Spec,
    batch_sharding,
    make_mesh,
    param_specs,
    replicated,
    shard_params,
    shard_slice,
    unshard,
)
from playaid_core_torch.train.train import build_model
from playaid_core_tpu.parallel import mesh as jax_mesh
from playaid_core_tpu.train import train as jax_train

torch.set_num_threads(2)

SPAWN_TIMEOUT_S = 240
REL_TOL = 2e-4


def _grid(shape, rank=None):
    devices = np.empty(int(np.prod(shape)), dtype=object)
    devices[:] = [torch.device("cpu")] * devices.size
    return Mesh(devices.reshape(shape), rank=rank)


# ---- shapes and asserts (the JAX package's tests/test_parallel.py:16-52) ----


def test_make_mesh_shapes():
    mesh = make_mesh(devices=["cpu"] * 8)
    assert mesh.shape == (8, 1) and mesh.axis_names == ("data", "model")
    assert not mesh.distributed and mesh.device == torch.device("cpu")
    assert make_mesh(devices=["cpu"] * 8, model_parallel=2).shape == (4, 2)
    assert make_mesh(devices=["cpu"] * 8, data_parallel=2, model_parallel=4).shape == (2, 4)
    assert make_mesh(device="cpu").shape == (1, 1)
    with pytest.raises(ValueError, match="do not split"):
        make_mesh(devices=["cpu"] * 6, model_parallel=4)
    with pytest.raises(ValueError, match="!="):
        make_mesh(devices=["cpu"] * 8, data_parallel=3, model_parallel=2)


def test_make_mesh_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()


def test_batch_sharding_gives_each_rank_its_rows():
    batch = np.arange(16 * 3).reshape(16, 3)
    rows = [batch_sharding(_grid((4, 2), rank))(batch) for rank in range(8)]
    for rank, part in enumerate(rows):
        i = rank // 2  # the data index: ranks of one row share their rows
        np.testing.assert_array_equal(part, batch[4 * i:4 * i + 4])
    assert replicated(_grid((4, 2), 3))(batch) is batch
    with pytest.raises(ValueError, match="does not split"):
        batch_sharding(_grid((4, 1), 0))(batch[:6])


def test_param_specs_rules():
    """The JAX test's tree on the port's names: the FFN's up-projection
    shards, the stem stays whole, 63 classes fall back to replication."""
    mesh = _grid((4, 2))
    params = {"layers.0.linear1.weight": torch.zeros(2048, 256),
              "layers.0.linear1.bias": torch.zeros(2048),
              "conv1.weight": torch.zeros(64, 3, 7, 7),
              "classifier.weight": torch.zeros(63, 256), "classifier.bias": torch.zeros(63)}
    specs = param_specs(params, mesh)
    assert specs["layers.0.linear1.weight"] == Spec(("model", None))
    assert specs["layers.0.linear1.bias"] == Spec(("model",))
    assert specs["conv1.weight"] == REPLICATED
    assert specs["classifier.weight"] == specs["classifier.bias"] == REPLICATED
    # Without a mesh (an axis of 1) every rule applies.
    assert param_specs(params)["classifier.weight"] == Spec(("model", None))


def test_shard_params_and_unshard_round_trip():
    """Each rank's slices, the packed q/k/v rows per head group, and the
    whole tensors back from the slices."""
    e = 8
    w = torch.arange(3 * e * e, dtype=torch.float32).reshape(3 * e, e)
    params = {"self_attn.in_proj_weight": w, "linear2.weight": torch.arange(12.0).reshape(2, 6)}
    specs = param_specs(params, _grid((1, 2)))
    shards = [shard_params(_grid((1, 2), rank), params) for rank in range(2)]
    q, k, v = w.chunk(3)
    assert torch.equal(shards[1]["self_attn.in_proj_weight"],
                       torch.cat([q[e // 2:], k[e // 2:], v[e // 2:]]))
    assert torch.equal(shards[0]["linear2.weight"], params["linear2.weight"][:, :3])
    for name in params:
        assert torch.equal(unshard([s[name] for s in shards], specs[name]), params[name])
    assert shard_slice(w, REPLICATED, 1, 2) is w


# ---- the rules against the JAX package's, leaf for leaf ----


def _jax_spec_tree(family, num_actions):
    """The JAX model's parameter shapes (no weights drawn) and its
    ``param_specs`` on a (4, 2) mesh of the 8 virtual CPU devices."""
    model, _ = jax_train.build_model(family, num_actions, 3)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jax.numpy.zeros((1, 3, 32, 32, 3)))
    mesh = jax_mesh.make_mesh(model_parallel=2)
    return shapes, jax_mesh.param_specs(shapes["params"], mesh)


def _sources(family, shapes):
    """For each of the port's parameter names, the '/'-joined JAX paths whose
    values it holds: every JAX leaf filled with its own id, carried across
    by ``convert.monolithic_state_dict``."""
    ids, paths = {}, []

    def fill(path, leaf):
        paths.append("/".join(str(p.key) for p in path))
        return np.full(leaf.shape, float(len(paths)), np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes["params"])
    stats = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, np.float32),
                                   shapes.get("batch_stats", {}))
    for name, value in monolithic_state_dict(family, {"params": params,
                                                      "batch_stats": stats}).items():
        found = {int(i) for i in np.unique(value.numpy()) if i > 0}
        ids[name] = [paths[i - 1] for i in sorted(found)]
    return ids


def _expected(jax_specs, port_name, value):
    """The port's spec of a tensor, from the JAX specs of its sources."""
    specs = [jax_specs[p] for p in value]
    if not any("model" in s for s in specs):
        return REPLICATED
    if port_name.endswith("in_proj_weight"):  # [E, heads, head_dim] x 3 -> rows per head
        return Spec(("model", None), blocks=3)
    if port_name.endswith("in_proj_bias"):
        return Spec(("model",), blocks=3)
    if port_name.endswith("out_proj.weight"):  # [heads, head_dim, E] -> columns
        return Spec((None, "model"))
    if ".lstm.weight_" in port_name:  # four gates' [in, hidden] -> rows of each gate block
        return Spec(("model", None), blocks=4)
    (spec,) = specs
    return Spec(tuple(reversed(tuple(spec))))  # Dense [in, out] -> Linear [out, in]


@pytest.mark.parametrize("family,num_actions", [("resformer", 63), ("cnn", 64), ("rnn", 63)])
def test_param_specs_match_jax(family, num_actions):
    """Every parameter of the port's detector is sharded exactly where the
    JAX rules shard its source leaves (through convert.py's mapping)."""
    shapes, jax_specs = _jax_spec_tree(family, num_actions)
    flat = {"/".join(str(p.key) for p in path): spec for path, spec in
            jax.tree_util.tree_flatten_with_path(
                jax_specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    model, _ = build_model(family, num_actions, 3)
    port = param_specs(dict(model.named_parameters()), _grid((4, 2)))
    sources = _sources(family, shapes)
    lstm = set()
    for name, spec in port.items():
        if name.endswith(("bias_ih_l0", "bias_ih_l1", "bias_ih_l2")):
            assert not sources[name] and spec == REPLICATED  # zeros: Flax has no such bias
            continue
        expected = _expected(flat, name, sources[name])
        if ".lstm.weight_" in name:
            lstm.add(name)
        assert spec == expected, (name, spec, expected, sources[name])
    assert bool(lstm) == (family == "rnn")
    if family == "resformer":
        assert not port["head.classifier.weight"].sharded  # 63 classes stay whole
        assert sum(s.sharded for s in port.values()) == 3 * 6
    if family == "cnn":
        assert port["head.classifier.weight"].sharded  # 64 do split
        assert port["head.temporal_dense.weight"].sharded


# ---- the RNN's LSTM on model ----


def test_stepped_lstm_at_model_1_equals_nn_lstm_in_float64():
    """The hand-stepped stack that runs on a mesh splitting ``model``, at
    model 1 (no mesh): outputs, the input's gradient and every parameter's
    gradient equal ``nn.LSTM``'s within 1e-12 of each tensor's max (float64;
    the same products, summed in another order)."""
    gen = torch.Generator().manual_seed(0)
    lstm = StackedLSTM(12, 16, 3).double()
    with torch.no_grad():
        for p in lstm.parameters():
            p.copy_(torch.randn(p.shape, generator=gen, dtype=torch.float64) * 0.4)
    x = torch.randn((3, 7, 12), generator=gen, dtype=torch.float64)
    grad = torch.randn((3, 7, 16), generator=gen, dtype=torch.float64)
    results = []
    for run in (lstm, lstm.stepped):
        lstm.zero_grad()
        xt = x.clone().requires_grad_(True)
        y = run(xt)
        y.backward(grad)
        results.append({"y": y.detach(), "x": xt.grad,
                        **{k: p.grad.clone() for k, p in lstm.named_parameters()}})
    assert not lstm.sharded
    for key, ref in results[0].items():
        err = float((results[1][key] - ref).abs().max())
        assert err <= 1e-12 * float(ref.abs().max()), (key, err)


def test_lstm_rows_split_only_where_the_hidden_size_divides():
    """The rule gives each rank its rows of every gate block where 4 x the
    model axis divides the rows (JAX's fallback otherwise: replicated, and
    the stack runs whole); the stepped stack refuses a size that does not
    divide its hidden width."""
    lstm = StackedLSTM(6, 6, 1)
    params = dict(lstm.named_parameters())
    assert param_specs(params, _grid((1, 2)))["weight_hh_l0"] == REPLICATED  # no "lstm." prefix
    named = {f"lstm.{k}": v for k, v in params.items()}
    assert param_specs(named, _grid((1, 2)))["lstm.weight_ih_l0"] == Spec(("model", None), 4)
    assert param_specs(named, _grid((1, 4)))["lstm.weight_ih_l0"] == REPLICATED
    assert param_specs(named, _grid((1, 2)))["lstm.bias_hh_l0"] == REPLICATED
    lstm.mesh = _grid((1, 4), rank=0)
    with pytest.raises(ValueError, match="does not split"):
        lstm.stepped(torch.zeros(1, 2, 6))


# ---- the collectives inside the model, at gloo world size 2 ----


def test_tensor_parallel_layer_matches_the_whole_layer():
    """The transformer layer on a (1, 2) mesh (whole heads and half the
    feed-forward a rank; dropout on, masks of the whole width) against the
    unsharded layer: output, input gradient and every parameter gradient."""
    torch.manual_seed(0)
    layer = TransformerEncoderLayer(32, 4, dim_feedforward=64)
    for p in layer.parameters():
        torch.nn.init.normal_(p, 0.0, 0.2)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 32)).astype(np.float32)
    grad = rng.normal(size=(3, 5, 32)).astype(np.float32)
    state = {k: v.detach().clone() for k, v in layer.state_dict().items()}
    results = {}
    for train in (False, True):
        case = {"module": "transformer_layer", "d_model": 32, "num_heads": 4,
                "dim_feedforward": 64, "state": state, "x": x, "grad": grad, "train": train,
                "seed": 7, "model_parallel": 2}
        out = dryrun.spawn_ranks(dryrun.run_module_case, 2, (case,),
                                 timeout_s=SPAWN_TIMEOUT_S)
        ref_layer = TransformerEncoderLayer(32, 4, dim_feedforward=64)
        ref_layer.load_state_dict(state)
        ref_layer.train(train).generator = torch.Generator().manual_seed(7)
        xt = torch.from_numpy(x).requires_grad_(True)
        y = ref_layer(xt)
        y.backward(torch.from_numpy(grad))
        results[train] = out
        for rank in range(2):
            got = out[rank]
            scale = float(y.detach().abs().max())
            assert np.abs(got["y"] - y.detach().numpy()).max() <= 1e-5 * scale
            assert np.abs(got["x_grad"] - xt.grad.numpy()).max() <= 1e-5 * float(
                xt.grad.abs().max())
            for name, p in ref_layer.named_parameters():
                ref = p.grad.numpy()
                assert got["param_grads"][name].shape == ref.shape, name
                err = np.abs(got["param_grads"][name] - ref).max()
                assert err <= 1e-5 * np.abs(ref).max(), name
    # Dropout changed the result: the masks were drawn, and drawn alike.
    assert np.abs(results[True][0]["y"] - results[False][0]["y"]).max() > 1e-3


def test_batch_norm_over_the_data_axis_matches_the_whole_batch():
    """BatchNorm2d on a (2, 1) mesh, each rank with half the batch, in
    float64: output, running statistics and input gradient within 1e-10 of
    one process on the whole batch.  The halves' statistics differ, so a
    local batch norm would be far off."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 6, 5, 3))
    x[:2] = x[:2] * 2.0 + 3.0
    grad = rng.normal(size=x.shape)
    bn = BatchNorm2d(6)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.normal(size=6)))
        bn.bias.copy_(torch.from_numpy(rng.normal(size=6)))
    state = {k: v.clone() for k, v in bn.state_dict().items()}
    case = {"module": "batch_norm", "channels": 6, "state": state, "x": x, "grad": grad,
            "double": True}
    out = dryrun.spawn_ranks(dryrun.run_module_case, 2, (case,), timeout_s=SPAWN_TIMEOUT_S)

    ref = BatchNorm2d(6).double()
    ref.load_state_dict(state)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = ref.train()(xt)
    y.backward(torch.from_numpy(grad))
    y = y.detach().numpy()
    np.testing.assert_allclose(np.concatenate([o["y"] for o in out]), y, rtol=0, atol=1e-10)
    np.testing.assert_allclose(np.concatenate([o["x_grad"] for o in out]), xt.grad.numpy(),
                               rtol=0, atol=1e-10)
    for rank in range(2):
        for name in ("running_mean", "running_var"):
            np.testing.assert_allclose(out[rank]["buffers"][name],
                                       getattr(ref, name).numpy(), rtol=0, atol=1e-10)
        for name, p in ref.named_parameters():
            np.testing.assert_allclose(out[rank]["param_grads"][name], p.grad.numpy(),
                                       rtol=0, atol=1e-10)
    # What local statistics would give: far from the whole batch's.
    local = BatchNorm2d(6).double()
    local.load_state_dict(state)
    local_y = np.concatenate([local.train()(torch.from_numpy(x[i:i + 2])).detach().numpy()
                              for i in (0, 2)])
    assert np.abs(local_y - y).max() > 1e-2


# ---- VodAnalyzer(mesh=) (the JAX package's tests/test_sharded_inference.py:32) ----


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sharded") / "v.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (320, 180))
    rng = np.random.default_rng(0)
    for _ in range(32):
        writer.write(rng.integers(0, 255, (180, 320, 3), dtype=np.uint8))
    writer.release()
    return path


@pytest.mark.parametrize("backend", ["cv2", "native"])
def test_sharded_vod_matches_single_device(video, backend):
    """Four replicas of the embed on a single-process (4, 1) mesh of CPU
    positions, each chunk's 16 rows split over them: labels identical to
    mesh=None, confidences within 1e-4."""
    boxes = np.tile(np.array([[0.3, 0.5, 0.2, 0.2], [0.7, 0.5, 0.2, 0.2]], np.float32),
                    (32, 1, 1))
    pipe = BatchedActionPipeline(family="cnn", num_actions=6, sequence_length=3, frame_delta=1,
                                 crop_size=32, device="cpu").init(0)
    kw = {"chunk": 8, "decode_backend": backend}
    single = VodAnalyzer(pipe, **kw).analyze(video, boxes)
    mesh = make_mesh(devices=["cpu"] * 4)
    analyzer = VodAnalyzer(pipe, mesh=mesh, **kw)
    embeds = [p.embed for p, _ in analyzer._replicas]
    assert len(embeds) == 4 and embeds[0] is pipe.embed
    assert len({id(e) for e in embeds}) == 4  # a replica per position, weights copied once
    sharded = analyzer.analyze(video, boxes)
    np.testing.assert_array_equal(single["labels"], sharded["labels"])
    np.testing.assert_allclose(single["confidences"], sharded["confidences"], rtol=1e-4,
                               atol=1e-4)
    assert sharded["frames"] == 32


def test_vod_mesh_must_start_on_the_pipelines_device():
    pipe = BatchedActionPipeline(family="cnn", num_actions=6, sequence_length=3,
                                 crop_size=32, device="cpu").init(0)
    with pytest.raises(ValueError, match="first device"):
        VodAnalyzer(pipe, mesh=Mesh(np.array([[torch.device("meta")]], dtype=object)))
    with pytest.raises(ValueError, match="one process"):
        VodAnalyzer(pipe, mesh=_grid((2, 1), rank=0))


# ---- the checkpoint across meshes ----


def test_checkpoint_from_a_2x2_mesh_continues_on_others(tmp_path):
    """A ResFormer trained a step on (2, 2) (dropout on), saved, and trained
    two more steps there; the same two steps from the file on (1, 2), (2, 1)
    and (1, 1): the continuation losses within 2e-4 relative, and the file
    is one that BatchedActionPipeline.load_checkpoint reads."""
    rng = np.random.default_rng(0)
    case = {"family": "resformer", "num_actions": 6, "sequence_length": 3, "crop_size": 32,
            "device": "cpu", "seed": 0, "lr": 1e-3,
            "frames": rng.integers(0, 256, (4, 3, 32, 32, 3), dtype=np.uint8),
            "labels": rng.integers(0, 6, (4, 3))}
    saved = dryrun.spawn_ranks(dryrun.run_train_case, 4,
                               (dict(case, model_parallel=2, steps=3, save=str(tmp_path),
                                     save_at=1),),
                               timeout_s=SPAWN_TIMEOUT_S)[0]
    path, ref = saved["checkpoint"], saved["losses"][1:]
    resume = dict(case, restore=path, steps=2)
    outs = dryrun.spawn_ranks(dryrun.run_train_cases, 2,
                              ([dict(resume, model_parallel=2), dict(resume)],),
                              timeout_s=SPAWN_TIMEOUT_S)[0]
    outs.append(dryrun.run_train_case(resume))
    assert [tuple(o["mesh"]) for o in outs] == [(1, 2), (2, 1), (1, 1)]
    assert ref[1] != ref[0]
    for out in outs:
        rel = max(abs(a - b) / abs(b) for a, b in zip(out["losses"], ref))
        assert rel < REL_TOL, (out["mesh"], out["losses"], ref)
    pipe = BatchedActionPipeline("resformer", 6, 3, crop_size=32, device="cpu")
    pipe.load_checkpoint(path)
    assert pipe.head.layers[0].linear1.weight.shape == (2048, 256)  # whole, not a shard


# ---- the Trainer's rows ----


def test_trainer_takes_its_rows_of_device_batches_and_refuses_one_process_meshes():
    """Rank 1 of a (2, 1) mesh takes the second half of each device batch
    (frames, fighter ids, labels) with no collective; a batch that does not
    split over data is replicated; a mesh of several positions in one
    process is refused (one rank per position)."""
    from playaid_core_torch.train.train import Trainer, TrainerConfig

    frames = torch.arange(4 * 3 * 2 * 2 * 3, dtype=torch.uint8).reshape(4, 3, 2, 2, 3)
    chars, labels = np.arange(4, dtype=np.int32), np.arange(12, dtype=np.int32).reshape(4, 3)

    class DeviceSynth:
        device = torch.device("cpu")
        device_batches = staticmethod(lambda batch_size, steps: iter([(frames, chars, labels)]))

    def config(batch_size):
        return TrainerConfig(family="cnn", num_actions=4, sequence_length=3,
                             batch_size=batch_size, crop_size=2, device="cpu")

    trainer = Trainer(config(4), DeviceSynth(), mesh=_grid((2, 1), rank=1))
    (got, got_chars, got_labels), = trainer._epoch_batches(1)
    assert torch.equal(got, frames[2:]) and np.array_equal(got_chars, chars[2:])
    assert torch.equal(got_labels, torch.from_numpy(labels[2:]))
    replicated_trainer = Trainer(config(3), DeviceSynth(), mesh=_grid((2, 1), rank=1))
    assert not replicated_trainer.split_batch
    (got, _, _), = replicated_trainer._epoch_batches(1)
    assert got is frames
    with pytest.raises(ValueError, match="one rank per mesh position"):
        Trainer(config(4), DeviceSynth(), mesh=make_mesh(devices=["cpu"] * 2))


# ---- the train command line in a process group ----


def test_train_cli_ranks_share_a_seed_that_changes_from_run_to_run():
    """``train.main`` in a process group seeds every rank's datasets with
    one seed that rank 0 draws afresh: the ranks agree, two runs differ."""
    from playaid_core_torch.train.train import _shared_seed

    first = dryrun.spawn_ranks(_shared_seed, 2, timeout_s=SPAWN_TIMEOUT_S)
    second = dryrun.spawn_ranks(_shared_seed, 2, timeout_s=SPAWN_TIMEOUT_S)
    assert first[0] == first[1] and second[0] == second[1]
    assert first[0] != second[0]
