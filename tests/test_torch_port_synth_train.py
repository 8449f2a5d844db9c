"""The port's Trainer on device-side synthesis, and the port's bench-weights
tool, against the JAX package's, on the CPU.

Trainer.fit takes a dataset's device_batches straight into the train step:
no producer thread, no staging, only the labels copied.  Over 2 steps of
the CNN family at difficulty 0 (the composite then does not depend on the
noise draws), from the JAX Trainer's initial weights carried across by
convert.monolithic_state_dict, the port's losses match the JAX Trainer's
within 1e-4 relative (the frames differ by at most 1 in at most 0.1% of
values, test_torch_port_synth.py) and its JSONL record has the JAX
record's keys.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from playaid_core_tpu.train import device_synth as jax_ds
from playaid_core_tpu.train import train as jax_train
from playaid_core_torch.convert import monolithic_state_dict
from playaid_core_torch.infer.pipeline import BatchedActionPipeline
from playaid_core_torch.train import device_synth as ds
from playaid_core_torch.train import train as port_train
from playaid_core_torch.train.train import Trainer, TrainerConfig
from tests.test_torch_port_synth import FIGHTERS, MOVES, _npy_twin, _write_assets

LOSS_REL_TOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return _write_assets(str(tmp_path_factory.mktemp("synth_train_assets")))


def smoke_args(clean, stages):
    """tests/test_device_synth.py's Trainer smoke: CNN, T 3, 32-px crops."""
    return dict(anim_subset=MOVES + ["Unknown"], characters=FIGHTERS, clean_char_dir=clean,
                stages_dir=stages, num_samples=8, num_frames_per_sample=3, synth_difficulty=0,
                seed=0, crop_size=32, stage_patch=96)


def smoke_config(**kw):
    return dict(family="cnn", num_actions=len(MOVES) + 1, sequence_length=3, batch_size=4,
                learning_rate=1e-3, num_epochs=1, num_samples=8, crop_size=32, warmup_steps=0,
                **kw)


def record_losses(trainer, index):
    """Wrap trainer.train_step to keep each step's loss (item ``index`` of
    what the step returns)."""
    losses, step = [], trainer.train_step

    def run(*args):
        out = step(*args)
        losses.append(float(out[index]))
        return out

    trainer.train_step = run
    return losses


def test_trainer_smoke_with_device_batches(assets):
    ds_port = ds.DeviceSynthDataset(device="cpu", **smoke_args(*assets))
    trainer = Trainer(TrainerConfig(device="cpu", **smoke_config()), ds_port)
    trainer.init_state()
    trainer.fit(num_epochs=1, steps_per_epoch=2)
    assert len(trainer.metrics_log) == 1
    rec = trainer.metrics_log[0]
    assert rec["steps_per_sec"] > 0
    assert np.isfinite(rec["train_loss"])


def test_fit_on_device_batches_matches_jax(assets, tmp_path, monkeypatch):
    """Two steps from the same weights: the losses within LOSS_REL_TOL, the
    JSONL record with the JAX record's keys, and no staging on the way."""
    jax_trainer = jax_train.Trainer(
        jax_train.TrainerConfig(dtype=jnp.float32, **smoke_config()),
        jax_ds.DeviceSynthDataset(**smoke_args(*assets)))
    jax_trainer.init_state()
    init = {"params": jax.device_get(jax_trainer.state.params),
            "batch_stats": jax.device_get(jax_trainer.state.batch_stats)}
    jax_losses = record_losses(jax_trainer, 1)
    jax_trainer.fit(num_epochs=1, steps_per_epoch=2)

    def refuse(*args, **kw):
        raise AssertionError("a device_batches dataset went through the host staging")

    monkeypatch.setattr(port_train, "BackgroundIterator", refuse)
    monkeypatch.setattr(port_train, "device_prefetch", refuse)
    log_path = tmp_path / "metrics.jsonl"
    trainer = Trainer(TrainerConfig(device="cpu", log_path=str(log_path), **smoke_config()),
                      ds.DeviceSynthDataset(device="cpu", **smoke_args(*assets)))
    trainer.init_state()
    trainer.model.load_state_dict(monolithic_state_dict(
        "cnn", jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), init)))
    losses = record_losses(trainer, 0)
    trainer.fit(num_epochs=1, steps_per_epoch=2)

    assert len(losses) == len(jax_losses) == 2
    np.testing.assert_allclose(losses, jax_losses, rtol=LOSS_REL_TOL, atol=0)
    with open(log_path) as f:
        record = json.loads(f.readline())
    assert set(record) == set(jax_trainer.metrics_log[0])
    assert record["synth_difficulty"] == 0 and trainer.state.step == 2


def _tool():
    spec = importlib.util.spec_from_file_location(
        "torch_port_train_bench_weights",
        os.path.join(ROOT, "tools", "torch_port_train_bench_weights.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_bench_weights_tool_round_trip(assets, tmp_path, monkeypatch):
    """The tool on an existing .npy tree (as on the card's machine, without
    cv2): the JAX tool's dataset and trainer arguments, then float16 weights
    that BatchedActionPipeline.load_checkpoint reads back."""
    tool = _tool()
    clean = _npy_twin(assets[0], str(tmp_path / "clean"), -1)
    stages = _npy_twin(assets[1], str(tmp_path / "stages"), 1)
    seen = {}
    save = tool.save_weights

    def keep(trainer, path):
        seen["trainer"] = trainer
        return save(trainer, path)

    monkeypatch.setattr(tool, "save_weights", keep)
    out = str(tmp_path / "w.pt")
    assert tool.main([str(tmp_path / "work"), "--clean", clean, "--stages", stages,
                      "--epochs", "1", "--steps", "2", "--batch", "1", "--warmup", "0",
                      "--out", out, "--device", "cpu"]) == 0
    trainer = seen["trainer"]
    data, cfg = trainer.train_dataset, trainer.config
    assert (data.num_frames_per_sample, data.synth_sprite_fill, data.synth_center_jitter,
            data.synth_frame_degrade, data.synth_window, data.synth_cycle_repeats,
            data.crop_size, data.stages.patch) == (7, (0.70, 0.98), 10, 0.5, "middleout",
                                                    (1, 2), 128, 192)
    assert (cfg.family, cfg.num_actions, cfg.batch_size, cfg.learning_rate,
            cfg.curriculum_threshold, cfg.lr_decay_steps) == ("cnn", 63, 1, 3e-4, 0.88, 2)
    saved = torch.load(out, weights_only=True)
    assert all(v.dtype == torch.float16 for part in saved.values() for v in part.values()
               if v.is_floating_point())
    pipe = BatchedActionPipeline("cnn", 63, 7, device="cpu").load_checkpoint(out)
    for part in ("embed", "head"):
        trained = getattr(trainer.model, part).state_dict()
        for k, v in getattr(pipe, part).state_dict().items():
            assert torch.equal(v, trained[k].half().float()), (part, k)
    with pytest.raises(SystemExit):
        tool.main([str(tmp_path / "work"), "--clean", clean])
