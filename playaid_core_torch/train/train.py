"""Training of the action-recognition families on one CUDA device.

Counterpart of ``playaid_core_tpu/train/train.py`` (reference: the train
CLI and Lightning wrappers, action_detector.py:16-81,
models/*_detector.py training steps), as an explicit PyTorch loop:

* :func:`build_model`: the CNN, RNN or ResFormer detector and its loss;
* :func:`create_train_state`: Adam (fused) with optax's schedules of the
  JAX trainer (constant; linear warmup from 5%; warmup then cosine decay
  to 10%), through a ``LambdaLR`` stepped after each update, so update n
  (from 0) runs at the schedule's value at count n, as optax's does;
* :func:`make_train_step` / :func:`make_eval_step`: a uint8 batch is
  normalised on the device inside the step; the step returns the loss,
  the accuracy, and the global gradient and parameter L2 norms, as device
  tensors (no host synchronisation);
* :class:`Trainer`: on a ``(data, model)`` mesh (``parallel/mesh.py``; one
  device by default): the parameters placed by the tensor-parallel rules
  (Adam's moments follow their shards), each rank's rows of every batch
  (a batch that does not divide over ``data`` is replicated), batch norm
  over the whole batch, gradients averaged over ``data``, norms that count
  each shard once, dropout masks drawn at the whole batch's shape; batches
  assembled in a background thread, shipped as
  uint8 through pinned slots and a copy stream two steps ahead
  (``parallel/staging.py``), or, from a dataset with ``device_batches``
  (``train/device_synth.py``), made on the device and taken straight into
  the step with only their labels copied; per-step metrics kept on the
  device until the epoch ends, the JAX trainer's JSONL record, its
  curriculum (train accuracy above the threshold raises the augmentation
  difficulty) and T resampling for the RNN, validation, and checkpoints: ``step_<epoch>.pt``
  holds ``{"embed", "head"}`` state dicts, which
  ``BatchedActionPipeline.load_checkpoint`` reads, and
  ``step_<epoch>.trainer.pt`` beside it the optimizer, schedule and
  dropout generator for :meth:`Trainer.restore_checkpoint` (whole tensors,
  gathered over ``model``: a checkpoint restores onto any mesh);
* :func:`main`: the ``train`` command line (argparse),
  ``python -m playaid_core_torch.train.train``; ``--model_parallel M``
  needs a process group (under ``torchrun``, ``main`` starts one with
  ``--backend``).

Every entry point runs on the CUDA device unless given ``device="cpu"``
(``--device cpu``), in float32 with TF32 off (``device.full_float32()``)
around forward and backward alike.  Weights are drawn from a
``torch.Generator`` (``init_state(seed)``), and so are the ResFormer's
dropout masks (a generator on the device, seeded ``seed + 1``).  The
command line's ``--bf16`` is not ported and raises.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.autograd.graph import increment_version

from playaid_core_torch import constants
from playaid_core_torch.device import full_float32, resolve_device
from playaid_core_torch.infer.pipeline import BatchedActionPipeline
from playaid_core_torch.models.cnn_action_detector import CNNActionDetector
from playaid_core_torch.models.losses import accuracy, center_frame_loss, per_frame_loss
from playaid_core_torch.models.resnet_transformer import ResnetTransformerDetector
from playaid_core_torch.models.rnn_action_detector import RNNActionDetector
from playaid_core_torch.ontology import MOVE_TO_CLASS_ID
from playaid_core_torch.parallel.mesh import (
    REPLICATED,
    attach_mesh,
    batch_sharding,
    gather_params,
    make_mesh,
    replicated,
    shard_slice,
)
from playaid_core_torch.parallel.staging import BackgroundIterator, device_prefetch
from playaid_core_torch.train.dataset import UltActionRecogDataset
from playaid_core_torch.train.schedules import make_schedule

MODEL_FAMILIES = {
    "cnn": (CNNActionDetector, center_frame_loss),
    "rnn": (RNNActionDetector, per_frame_loss),
    "resformer": (ResnetTransformerDetector, per_frame_loss),
}

NOT_BF16 = ("the port trains in float32 only: bfloat16 comes in with the label-agreement "
            "check of the ROADMAP's north star")


def build_model(family: str, num_actions: int, sequence_length: int):
    """The family's detector (weights not yet drawn) and its loss."""
    cls, loss_fn = MODEL_FAMILIES[family]
    if family == "rnn":
        return cls(num_actions), loss_fn
    return cls(num_actions, sequence_length), loss_fn


@dataclass
class TrainState:
    """The model, its optimizer and schedule, and the parameters they train
    (those with ``requires_grad``) with their names; on a mesh, the mesh
    and which parameters are this rank's shards."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    params: list
    names: list
    mesh: Optional[object] = None
    sharded: Optional[list] = None

    @property
    def step(self):
        """Updates taken so far."""
        return self.scheduler.last_epoch


def bump_versions_after_step(optimizer):
    """``optimizer``, with a hook that bumps the version counter of each
    parameter it holds after every step, and returned.

    A fused step writes the parameters without bumping their versions (the
    foreach and for-loop steps bump them), so caches keyed on versions, such
    as the fused residual block's weight pack (``BasicBlock.block_pack``),
    would keep packs of the old weights."""
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def bump_versions(opt, args, kwargs):
        for p in params:
            increment_version(p)

    optimizer.register_step_post_hook(bump_versions)
    return optimizer


def create_train_state(model, learning_rate, warmup_steps=200, decay_steps=None, mesh=None,
                       specs=None):
    """Adam (beta 0.9/0.999, eps 1e-8 outside the square root, as optax's)
    over ``model``'s trainable parameters, on their device, with the JAX
    trainer's schedule (:func:`make_schedule`).  On a ``mesh``, ``specs``
    (``attach_mesh``'s) say which parameters are shards."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    names, params = [n for n, _ in named], [p for _, p in named]
    optimizer = bump_versions_after_step(torch.optim.Adam(
        params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, fused=True))
    schedule = make_schedule(learning_rate, warmup_steps, decay_steps)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda count: schedule(count) / learning_rate)
    sharded = [bool(specs and specs[n].sharded and mesh.axis_size("model") > 1) for n in names]
    return TrainState(model, optimizer, scheduler, params, names, mesh, sharded)


def global_norm(tensors, sharded=None, mesh=None):
    """L2 norm of all the tensors' entries together (``optax.global_norm``).
    On a mesh, the tensors flagged ``sharded`` are this rank's shards: their
    squares are summed over ``model`` once, and whole tensors count once."""
    sharded = sharded or [False] * len(tensors)
    parts = []
    for shard in (True, False):
        norms = [torch.linalg.vector_norm(t) for t, s in zip(tensors, sharded) if s == shard]
        parts.append(torch.stack(norms).square().sum() if norms else tensors[0].new_zeros(()))
    parts = torch.stack(parts)
    if mesh is not None:
        mesh.all_reduce_(parts[:1], "model")
    return parts.sum().sqrt()


def _normalise(frames):
    """A uint8 batch (the wire format) -> float32 / 255, on its device."""
    if frames.dtype == torch.uint8:
        return frames.float() / 255.0
    return frames


def _match_labels(log_probs, labels):
    """CNN-family outputs are ``[B, C]``, supervised on the centre frame."""
    if log_probs.dim() == 2 and log_probs.shape[0] == labels.shape[0]:
        return labels[:, labels.shape[1] // 2]
    return labels


def make_train_step(model, loss_fn):
    """``train_step(state, frames, labels) -> (loss, acc, grad_norm,
    param_norm)``: one update of ``state`` in place, in training mode.
    ``frames`` ``[B, T, H, W, 3]`` uint8 or float in [0, 1]; the results
    are 0-d tensors on the device.  On ``state.mesh`` the batch is this
    rank's rows: the gradients are averaged over ``data`` before the
    update, and the loss and accuracy are the whole batch's."""
    def train_step(state, frames, labels):
        if not model.training:
            model.train()
        with full_float32():
            log_probs = model(_normalise(frames))
            loss = loss_fn(log_probs, labels)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        with torch.no_grad():
            held = [(p.grad, s) for p, s in zip(state.params, state.sharded)
                    if p.grad is not None]
            grads = [g for g, _ in held]
            if state.mesh is not None:
                state.mesh.average_gradients(grads)
            grad_norm = global_norm(grads, [s for _, s in held], state.mesh)
        state.optimizer.step()
        state.scheduler.step()
        with torch.no_grad():
            acc = accuracy(log_probs, _match_labels(log_probs, labels))
            param_norm = global_norm(state.params, state.sharded, state.mesh)
            loss = loss.detach()
            if state.mesh is not None:
                loss, acc = state.mesh.mean_over("data", loss, acc)
        return loss, acc, grad_norm, param_norm

    return train_step


def make_eval_step(model, loss_fn):
    """``eval_step(state, frames, labels) -> (loss, acc)`` in eval mode (batch
    norm on its running statistics, no dropout; on CUDA, ResNet-18's
    identity blocks run the fused residual-block kernel).  On ``state.mesh``
    the loss and accuracy are the whole batch's."""
    @torch.no_grad()
    def eval_step(state, frames, labels):
        if model.training:
            model.eval()
        with full_float32():
            log_probs = model(_normalise(frames))
            loss = loss_fn(log_probs, labels)
        acc = accuracy(log_probs, _match_labels(log_probs, labels))
        if state.mesh is not None:
            loss, acc = state.mesh.mean_over("data", loss, acc)
        return loss, acc

    return eval_step


@dataclass
class TrainerConfig:
    family: str = "resformer"
    num_actions: int = 63
    sequence_length: int = 7
    batch_size: int = 8
    learning_rate: float = 3e-4
    num_epochs: int = 1000
    num_samples: int = 1024
    crop_size: int = 128
    model_parallel: int = 1
    curriculum_threshold: float = 0.85
    checkpoint_dir: Optional[str] = None
    log_path: Optional[str] = None
    # Optional TensorBoard event dir (torch's SummaryWriter when importable).
    tensorboard_dir: Optional[str] = None
    # Cosine-decay horizon in steps (None = constant LR after warmup).
    lr_decay_steps: Optional[int] = None
    # Linear LR warmup steps; 0 disables it (tiny budgets would otherwise
    # spend their whole run inside the ramp).
    warmup_steps: int = 200
    # Print one line per epoch.
    verbose: bool = False
    # None = the CUDA device (raises without one); "cpu" runs on the CPU.
    device: Optional[str] = None


def _training_state_path(path):
    """The file beside a checkpoint that holds the optimizer, schedule and
    generator."""
    return os.path.splitext(path)[0] + ".trainer.pt"


def _device_key(device):
    """``device`` with the current CUDA device's index filled in, so that
    ``cuda`` and ``cuda:0`` compare equal; None stays None."""
    if device is None:
        return None
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Trainer:
    """Training loop with staging, curriculum, validation and checkpoints,
    on a mesh.

    ``mesh=None`` means ``make_mesh(model_parallel=config.model_parallel)``
    on this trainer's device: with ``torch.distributed`` initialised, one
    rank per position of the world (every rank builds its trainer in the
    same order, and every rank calls ``fit``, ``evaluate`` and the
    checkpoint methods, which hold collectives); otherwise this device
    alone.  Every rank assembles the same batches (the datasets are seeded
    alike) and copies only its rows to its device."""

    def __init__(self, config: TrainerConfig, train_dataset, val_dataset=None, mesh=None):
        self.config = config
        self.device = resolve_device(config.device)
        self.mesh = mesh if mesh is not None else make_mesh(
            model_parallel=config.model_parallel, device=self.device)
        if self.mesh.size > 1 and not self.mesh.distributed:
            raise ValueError(f"the Trainer runs one rank per mesh position; {self.mesh} lives in "
                             "one process (initialise torch.distributed, e.g. under torchrun)")
        if _device_key(self.mesh.device) != _device_key(self.device):
            raise ValueError(f"the mesh puts this rank on {self.mesh.device} and the trainer on "
                             f"{self.device}")
        # A batch that does not split over data is replicated, as in the JAX trainer.
        self.split_batch = config.batch_size % self.mesh.axis_size("data") == 0
        self._rows = batch_sharding(self.mesh) if self.split_batch else replicated(self.mesh)
        self.specs = None
        if hasattr(train_dataset, "device_batches") and (
                _device_key(getattr(train_dataset, "device", None)) != _device_key(self.device)):
            raise ValueError(
                f"the dataset makes its batches on {getattr(train_dataset, 'device', None)} and "
                f"the trainer runs on {self.device}: build both for one device")
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self.model, self.loss_fn = build_model(config.family, config.num_actions,
                                               config.sequence_length)
        self.train_step = make_train_step(self.model, self.loss_fn)
        self.eval_step = make_eval_step(self.model, self.loss_fn)
        self.state = None
        self.generator = None
        self.metrics_log = []
        self._tb_writer = None
        if config.tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb_writer = SummaryWriter(config.tensorboard_dir)
            except Exception:
                self._tb_writer = None  # the JSONL log remains authoritative

    def init_state(self, seed=0):
        """Draw the weights as Flax initialises them, from a CPU
        ``torch.Generator`` seeded ``seed`` (the same weights on any device
        and rank), move the model to the device, keep this rank's shards
        (``attach_mesh``) and build the optimizer over them.  The dropout
        masks come from a generator on the device seeded ``seed + 1``."""
        self.model.init_weights(torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        self.specs = attach_mesh(self.model, self.mesh, self.split_batch)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        if hasattr(self.model, "set_dropout_generator"):
            self.model.set_dropout_generator(self.generator)
        self.state = create_train_state(
            self.model, self.config.learning_rate,
            warmup_steps=self.config.warmup_steps,
            decay_steps=self.config.lr_decay_steps,
            mesh=self.mesh, specs=self.specs,
        )
        return self.state

    @property
    def is_writer(self):
        """True on the rank that writes logs and checkpoints (rank 0)."""
        return not self.mesh.distributed or self.mesh.rank == 0

    def _log(self, record):
        self.metrics_log.append(record)
        if not self.is_writer:
            return
        if self.config.verbose:
            parts = [f"epoch {record.get('epoch', len(self.metrics_log) - 1)}"]
            for key in ("train_loss", "train_acc", "val_loss", "val_acc"):
                if key in record:
                    parts.append(f"{key} {record[key]:.4f}")
            print("  ".join(parts), flush=True)
        if self.config.log_path:
            os.makedirs(os.path.dirname(self.config.log_path), exist_ok=True)
            with open(self.config.log_path, "a") as f:
                f.write(json.dumps(record) + "\n")
        if self._tb_writer is not None:
            step = record.get("epoch", len(self.metrics_log))
            for key, value in record.items():
                if isinstance(value, (int, float)) and key != "epoch":
                    self._tb_writer.add_scalar(key, value, step)
            self._tb_writer.flush()

    def _epoch_batches(self, steps):
        """An epoch's (frames, chars, labels) with frames and labels on the
        device.  A dataset with ``device_batches`` makes its uint8 frames on
        the device: no producer thread, no staging, only the labels are
        copied.  Otherwise the host assembles uint8 batches in a background
        thread and ``device_prefetch`` copies them two steps ahead."""
        cfg = self.config
        device_gen = getattr(self.train_dataset, "device_batches", None)
        rows = self._rows
        if device_gen is not None:
            for frames, chars, labels in device_gen(cfg.batch_size, steps):
                yield (rows(frames), rows(chars),
                       torch.from_numpy(rows(labels)).to(self.device, non_blocking=True))
            return
        with BackgroundIterator(self.train_dataset.batches(cfg.batch_size, steps),
                                maxsize=4) as batches:
            yield from device_prefetch(batches, 2, self.device, rows)

    def fit(self, num_epochs=None, steps_per_epoch=None, seed=0):
        if self.state is None:
            self.init_state(seed)
        cfg = self.config
        num_epochs = num_epochs if num_epochs is not None else cfg.num_epochs
        steps = steps_per_epoch or max(cfg.num_samples // cfg.batch_size, 1)

        for epoch in range(num_epochs):
            epoch_accs, epoch_losses, epoch_gnorms = [], [], []
            epoch_pnorm = None
            n_steps = 0
            t_frames = 1
            start = time.time()
            # uint8 batches (the wire format): normalised on the device.
            for frames, chars, labels in self._epoch_batches(steps):
                loss, acc, gnorm, pnorm = self.train_step(self.state, frames, labels)
                # Kept on the device until the epoch ends: reading one here
                # would wait for the step and stop the copies and the host's
                # batch assembly from overlapping it.
                epoch_losses.append(loss)
                epoch_accs.append(acc)
                epoch_gnorms.append(gnorm)
                epoch_pnorm = pnorm
                n_steps += 1
                t_frames = frames.shape[1]  # the RNN resamples T per epoch
            epoch_losses = torch.stack(epoch_losses).tolist() if epoch_losses else []
            epoch_accs = torch.stack(epoch_accs).tolist() if epoch_accs else []
            epoch_gnorms = torch.stack(epoch_gnorms).tolist() if epoch_gnorms else []

            epoch_acc = float(np.mean(epoch_accs)) if epoch_accs else 0.0
            elapsed = time.time() - start
            record = {
                "epoch": epoch,
                "train_loss": float(np.mean(epoch_losses)) if epoch_losses else 0.0,
                "train_acc": epoch_acc,
                "grad_norm": float(np.mean(epoch_gnorms)) if epoch_gnorms else 0.0,
                "grad_norm_last": epoch_gnorms[-1] if epoch_gnorms else 0.0,
                "param_norm": float(epoch_pnorm) if epoch_pnorm is not None else 0.0,
                "seconds": elapsed,
                # Throughput: steps/s and crops/s (a crop = one frame of a
                # window pushed through the encoder).
                "steps_per_sec": round(n_steps / elapsed, 3) if elapsed > 0 else 0.0,
                "crops_per_sec": (
                    round(n_steps * cfg.batch_size * t_frames / elapsed, 1)
                    if elapsed > 0 else 0.0
                ),
                "synth_difficulty": self.train_dataset.synth_difficulty,
            }

            # Curriculum (reference: models/cnn_action_detector.py:118-129).
            if epoch_acc > cfg.curriculum_threshold:
                self.train_dataset.make_synth_more_challenging()
            # Only the RNN's graph does not depend on T; the CNN's temporal
            # dense and the ResFormer's time encoding are sized to it.
            if cfg.family == "rnn":
                self.train_dataset.switch_num_frames_per_sample()

            if self.val_dataset is not None:
                val_losses, val_accs = [], []
                for frames, chars, labels in device_prefetch(
                    self.val_dataset.batches(cfg.batch_size, max(steps // 4, 1)), 2, self.device,
                    self._rows,
                ):
                    loss, acc = self.eval_step(self.state, frames, labels)
                    val_losses.append(loss)
                    val_accs.append(acc)
                record["val_loss"] = float(np.mean(torch.stack(val_losses).tolist()))
                record["val_acc"] = float(np.mean(torch.stack(val_accs).tolist()))

            self._log(record)
            if cfg.checkpoint_dir:
                self.save_checkpoint(epoch)
        return self.state

    def evaluate(self, dataset, num_batches=8):
        losses, accs = [], []
        for frames, chars, labels in device_prefetch(
            dataset.batches(self.config.batch_size, num_batches), 2, self.device, self._rows,
        ):
            loss, acc = self.eval_step(self.state, frames, labels)
            losses.append(float(loss))
            accs.append(float(acc))
        return {"loss": float(np.mean(losses)), "acc": float(np.mean(accs))}

    # ---------------- checkpoints ----------------

    def whole_state(self):
        """``{"embed", "head"}`` state dicts of whole tensors on the CPU (on a
        mesh, the shards gathered over ``model``: a collective)."""
        whole = {}
        for part in ("embed", "head"):
            local = {k: v.detach() for k, v in getattr(self.model, part).state_dict().items()}
            specs = {k: self.specs.get(f"{part}.{k}", REPLICATED) for k in local}
            whole[part] = {k: v.cpu() for k, v in gather_params(self.mesh, local, specs).items()}
        return whole

    def load_whole(self, state):
        """Load ``{"embed", "head"}`` state dicts of whole tensors: on a mesh,
        this rank's slices."""
        for part in ("embed", "head"):
            getattr(self.model, part).load_state_dict(
                {k: self._local(f"{part}.{k}", v) for k, v in state[part].items()})

    def _local(self, name, tensor):
        return shard_slice(tensor, self.specs.get(name, REPLICATED), self.mesh.index("model"),
                           self.mesh.axis_size("model"))

    def save_checkpoint(self, step):
        """Write ``step_<step>.pt`` (``{"embed", "head"}`` state dicts of
        whole tensors on the CPU, which ``BatchedActionPipeline.load_checkpoint``
        reads) and ``step_<step>.trainer.pt`` (optimizer with whole moments,
        schedule, generator) into ``checkpoint_dir``; return the first's
        path.  On a mesh the shards are gathered over ``model`` and rank 0
        writes; every rank returns once the files exist."""
        path = os.path.abspath(os.path.join(self.config.checkpoint_dir, f"step_{step}.pt"))
        whole = self.whole_state()
        optimizer = self.state.optimizer.state_dict()
        # state_dict() hands out the optimizer's own per-parameter dicts.
        optimizer["state"] = {i: dict(m) for i, m in optimizer["state"].items()}
        for i, moments in optimizer["state"].items():
            spec = self.specs[self.state.names[i]]
            for key in ("exp_avg", "exp_avg_sq"):
                moments[key] = gather_params(self.mesh, {key: moments[key]},
                                             {key: spec})[key].cpu()
        if self.is_writer:
            os.makedirs(self.config.checkpoint_dir, exist_ok=True)
            torch.save(whole, path)
            torch.save({"optimizer": optimizer,
                        "scheduler": self.state.scheduler.state_dict(),
                        "generator": self.generator.get_state()},
                       _training_state_path(path))
        self.mesh.barrier()
        return path

    def restore_checkpoint(self, path):
        """Load the weights of ``path`` (anything
        ``BatchedActionPipeline.load_checkpoint`` reads: a file of
        :meth:`save_checkpoint` or a reference Lightning ``.ckpt``), and the
        optimizer, schedule and generator from the file beside it when
        there is one; on a mesh, this rank's slices of the whole tensors,
        so a checkpoint written on one mesh restores onto any other."""
        if self.state is None:
            self.init_state()
        cfg = self.config
        pipe = BatchedActionPipeline(cfg.family, cfg.num_actions, cfg.sequence_length,
                                     crop_size=cfg.crop_size, device="cpu").load_checkpoint(path)
        self.load_whole({"embed": pipe.embed.state_dict(), "head": pipe.head.state_dict()})
        side = _training_state_path(path)
        if os.path.exists(side):
            saved = torch.load(side, map_location="cpu", weights_only=True)
            for i, moments in saved["optimizer"]["state"].items():
                for key in ("exp_avg", "exp_avg_sq"):
                    moments[key] = self._local(self.state.names[i], moments[key]).contiguous()
            self.state.optimizer.load_state_dict(saved["optimizer"])
            self.state.scheduler.load_state_dict(saved["scheduler"])
            self.generator.set_state(saved["generator"])
        return self.state


def _parser():
    p = argparse.ArgumentParser(
        prog="python -m playaid_core_torch.train.train",
        description="Train an action-recognition model (reference: action_detector.py:16-81).")
    p.add_argument("--ckpt", default=None, help="initial checkpoint path")
    p.add_argument("--fighters", "-f", action="append", default=[], help="fighter(s) names")
    p.add_argument("--family", default="resformer", choices=list(MODEL_FAMILIES),
                   help="model family")
    p.add_argument("--batch_size", default=8, type=int, help="batch size")
    p.add_argument("--num_epochs", default=1000, type=int, help="num epochs")
    p.add_argument("--name", default=None, help="name of the run")
    p.add_argument("--num_samples", default=1024, type=int,
                   help="simulated number of items in the dataset")
    p.add_argument("--num_frames_per_sample", default=7, type=int,
                   help="number of frames per sample")
    p.add_argument("--frame_delta", action="append", type=int, default=None,
                   help="frame delta (repeatable; default 1 2 3 4 5 6)")
    p.add_argument("--model_parallel", default=1, type=int,
                   help="model-parallel mesh axis size (above 1: one rank per position, "
                        "e.g. under torchrun)")
    p.add_argument("--backend", default="nccl", choices=("nccl", "gloo"),
                   help="process-group backend when main starts the group (under torchrun)")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute (not ported)")
    p.add_argument("--tensorboard", action="store_true",
                   help="also write TensorBoard events next to the JSONL log")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device; 'cpu' for the CPU)")
    return p


def _start_group_from_env(backend, device):
    """Under torchrun (``WORLD_SIZE`` and ``LOCAL_RANK`` in the environment)
    with no process group yet, start one with ``backend``.  Returns whether
    it did, and this rank's device (``cuda:<LOCAL_RANK>`` unless
    ``device`` is given)."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return False, device
    if device is None:
        device = f"cuda:{os.environ['LOCAL_RANK']}"
        torch.cuda.set_device(resolve_device(device))
    dist.init_process_group(backend, timeout=datetime.timedelta(seconds=600))
    return True, device


def main(argv=None):
    """The train command line: ground-truth train/validation splits of every
    move, a trainer with checkpoints under ``SAVED_ACTION_MODELS/<name>``
    and the JSONL log under ``ACTION_RECOG_OUTPUT_DIR/<name>``, then the
    test split's loss and accuracy.  In a process group (started by the
    caller, or here under torchrun) every rank runs it: the mesh spans the
    world (``--model_parallel`` of it on ``model``), the datasets share a
    seed that rank 0 draws afresh (one process draws unseeded), rank 0
    writes and prints."""
    args = _parser().parse_args(argv)
    if args.bf16:
        raise NotImplementedError(NOT_BF16)
    started, device = _start_group_from_env(args.backend, args.device)
    try:
        return _main(args, resolve_device(device))
    finally:
        if started:
            dist.destroy_process_group()


def _shared_seed():
    """A seed that rank 0 draws afresh and every rank receives, so that the
    ranks draw the same batches while runs still differ."""
    box = [int(np.random.SeedSequence().entropy % 2**63)] if dist.get_rank() == 0 else [None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _main(args, device):
    seed = _shared_seed() if dist.is_initialized() else None
    actions = list(MOVE_TO_CLASS_ID.keys())
    char_subset = list(args.fighters)
    name = args.name or f"{args.family}-{'-'.join(char_subset) or 'all'}"
    frame_delta = args.frame_delta or [1, 2, 3, 4, 5, 6]

    dataset_args = dict(
        num_samples=args.num_samples,
        img_dimension=128,
        anim_subset=actions,
        num_frames_per_sample=[args.num_frames_per_sample],
        frame_delta=list(frame_delta),
        char_subset=char_subset,
        # No model family consumes the preceding-action context.
        num_preceding_actions=0,
        seed=seed,
    )
    train_ds = UltActionRecogDataset(split="train", **dataset_args)
    val_args = dict(dataset_args, num_samples=args.num_samples // 4)
    val_ds = UltActionRecogDataset(split="validation", **val_args)

    config = TrainerConfig(
        family=args.family,
        num_actions=len(actions),
        sequence_length=args.num_frames_per_sample,
        batch_size=args.batch_size,
        learning_rate=3e-4,
        num_epochs=args.num_epochs,
        num_samples=args.num_samples,
        model_parallel=args.model_parallel,
        checkpoint_dir=os.path.join(constants.SAVED_ACTION_MODELS, name),
        log_path=os.path.join(constants.ACTION_RECOG_OUTPUT_DIR, name, "metrics.jsonl"),
        tensorboard_dir=(
            os.path.join(constants.ACTION_RECOG_OUTPUT_DIR, name, "tb")
            if args.tensorboard else None
        ),
        device=str(device),
    )
    trainer = Trainer(config, train_ds, val_ds)
    trainer.init_state()
    if args.ckpt:
        trainer.restore_checkpoint(args.ckpt)
    trainer.fit()
    result = trainer.evaluate(UltActionRecogDataset(split="test", **val_args))
    if trainer.is_writer:
        print(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
