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
* :class:`Trainer`: batches assembled in a background thread, shipped as
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
  dropout generator for :meth:`Trainer.restore_checkpoint`;
* :func:`main`: the ``train`` command line (argparse),
  ``python -m playaid_core_torch.train.train``.

Every entry point runs on the CUDA device unless given ``device="cpu"``
(``--device cpu``), in float32 with TF32 off (``device.full_float32()``)
around forward and backward alike.  Weights are drawn from a
``torch.Generator`` (``init_state(seed)``), and so are the ResFormer's
dropout masks (a generator on the device, seeded ``seed + 1``).  The
command line's ``--bf16`` and ``--model_parallel`` above 1 are not ported
and raise.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch.autograd.graph import increment_version

from playaid_core_torch import constants
from playaid_core_torch.device import full_float32, resolve_device
from playaid_core_torch.infer.pipeline import BatchedActionPipeline
from playaid_core_torch.models.cnn_action_detector import CNNActionDetector
from playaid_core_torch.models.losses import accuracy, center_frame_loss, per_frame_loss
from playaid_core_torch.models.resnet_transformer import ResnetTransformerDetector
from playaid_core_torch.models.rnn_action_detector import RNNActionDetector
from playaid_core_torch.ontology import MOVE_TO_CLASS_ID
from playaid_core_torch.parallel.staging import BackgroundIterator, device_prefetch
from playaid_core_torch.train.dataset import UltActionRecogDataset

MODEL_FAMILIES = {
    "cnn": (CNNActionDetector, center_frame_loss),
    "rnn": (RNNActionDetector, per_frame_loss),
    "resformer": (ResnetTransformerDetector, per_frame_loss),
}

NOT_BF16 = ("the port trains in float32 only: bfloat16 comes in with the label-agreement "
            "check of the ROADMAP's north star")
NOT_MODEL_PARALLEL = ("the port trains on one device: a model-parallel mesh is ROADMAP "
                      "queue 1 item 5 (parallel/mesh.py -> torch.distributed)")


def build_model(family: str, num_actions: int, sequence_length: int):
    """The family's detector (weights not yet drawn) and its loss."""
    cls, loss_fn = MODEL_FAMILIES[family]
    if family == "rnn":
        return cls(num_actions), loss_fn
    return cls(num_actions, sequence_length), loss_fn


def _linear_schedule(init_value, end_value, transition_steps):
    """``optax.linear_schedule``."""
    def schedule(count):
        if transition_steps <= 0:
            return init_value
        frac = 1.0 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value
    return schedule


def make_schedule(learning_rate, warmup_steps=200, decay_steps=None):
    """The JAX trainer's learning rate at update count ``count`` (from 0):
    ``optax.warmup_cosine_decay_schedule(0.05 lr, lr, warmup_steps or 1,
    decay_steps, 0.1 lr)`` when ``decay_steps``, else
    ``optax.linear_schedule(0.05 lr, lr, warmup_steps)`` when
    ``warmup_steps``, else ``lr``."""
    init_value = learning_rate * 0.05
    if decay_steps:
        warmup = warmup_steps or 1
        if not decay_steps - warmup > 0:
            raise ValueError(f"decay_steps {decay_steps} must exceed the warmup {warmup}")
        end_value = learning_rate * 0.1
        alpha = 0.0 if learning_rate == 0.0 else end_value / learning_rate
        ramp = _linear_schedule(init_value, learning_rate, warmup)

        def schedule(count):
            if count < warmup:
                return ramp(count)
            t = min(count - warmup, decay_steps - warmup)
            cosine = 0.5 * (1 + math.cos(math.pi * t / (decay_steps - warmup)))
            return learning_rate * ((1 - alpha) * cosine + alpha)
        return schedule
    if warmup_steps:
        return _linear_schedule(init_value, learning_rate, warmup_steps)
    return lambda count: learning_rate


@dataclass
class TrainState:
    """The model, its optimizer and schedule, and the parameters they train
    (those with ``requires_grad``)."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    params: list

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


def create_train_state(model, learning_rate, warmup_steps=200, decay_steps=None):
    """Adam (beta 0.9/0.999, eps 1e-8 outside the square root, as optax's)
    over ``model``'s trainable parameters, on their device, with the JAX
    trainer's schedule (:func:`make_schedule`)."""
    params = [p for p in model.parameters() if p.requires_grad]
    optimizer = bump_versions_after_step(torch.optim.Adam(
        params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, fused=True))
    schedule = make_schedule(learning_rate, warmup_steps, decay_steps)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda count: schedule(count) / learning_rate)
    return TrainState(model, optimizer, scheduler, params)


def global_norm(tensors):
    """L2 norm of all the tensors' entries together (``optax.global_norm``)."""
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t) for t in tensors]))


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
    are 0-d tensors on the device."""
    def train_step(state, frames, labels):
        if not model.training:
            model.train()
        with full_float32():
            log_probs = model(_normalise(frames))
            loss = loss_fn(log_probs, labels)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        with torch.no_grad():
            grad_norm = global_norm([p.grad for p in state.params if p.grad is not None])
        state.optimizer.step()
        state.scheduler.step()
        with torch.no_grad():
            acc = accuracy(log_probs, _match_labels(log_probs, labels))
            param_norm = global_norm(state.params)
        return loss.detach(), acc, grad_norm, param_norm

    return train_step


def make_eval_step(model, loss_fn):
    """``eval_step(state, frames, labels) -> (loss, acc)`` in eval mode (batch
    norm on its running statistics, no dropout; on CUDA, ResNet-18's
    ``layer4[1]`` runs the fused residual-block kernel)."""
    @torch.no_grad()
    def eval_step(state, frames, labels):
        if model.training:
            model.eval()
        with full_float32():
            log_probs = model(_normalise(frames))
            loss = loss_fn(log_probs, labels)
        return loss, accuracy(log_probs, _match_labels(log_probs, labels))

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
    on one device."""

    def __init__(self, config: TrainerConfig, train_dataset, val_dataset=None):
        self.config = config
        self.device = resolve_device(config.device)
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
        ``torch.Generator`` seeded ``seed`` (the same weights on any
        device), move the model to the device and build the optimizer.
        The dropout masks come from a generator on the device seeded
        ``seed + 1``."""
        self.model.init_weights(torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        if hasattr(self.model, "set_dropout_generator"):
            self.model.set_dropout_generator(self.generator)
        self.state = create_train_state(
            self.model, self.config.learning_rate,
            warmup_steps=self.config.warmup_steps,
            decay_steps=self.config.lr_decay_steps,
        )
        return self.state

    def _log(self, record):
        self.metrics_log.append(record)
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
        if device_gen is not None:
            for frames, chars, labels in device_gen(cfg.batch_size, steps):
                yield frames, chars, torch.from_numpy(labels).to(self.device, non_blocking=True)
            return
        with BackgroundIterator(self.train_dataset.batches(cfg.batch_size, steps),
                                maxsize=4) as batches:
            yield from device_prefetch(batches, 2, self.device)

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
            dataset.batches(self.config.batch_size, num_batches), 2, self.device,
        ):
            loss, acc = self.eval_step(self.state, frames, labels)
            losses.append(float(loss))
            accs.append(float(acc))
        return {"loss": float(np.mean(losses)), "acc": float(np.mean(accs))}

    # ---------------- checkpoints ----------------

    def save_checkpoint(self, step):
        """Write ``step_<step>.pt`` (``{"embed", "head"}`` state dicts on the
        CPU) and ``step_<step>.trainer.pt`` (optimizer, schedule,
        generator) into ``checkpoint_dir``; return the first's path."""
        os.makedirs(self.config.checkpoint_dir, exist_ok=True)
        path = os.path.abspath(os.path.join(self.config.checkpoint_dir, f"step_{step}.pt"))

        def cpu(module):
            return {k: v.detach().cpu() for k, v in module.state_dict().items()}

        torch.save({"embed": cpu(self.model.embed), "head": cpu(self.model.head)}, path)
        torch.save({"optimizer": self.state.optimizer.state_dict(),
                    "scheduler": self.state.scheduler.state_dict(),
                    "generator": self.generator.get_state()},
                   _training_state_path(path))
        return path

    def restore_checkpoint(self, path):
        """Load the weights of ``path`` (anything
        ``BatchedActionPipeline.load_checkpoint`` reads: a file of
        :meth:`save_checkpoint` or a reference Lightning ``.ckpt``), and the
        optimizer, schedule and generator from the file beside it when
        there is one."""
        if self.state is None:
            self.init_state()
        cfg = self.config
        pipe = BatchedActionPipeline(cfg.family, cfg.num_actions, cfg.sequence_length,
                                     crop_size=cfg.crop_size, device="cpu").load_checkpoint(path)
        self.model.embed.load_state_dict(pipe.embed.state_dict())
        self.model.head.load_state_dict(pipe.head.state_dict())
        side = _training_state_path(path)
        if os.path.exists(side):
            saved = torch.load(side, map_location="cpu", weights_only=True)
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
                   help="model-parallel mesh axis size (above 1 is not ported)")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute (not ported)")
    p.add_argument("--tensorboard", action="store_true",
                   help="also write TensorBoard events next to the JSONL log")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device; 'cpu' for the CPU)")
    return p


def main(argv=None):
    """The train command line: ground-truth train/validation splits of every
    move, a trainer with checkpoints under ``SAVED_ACTION_MODELS/<name>``
    and the JSONL log under ``ACTION_RECOG_OUTPUT_DIR/<name>``, then the
    test split's loss and accuracy."""
    args = _parser().parse_args(argv)
    if args.bf16:
        raise NotImplementedError(NOT_BF16)
    if args.model_parallel > 1:
        raise NotImplementedError(NOT_MODEL_PARALLEL)
    device = resolve_device(args.device)
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
    print(trainer.evaluate(UltActionRecogDataset(split="test", **val_args)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
