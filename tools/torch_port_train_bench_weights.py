#!/usr/bin/env python3
"""Train the bench's CNN-63 weights with the PyTorch port, on the card.

The port's counterpart of tools/train_bench_weights.py: the CNN family
(ResNet-18 trunk + temporal head, the headline pipeline's model) at the
full 63-class operating point, trained by the port's Trainer on the port's
device-side synthesis (playaid_core_torch/train/device_synth.py: the
sprite and stage banks live on the card, the composite runs there), then
saved as float16 {"embed", "head"} state dicts that
BatchedActionPipeline.load_checkpoint reads.

    python3 tools/torch_port_train_bench_weights.py WORKDIR [--epochs 40]
        [--steps 75] [--batch 16] [--out PATH] [--clean DIR --stages DIR]
        [--device cpu]

Without --clean and --stages it builds the assets under WORKDIR without
cv2, so on the card's machine too: the JAX tool's skeletal sprites
(variants 0-4, 6 fighters x 48 moves x 16 frames), drawn by the port's
generate_sprite_set(fmt="npy") pixel for pixel as cv2 draws them, and its
four 540x960 stage textures, written as BGR .npy arrays of the same draws.
Those stages skip the JAX tool's JPEG round trip (it writes them as jpg
files), so their pixels are the draws themselves, not their decoded jpg.
So the headline CNN-63 weights can be retrained on the card from the real
skeletal sprites.  With --clean and --stages it takes an existing
clean-char tree and stage directory (png/jpg files need cv2; .npy files
do not).  Training runs in float32 (the port trains in float32 only),
where the JAX tool used bfloat16.

The JAX tool's fixture self-check (label agreement on bench.py's
make_sprite_video clip) needs JAX and cv2; it is not here and waits for
the port's bench (ROADMAP queue 1).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# The JAX tool's training variants, and its stage textures: name -> a draw
# from numpy.random.default_rng(0), in this order.
VARIANTS = (0, 1, 2, 3, 4)
STAGE_SPECS = [
    ("noise_dark", lambda r: r.integers(0, 60, (540, 960, 3))),
    ("noise_mid", lambda r: r.integers(0, 140, (540, 960, 3))),
    ("bands", lambda r: np.repeat(r.integers(0, 160, (54, 960, 3)), 10, axis=0)),
    ("tiles", lambda r: np.kron(r.integers(0, 170, (18, 32, 3)), np.ones((30, 30, 1)))),
]


def build_assets(workdir):
    """Sprite sets of the training variants (.npy BGRA, drawn in one
    process a CPU) and the stage textures (.npy BGR) under workdir, made
    once; no cv2 needed."""
    from playaid_core_torch.datagen import skeletal_sprites as sk

    clean = os.path.join(workdir, "clean")
    stages = os.path.join(workdir, "stages")
    os.makedirs(stages, exist_ok=True)
    if not os.path.isdir(clean):
        print(f"generating skeletal sprite sets (train variants {VARIANTS})...")
        offsets = {v: (k % 3) / 3.0 for k, v in enumerate(VARIANTS)}
        n = sk.generate_sprite_set(clean, fighters=list(sk.FIGHTER_STYLES),
                                   moves=sk.MOVES + sk.EXTRA_MOVES, frames_per_move=16,
                                   variant_seeds=VARIANTS, phase_offsets=offsets, fmt="npy")
        print(f"  {n} sprites")
    rng = np.random.default_rng(0)
    for name, draw in STAGE_SPECS:
        path = os.path.join(stages, f"{name}.npy")
        stage = draw(rng).astype(np.uint8)  # drawn whether or not it is written
        if not os.path.exists(path):
            np.save(path, stage)
    return clean, stages


def actions():
    """The 63 moves in class-id order (label id == the pipeline's class id)."""
    from playaid_core_torch.ontology import MOVE_TO_CLASS_ID

    return list(MOVE_TO_CLASS_ID.keys())


def bench_dataset(clean, stages, steps, batch, device=None, seed=0):
    """The JAX tool's DeviceSynthDataset arguments (train_bench_weights.py:94-100)."""
    from playaid_core_torch.datagen.skeletal_sprites import FIGHTER_STYLES
    from playaid_core_torch.train.device_synth import DeviceSynthDataset

    return DeviceSynthDataset(
        anim_subset=actions(), characters=list(FIGHTER_STYLES), clean_char_dir=clean,
        stages_dir=stages, num_samples=steps * batch, num_frames_per_sample=7,
        synth_sprite_fill=(0.70, 0.98), synth_center_jitter=10, synth_frame_degrade=0.5,
        synth_window="middleout", synth_cycle_repeats=(1, 2), synth_difficulty=1, seed=seed,
        device=device)


def bench_config(epochs, steps, batch, device=None, **kw):
    """The JAX tool's TrainerConfig (train_bench_weights.py:106-111), in
    float32: the learning rate decays over the whole run."""
    from playaid_core_torch.train.train import TrainerConfig

    args = dict(family="cnn", num_actions=len(actions()), sequence_length=7, batch_size=batch,
                learning_rate=3e-4, num_samples=steps * batch, crop_size=128,
                curriculum_threshold=0.88, lr_decay_steps=epochs * steps, verbose=True,
                device=device)
    args.update(kw)
    return TrainerConfig(**args)


def save_weights(trainer, path):
    """The trained model's {"embed", "head"} state dicts, float tensors as
    float16, written with torch.save: a file that
    BatchedActionPipeline.load_checkpoint reads."""
    import torch

    def half(module):
        return {k: v.detach().cpu().half() if v.is_floating_point() else v.detach().cpu()
                for k, v in module.state_dict().items()}

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"embed": half(trainer.model.embed), "head": half(trainer.model.head)}, path)
    return path


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python3 tools/torch_port_train_bench_weights.py",
        description=__doc__.split("\n\n")[0],
        epilog="The JAX tool's fixture self-check is not ported: it waits for the port's "
               "bench (ROADMAP queue 1).")
    p.add_argument("workdir")
    p.add_argument("--epochs", default=40, type=int)
    p.add_argument("--steps", default=75, type=int, help="steps per epoch")
    p.add_argument("--batch", default=16, type=int)
    p.add_argument("--warmup", default=200, type=int, help="linear warmup steps")
    p.add_argument("--out", default=None, help="output file (default: WORKDIR/bench_cnn63.pt)")
    p.add_argument("--clean", default=None, help="an existing clean-char sprite tree")
    p.add_argument("--stages", default=None, help="an existing stage texture directory")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device; 'cpu' for the CPU)")
    args = p.parse_args(argv)
    if (args.clean is None) != (args.stages is None):
        p.error("--clean and --stages go together")

    from playaid_core_torch.train.train import Trainer

    os.makedirs(args.workdir, exist_ok=True)
    if args.clean is None:
        clean, stages = build_assets(args.workdir)
    else:
        clean, stages = args.clean, args.stages
    ds = bench_dataset(clean, stages, args.steps, args.batch, device=args.device)
    print(f"sprite bank: {ds.sprites.num_sprites} sprites ({ds.sprites.nbytes / 1e9:.2f} GB), "
          f"{ds.stages.num_patches} stage patches")
    config = bench_config(args.epochs, args.steps, args.batch, device=args.device,
                          warmup_steps=args.warmup)
    trainer = Trainer(config, ds)
    trainer.init_state()
    trainer.fit(num_epochs=args.epochs, steps_per_epoch=args.steps)
    sps = sorted(r["steps_per_sec"] for r in trainer.metrics_log)
    print(f"train throughput: median {sps[len(sps) // 2]:.1f} steps/s (epoch accs tail: "
          f"{[round(r['train_acc'], 3) for r in trainer.metrics_log[-5:]]})")
    out = save_weights(trainer, args.out or os.path.join(args.workdir, "bench_cnn63.pt"))
    print(f"saved {out} ({os.path.getsize(out) / 1e6:.1f} MB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
