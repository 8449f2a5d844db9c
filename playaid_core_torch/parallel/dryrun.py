"""Multi-rank runs of the port: the flagship step on a mesh of ranks, and
the helpers that start ranks.

Counterpart of ``__graft_entry__.py`` (``entry``, ``dryrun_multichip``).
:func:`spawn_ranks` starts ``n`` processes with the ``spawn`` method; each
joins a process group (``backend``: NCCL for one rank per card, gloo for
the CPU or for ranks that share a card) through a file store and runs a
function of this package, so the children import ``torch`` and the port
only.  Every process group, wait and join has a timeout: a rank that hangs
fails the run.

:func:`run_train_case` is the rank's work: a ``Trainer`` of one family on a
mesh (the world's, or one device) from given or seeded weights, steps on a
fixed batch, an optional checkpoint written or restored.  The CPU tests and
:func:`dryrun_multichip` drive it.
"""

from __future__ import annotations

import collections
import datetime
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0
REL_TOL = 2e-4  # the JAX dry run's bound: float32 reductions in another order


def entry(device=None):
    """``(fn, example_args)``: the flagship forward (the ResFormer at 63
    classes, T 7, 128-px crops, seeded weights) on ``device`` (None: the
    card)."""
    from playaid_core_torch.device import resolve_device
    from playaid_core_torch.models.resnet_transformer import ResnetTransformerDetector

    device = resolve_device(device)
    model = ResnetTransformerDetector(num_actions=63, sequence_length=7)
    model.init_weights(torch.Generator().manual_seed(0))
    model.to(device).eval()
    frames = torch.zeros((2, 7, 128, 128, 3), device=device)

    @torch.no_grad()
    def fn(frames):
        return model(frames)

    return fn, (frames,)


def spawn_ranks(target, world_size, args=(), backend="gloo", timeout_s=DEFAULT_TIMEOUT_S,
                threads=1):
    """Run ``target(*args)`` in ``world_size`` spawned ranks of one process
    group; return their results in rank order.  Raises ``TimeoutError`` (and
    kills every rank) when the ranks do not finish within ``timeout_s``,
    and ``RuntimeError`` with the tracebacks when one fails."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    store = tempfile.mkdtemp(prefix="playaid_mesh_")
    init_method = "file://" + os.path.join(store, "store")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(target, args, rank, world_size, backend, init_method,
                               timeout_s, threads, results))
             for rank in range(world_size)]
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        got = {}
        # Drain the queue before joining: a child blocks on a full pipe.
        while len(got) < world_size:
            left = deadline - time.monotonic()
            try:
                rank, ok, value = results.get(timeout=max(min(left, 5.0), 0.01))
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead or left <= 0:
                    why = (f"rank(s) exited with {[p.exitcode for p in dead]}" if dead
                           else f"no result within {timeout_s} s")
                    raise TimeoutError(f"{world_size} {backend} ranks: {why}; "
                                       f"{len(got)} finished") from None
                continue
            got[rank] = (ok, value)
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
        shutil.rmtree(store, ignore_errors=True)
    errors = [f"rank {r}:\n{v}" for r, (ok, v) in sorted(got.items()) if not ok]
    if errors:
        raise RuntimeError("\n".join(errors))
    return [got[r][1] for r in range(world_size)]


def _rank_main(target, args, rank, world_size, backend, init_method, timeout_s, threads,
               results):
    torch.set_num_threads(threads)
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            results.put((rank, True, target(*args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_train_case(case):
    """A rank's (or one process's) training run; ``case`` is a dict:

    * ``family``, ``num_actions``, ``sequence_length``, ``crop_size``,
      ``lr``; ``device`` (this rank's; None: the card); ``model_parallel`` (the world's
      mesh, or ``devices`` for a single-process mesh, default ``[device]``);
    * ``init``: ``{"embed", "head"}`` whole state dicts, or None for
      ``init_state(seed)``'s weights; ``seed`` (weights and dropout);
    * ``frames`` uint8 ``[B, T, S, S, 3]`` and ``labels`` ``[B, T]``: every
      step's batch; ``steps``; ``double``: the model and frames in float64;
    * ``restore``: a checkpoint to restore first; ``save``: a directory to
      write ``step_<n>.pt`` into after ``save_at`` steps (default: all);
    * ``out``: a path where rank 0 writes the whole state after the steps,
      with the last step's whole gradients (averaged over ``data``) under
      ``"grads"``; a path holding ``{step}`` is written after every step.

    Returns ``{"losses", "accs", "grad_norms", "param_norms", "seconds",
    "bytes", "calls", "mesh"}`` (the step results as floats; ``seconds`` per
    step, synchronised; ``bytes`` each collective's payload over the steps,
    ``calls`` their number)."""
    from playaid_core_torch.device import resolve_device
    from playaid_core_torch.parallel.mesh import make_mesh
    from playaid_core_torch.train.train import Trainer, TrainerConfig

    device = resolve_device(case.get("device"))
    devices = case.get("devices")
    mesh = make_mesh(devices=devices, model_parallel=case.get("model_parallel", 1),
                     device=device if devices is None else None)
    frames_np, labels_np = case["frames"], case["labels"]
    config = TrainerConfig(
        family=case["family"], num_actions=case["num_actions"],
        sequence_length=case["sequence_length"], batch_size=frames_np.shape[0],
        learning_rate=case.get("lr", 3e-4), crop_size=case["crop_size"], warmup_steps=0,
        checkpoint_dir=case.get("save"), device=str(device))
    trainer = Trainer(config, None, mesh=mesh)
    trainer.init_state(case.get("seed", 0))
    if case.get("init") is not None:
        trainer.load_whole(case["init"])
    if case.get("double"):
        trainer.model.double()
    if case.get("restore"):
        trainer.restore_checkpoint(case["restore"])
    rows = trainer._rows
    frames = torch.from_numpy(rows(frames_np)).to(device)
    if case.get("double"):
        frames = frames.double() / 255.0
    labels = torch.from_numpy(rows(labels_np)).to(device)
    mesh.bytes.clear()
    mesh.calls.clear()
    out = {"losses": [], "accs": [], "grad_norms": [], "param_norms": [], "seconds": []}
    steps = case.get("steps", 1)
    for step in range(1, steps + 1):
        t0 = time.perf_counter()
        loss, acc, gnorm, pnorm = trainer.train_step(trainer.state, frames, labels)
        values = [float(v) for v in (loss, acc, gnorm, pnorm)]  # waits for the step
        out["seconds"].append(time.perf_counter() - t0)
        for key, v in zip(("losses", "accs", "grad_norms", "param_norms"), values):
            out[key].append(v)
        moved, calls = collections.Counter(mesh.bytes), collections.Counter(mesh.calls)
        if case.get("save") and step == case.get("save_at", steps):
            out["checkpoint"] = trainer.save_checkpoint(step)
        path = case.get("out")
        if path and ("{step}" in path or step == steps):
            _write_whole(trainer, mesh, path.format(step=step))
        mesh.bytes, mesh.calls = moved, calls  # the checkpoint's gathers are no step's
    out["bytes"] = dict(mesh.bytes)
    out["calls"] = dict(mesh.calls)
    out["mesh"] = mesh.shape
    return out


def _write_whole(trainer, mesh, path):
    """Rank 0 writes the whole state, with the last step's whole gradients
    (averaged over ``data``) under ``"grads"``; every rank gathers."""
    from playaid_core_torch.parallel.mesh import gather_params

    whole = trainer.whole_state()
    state = trainer.state
    grads = {n: p.grad for n, p in zip(state.names, state.params) if p.grad is not None}
    whole["grads"] = {n: g.cpu() for n, g in gather_params(
        mesh, grads, {n: trainer.specs[n] for n in grads}).items()}
    if trainer.is_writer:
        torch.save(whole, path)
    mesh.barrier()


def run_train_cases(cases):
    """:func:`run_train_case` of each case in turn (one mesh each)."""
    return [run_train_case(case) for case in cases]


def run_module_case(case):
    """A rank's forward and backward of one module on the world's mesh, for
    the tests of the collectives; ``case`` is a dict:

    * ``module``: ``"transformer_layer"`` (``d_model``, ``num_heads``,
      ``dim_feedforward``) or ``"batch_norm"`` (``channels``), with its
      whole ``state`` dict; ``model_parallel`` of the world's mesh;
    * ``x`` and ``grad`` (the output's gradient): the whole batch (numpy),
      of which this rank takes its rows; ``train``; ``seed`` of the dropout
      generator; ``double``.

    Returns this rank's rows of the output and of the input's gradient,
    the parameters' gradients (whole, summed over ``data``) and the
    module's buffers."""
    from playaid_core_torch.models.resnet import BatchNorm2d
    from playaid_core_torch.models.resnet_transformer import TransformerEncoderLayer
    from playaid_core_torch.parallel.mesh import (
        attach_mesh,
        batch_sharding,
        gather_params,
        make_mesh,
    )

    if case["module"] == "batch_norm":
        module = BatchNorm2d(case["channels"])
    else:
        module = TransformerEncoderLayer(case["d_model"], case["num_heads"],
                                         case["dim_feedforward"])
        module.generator = torch.Generator().manual_seed(case.get("seed", 0))
    module.load_state_dict(case["state"])
    dtype = torch.float64 if case.get("double") else torch.float32
    module.to(dtype).train(case.get("train", True))
    mesh = make_mesh(model_parallel=case.get("model_parallel", 1), device="cpu")
    specs = attach_mesh(module, mesh)
    rows = batch_sharding(mesh)
    x = torch.from_numpy(rows(case["x"])).to(dtype).requires_grad_(True)
    y = module(x)
    y.backward(torch.from_numpy(rows(case["grad"])).to(dtype))
    grads = {k: p.grad for k, p in module.named_parameters()}
    for g in grads.values():
        mesh.all_reduce_(g, "data")
    grads = gather_params(mesh, grads, specs)
    return {"y": y.detach().numpy(), "x_grad": x.grad.numpy(),
            "param_grads": {k: g.numpy() for k, g in grads.items()},
            "buffers": {k: b.numpy() for k, b in module.named_buffers()}}


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def dryrun_multichip(n_devices, backend="nccl", device=None, crop_size=128,
                     sequence_length=7, timeout_s=DEFAULT_TIMEOUT_S):
    """The flagship training step (ResFormer, 63 classes) on an ``(n/2, 2)``
    mesh of ``n_devices`` spawned ranks (``(n, 1)`` for odd ``n``), as the
    JAX dry run checks it: three steps lower the loss; the first step's loss
    and grad norm are within 2e-4 relative of one rank's on the whole batch;
    a checkpoint written on the mesh continues on half the ranks within
    2e-4; and ``VodAnalyzer`` on a single-process mesh gives labels
    identical to one device (on a clip written with cv2; skipped without
    it).  ``device``: each rank's (None: its card).  Returns the summary
    line."""
    model_parallel = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    data_parallel = n_devices // model_parallel
    t, s = sequence_length, crop_size
    batch = max(data_parallel, 2)
    gen = np.random.default_rng(0)
    case = {"family": "resformer", "num_actions": 63, "sequence_length": t, "crop_size": s,
            "device": device or "cuda", "seed": 0, "model_parallel": model_parallel,
            "frames": gen.integers(0, 256, (batch, t, s, s, 3), dtype=np.uint8),
            "labels": gen.integers(0, 63, (batch, t)).astype(np.int64), "steps": 3}
    work = tempfile.mkdtemp(prefix="playaid_dryrun_")
    try:
        meshed = spawn_ranks(run_train_case, n_devices, (dict(case, save=work),), backend,
                             timeout_s)[0]
        losses = meshed["losses"]
        assert losses[0] > losses[1] > losses[2], f"loss not decreasing: {losses}"
        one = spawn_ranks(run_train_case, 1, (dict(case, model_parallel=1, steps=1),),
                          backend, timeout_s)[0]
        rel_loss = _rel(losses[0], one["losses"][0])
        rel_gnorm = _rel(meshed["grad_norms"][0], one["grad_norms"][0])
        assert rel_loss < REL_TOL, (losses[0], one["losses"][0])
        assert rel_gnorm < REL_TOL, (meshed["grad_norms"][0], one["grad_norms"][0])
        ckpt_line = _dryrun_checkpoint(case, meshed, n_devices, backend, timeout_s)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    vod_line = _dryrun_vod(n_devices, model_parallel, device)
    return (f"dryrun_multichip({n_devices}): mesh={meshed['mesh']} flagship resformer t={t} "
            f"s={s} losses={[round(v, 4) for v in losses]} (strictly decreasing) | numerics "
            f"vs 1 rank: loss rel {rel_loss:.2e}, grad-norm rel {rel_gnorm:.2e} | {ckpt_line} "
            f"| {vod_line}")


def _dryrun_checkpoint(case, meshed, n_devices, backend, timeout_s):
    """Continue from the mesh's checkpoint on half the ranks (two steps),
    against the mesh's own continuation."""
    if n_devices < 4 or n_devices % 2:
        return "ckpt: skipped (needs >= 4 even devices)"
    path = meshed["checkpoint"]
    restore = dict(case, restore=path, steps=2)
    again = spawn_ranks(run_train_case, n_devices, (restore,), backend, timeout_s)[0]
    half = n_devices // 2
    restore2 = dict(restore, model_parallel=2 if half % 2 == 0 else 1)
    resumed = spawn_ranks(run_train_case, half, (restore2,), backend, timeout_s)[0]
    rel = max(_rel(a, b) for a, b in zip(resumed["losses"], again["losses"]))
    assert rel < REL_TOL, f"post-restore losses {resumed['losses']} vs {again['losses']}"
    return (f"ckpt: saved on {meshed['mesh']} -> restored on {resumed['mesh']}, continuation "
            f"losses rel {rel:.2e}")


def _dryrun_vod(n_devices, model_parallel, device):
    """``VodAnalyzer`` on a single-process mesh of ``n_devices`` (replicas on
    the ``data`` axis) against one device, on a 24-frame mp4v clip."""
    try:
        import cv2
    except ImportError:
        return "vod: skipped (no cv2)"
    from playaid_core_torch.infer.pipeline import BatchedActionPipeline
    from playaid_core_torch.infer.vod_pipeline import VodAnalyzer
    from playaid_core_torch.parallel.mesh import make_mesh

    num_frames, w, h = 24, 320, 180
    work = tempfile.mkdtemp(prefix="playaid_dryrun_vod_")
    try:
        path = os.path.join(work, "clip.mp4")
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 60, (w, h))
        gen = np.random.default_rng(3)
        base = gen.integers(0, 120, (h, w, 3), dtype=np.uint8)
        boxes = np.zeros((num_frames, 2, 4), np.float32)
        for i in range(num_frames):
            frame = base.copy()
            x = 0.3 + 0.4 * i / num_frames
            cv2.circle(frame, (int(x * w), h // 2), 20, (0, 200, 255), -1)
            cv2.circle(frame, (int((1 - x) * w), h // 2), 20, (255, 80, 0), -1)
            writer.write(frame)
            boxes[i, 0] = (x, 0.5, 50 / w, 50 / h)
            boxes[i, 1] = (1 - x, 0.5, 50 / w, 50 / h)
        writer.release()
        pipe = BatchedActionPipeline(family="cnn", num_actions=16, sequence_length=5,
                                     frame_delta=2, crop_size=64, device=device).init(0)
        chunk = max(8, 2 * (n_devices // model_parallel))
        single = VodAnalyzer(pipe, chunk=chunk, decode_backend="cv2").analyze(path, boxes)
        mesh = make_mesh(devices=[pipe.device] * n_devices, model_parallel=model_parallel)
        sharded = VodAnalyzer(pipe, chunk=chunk, mesh=mesh, decode_backend="cv2").analyze(
            path, boxes)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    assert np.array_equal(single["labels"], sharded["labels"]), "sharded labels differ"
    return f"vod: sharded labels identical over {sharded['frames']} frames"
