#!/usr/bin/env python3
"""Phase 13 (b)'s batch-norm check alone, step by step, on a CUDA card.

Run from the root of a checkout on a machine with a card:
    python3 tools/torch_port_mesh_bn.py [REPEATS] [MESH_RUNS] [MODE ...]

chip_smoke.py phase 13 (b) trains CNN-63 from the bench weights on phase
10's first batch for 1 + MESH_STEPS steps, on a (2, 1) mesh of two gloo
ranks sharing the card and on one process, and holds the mesh's batch-norm
running statistics to the one process's within MESH_STATS_REL_TOL of
max|ref| per tensor.  This tool runs that case alone, with the whole state
and that step's gradients written after every step, each run in a process
of its own as in the phase, in each MODE (default: default float64):
"default", float32, as the phase trains the runs whose statistics it
holds after step 1; "deterministic", the same with cuDNN's and PyTorch's
deterministic algorithms asked for; "float64", the model and frames in
float64, as the phase trains the runs whose statistics it holds after the
last step.
  - The one process REPEATS times (default 4), each run against the first
    after each step: the worst statistic and the worst gradient (max|g -
    g0| / max|g0| per tensor).
    The one-process runs' warnings (an operation with no deterministic
    implementation warns in deterministic mode) are listed.
  - The mesh MESH_RUNS times (default 2), each against the one process's
    first run after each step: the same two numbers.
  - After step 1, for each run against the one process's first: the
    parameters that moved apart by more than the learning rate (Adam's
    first step moves a parameter whose |gradient| is well above its eps
    by the learning rate times the gradient's sign, so these are gradients
    of opposite sign), and the largest |gradient| among them.
Writes its states under build/mesh_bn/, prints the card's name and power
limit, a line per comparison, and a JSON summary as its last line.
"""

import json
import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

WORK = os.path.join(ROOT, "build", "mesh_bn")
MODES = ("default", "deterministic", "float64")
TIMEOUT_S = 600


def state_path(mode, who, step):
    return os.path.join(WORK, f"{mode}_{who}_step{step}.pt")


def deterministic_algorithms(torch):
    """cuDNN's deterministic algorithms (no benchmarking) and PyTorch's (an
    operation without one warns), with the fixed cuBLAS workspace they ask
    for, before the process first uses the card."""
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)


def case(torch, mode):
    """Phase 13 (b)'s CNN-63 case on cuda:0 under mode's cuDNN settings."""
    import chip_smoke

    if mode == "deterministic":  # for the rest of this child process
        deterministic_algorithms(torch)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    return dict(chip_smoke.mesh_cases(dev)[0], double=mode == "float64"), dev


def one_main(mode, repeats):
    """Child: the one-process run, repeats times."""
    import torch

    from playaid_core_torch.parallel.dryrun import run_train_case

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        cnn, dev = case(torch, mode)
        for r in range(repeats):
            run_train_case(dict(cnn, devices=[str(dev)],
                                out=state_path(mode, f"one{r}", "{step}")))
    with open(os.path.join(WORK, f"{mode}_warnings.json"), "w") as f:
        json.dump(sorted({str(w.message)[:300] for w in seen}), f)
    return 0


def rank_main(mode, run, rank):
    """Child: rank of the (2, 1) mesh's run number run."""
    import datetime

    import torch
    import torch.distributed as dist

    from playaid_core_torch.parallel.dryrun import run_train_case

    cnn, dev = case(torch, mode)
    dist.init_process_group("gloo", init_method=os.environ["MESH_BN_STORE"], world_size=2,
                            rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        run_train_case(dict(cnn, model_parallel=1,
                            out=state_path(mode, f"mesh{run}", "{step}")))
    finally:
        dist.destroy_process_group()
    return 0


def spawn(args, env=None):
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), *args], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def wait(procs, what):
    for p in procs:
        try:
            _, err = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            raise RuntimeError(f"{what}: no end within {TIMEOUT_S} s")
        if p.returncode != 0:
            raise RuntimeError(f"{what}: exit {p.returncode}:\n{err[-3000:]}")


def grads_rel_err(got, ref):
    """The worst gradient of two whole state files, as max|got - ref| /
    max|ref| per tensor."""
    return max(float((got[k] - v).abs().max() / v.abs().max().clamp_min(1e-30))
               for k, v in ref.items())


def flips(got, ref, lr):
    """Parameters of two whole state files more than lr apart, and the
    largest |gradient| of ref's among them."""
    count, largest = 0, 0.0
    for name, g in ref["grads"].items():
        part, key = name.split(".", 1)
        apart = (got[part][key] - ref[part][key]).abs() > lr
        count += int(apart.sum())
        if apart.any():
            largest = max(largest, float(g[apart].abs().max()))
    return count, largest


def main():
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("torch_port_mesh_bn: no CUDA device", file=sys.stderr)
        return 2
    repeats = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    mesh_runs = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    modes = sys.argv[3:] or ["default", "float64"]
    assert set(modes) <= set(MODES), modes
    card = chip_smoke.nvidia_smi_line()
    os.makedirs(WORK, exist_ok=True)
    chip_smoke.write_train_tree(chip_smoke.TRAIN_ROOT, chip_smoke.train_actions())
    steps = 1 + chip_smoke.MESH_STEPS
    summary = {"card": card, "tol": chip_smoke.MESH_STATS_REL_TOL, "steps": steps,
               "lr": chip_smoke.TRAIN_LR}
    for mode in modes:
        t0 = time.perf_counter()
        wait([spawn(["--one", mode, str(repeats)])], f"{mode} one process")
        for run in range(mesh_runs):
            store = os.path.join(WORK, f"store_{mode}_{run}")
            if os.path.exists(store):
                os.remove(store)
            env = dict(os.environ, MESH_BN_STORE="file://" + store)
            wait([spawn(["--rank", mode, str(run), str(r)], env) for r in range(2)],
                 f"{mode} mesh run {run}")
        rows = {}
        for step in range(1, steps + 1):
            ref = torch.load(state_path(mode, "one0", step), weights_only=True)
            for who in [f"one{r}" for r in range(1, repeats)] + [f"mesh{r}"
                                                                for r in range(mesh_runs)]:
                got = torch.load(state_path(mode, who, step), weights_only=True)
                stats = chip_smoke.stats_rel_err(got, ref)
                grads = grads_rel_err(got["grads"], ref["grads"])
                row = {"step": step, "stats": stats, "grads": grads}
                if step == 1:
                    row["flips"], row["flip_grad_max"] = flips(got, ref, chip_smoke.TRAIN_LR)
                rows.setdefault(who, []).append(row)
                print(f"{mode}: {who} vs one0 after step {step}: worst statistic {stats:.3e} "
                      f"(tol {chip_smoke.MESH_STATS_REL_TOL}), worst gradient {grads:.3e}"
                      + (f", {row['flips']} parameters apart by more than the learning rate "
                         f"{chip_smoke.TRAIN_LR} (largest |gradient| among them "
                         f"{row['flip_grad_max']:.3e})" if step == 1 else "")
                      + f"; {card}", flush=True)
        with open(os.path.join(WORK, f"{mode}_warnings.json")) as f:
            warned = json.load(f)
        print(f"{mode}: warnings of the one-process runs: {warned}", flush=True)
        summary[mode] = {"rows": rows, "warnings": warned, "seconds": time.perf_counter() - t0}
    print(card, flush=True)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        sys.exit(one_main(sys.argv[2], int(sys.argv[3])))
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[2], int(sys.argv[3]), int(sys.argv[4])))
    sys.exit(main())
