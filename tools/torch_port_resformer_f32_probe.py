#!/usr/bin/env python3
"""Where the ResFormer's float32 gradients leave float64's, one process
against a mesh of ranks.

Run from the root of a checkout on a machine with a CUDA device:

    python3 tools/torch_port_resformer_f32_probe.py [--frames phase10|uniform]

It trains the case of ``chip_smoke.py`` phase 13 (b) (the full-width
ResFormer, 63 classes, T 7, 128 px, batch 8, seeded weights) for one step
on phase 10's letterboxed crops, or with ``--frames uniform`` on uniform
random frames and labels from seed 0 (phase 13 (b)'s float32 case, the
input of ``dryrun_multichip``), keeps every parameter's gradient,
and holds each float32 run against the float64 run of this process:

* one process, as the card's defaults leave cuDNN, twice;
* one process with ``cudnn.benchmark`` off and ``cudnn.deterministic`` on;
* one process with cuDNN off;
* one spawned gloo rank, and two spawned gloo ranks on a (1, 2) mesh.

For each it prints the first-step loss, the grad norm's relative error to
float64, and the gradients' error per tensor (max|g - g64| / max|g64|):
the median, and the four worst tensors.  For the one-process runs it also
records the sign of every ``torch.relu`` input and prints the units whose
float32 sign differs from float64's: where (the caller and the shape), how
many, and their float64 inputs beside the tensor's max.  The last line is
one JSON object.
"""

import contextlib
import json
import os
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


@contextlib.contextmanager
def cudnn_flags(**flags):
    saved = {k: getattr(torch.backends.cudnn, k) for k in flags}
    for k, v in flags.items():
        setattr(torch.backends.cudnn, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(torch.backends.cudnn, k, v)


@contextlib.contextmanager
def relu_inputs(keep_values):
    """Record, call by call, where each ``torch.relu`` was called, and the
    sign of its input (and with ``keep_values`` the input itself)."""
    relu, calls = torch.relu, []

    def recording(x):
        frame = sys._getframe(1)
        site = f"{os.path.basename(frame.f_code.co_filename)}:{frame.f_lineno}"
        calls.append((site, tuple(x.shape), x.detach().clone() if keep_values else x > 0))
        return relu(x)

    torch.relu = recording
    try:
        yield calls
    finally:
        torch.relu = relu


def relu_flips(calls, ref_calls):
    """The calls whose input sign differs from float64's, with the count and
    the largest float64 |input| among them, beside the input's max."""
    flips = []
    for k, ((site, shape, positive), (_, _, x64)) in enumerate(zip(calls, ref_calls)):
        differ = positive != (x64 > 0)
        n = int(differ.sum())
        if n:
            flips.append({"call": k, "site": site, "shape": list(shape), "units": n,
                          "max_abs_x64": float(x64[differ].abs().max()),
                          "x64_scale": float(x64.abs().max())})
    return flips


def leaf_errors(grads, ref):
    errs = {n: float((grads[n].double() - g).abs().max() / g.abs().max().clamp_min(1e-30))
            for n, g in ref.items()}
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:4]
    return float(np.median(list(errs.values()))), worst


def main():
    import chip_smoke
    from playaid_core_torch.parallel.dryrun import run_train_case, spawn_ranks

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = chip_smoke.nvidia_smi_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, cuDNN "
          f"{torch.backends.cudnn.version()}; cudnn benchmark {torch.backends.cudnn.benchmark}, "
          f"deterministic {torch.backends.cudnn.deterministic}, allow_tf32 "
          f"{torch.backends.cudnn.allow_tf32}; matmul allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}, precision "
          f"{torch.get_float32_matmul_precision()}; {card}", flush=True)
    chip_smoke.write_train_tree(chip_smoke.TRAIN_ROOT, chip_smoke.train_actions())
    _, resformer, uniform, _ = chip_smoke.mesh_cases(dev)
    if sys.argv[1:] == ["--frames", "uniform"]:
        resformer = uniform
    work = tempfile.mkdtemp(prefix="resformer_f32_probe_", dir=os.path.join(ROOT, "build"))
    base = dict(resformer, save=None, steps=1)

    relu_calls = {}

    def one_process(name, **kw):
        path = os.path.join(work, f"{name}.pt")
        with relu_inputs(keep_values=kw.get("double", False)) as calls:
            res = run_train_case(dict(base, devices=[str(dev)], out=path, **kw))
        relu_calls[name] = calls
        return res, torch.load(path, weights_only=True)["grads"]

    def ranks(name, n, model_parallel):
        path = os.path.join(work, f"{name}.pt")
        res = spawn_ranks(run_train_case, n, (dict(base, model_parallel=model_parallel,
                                                   out=path),), "gloo", 900.0)[0]
        return res, torch.load(path, weights_only=True)["grads"]

    ref, g64 = one_process("float64", double=True)
    runs = {}
    runs["one process"] = one_process("f32_a")
    runs["one process, again"] = one_process("f32_b")
    with cudnn_flags(benchmark=False, deterministic=True):
        runs["one process, cudnn deterministic"] = one_process("f32_det")
    with cudnn_flags(enabled=False):
        runs["one process, cudnn off"] = one_process("f32_nocudnn")
    runs["one gloo rank (1, 1)"] = ranks("rank1", 1, 1)
    runs["two gloo ranks (1, 2)"] = ranks("rank2", 2, 2)
    g64n = ref["grad_norms"][0]
    summary = {"float64": {"loss": ref["losses"][0], "grad_norm": g64n}}
    files = {"one process": "f32_a", "one process, again": "f32_b",
             "one process, cudnn deterministic": "f32_det", "one process, cudnn off": "f32_nocudnn"}
    for name, (res, grads) in runs.items():
        if name in files:
            flips = relu_flips(relu_calls[files[name]], relu_calls["float64"])
            summary.setdefault("relu_flips", {})[name] = flips
            print(f"{name}: relu inputs whose sign differs from float64's: {flips}", flush=True)
        median, worst = leaf_errors(grads, g64)
        gerr = abs(res["grad_norms"][0] - g64n) / g64n
        summary[name] = {"loss": res["losses"][0], "grad_norm": res["grad_norms"][0],
                         "grad_norm_rel_to_f64": gerr, "leaf_median": median,
                         "leaf_worst": worst}
        print(f"{name}: loss {res['losses'][0]:.9f}, grad norm {res['grad_norms'][0]:.9f} "
              f"(float64 {g64n:.9f}, rel {gerr:.3e}); per-tensor err median {median:.3e}, "
              f"worst {[(n, f'{e:.3e}') for n, e in worst]}; {card}", flush=True)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
