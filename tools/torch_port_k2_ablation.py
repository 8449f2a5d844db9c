#!/usr/bin/env python3
"""Where the time of the residual-block kernel goes, on a CUDA card.

Run from the root of a checkout on a machine with a card:
    python3 tools/torch_port_k2_ablation.py

Builds four variants of playaid_core_torch/csrc/residual_block.cu into
build/kernels/: the kernel as it is, without its wgmma products, without
the copies after the ring's first fill, and without either, and times each
at the main path's shape (B=48, 4x4x512) in float32 and bfloat16 with CUDA
events over back-to-back launches.  The variants compute wrong results;
only their times mean anything.  Prints the card's name and power limit.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from playaid_core_torch.ops import _build  # noqa: E402
from playaid_core_torch.ops.conv_block import launch_shape, pack_block  # noqa: E402

# (text of the kernel, the same text fenced by a macro)
CUTS = {
    "SKIP_MMA": [
        "Mma<T, kBN>::run(part, a_lo, b_hi, s > 0);\n        Mma<T, kBN>::run(part, a_hi, b_lo, 1);\n"
        "        Mma<T, kBN>::run(part, a_hi, b_hi, 1);\n",
        "Mma<T, kBN>::run(part, a_hi, b_hi, s > 0);\n",
    ],
    "SKIP_LOAD": [
        "if (ks + STAGES - 1 < k_count) load_stage(ks + STAGES - 1, (ks + STAGES - 1) % STAGES);\n",
    ],
}
VARIANTS = {"as is": [], "no wgmma": ["SKIP_MMA"], "no copies after the first fill": ["SKIP_LOAD"],
            "neither": ["SKIP_MMA", "SKIP_LOAD"]}
ITERS = 100


def ablated_source():
    text = open(os.path.join(ROOT, "playaid_core_torch", "csrc", "residual_block.cu")).read()
    for macro, snippets in CUTS.items():
        for snippet in snippets:
            if text.count(snippet) != 1:
                raise RuntimeError(f"the kernel no longer has {snippet.strip()!r} once")
            text = text.replace(snippet, f"\n#ifndef {macro}\n{snippet}#endif\n")
    return text


def build():
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "residual_block_ablation.cu"
    src.write_text(ablated_source())
    procs = {}
    for name, macros in VARIANTS.items():
        lib = _build.BUILD_DIR / f"libresidual_block_ablation{len(procs)}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *(f"-D{m}" for m in macros), "-o", str(lib),
               str(src)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    libs = build()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    c = 512
    x = torch.from_numpy(np.maximum(rng.normal(0, 1, (48, 4, 4, c)), 0).astype(np.float32))
    w1, w2 = (torch.from_numpy(rng.normal(0, (2 / (9 * c)) ** 0.5, (3, 3, c, c))
                               .astype(np.float32)).to(dev) for _ in range(2))
    ones, zeros = torch.ones(c, device=dev), torch.zeros(c, device=dev)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for dtype, entry in ((torch.float32, "residual_block_f32"),
                         (torch.bfloat16, "residual_block_bf16")):
        pack = pack_block(w1, ones, zeros, w2, ones, zeros, dtype)
        xd = x.to(dev, dtype)
        mid, out = torch.empty_like(xd), torch.empty_like(xd)
        ptrs = [t.data_ptr() for t in (xd, pack.w1, pack.s1, pack.b1, pack.w2, pack.s2, pack.b2,
                                       mid, out)]
        stream = torch.cuda.current_stream().cuda_stream
        shape = launch_shape(c, 48 * 4 * 4)
        for name, lib in libs.items():
            fn = getattr(lib, entry)
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            for _ in range(5):
                _build.check(fn(*ptrs, 48, 4, 4, c, *shape, 0, stream), name)
            torch.cuda.synchronize()
            start.record()
            for _ in range(ITERS):
                _build.check(fn(*ptrs, 48, 4, 4, c, *shape, 0, stream), name)
            stop.record()
            torch.cuda.synchronize()
            print(f"{dtype}: {name}: {start.elapsed_time(stop) / ITERS:.4f} ms a call "
                  f"(two launches)", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
