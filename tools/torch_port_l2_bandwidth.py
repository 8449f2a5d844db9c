#!/usr/bin/env python3
"""Copy rate from L2 into shared memory on a CUDA card, for the copy
patterns of the port's residual-block kernel.

Run from the root of a checkout on a machine with a card:
    python3 tools/torch_port_l2_bandwidth.py

Builds tools/torch_port_l2_bandwidth.cu with nvcc into build/kernels/ and
prints, for a 16 MB buffer that stays in L2, the bytes per second of 16 KB
tile copies by 132, 264 and 528 blocks, and the card's name and power limit.
"""

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from playaid_core_torch.ops import _build  # noqa: E402

PATTERNS = ("cp.async, 4 whole 128-byte rows a warp", "cp.async, 8 rows x 64 bytes a warp",
            "cp.async.bulk, one 16 KB copy a tile")
TILE = 16384
BUFFER_BYTES = 16 << 20
ITERS = 400


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = _build.BUILD_DIR / "libl2_bandwidth.so"
    src = os.path.join(ROOT, "tools", "torch_port_l2_bandwidth.cu")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), src], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(str(lib_path)).copy_tiles
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    buf = torch.randint(0, 255, (BUFFER_BYTES,), dtype=torch.uint8, device="cuda")
    sink = torch.empty(4096, device="cuda")
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for pattern, name in enumerate(PATTERNS):
        n_tiles = BUFFER_BYTES // TILE // (16 if pattern == 1 else 1)
        for blocks in (132, 264, 528):
            _build.check(fn(pattern, buf.data_ptr(), n_tiles, blocks, 5, sink.data_ptr()), name)
            torch.cuda.synchronize()
            start.record()
            _build.check(fn(pattern, buf.data_ptr(), n_tiles, blocks, ITERS, sink.data_ptr()),
                         name)
            stop.record()
            torch.cuda.synchronize()
            rate = blocks * ITERS * TILE / start.elapsed_time(stop) / 1e9
            print(f"{name}, {blocks} blocks: {rate:.2f} TB/s", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
