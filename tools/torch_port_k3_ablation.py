#!/usr/bin/env python3
"""Where the time of the Viterbi kernel (K3) goes, on a CUDA card.

Run from the root of a checkout on a machine with a card:
    python3 tools/torch_port_k3_ablation.py [SOURCE]

SOURCE is a K3 source, playaid_core_torch/csrc/viterbi.cu by default; the
design before its redesign for Hopper is recognised too (``git show
0df8723:playaid_core_torch/csrc/viterbi.cu > build/viterbi_0df8723.cu`` and
pass that file).  Builds five
fenced copies of it into build/kernels/ (the kernel itself gains no switch):
  (a) the kernel as it is;
  (b) the forward pass without the backtrack;
  (c) (b) without the backpointer stores;
  (d) (b) with each row's read replaced by a register constant;
  (e) (b) without either: the bare forward chain;
and times each at [2, 256, 63] (true length 240, phase 4's launch) and
[2, 14,400, 63] (the seeded match) with CUDA events over back-to-back calls
and in device time under torch.profiler.  Variants (b)-(e) compute wrong
labels; only their times mean anything.  (a)'s labels are held to
viterbi_decode_ref.

Then the chain floor (tools/torch_port_k3_chain_floor.cu): a one-warp
kernel that runs F dependent steps of only
    m = the maximum of 63 floats over the warp; carry = row + max(carry, m - cost)
(a compare and a select, as K3 keeps the stay bit), its rows read from
shared memory, with the reduction done each way a design may take: a
hardware reduction (redux.sync) over 32 lanes of 2 classes of an
order-preserving key, signed (one xor each way, K3's) or unsigned (three
operations each way, the earlier design's), or an fmaxf shuffle butterfly
over 32, 16, 8 or 4 lanes of 2, 4, 8 or 16 classes.  Cycles a step from clock64() inside the kernel and
microseconds a step from CUDA events.  The floor times the steps of a shape
is K3's latency bound at that shape.  Prints the card's name and power
limit, and a JSON summary as its last line.
"""

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (  # noqa: E402
    CHAIN_FLOORS,
    MATCH_ROWS,
    SWITCH_COST,
    chain_floor,
    device_ms,
    load_chain_floor,
    nvidia_smi_line,
    start_chain_floor_build,
    time_cuda,
)
from playaid_core_torch.ops import _build  # noqa: E402
from playaid_core_torch.ops import viterbi as k3  # noqa: E402

# macro: [(text of the kernel, what replaces it under the macro), ...], one
# alternative for each design; exactly one must appear, once.
CUTS = {
    "SKIP_BACKTRACK": [
        # 0df8723: lane 0 walks the steps back.
        ("  if (lane == 0) {\n    int cur = last;\n    out[n - 1] = cur;\n", "  if (false) {\n"
         "    int cur = last;\n    out[n - 1] = cur;\n"),
        # Now: the warp walks the 32-step groups back.
        ("  backtrack<K>(s_words, s_from, g_words, g_from, out, n, last, cap, lane);\n", ""),
    ],
    "SKIP_STORES": [
        ("        if (lane == 0) {\n          const int s = t - 1;\n",
         "        if (false) {\n          const int s = t - 1;\n"),
        ("    flush<K>(shared ? s_words + (size_t)g * 32 * K : g_words + (size_t)(g - cap) * 32 * K,\n"
         "             shared ? s_from + (size_t)g * 32 : g_from + (size_t)(g - cap) * 32, stay_words,\n"
         "             from_mine, lane);\n", ""),
    ],
    "SKIP_ROWS": [
        ("        load_row<K>(ring[j], x, t + D, n, a, lane);\n",
         "#pragma unroll\n        for (int k = 0; k < K; ++k)\n"
         "          ring[j][k] = lane + 32 * k < a ? -1.0f : -CUDART_INF_F;\n"),
        ("  for (int k = 0; k < K; ++k) row[k] = valid[k] ? srow[col[k]] : -CUDART_INF_F;\n",
         "  for (int k = 0; k < K; ++k) row[k] = valid[k] ? -1.0f : -CUDART_INF_F;\n"),
    ],
}
VARIANTS = {
    "(a) as is": [],
    "(b) no backtrack": ["SKIP_BACKTRACK"],
    "(c) no backtrack, no backpointer stores": ["SKIP_BACKTRACK", "SKIP_STORES"],
    "(d) no backtrack, rows a register constant": ["SKIP_BACKTRACK", "SKIP_ROWS"],
    "(e) no backtrack, no stores, rows a constant": ["SKIP_BACKTRACK", "SKIP_STORES",
                                                     "SKIP_ROWS"],
}
EARLIER_MARK = "load_row<K>(ring[j], x, t + D, n, a, lane);"


def ablated_source(text):
    for macro, alternatives in CUTS.items():
        found = [(old, new) for old, new in alternatives if text.count(old) == 1]
        if len(found) != 1:
            raise RuntimeError(f"{macro}: the source holds {len(found)} of its cuts once, not 1")
        old, new = found[0]
        text = text.replace(old, f"\n#ifndef {macro}\n{old}#else\n{new}#endif\n")
    return text


def nvcc(src, lib, macros=()):
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *(f"-D{m}" for m in macros), "-o", str(lib),
           str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build(text):
    """Every variant of K3, one nvcc each, and the chain floor, all at once."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "viterbi_ablation.cu"
    src.write_text(ablated_source(text))
    procs = {name: (lib, nvcc(src, lib, macros)) for i, (name, macros) in
             enumerate(VARIANTS.items())
             for lib in [_build.BUILD_DIR / f"libviterbi_ablation{i}.so"]}
    floor = start_chain_floor_build()
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        if name == "(a) as is":
            print(f"ptxas, {name}:\n{out.strip()}", flush=True)
        libs[name] = ctypes.CDLL(str(lib))
    return libs, load_chain_floor(floor)


def earlier_call(fn, lp, true_len, cost):
    """A call of 0df8723's entry point: every step's K stay masks and 16-bit
    from, the first cap steps in shared memory, the rest spilled."""
    b, f, a = lp.shape
    k = 1
    while 32 * k < a:
        k *= 2
    cap = min(f - 1, k3._SMEM_BYTES // (4 * k + 2))
    spill = f - 1 - cap
    masks = torch.empty((b, max(spill, 1), k), dtype=torch.int32, device=lp.device)
    froms = torch.empty((b, max(spill, 1)), dtype=torch.int16, device=lp.device)
    labels = torch.empty((b, f), dtype=torch.int64, device=lp.device)
    _build.check(fn(lp.data_ptr(), None, max(min(int(true_len), f), 0), float(cost),
                    labels.data_ptr(), masks.data_ptr(), froms.data_ptr(), b, f, a, cap, spill,
                    torch.cuda.current_stream().cuda_stream), "0df8723's viterbi_decode")
    return labels


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        ROOT, "playaid_core_torch", "csrc", "viterbi.cu")
    text = open(path).read()
    earlier = EARLIER_MARK in text
    design = "0df8723" if earlier else "current"
    card = nvidia_smi_line()
    print(f"card: {card}; source {path} ({design} design)", flush=True)
    libs, floor = build(text)
    dev = torch.device("cuda")
    short = torch.log_softmax(torch.from_numpy(np.random.default_rng(5).normal(
        0.0, 3.0, (2, 256, 63)).astype(np.float32)), dim=2).to(dev)
    match = torch.log_softmax(torch.from_numpy(np.random.default_rng(3).normal(
        0.0, 3.0, (2, MATCH_ROWS, 63)).astype(np.float32)), dim=2).to(dev)
    shapes = [("[2, 256, 63], true length 240", short, 240, 100, 40),
              ("[2, 14400, 63]", match, MATCH_ROWS, 8, 4)]
    summary = {"card": card, "design": design, "source": path, "variants": {}, "floor": {}}
    for name, macros in VARIANTS.items():
        fn = getattr(libs[name], "viterbi_decode")
        fn.argtypes, fn.restype = k3._ARGTYPES, ctypes.c_int
        for what, lp, n, iters, dev_iters in shapes:
            def call(_):
                if earlier:
                    return earlier_call(fn, lp, n, SWITCH_COST)
                return k3.launch(fn, lp, n, SWITCH_COST)

            if not macros:
                same = torch.equal(call(0), k3.viterbi_decode_ref(lp, n, SWITCH_COST))
                print(f"{name} {what}: labels identical to viterbi_decode_ref: {same}",
                      flush=True)
                if not same:
                    return 1
            ms = time_cuda(torch, call, iters)
            dms, _ = device_ms(torch, call, dev_iters, "viterbi", 1)
            us = None if dms is None else dms * 1e3 / n
            summary["variants"].setdefault(name, {})[what] = {
                "call_ms": ms, "device_ms": dms, "device_us_per_step": us}
            print(f"{name} {what}: call {ms:.4f} ms, device "
                  f"{'not measured' if dms is None else f'{dms:.4f} ms'}, "
                  f"{'not measured' if us is None else f'{us:.4f} us'} a step", flush=True)

    for v, name in enumerate(CHAIN_FLOORS):
        for steps, iters in ((240, 200), (MATCH_ROWS, 20)):
            cyc, us = chain_floor(torch, floor, steps, v, iters)
            summary["floor"].setdefault(name, {})[steps] = {"cycles_per_step": cyc,
                                                             "event_us_per_step": us}
            print(f"chain floor, {name}, {steps} steps: {cyc:.1f} cycles a step (clock64), "
                  f"{us:.4f} us a step (events, launch included)", flush=True)
    print(card)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
