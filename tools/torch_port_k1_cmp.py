#!/usr/bin/env python3
"""K1 (csrc/crop_resize.cu) against the design before it, on a CUDA card.

Run from the root of a checkout on a machine with a card:
    python3 tools/torch_port_k1_cmp.py [--parent SOURCE] [--out DIR]

SOURCE is the crop kernel of commit 45b0240, the design before
channels-first crops (``git show
45b0240:playaid_core_torch/csrc/crop_resize.cu > build/k1_parent/crop_resize.cu``,
the default path; it writes channels-last crops and stages each band's tap
rows through shared memory).  Builds it and copies of the kernel as it is
into build/k1_cmp/, one nvcc each, all at once, which differ only in the
lines COPIES replaces (the kernel itself gains no switch): "now" (as it
is: 64 threads, a lane loading the taps of 2 column groups at once), "g1"
and "g4" (1 and 4 column groups at once) and "t128" (128 threads: four
warps a block, each an output row).  The SASS of "now" goes to DIR/k1_sass_now.txt
(cuobjdump; DIR is build/k1_cmp by default).  Then, at
each route's shapes (the frames entry at phase 5's 48 crops of 1080p frames
and phase 2's edge boxes and 30-px crops; the shared-frame route of phase
16 (c): one 1080p frame, two crops; the window entry at phase 5's and 8's
96 windows of 384^2 and phase 2's edge origins; the bank entry at phase
11's 112 RGBA sprite rows with mirrors and 16 RGB stage rows):
  - the values of every copy against the parent's, bit for bit (the frames
    and window entries' channels-first storage read through its
    [n, S, S, 3] view, the parent's channels-last storage as it is), and
    against the plain PyTorch version;
  - the storage: channels first for the frames and window entries,
    channels last for the bank entry;
  - each copy's call ms (CUDA events over back-to-back launches with their
    arguments built in advance) and device ms (the exported profiler
    trace), in turns parent, the copies, the copies backwards, parent;
    F.grid_sample's call ms at the same points.
Then the host time of the frames wrapper (ops/crop_kernel.square_crop_resize)
at 2 and 48 crops, split: the whole call, the bare ctypes launch (and the
ctypes call alone, at 0 frames, which returns before the launch), and each
step the wrapper takes on the host, microseconds a call over many calls;
and a cProfile of the wrapper (DIR/k1_cmp_cprofile.txt).  Prints
the card's name and power limit and a JSON summary as its last line.
"""

import argparse
import cProfile
import ctypes
import io
import json
import os
import pstats
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (  # noqa: E402
    CHUNK,
    CROP,
    HEIGHT,
    NUM_FRAMES,
    PADDING,
    STRIDE,
    WIDTH,
    WINDOW,
    device_ms,
    fighter_boxes,
    grid_sample_inputs,
    nvidia_smi_line,
    render_frames,
    time_cuda,
)
from playaid_core_torch.infer.vod_pipeline import extract_windows  # noqa: E402
from playaid_core_torch.ops import _build  # noqa: E402
from playaid_core_torch.ops import crop_kernel  # noqa: E402
from playaid_core_torch.ops.preprocess import (  # noqa: E402
    batched_bank_resize,
    batched_square_crop_resize,
    batched_window_resize,
)

SOURCE = os.path.join(ROOT, "playaid_core_torch", "csrc", "crop_resize.cu")
PARENT = os.path.join(ROOT, "build", "k1_parent", "crop_resize.cu")
OUT = os.path.join(ROOT, "build", "k1_cmp")
GROUPS = "constexpr int GROUPS = 2;"
COPIES = {"now": [],
          "g1": [(GROUPS, "constexpr int GROUPS = 1;")],
          "g4": [(GROUPS, "constexpr int GROUPS = 4;")],
          "t128": [("constexpr int THREADS = 64;", "constexpr int THREADS = 128;")]}
ORDER = ("parent", *COPIES, *reversed(COPIES), "parent")
SETS = 8          # frame batches of the frames entry, past the 50 MB L2 together
HOST_CALLS = 2000


def build(parent, out_dir):
    """One nvcc for each copy, all at once; {tag: ctypes library}."""
    os.makedirs(OUT, exist_ok=True)
    with open(SOURCE) as f:
        text = f.read()
    sources = {"parent": parent}
    for tag, cuts in COPIES.items():
        copy = text
        for old, new in cuts:
            assert copy.count(old) == 1, old
            copy = copy.replace(old, new)
        path = os.path.join(OUT, f"crop_resize_{tag}.cu")
        with open(path, "w") as f:
            f.write(copy)
        sources[tag] = path
    procs = {}
    for tag, src in sources.items():
        lib = os.path.join(OUT, f"libk1_{tag}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src]
        procs[tag] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for tag, (lib, proc) in procs.items():
        log_text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {tag}:\n{log_text}")
        for line in log_text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {tag}: {line.strip()}")
        libs[tag] = ctypes.CDLL(lib)
        if tag == "now":
            sass = subprocess.run([os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump"),
                                   "-sass", lib], capture_output=True, text=True).stdout
            with open(os.path.join(out_dir, "k1_sass_now.txt"), "w") as f:
                f.write(sass)
        for entry, types in crop_kernel._ARGTYPES.items():
            fn = getattr(libs[tag], entry)
            fn.argtypes, fn.restype = types, ctypes.c_int
    return libs


def stream():
    return torch.cuda.current_stream().cuda_stream


class Case:
    """One launch's inputs, and how each entry is called on them."""

    def __init__(self, name, entry, inputs, out_shape, planar, args, plain, lib_args=None,
                 sets=1):
        self.name, self.entry, self.inputs, self.planar = name, entry, inputs, planar
        self.out_shape, self.args, self.plain = out_shape, args, plain
        self.lib_args, self.sets = lib_args, sets

    def launch(self, lib, k=0, planar=None):
        """Launch lib's entry on set k (writing planar storage unless planar
        is False: the parent's); the output as [n, S, S, C]."""
        planar = self.planar if planar is None else planar
        n, s, c = self.out_shape[0], self.out_shape[1], self.out_shape[3]
        out = torch.empty((n, c, s, s) if planar else (n, s, s, c), dtype=torch.float32,
                          device="cuda")
        _build.check(getattr(lib, self.entry)(*self.args(k, out)), f"{self.name} launch")
        return out.permute(0, 2, 3, 1) if planar else out


def frames_case(name, frames, boxes, size, padding, bgr, sets):
    """The frames entry on sets of (frames [N, H, W, 3], boxes [N, K, 4])."""
    n, h, w = frames[0].shape[:3]
    per = boxes[0].shape[1]

    def args(k, out):
        return (frames[k].data_ptr(), boxes[k].data_ptr(), out.data_ptr(), n, per, h, w, size,
                float(padding), int(bgr), 1, stream())

    def plain(k):
        return batched_square_crop_resize(frames[k], boxes[k], size, padding, bgr,
                                          True).reshape(-1, size, size, 3)

    return Case(name, "crop_resize", (frames, boxes), (n * per, size, size, 3), True, args,
                plain, sets=sets)


def window_case(name, wins, origins, sets):
    m, h, w = wins[0].shape[:3]

    def args(k, out):
        return (wins[k].data_ptr(), origins[k].data_ptr(), out.data_ptr(), m, h, w, CROP, 1, 1,
                stream())

    def plain(k):
        o = origins[k]
        return batched_window_resize(wins[k].flip(-1), o[:, 0], o[:, 1], o[:, 2], CROP)

    return Case(name, "window_resize", (wins, origins), (m, CROP, CROP, 3), True, args, plain,
                sets=sets)


def bank_case(name, bank, rows, origins, flip):
    m, h, w, c = bank.shape
    n = rows.shape[0]

    def args(k, out):
        return (bank.data_ptr(), rows.data_ptr(), origins.data_ptr(),
                None if flip is None else flip.data_ptr(), out.data_ptr(), m, n, h, w, c, CROP,
                stream())

    def plain(k):
        return batched_bank_resize(bank, rows, origins, CROP, flip)

    return Case(name, "bank_resize", (bank,), (n, CROP, CROP, c), False, args, plain)


def make_cases(dev):
    boxes_all = fighter_boxes(NUM_FRAMES)
    sampled = np.arange(0, NUM_FRAMES, STRIDE)
    per_chunk = CHUNK // STRIDE
    host = np.empty((SETS * per_chunk, HEIGHT, WIDTH, 3), np.uint8)
    render_frames(sampled[:len(host)], NUM_FRAMES, host)
    frames = [torch.from_numpy(host[k * per_chunk:(k + 1) * per_chunk]).to(dev)
              for k in range(SETS)]
    boxes = [torch.from_numpy(boxes_all[sampled[k * per_chunk:(k + 1) * per_chunk]]).to(dev)
             for k in range(SETS)]
    cases = [frames_case("frames, 48 crops (phase 5)", frames, boxes, CROP, PADDING, True, SETS)]
    edge = torch.tensor([[0, 0, .2, .3], [1, 1, .2, .3], [0, .5, .25, .25], [1, .5, .25, .25],
                         [.5, 0, .25, .25], [.5, 1, .25, .25], [0, 1, .3, .3], [1, 0, .3, .3]],
                        dtype=torch.float32, device=dev)
    cases.append(frames_case("frames, 8 edge boxes (phase 2)", [frames[0][:8].contiguous()],
                             [edge[:, None].contiguous()], CROP, PADDING, True, 1))
    odd = torch.tensor([[0.5, 0.5, 1.5, 1.2], [0.02, 0.98, 0.8, 0.8], [0.5, 0.5, 0, 0]],
                       device=dev)
    cases.append(frames_case("frames, 30-px crops of oversized windows (phase 2)",
                             [frames[0][:3, :90, :160].contiguous()], [odd[:, None].contiguous()],
                             30, 6, False, 1))
    shared = [(frames[k][:1].contiguous(), boxes[k][:1].contiguous()) for k in range(SETS)]
    cases.append(frames_case("shared frame, 1 frame x 2 crops (phase 16 (c))",
                             [f for f, _ in shared], [b for _, b in shared], CROP, PADDING, True,
                             SETS))
    cases[-1].lib_args = [grid_sample_inputs(torch, f, b) for f, b in shared]
    cases[0].lib_args = [grid_sample_inputs(torch, frames[k], boxes[k]) for k in range(SETS)]
    wins, origins = [], []
    for k in range(3):  # 127 MB of windows: past the L2
        w = np.empty((CHUNK, 2, WINDOW, WINDOW, 3), np.uint8)
        o = np.empty((CHUNK, 2, 3), np.float32)
        for j in range(CHUNK):
            row = (k * CHUNK + j) % len(host)
            w[j], o[j] = extract_windows(host[row], boxes_all[sampled[row]], WINDOW, PADDING)
        wins.append(torch.from_numpy(w.reshape(-1, WINDOW, WINDOW, 3)).to(dev))
        origins.append(torch.from_numpy(o.reshape(-1, 3)).to(dev))
    cases.append(window_case("windows, 96 of 384^2 (phases 5 and 8)", wins, origins, 3))
    edge_org = torch.tensor([[-20.0, -35.5, 300.0], [10.0, 5.0, 400.0], [0.0, 0.0, 0.0],
                             [-100.0, 250.0, 200.0]], device=dev)
    cases.append(window_case("windows, 4 edge origins (phase 2)", [wins[0][:4].contiguous()],
                             [edge_org], 1))
    gen = np.random.default_rng(7)
    sprites = torch.from_numpy(gen.integers(0, 256, (288, 128, 128, 4), dtype=np.uint8)).to(dev)
    rows = torch.from_numpy(gen.integers(0, 288, 112).astype(np.int32)).to(dev)
    sides = gen.uniform(96, 176, 112)
    org = np.stack([gen.uniform(-24, 24, 112), gen.uniform(-24, 24, 112), sides], 1)
    flip = torch.from_numpy((np.arange(112) % 2).astype(np.int32)).to(dev)
    cases.append(bank_case("bank, 112 RGBA sprite rows, mirrored (phase 11)", sprites, rows,
                           torch.from_numpy(org.astype(np.float32)).to(dev), flip))
    stages = torch.from_numpy(gen.integers(0, 256, (12, 192, 192, 3), dtype=np.uint8)).to(dev)
    srows = torch.from_numpy(gen.integers(0, 12, 16).astype(np.int32)).to(dev)
    sorg = np.stack([gen.uniform(0, 64, 16), gen.uniform(0, 64, 16), gen.uniform(128, 192, 16)],
                    1)
    cases.append(bank_case("bank, 16 RGB stage rows (phase 11)", stages, srows,
                           torch.from_numpy(sorg.astype(np.float32)).to(dev), None))
    return cases


def per_call_us(fn, calls=HOST_CALLS):
    """Host microseconds a call of fn() over calls calls (the card
    synchronised before and after)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def host_split(case):
    """Microseconds a call of the frames wrapper and of each of its host
    steps, on set 0 of case."""
    frames, boxes = case.inputs[0][0], case.inputs[1][0]
    dev = frames.device
    wrapper = crop_kernel.square_crop_resize
    fn = crop_kernel._library()
    out = torch.empty((boxes.shape[0], boxes.shape[1], 3, CROP, CROP), device=dev)
    n, h, w = frames.shape[:3]
    bare = (frames.data_ptr(), boxes.data_ptr(), out.data_ptr(), n, boxes.shape[1], h, w, CROP,
            float(PADDING), 1, 1, torch.cuda.current_stream(dev).cuda_stream)
    shape = boxes.shape[:-1] + (3, CROP, CROP)
    steps = {
        "wrapper": lambda: wrapper(frames, boxes, CROP, PADDING, True, True),
        "bare ctypes launch": lambda: fn(*bare),
        "bare ctypes call, no launch (0 frames)": lambda: fn(*bare[:3], 0, *bare[4:]),
        "torch.cuda.current_stream(dev).cuda_stream": lambda: torch.cuda.current_stream(
            dev).cuda_stream,
        "torch.empty": lambda: torch.empty(shape, dtype=torch.float32, device=dev),
        "torch.empty(...).movedim(-3, -1)": lambda: torch.empty(
            shape, dtype=torch.float32, device=dev).movedim(-3, -1),
        "_channels_first (torch.empty_strided)": lambda: crop_kernel._channels_first(
            boxes.shape[:-1], CROP, dev),
        "_build.current_stream(dev)": lambda: _build.current_stream(dev),
        "checks and conversions": lambda: (frames.dim(), frames.shape[-1], boxes.dim(),
                                           frames.device.type, frames.dtype,
                                           frames.contiguous().data_ptr() % 16,
                                           boxes.float().contiguous().data_ptr()),
        "_library()": crop_kernel._library,
        "_build.count_launch": lambda: _build.count_launch(wrapper),
        "data_ptr x3": lambda: (frames.data_ptr(), boxes.data_ptr(), out.data_ptr()),
    }
    split = {}
    for mode in ("plain", "inference_mode"):
        with torch.inference_mode(mode == "inference_mode"):
            split[mode] = {k: per_call_us(f) for k, f in steps.items()}
    return split


def main():
    if not torch.cuda.is_available():
        print("torch_port_k1_cmp: no CUDA device", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", default=PARENT)
    parser.add_argument("--out", default=OUT)
    args = parser.parse_args()
    os.makedirs(args.out, exist_ok=True)
    card = nvidia_smi_line()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    libs = build(args.parent, args.out)
    print(f"built the parent and {len(COPIES)} copies in {time.perf_counter() - t0:.1f} s")
    cases = make_cases(dev)
    summary = {"card": card, "torch": torch.__version__, "cases": {}}
    for case in cases:
        row = {}
        with torch.inference_mode():
            ref = case.launch(libs["parent"], planar=False)
            for tag in COPIES:
                got = case.launch(libs[tag])
                row[f"{tag}_identical"] = bool(torch.equal(got, ref))
            got = case.launch(libs["now"])
            if case.planar:
                row["storage"] = "channels first" if got.permute(0, 3, 1, 2).is_contiguous() \
                    else "other"
            else:
                row["storage"] = "channels last" if got.is_contiguous() else "other"
            row["plain_max_abs_err"] = float((got - case.plain(0)).abs().max())
            for tag in ORDER:
                lib, planar = libs[tag], case.planar and tag != "parent"
                ms = time_cuda(torch, lambda it: case.launch(lib, it % case.sets, planar), 60)
                dms, per = device_ms(torch, lambda it: case.launch(lib, it % case.sets, planar),
                                     60, "crop_resize_kernel", 1)
                row.setdefault(f"{tag}_ms", []).append(ms)
                row.setdefault(f"{tag}_device_ms", []).append(dms)
            if case.lib_args is not None:
                row["grid_sample_ms"] = time_cuda(torch, lambda it: F.grid_sample(
                    *case.lib_args[it % len(case.lib_args)], mode="bilinear",
                    padding_mode="zeros", align_corners=False), 60)
        summary["cases"][case.name] = row
        print(f"{case.name}: {json.dumps(row)}; {card}", flush=True)
    for case in (cases[3], cases[0]):
        split = host_split(case)
        summary["cases"][case.name]["host_us"] = split
        print(f"{case.name}: host us a call {json.dumps(split)}; threads "
              f"{threading.active_count()}; {card}", flush=True)
    prof = cProfile.Profile()
    frames, boxes = cases[3].inputs[0][0], cases[3].inputs[1][0]
    with torch.inference_mode():
        prof.enable()
        for _ in range(HOST_CALLS):
            crop_kernel.square_crop_resize(frames, boxes, CROP, PADDING, True, True)
        prof.disable()
    torch.cuda.synchronize()
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(14)
    with open(os.path.join(args.out, "k1_cmp_cprofile.txt"), "w") as f:
        f.write(text.getvalue())
    print(card, flush=True)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
