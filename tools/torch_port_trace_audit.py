#!/usr/bin/env python3
"""How often torch.profiler's trace of the port's window route misses a
host-to-device copy, and whether the trace shows why.

Run from the root of a checkout on a machine with a card:
    python3 tools/torch_port_trace_audit.py [RUNS]

Sets up chip_smoke.py's phase 8 (the scripted 480-frame log, its boxes,
frames from the numpy capture, VodAnalyzer(host_resize=False), stride 1,
chunk 48, the bench weights), then profiles RUNS argmax analyses (30 by
default) and, for each, holds the trace's host-to-device copies against
what the staging ring was handed, with chip_smoke.trace_copy_audit: copies
of windows and of origins, cudaMemcpy calls traced on the host, calls with
no copy on the device, the profiler's notes of dropped records.  Prints a
line a run, a JSON summary and the card's name and power limit.
"""

import json
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from playaid_core_torch.convert import load_npz_tree  # noqa: E402
from playaid_core_torch.infer import vod_pipeline  # noqa: E402
from playaid_core_torch.infer.pipeline import BatchedActionPipeline  # noqa: E402
from playaid_core_torch.ops import _build  # noqa: E402


def main():
    runs = int(sys.argv[1]) if len(sys.argv) > 1 else 30
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    _build.build()
    work = os.path.join(ROOT, "build", "smoke")
    os.makedirs(work, exist_ok=True)
    log_path = os.path.join(work, "match_log.txt")
    chip_smoke.write_match_log(log_path, chip_smoke.NUM_FRAMES)
    boxes = vod_pipeline.boxes_from_log(log_path, parser="python")
    vod_pipeline.BoundedSegmentDecoder.open_capture = staticmethod(
        lambda path: chip_smoke.LogClipCapture(boxes))
    chunk, win = chip_smoke.CHUNK, chip_smoke.WINDOW
    analyzer = vod_pipeline.VodAnalyzer(
        BatchedActionPipeline(device="cuda"), variables=load_npz_tree(chip_smoke.ASSET),
        host_resize=False, window=win, stride=1, chunk=chunk, decode="argmax")
    analyzer.analyze("log_clip.mp4", boxes)
    num_chunks = (chip_smoke.NUM_FRAMES + chunk - 1) // chunk
    win_bytes, org_bytes = chunk * 2 * win * win * 3, chunk * 2 * 3 * 4
    to_device = vod_pipeline.PinnedStager.to_device
    trace = os.path.join(work, "trace_audit.json")
    short = []
    for run in range(runs):
        staged = []

        def counted(stager, *arrays):
            staged.append(sum(a.nbytes for a in arrays))
            return to_device(stager, *arrays)

        vod_pipeline.PinnedStager.to_device = counted
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                analyzer.analyze("log_clip.mp4", boxes)
                wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            vod_pipeline.PinnedStager.to_device = to_device
        prof.export_chrome_trace(trace)
        audit = chip_smoke.trace_copy_audit(trace, "crop_resize")
        wins = sum(1 for b, _ in audit["h2d"] if b == win_bytes)
        orgs = sum(1 for b, _ in audit["h2d"] if b == org_bytes)
        if run == 0:
            with open(trace) as f:
                print(f"trace keys: {sorted(json.load(f))}")
        line = (f"run {run}: {wall_ms:.1f} ms; window copies {wins}/{num_chunks}, origin copies "
                f"{orgs}/{num_chunks}, staged {len(staged)}; cudaMemcpy calls traced "
                f"{audit['calls']}, with no device copy {len(audit['lost'])}; notes "
                f"{audit['notes'] or 'none'}; streams {sorted({s for _, s in audit['h2d']}, key=str)}"
                f" (K1 on {sorted(audit['kernel_streams'], key=str)})")
        print(line, flush=True)
        if wins != num_chunks or orgs != num_chunks:
            short.append({"run": run, "windows": wins, "origins": orgs,
                          "lost": len(audit["lost"]), "notes": audit["notes"]})
    print(json.dumps({"runs": runs, "short": short,
                      "short_with_a_sign": sum(1 for s in short if s["lost"] or s["notes"])}))
    print(chip_smoke.nvidia_smi_line())
    return 1 if any(not (s["lost"] or s["notes"]) for s in short) else 0


if __name__ == "__main__":
    sys.exit(main())
