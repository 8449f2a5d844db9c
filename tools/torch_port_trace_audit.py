#!/usr/bin/env python3
"""Whether torch.profiler's trace keeps the device records of the port's
host-to-device copies, and whether it shows when it has lost one.

Run from the root of a checkout on a machine with a card:
    python3 tools/torch_port_trace_audit.py window [RUNS]
    python3 tools/torch_port_trace_audit.py lead [REPEATS]
    python3 tools/torch_port_trace_audit.py synth [REPEATS]
    python3 tools/torch_port_trace_audit.py settle [REPEATS]

window (the default; RUNS 30): sets up chip_smoke.py's phase 8 (the
scripted 480-frame log, its boxes, frames from the numpy capture,
VodAnalyzer(host_resize=False), stride 1, chunk 48, the bench weights),
then profiles RUNS argmax analyses and, for each, holds the trace's
host-to-device copies against what the staging ring was handed: copies of
windows and of origins, cudaMemcpy calls traced on the host, calls with no
copy on the device, the profiler's notes of dropped records.  Prints a line
a run and a JSON summary; exits 1 if a trace came up short with no sign of
a loss.

lead (REPEATS 3): profiles four cases at the start of the process, then
runs chip_smoke.py's phases 1-8 in this process (its phase 9 is replaced by
the same four cases), so each case runs REPEATS times young and as often
late:
  copy        a lone 44,236,800 B pageable host-to-device copy;
  copy+lead   the same copy in a chip_smoke.profiled session, which first
              runs one small kernel to its end (and ends with another);
  detect x3   three detector batches of 16 720p frames (seeded weights);
  detect+lead the same three batches in a chip_smoke.profiled session.
Prints a line a profile and a summary line a case and time (profiles that
lost a record, of all).

synth (REPEATS 20): chip_smoke.py's phase 11 epoch (its synthetic tree,
written if need be, chip_smoke.synth_profile_trainer) run once, then
profiled REPEATS times in a row in this process, whose first profiles they
are; a line a session (host-to-device copies against the 3 a step, lost
calls and where they sit) and a summary line.

settle (REPEATS 10): phase 11's dataset built under chip_smoke.profiled
(device only), as chip_smoke.py --synth builds it; then, REPEATS times,
80 calls of K1's bank entry (a batch's two launches each) profiled once
with chip_smoke.profiled's pause and the opening kernels after it, and
once with its first opening kernel alone (the order alternating); a line a session (bank kernel records
against 160, kernel launches with no record on the device and where they
sit) and a summary line a variant.

Every mode prints the card's name and power limit last.
"""

import json
import os
import sys
import time
from collections import Counter

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from playaid_core_torch.convert import load_npz_tree  # noqa: E402
from playaid_core_torch.infer import vod_pipeline  # noqa: E402
from playaid_core_torch.infer.pipeline import BatchedActionPipeline  # noqa: E402
from playaid_core_torch.ops import _build  # noqa: E402
from playaid_core_torch.parallel.staging import PinnedStager  # noqa: E402
from playaid_core_torch.train.detector_train import DetectorTrainer  # noqa: E402
from playaid_core_torch.video import reader  # noqa: E402

WORK = os.path.join(ROOT, "build", "smoke")


def window(runs):
    _build.build()
    os.makedirs(WORK, exist_ok=True)
    log_path = os.path.join(WORK, "match_log.txt")
    chip_smoke.write_match_log(log_path, chip_smoke.NUM_FRAMES)
    boxes = vod_pipeline.boxes_from_log(log_path, parser="python")
    reader.open_capture = lambda path: chip_smoke.LogClipCapture(boxes)
    chunk, win = chip_smoke.CHUNK, chip_smoke.WINDOW
    analyzer = vod_pipeline.VodAnalyzer(
        BatchedActionPipeline(device="cuda"), variables=load_npz_tree(chip_smoke.ASSET),
        host_resize=False, window=win, stride=1, chunk=chunk, decode="argmax")
    analyzer.analyze("log_clip.mp4", boxes)
    num_chunks = (chip_smoke.NUM_FRAMES + chunk - 1) // chunk
    win_bytes, org_bytes = chunk * 2 * win * win * 3, chunk * 2 * 3 * 4
    to_device = PinnedStager.to_device
    trace = os.path.join(WORK, "trace_audit.json")
    short = []
    for run in range(runs):
        staged = []

        def counted(stager, *arrays):
            staged.append(sum(a.nbytes for a in arrays))
            return to_device(stager, *arrays)

        PinnedStager.to_device = counted
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                analyzer.analyze("log_clip.mp4", boxes)
                wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            PinnedStager.to_device = to_device
        prof.export_chrome_trace(trace)
        audit = chip_smoke.trace_copy_audit(trace, "crop_resize")
        wins = sum(1 for b, _ in audit["h2d"] if b == win_bytes)
        orgs = sum(1 for b, _ in audit["h2d"] if b == org_bytes)
        if run == 0:
            with open(trace) as f:
                print(f"trace keys: {sorted(json.load(f))}")
        print(f"run {run}: {wall_ms:.1f} ms; window copies {wins}/{num_chunks}, origin copies "
              f"{orgs}/{num_chunks}, staged {len(staged)}; cudaMemcpy calls traced "
              f"{audit['calls']}, with no device copy {len(audit['lost'])}; notes "
              f"{audit['notes'] or 'none'}; streams {sorted({s for _, s in audit['h2d']}, key=str)}"
              f" (K1 on {sorted(audit['kernel_streams'], key=str)})", flush=True)
        if wins != num_chunks or orgs != num_chunks:
            short.append({"run": run, "windows": wins, "origins": orgs,
                          "lost": len(audit["lost"]), "notes": audit["notes"]})
    print(json.dumps({"runs": runs, "short": short,
                      "short_with_a_sign": sum(1 for s in short if s["lost"] or s["notes"])}))
    return 1 if any(not (s["lost"] or s["notes"]) for s in short) else 0


LOST = Counter()
RUNS = Counter()


def audit_copies(session, fn, tag, when):
    path = os.path.join(WORK, f"lead_{when}_{tag.replace(' ', '_')}.json")
    os.makedirs(WORK, exist_ok=True)
    with session() as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    a = chip_smoke.trace_copy_audit(path, "conv3x3_wgmma")
    big = [b for b, _ in a["h2d"] if b is not None and b >= 65536]
    RUNS[when, tag] += 1
    LOST[when, tag] += bool(a["lost"])
    print(f"{when:5s} {tag:12s}: {a['calls']} cudaMemcpy calls, {len(a['lost'])} with no copy "
          f"on the device; host-to-device copies of >= 64 KiB {big}", flush=True)


def lead_cases(when, repeats):
    dev = torch.device("cuda")
    cap = chip_smoke.PixelsClipCapture()
    rgb = np.ascontiguousarray(np.stack([cap.read()[1] for _ in range(16)])[..., ::-1])
    trainer = DetectorTrainer(device=dev).init(0)
    kw = dict(max_det=64, score_threshold=0.0, classes=(2, 3))
    for _ in range(3):
        trainer.detect(rgb, **kw)
    host = torch.from_numpy(rgb)

    def plain():
        return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def led():
        return chip_smoke.profiled(torch)

    def three():
        for _ in range(3):
            trainer.detect(rgb, **kw)

    for _ in range(repeats):
        audit_copies(plain, lambda: host.to(dev), "copy", when)
        audit_copies(led, lambda: host.to(dev), "copy+lead", when)
        audit_copies(plain, three, "detect x3", when)
        audit_copies(led, three, "detect+lead", when)


def lead(repeats):
    lead_cases("young", repeats)
    chip_smoke.run_pixels_phase = lambda *args: lead_cases("late", repeats) or {}
    try:
        chip_smoke.main()
    except SystemExit:
        pass
    for (when, tag), n in sorted(RUNS.items()):
        print(f"summary {when:5s} {tag:12s}: {LOST[when, tag]} of {n} profiles lost a record")
    return 0


def synth(repeats):
    dev = torch.device("cuda")
    chip_smoke.write_synth_tree(chip_smoke.SYNTH_ROOT)
    trainer = chip_smoke.synth_profile_trainer(dev)
    steps = chip_smoke.WIRE_STEPS

    def run():
        trainer.fit(num_epochs=1, steps_per_epoch=steps)

    run()
    short = []
    for session in range(1, repeats + 1):
        r = chip_smoke.profile_h2d(torch, run, os.path.join(WORK, "trace_audit_synth.json"))
        print(f"session {session}: {len(r['h2d'])} of {3 * steps} host-to-device copies, "
              f"{sum(b for b in r['h2d'] if b)} B; {r['calls']} cudaMemcpy calls, {r['lost']} "
              f"with no copy on the device (call index, ms into the trace: {r['lost_at']}); "
              f"notes {r['notes'] or 'none'}; busy {r['busy_us'] / r['wall_us']:.3f}", flush=True)
        if len(r["h2d"]) != 3 * steps or r["lost"] or r["notes"]:
            short.append(session)
    print(json.dumps({"sessions": repeats, "short": short}))
    return 0


def settle(repeats):
    from playaid_core_torch.ops.crop_kernel import bank_resize

    dev = torch.device("cuda")
    clean, stages, _, _ = chip_smoke.write_synth_tree(chip_smoke.SYNTH_ROOT)
    b, t, s = chip_smoke.SYNTH_BATCH, chip_smoke.SYNTH_T, chip_smoke.CROP
    with chip_smoke.profiled(torch, cpu=False):
        data = chip_smoke.bench_tool().bench_dataset(clean, stages, chip_smoke.SYNTH_STEPS, b,
                                                     device=dev)
        torch.cuda.synchronize()
    p = data._sample_batch_params(b)
    ints = torch.from_numpy(p["ints"]).to(dev)
    floats = torch.from_numpy(p["floats"]).to(dev)
    flip = ints[:, t + 1, None].expand(b, t).reshape(-1)
    sp = (data.sprites.bank, ints[:, :t].reshape(-1),
          torch.stack([floats[:, :t].reshape(-1), floats[:, t:2 * t].reshape(-1),
                       floats[:, 2 * t:3 * t].reshape(-1)], 1), s, flip)
    st = (data.stages.bank, ints[:, t], floats[:, 3 * t:3 * t + 3], s, None)
    for _ in range(3):
        bank_resize(*sp), bank_resize(*st)
    torch.cuda.synchronize()
    trace = os.path.join(WORK, "trace_audit_settle.json")
    short, sessions = Counter(), Counter()
    for rep in range(repeats):
        pauses = (chip_smoke.PROFILE_SETTLE_S, 0.0)
        for pause in pauses if rep % 2 else pauses[::-1]:
            with chip_smoke.profiled(torch, settle_s=pause) as prof:
                for _ in range(80):
                    bank_resize(*sp), bank_resize(*st)
                torch.cuda.synchronize()
            prof.export_chrome_trace(trace)
            records = sum(1 for name, cat, *_ in chip_smoke.trace_device_events(trace)
                          if cat == "kernel" and "crop_resize_kernel" in name)
            launches, lost = chip_smoke.lost_launches(trace)
            sessions[pause] += 1
            short[pause] += records != 160
            print(f"repeat {rep}, pause {pause} s: {records} of 160 bank kernel records; "
                  f"{launches} launches, {len(lost)} with no kernel on the device (launch "
                  f"index, ms into the trace: {lost})", flush=True)
    for pause in sorted(sessions):
        print(f"summary pause {pause} s: {short[pause]} of {sessions[pause]} sessions short")
    return 0


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    mode = sys.argv[1] if len(sys.argv) > 1 else "window"
    count = int(sys.argv[2]) if len(sys.argv) > 2 else None
    if mode == "window":
        rc = window(count or 30)
    elif mode == "lead":
        rc = lead(count or 3)
    elif mode == "synth":
        rc = synth(count or 20)
    elif mode == "settle":
        rc = settle(count or 10)
    else:
        print(f"unknown mode {mode!r}: window, lead, synth or settle", file=sys.stderr)
        return 2
    print(chip_smoke.nvidia_smi_line())
    return rc


if __name__ == "__main__":
    sys.exit(main())
