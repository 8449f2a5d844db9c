"""Constants and files shared by the benchmark's tests."""

import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TINY_TRAFFIC = {
    "route": "vod", "why": "a CPU-sized VOD", "frames_per_vod": 96,
    "width": 640, "height": 360, "box_px": 100, "disc_radius": 30, "bob_px": 10, "moves": 3,
    "phases": 4, "phase_frames": 5, "segment_frames": 30,
    "analyzer": {"decode_backend": "native", "transfer_format": "yuv420", "stride": 2,
                 "lowres": 0},
    "warm_frames": 48, "trace_vods": 1,
}
# Program against reference on the CPU reads lp_err about 1e-5 and conf_err
# about 1e-4 at these sizes; the faults read 0.1 and more.
TINY_LIMITS = {"lp_err": {"limit": 1e-3}, "label_mismatch": {"limit": 0},
               "conf_err": {"limit": 1e-2}}


def benchmark():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)
