#!/usr/bin/env python3
"""Readings that the correctness limits are set from, for one cell.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,... \\
        [--control 3] [--vods 2] [--out build/portbench/calibrate.jsonl]

For each seed, in this one process: the cell's set-up, ``--vods`` VODs
through the timed path (``VodAnalyzer.analyze`` at the cell's sizes), and
the correctness numbers of the program against the float32 reference; for
the first ``--control`` seeds also the control's: the reference computed
in TF32 (the precision below the configuration's float32 with TF32 off)
put in the program's place.  One JSON line a seed on standard output and
in ``--out``.  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(catalog, cell_name, seed, vods, control, device="cuda", log=print):
    """``{"program": numbers, "control": numbers or None}`` of one seed."""
    cell = catalog.workload(cell_name)
    config = catalog.config(cell["config"])
    traffic = catalog.traffic(cell["traffic"])
    route = catalog.module("routes", traffic["route"]).Route(
        config, catalog.family(config["family"]), traffic, seed, device, catalog.root, log)
    route.setup()
    runs = [route.analyze(v) for v in range(vods)]
    route.release(runs)
    t0 = time.perf_counter()
    out = {"program": route.check(runs), "check_s": time.perf_counter() - t0,
           "failed": sum(not r.ok for r in runs)}
    if control:
        out["control"] = route.check(runs, mode="tf32")
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control", type=int, default=3)
    parser.add_argument("--vods", type=int, default=2)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    from portbench.catalog import Catalog
    from portbench.run import cache_env

    cache_env(ROOT)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        catalog = Catalog(json.load(f))
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        line = {"workload": args.workload, "seed": seed,
                **readings(catalog, args.workload, seed, args.vods, i < args.control,
                           log=lambda m: print(m, file=sys.stderr))}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
