#!/usr/bin/env python3
"""Time chip_smoke.py phase by phase, and compare trees on one card.

    python3 tools/torch_port_smoke_phases.py run OUTDIR TREE [TREE ...]
    python3 tools/torch_port_smoke_phases.py table FILE [FILE ...]

``run`` runs ``python3 chip_smoke.py`` from each TREE in turn (an unpacked
``git archive`` of each commit to compare, e.g. parent, change, change,
parent), writing every line of its standard output, prefixed with the
seconds since that run's start, to ``OUTDIR/cmp{k}_{tree name}_stdout.txt``
(standard error beside it).  It exits with the largest exit code.

``table`` reads such files and prints the seconds of each phase: from a
phase's first line to the next phase's first line.  Phases 11 and 15 run in
child processes whose lines appear only when they end, so phase 10's span
holds phase 11's (shown as 10+11), and phase 15's own time, from its
``phase 15 in ... s`` line, is taken out of phase 14's span.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import time

PHASE = re.compile(r"(?:ok   |FAIL )?phase (\d+)")
PHASE15 = re.compile(r"phase 15 in ([0-9.]+) s")


def run(outdir, trees):
    os.makedirs(outdir, exist_ok=True)
    rcs = []
    for k, tree in enumerate(trees):
        tag = os.path.basename(os.path.normpath(tree))
        t0 = time.time()
        with open(os.path.join(outdir, f"cmp{k}_{tag}_stdout.txt"), "w") as out, \
                open(os.path.join(outdir, f"cmp{k}_{tag}_stderr.txt"), "w") as err:
            proc = subprocess.Popen([sys.executable, "chip_smoke.py"], cwd=tree,
                                    stdout=subprocess.PIPE, stderr=err, text=True)
            last = []
            for line in proc.stdout:
                out.write(f"{time.time() - t0:8.1f} {line}")
                out.flush()
                last = (last + [line.rstrip()])[-2:]
            rc = proc.wait()
        rcs.append(rc)
        print(f"run {k} {tag}: rc {rc} in {time.time() - t0:.1f} s; last: {last}", flush=True)
    return max(rcs) if rcs else 1


def phase_seconds(path):
    """{phase label: seconds} of one timestamped run, with 'start' (before
    phase 1's first line) and 'total'."""
    first, own15, end = {}, None, 0.0
    with open(path) as f:
        for line in f:
            stamp, _, text = line.strip().partition(" ")
            end = float(stamp)
            m = PHASE.match(text.strip())
            if m:
                first.setdefault(int(m.group(1)), end)
            m = PHASE15.search(text)
            if m:
                own15 = float(m.group(1))
    order = sorted(first, key=first.get)
    spans = {"start": first[order[0]] if order else end}
    for i, p in enumerate(order):
        spans[p] = (first[order[i + 1]] if i + 1 < len(order) else end) - first[p]
    if 11 in spans and 10 in spans:
        spans["10+11"] = spans.pop(10) + spans.pop(11)
    elif 10 in spans:
        spans["10+11"] = spans.pop(10)
    if own15 is not None:
        spans.pop(15, None)
        spans[14] -= own15
        spans[15] = own15
    spans["total"] = end
    return spans


def table(paths):
    runs = [phase_seconds(p) for p in paths]
    labels = ["start"] + [p for p in range(1, 16) if p not in (10, 11)]
    labels.insert(labels.index(12), "10+11")
    labels.append("total")
    print("phase " + " ".join(f"{os.path.basename(p)[:18]:>18}" for p in paths))
    for label in labels:
        cells = [f"{r[label]:18.1f}" if label in r else f"{'-':>18}" for r in runs]
        print(f"{label!s:>5} " + " ".join(cells))
    return 0


def main(argv):
    if len(argv) >= 3 and argv[0] == "run":
        return run(argv[1], argv[2:])
    if len(argv) >= 2 and argv[0] == "table":
        return table(argv[1:])
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
