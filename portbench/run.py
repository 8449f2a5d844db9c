#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell, its configuration and its traffic
are named in ``BENCHMARK.json``; every file the harness reads is found by
name (``portbench/catalog.py``).  A run:

1. sets up: the card, the port's kernels (built into the checkout's
   ``build/kernels/`` at the first run, loaded after), the model and its
   weights, the traffic's inputs from ``--seed``, and one warm-up of every
   shape the cell uses (``setup_s``);
2. with ``--trace 0``, runs VODs back to back for ``--seconds`` and reports
   the cell's end-to-end metrics; with ``--trace 1``, runs the traffic's
   few traced VODs under ``torch.profiler`` and reports its per-layer
   metrics, the device's busy time and the trace's breakdown;
3. reads the card's peak memory, frees the program's state, and checks
   what the timed path produced against the plain reference
   (``portbench/reference``), each number beside its limit
   (``portbench/limits/<cell>.json``);
4. prints one JSON line: ``correct``, ``attempted``, ``failed``,
   ``metrics``, ``device``, (``breakdown``), ``checks``.

It exits non-zero without a result when no CUDA card is present, or when
the JAX package or JAX has been imported into this process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "playaid_core_tpu")
OUT_DIR = os.path.join(ROOT, "build", "portbench")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def cache_env(root):
    """Every build and kernel cache inside the checkout, at fixed paths."""
    cache = os.path.join(root, "build", "cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")
    os.environ["USE_FLAX"] = "0"


class Context:
    """What the metric readers read: the cell, its configuration, its
    family's module and its traffic, ``setup_s``, the window's ``runs``,
    and in traced runs the ``trace`` and the ``traced`` runs."""

    def __init__(self, **kw):
        self.trace = None
        self.runs = self.traced = ()
        self.__dict__.update(kw)


def log_window(runs, cpu_s):
    """A diagnostic line: the window's VOD times and the cores this
    process used."""
    import statistics

    ms = sorted((r.end - r.start) * 1e3 for r in runs)
    q = statistics.quantiles(ms, n=20, method="inclusive") if len(ms) > 1 else ms * 19
    span = max(r.end for r in runs) - runs[0].start
    log(f"portbench: window: {len(runs)} VODs, ms a VOD p5 {q[0]:.1f} p50 {q[9]:.1f} "
        f"p95 {q[18]:.1f} max {ms[-1]:.1f}; this process {cpu_s / span:.2f} cores")


def run_cell(catalog, cell_name, seed, seconds, trace, device="cuda", t_start=None):
    """One run of a cell; returns the result dict."""
    import torch

    from portbench import tracing

    t_start = time.perf_counter() if t_start is None else t_start
    cell = catalog.workload(cell_name)
    config = catalog.config(cell["config"])
    family = catalog.family(config["family"])
    traffic = catalog.traffic(cell["traffic"])
    route = catalog.module("routes", traffic["route"]).Route(config, family, traffic, seed, device,
                                                             catalog.root, log)
    route.setup()
    setup_s = time.perf_counter() - t_start
    log(f"portbench: {cell_name} seed {seed}: set-up {setup_s:.3f} s")
    ctx = Context(cell=cell, config=config, family=family, traffic=traffic, setup_s=setup_s,
                  seed=seed)
    cuda = torch.device(device).type == "cuda"
    if trace:
        os.makedirs(OUT_DIR, exist_ok=True)
        path = os.path.join(OUT_DIR, f"trace-{cell_name}.json")
        with tracing.profiled(torch, path, cuda):
            with torch.profiler.record_function("portbench.window"):
                runs = route.run_traced()
        ctx.trace = tracing.Trace(path)
        ctx.traced = runs
    else:
        cpu0 = time.process_time()
        runs = route.run_window(seconds)
        log_window(runs, time.process_time() - cpu0)
        ctx.runs = runs
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    failed = [r for r in runs if not r.ok]
    for r in failed:
        log(f"portbench: VOD {r.vod} failed: {r.error}")
    metrics = {}
    for m in catalog.metrics_of(cell_name, trace):
        value = catalog.module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    route.release(runs)
    numbers = route.check(runs)
    limits = catalog.limits(cell_name)
    checks = {name: {"value": numbers[name], "limit": limits[name]["limit"]}
              for name in limits}
    correct = (not failed and set(limits) <= set(numbers)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": memory_peak}
    if trace:
        dev["busy_s"] = ctx.trace.busy_s
        dev["window_s"] = ctx.trace.window_s
    result = {"correct": correct, "attempted": len(runs), "failed": len(failed),
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = {"device_ops": ctx.trace.device_ops(),
                               "idle_gaps": ctx.trace.idle_gaps()}
    result["checks"] = checks
    return result


def power_line():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cache_env(ROOT)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)

    from portbench.catalog import Catalog

    catalog = Catalog(bench)
    chips = catalog.workload(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"portbench: the cell needs {chips} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    torch.cuda.set_device(0)
    result = run_cell(catalog, args.workload, args.seed, args.seconds, args.trace,
                      t_start=T_START)
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        log(f"portbench: forbidden modules were imported into this process: {found}")
        return 3
    log(f"portbench: card {power_line()}")
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
