"""Where the harness finds what ``BENCHMARK.json`` names.

Everything that belongs to one configuration, traffic mix, route, metric or
cell sits in a file of its own, found by name:

* ``<cell>.config``'s file: the path in ``configs[].file``;
* ``traffic/<traffic>.json``: the traffic mix;
* ``routes/<route>.py``: the entry route the traffic file names;
* ``metrics/<metric>.py``: one reader a metric, ``read(ctx) -> float |
  None``;
* ``families/<family>.py``: what differs between model families, named by
  a configuration's ``family``: ``weights(config, seed, device, root)``,
  the reference's ``embed(crops, sd, config)`` and ``head(windows, sd,
  config)``, ``embed_flops(config)``, ``head_flops(config)`` and
  ``k2_blocks(config)``;
* ``limits/<cell>.json``: the limits of the cell's correctness numbers.

A catalog searches its base directories in order (``portbench/`` alone for
a run), so a later PR, or a test, adds a cell with new files and edits
none.
"""

from __future__ import annotations

import importlib.util
import json
import os

PORTBENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PORTBENCH)


class Catalog:
    def __init__(self, bench=None, bases=(PORTBENCH,), root=ROOT):
        self.bench = bench
        self.bases = list(bases)
        self.root = root
        self._modules = {}

    def _find(self, kind, filename):
        for base in self.bases:
            path = os.path.join(base, kind, filename)
            if os.path.exists(path):
                return path
        raise FileNotFoundError(f"no {kind}/{filename} under {self.bases}")

    def _json(self, path):
        with open(path) as f:
            return json.load(f)

    def workload(self, name):
        for cell in self.bench["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in the benchmark")

    def config(self, name):
        for entry in self.bench["configs"]:
            if entry["name"] == name:
                return self._json(os.path.join(self.root, entry["file"]))
        raise KeyError(f"no configuration {name!r} in the benchmark")

    def traffic(self, name):
        return self._json(self._find("traffic", f"{name}.json"))

    def limits(self, cell):
        return self._json(self._find("limits", f"{cell}.json"))

    def module(self, kind, name):
        """``routes/<name>.py``, ``metrics/<name>.py`` or
        ``families/<name>.py``, loaded by path (a metric's name may hold
        dots)."""
        key = (kind, name)
        if key not in self._modules:
            path = self._find(kind, f"{name}.py")
            spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]

    def family(self, name):
        """``families/<name>.py``: the model family's weights, reference and
        counts.  A family with no file raises ``FileNotFoundError``."""
        return self.module("families", name)

    def metrics_of(self, cell, trace):
        """The metrics a run of ``cell`` reports: its end-to-end metrics with
        ``trace`` 0, its per-layer metrics with ``trace`` 1."""
        e2e = [m for m in self.bench["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if not trace:
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]
