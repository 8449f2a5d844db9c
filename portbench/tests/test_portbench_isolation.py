"""A run imports neither JAX nor the JAX package: a subprocess blocks them
(by whole top-level name) and runs a tiny cell through the harness, the
route, every metric reader and the reference."""

import subprocess
import sys
import textwrap

from portbench.tests.helpers import ROOT

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "playaid_core_tpu")


def test_run_imports_no_jax(tmp_path):
    script = textwrap.dedent(f"""
        import importlib.abc, json, sys
        sys.path.insert(0, {ROOT!r})
        BLOCKED = {BLOCKED!r}

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"blocked: {{name}}")
                return None

        sys.meta_path.insert(0, Block())
        import pathlib
        from portbench import calibrate, run
        from portbench.catalog import Catalog
        from portbench.tests import conftest, helpers
        bench = helpers.benchmark()
        for m in bench["end_to_end"] + bench["per_layer"]:
            Catalog(bench).module("metrics", m["name"])
        tiny = conftest.tiny.__wrapped__(pathlib.Path({str(tmp_path)!r}))
        result = run.run_cell(tiny, "tiny.match", 3, 0.1, 0, device="cpu")
        found = sorted({{m.split(".")[0] for m in sys.modules}} & set(BLOCKED))
        print(json.dumps({{"correct": result["correct"], "found": found}}))
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == '{"correct": true, "found": []}'
