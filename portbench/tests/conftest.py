"""Fixtures of the benchmark's own tests (run them with ``python -m pytest
portbench/tests``; the card's with ``-m card`` on a machine with one).

``tiny`` is a catalog that holds one more cell, ``tiny.match``, defined by
files this fixture writes alone (a traffic mix of 96-frame VODs at 640x360
and its limits) and by entries of an in-memory ``BENCHMARK.json``.
Nothing under ``portbench/`` is edited to add it.
"""

import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from portbench.tests.helpers import TINY_LIMITS, TINY_TRAFFIC, benchmark  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips on a machine without")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def tiny(tmp_path):
    """A catalog with the cell ``tiny.match`` added by files of this fixture
    and entries of an in-memory ``BENCHMARK.json``."""
    from portbench.catalog import PORTBENCH, Catalog

    bench = benchmark()
    for kind, name, body in (("traffic", "tiny", TINY_TRAFFIC),
                             ("limits", "tiny.match", TINY_LIMITS)):
        (tmp_path / kind).mkdir(exist_ok=True)
        (tmp_path / kind / f"{name}.json").write_text(json.dumps(body))
    bench["workloads"].append(
        {"name": "tiny.match", "config": "cnn63", "traffic": "tiny", "chips": 1, "why": "test"})
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if "vod_frames_per_s" in (metric["name"], metric.get("moves")):
            metric["workloads"].append("tiny.match")
    return Catalog(bench, bases=[str(tmp_path), PORTBENCH])
