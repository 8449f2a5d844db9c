"""BENCHMARK.json names only files that exist, and a cell is added by files
and entries alone."""

import os
import re

import pytest

from portbench.tests.helpers import benchmark
from portbench.catalog import Catalog

BENCH = benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CATALOG = Catalog(BENCH)


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file(entry):
    config = CATALOG.config(entry["name"])
    assert NAME.match(entry["name"]) and entry["file"].startswith("portbench/")
    assert config["name"] == entry["name"] and config["reduced"] == entry["reduced"]
    assert config["source"] == entry["source"]
    assert config["dtype"] == "float32" and config["tf32"] is False
    family = CATALOG.family(config["family"])
    assert all(callable(getattr(family, f)) for f in (
        "weights", "embed", "head", "embed_flops", "head_flops", "k2_blocks"))


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files(cell):
    assert NAME.match(cell["name"]) and cell["chips"] == 1 and len(cell["why"]) <= 200
    traffic = CATALOG.traffic(cell["traffic"])
    assert CATALOG.module("routes", traffic["route"]).Route
    assert set(CATALOG.limits(cell["name"])) == {"lp_err", "label_mismatch", "conf_err"}
    assert any(m["name"] == "setup_s" for m in CATALOG.metrics_of(cell["name"], 0))
    assert len(CATALOG.metrics_of(cell["name"], 0)) >= 2
    assert CATALOG.metrics_of(cell["name"], 1)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader(metric):
    assert NAME.match(metric["name"]) and metric["better"] in ("lower", "higher")
    assert callable(CATALOG.module("metrics", metric["name"]).read)
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        e2e = {m["name"]: m for m in BENCH["end_to_end"]}
        moved = e2e[metric["moves"]]
        for cell in metric["workloads"]:
            assert cell in moved.get("workloads", [cell])


def test_pair_of_config_and_traffic_once():
    pairs = [(c["config"], c["traffic"]) for c in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_cell_defined_in_a_fixture_alone(tiny):
    """The fixture's cells are found from its own files; nothing under
    portbench/ names them."""
    assert tiny.traffic(tiny.workload("tiny.match")["traffic"])["frames_per_vod"] == 96
    assert tiny.limits("tiny.match")["label_mismatch"]["limit"] == 0
    assert [m["name"] for m in tiny.metrics_of("tiny.match", 0)] == ["setup_s",
                                                                    "vod_frames_per_s"]
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert not os.path.exists(os.path.join(here, "traffic", "tiny.json"))
