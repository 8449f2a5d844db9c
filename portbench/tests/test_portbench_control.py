"""The control: the reference computed in TF32, the precision below the
configurations' float32 with TF32 off, put in the program's place, fails
each cell's limits on the card, while the program passes them.  One VOD a
seed, three seeds a cell, at the cells' own sizes."""

import pytest

from portbench.tests.helpers import benchmark
from portbench import calibrate
from portbench.catalog import Catalog

BENCH = benchmark()
CELLS = [c["name"] for c in BENCH["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell):
    catalog = Catalog(BENCH)
    limits = {k: v["limit"] for k, v in catalog.limits(cell).items()}
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        r = calibrate.readings(catalog, cell, seed, vods=1, control=True)
        assert r["failed"] == 0
        assert all(r["program"][k] <= limit for k, limit in limits.items()), r
        assert any(r["control"][k] > limit for k, limit in limits.items()), r
