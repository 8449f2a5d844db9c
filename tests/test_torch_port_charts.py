"""Every chart renderer of the port's ``fast`` backend against the JAX
function's array, bit for bit, on the stats of tests/synthlog.py's scripted
match at several frames; the port's arrays hash to
tests/fixtures/chart_hashes_fast.json as the JAX package's do; the
compositing helpers; the ``mpl`` backend (matplotlib imported when it
renders) against JAX's.
"""

import json
import os

import numpy as np
import pytest

from playaid_core_torch.render import charts as port_charts
from playaid_core_torch.render import compositing as port_comp
from playaid_core_torch.stats import Stats as PortStats
from playaid_core_torch.timeline import load_ground_truth_from_path as port_load
from playaid_core_torch.timeline import update_fighters_from_timeline as port_update
from playaid_core_tpu.render import charts as jax_charts
from playaid_core_tpu.render import compositing as jax_comp
from playaid_core_tpu.stats import Stats as JaxStats
from playaid_core_tpu.timeline import load_ground_truth_from_path as jax_load
from playaid_core_tpu.timeline import update_fighters_from_timeline as jax_update
from tests import test_chart_goldens
from tests.synthlog import scripted_match, write_log

FRAMES = (5, 22, 44, 71, 90, 119)
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "chart_hashes_fast.json")


@pytest.fixture(scope="module")
def replays(tmp_path_factory):
    """(port fighters, port stats, jax fighters, jax stats) at each frame of
    FRAMES, replayed in both packages."""
    log = tmp_path_factory.mktemp("port_charts") / "log.txt"
    write_log(log, scripted_match(120))
    out = {}
    for name, load, update, Stats in (("port", port_load, port_update, PortStats),
                                      ("jax", jax_load, jax_update, JaxStats)):
        gt = load(str(log))
        stats, fighters = Stats(), []
        for i in range(len(gt)):
            fighters = update(i, gt[i], fighters)
            stats.record_frame(fighters)
            if i in FRAMES:
                out.setdefault(i, {})[name] = (list(fighters), _snapshot(stats))
    return out


def _snapshot(stats):
    """A copy of the stats as they stand (the renderers read them later)."""
    import copy

    return copy.deepcopy(stats)


RENDERERS = [
    ("move_pie_chart", lambda c, f, s: c.move_pie_chart(f, s, 60)[1]),
    ("move_pie_chart_160", lambda c, f, s: c.move_pie_chart(f, s, 160)[1]),
    ("move_pie_chart_history", lambda c, f, s: c.move_pie_chart_history(f, s, 60)[1]),
    ("defensive_option_chart", lambda c, f, s: c.defensive_option_chart(f, s)[1]),
    ("move_damage_graph", lambda c, f, s: c.move_damage_graph(f, s, width=400, height=480)[1]),
    ("move_success_punished_missed_bar_graph",
     lambda c, f, s: c.move_success_punished_missed_bar_graph(f, s, width=560, height=400)[1]),
    ("disadvantage_tech_option_chart", lambda c, f, s: c.disadvantage_tech_option_chart(f, s)[1]),
    ("disadvantage_ledge_option_chart",
     lambda c, f, s: c.disadvantage_ledge_option_chart(f, s)[1]),
    ("action_chart", lambda c, f, s: c.action_chart(f, s)[1]),
    ("disadvantage_tech_history", lambda c, f, s: c.disadvantage_tech_history(f, s)),
    ("disadvantage_ledge_history", lambda c, f, s: c.disadvantage_ledge_history(f, s)),
    ("summary_card", lambda c, f, s: c.defensive_option_chart(f, s, width=1360, height=1480)[1]),
]


@pytest.mark.parametrize("name,render", RENDERERS, ids=[r[0] for r in RENDERERS])
def test_fast_renderers_equal_jax(replays, name, render):
    for frame, both in replays.items():
        (pf, ps), (jf, js) = both["port"], both["jax"]
        for a, b in zip(pf, jf):
            got, want = render(port_charts, a, ps), render(jax_charts, b, js)
            if want is None:
                assert got is None, (name, frame)
                continue
            assert got.shape == want.shape and got.dtype == want.dtype, (name, frame)
            np.testing.assert_array_equal(got, want, err_msg=f"{name} at frame {frame}")


@pytest.mark.parametrize("rotated", [False, True])
def test_bar_graph_image_equals_jax(rotated):
    args = (("Jab", "FTilt", "NAir", "DSpecial"), (3, 1, 0, 7))
    kw = dict(title="test", orientation=0.78 if rotated else 0.0, width=300, height=260)
    np.testing.assert_array_equal(port_charts.bar_graph_image(*args, **kw),
                                  jax_charts.bar_graph_image(*args, **kw))


def test_chart_hashes_match_the_fast_goldens(replays):
    """tests/test_chart_goldens.py's renders, from the port's charts on the
    port's stats, hash to the committed fast goldens."""
    log_fighters, stats = replays[119]["port"]
    render_all = test_chart_goldens._render_all
    saved = render_all.__globals__["charts"]
    render_all.__globals__["charts"] = port_charts
    try:
        current = render_all(log_fighters[0], stats)
    finally:
        render_all.__globals__["charts"] = saved
    with open(FIXTURE) as f:
        assert current == json.load(f)


def test_compositing_equals_jax():
    rng = np.random.default_rng(0)
    for _ in range(10):
        src = rng.integers(0, 256, (30, 40, 4), dtype=np.uint8)
        dst = rng.integers(0, 256, (50, 60, 4), dtype=np.uint8)
        x, y = (int(v) for v in rng.integers(-5, 55, 2))
        np.testing.assert_array_equal(port_comp.paste_on_top(src, dst.copy(), x, y),
                                      jax_comp.paste_on_top(src, dst.copy(), x, y))
        np.testing.assert_array_equal(port_comp.make_white_transparent(src.copy()),
                                      jax_comp.make_white_transparent(src.copy()))
    for s in ("abc", "abc✅", "Pokémon"):
        assert port_comp.is_ascii(s) == jax_comp.is_ascii(s)
        assert port_comp.split_text_emoji(s + " 12 ✅") == jax_comp.split_text_emoji(s + " 12 ✅")


def test_mpl_backend_equals_jax(replays):
    (pf, ps), (jf, js) = replays[71]["port"], replays[71]["jax"]
    port_charts.set_chart_backend("mpl")
    jax_charts.set_chart_backend("mpl")
    try:
        got = port_charts.defensive_option_chart(pf[0], ps)[1]
        want = jax_charts.defensive_option_chart(jf[0], js)[1]
        pie = port_charts._move_pie_chart(2, 1, 1, 60)[1]
        pie_ref = jax_charts._move_pie_chart(2, 1, 1, 60)[1]
    finally:
        port_charts.set_chart_backend("fast")
        jax_charts.set_chart_backend("fast")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pie, pie_ref)
    with pytest.raises(ValueError):
        port_charts.set_chart_backend("svg")
