"""The port's geometry, fighter, timeline and stats modules against the JAX
package on tests/synthlog.py's scripted match: every fighter field frame by
frame, the stats tree and the narration exactly, the query API, the stats
snapshots (``yaml.safe_load`` of the port's files equals the JAX files'),
the AI-output timeline from the port's own ``ai_output.yaml``, the
streaming generators, the pairings CSV and ``GTVideo``.
"""

import os

import cv2
import numpy as np
import pytest
import yaml

from playaid_core_torch import geometry, time_utils
from playaid_core_torch import fighter as port_fighter
from playaid_core_torch import stats as port_stats
from playaid_core_torch import timeline as port_tl
from playaid_core_torch.infer import ai_output
from playaid_core_tpu import fighter as jax_fighter
from playaid_core_tpu import geometry as jax_geometry
from playaid_core_tpu import stats as jax_stats
from playaid_core_tpu import time_utils as jax_time_utils
from playaid_core_tpu import timeline as jax_tl
from tests.synthlog import scripted_match, write_log

N = 120


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_stats")
    video = d / "v.mp4"
    w = cv2.VideoWriter(str(video), cv2.VideoWriter_fourcc(*"mp4v"), 60, (320, 180))
    for i in range(60):
        w.write(np.full((180, 320, 3), i * 4 % 255, np.uint8))
    w.release()
    log = d / "log.txt"
    write_log(log, scripted_match(N))
    return str(video), str(log)


def _replay(tl, stats_mod, log, log_offset=0):
    gt = tl.load_ground_truth_from_path(log, log_offset=log_offset)
    tl.precompute_timeline_projection(gt)
    stats = stats_mod.Stats()
    fighters, states = [], []
    for i in range(len(gt)):
        fighters = tl.update_fighters_from_timeline(i, gt[i], fighters)
        stats.record_frame(fighters)
        states.append([_state(f) for f in fighters])
    return fighters, stats, states


def _plain(v):
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if hasattr(v, "yolo_crop"):
        return ("crop", v.yolo_crop(), v.confidence, v.class_id)
    return v


def _state(f):
    out = {k: _plain(v) for k, v in vars(f).items()}
    for prop in ("anim_state", "status", "in_tech_situation", "in_ledge_situation"):
        out[prop] = getattr(f, prop)
    out["time_remaining"] = f.time_remaining
    try:
        out["using_damage_move"] = f.using_damage_move
    except Exception as e:  # noqa: BLE001 - compared across packages
        out["using_damage_move"] = type(e).__name__
    return out


@pytest.mark.parametrize("value", [0, 59, 60, 3599, 3600, 54321])
def test_time_utils(value):
    assert time_utils.frame_to_timestamp(value) == jax_time_utils.frame_to_timestamp(value)
    assert time_utils.frame_to_seconds(value, 30) == jax_time_utils.frame_to_seconds(value, 30)
    stamp = jax_time_utils.frame_to_timestamp(value)
    assert time_utils.timestamp_to_frame(stamp) == jax_time_utils.timestamp_to_frame(stamp)


def test_geometry_helpers():
    rng = np.random.default_rng(0)
    frame = np.zeros((180, 320, 3), np.uint8)
    for _ in range(20):
        box = tuple(float(v) for v in rng.uniform(0.05, 0.9, 4))
        p, j = geometry.YoloCrop(*box), jax_geometry.YoloCrop(*box)
        assert p.center_pixels(320, 180) == j.center_pixels(320, 180)
        assert p.square_yolo_crop_pixels(frame) == j.square_yolo_crop_pixels(frame)
        assert p.square_yolo_crop(frame) == j.square_yolo_crop(frame)
        px = tuple(float(v) for v in rng.uniform(1, 300, 4))
        assert (geometry.normalize_yolo_pixel(px, 320, 180)
                == jax_geometry.normalize_yolo_pixel(px, 320, 180))
        a = geometry.YoloCrop.from_pixel_yolo(320, 180, *px)
        b = jax_geometry.YoloCrop.from_pixel_yolo(320, 180, *px)
        assert a.yolo_crop() == b.yolo_crop()


@pytest.mark.parametrize("log_offset", [0, -2, 3])
def test_fighters_field_for_field(pair, log_offset):
    _, log = pair
    _, _, port_states = _replay(port_tl, port_stats, log, log_offset)
    _, _, jax_states = _replay(jax_tl, jax_stats, log, log_offset)
    assert len(port_states) == len(jax_states)
    for i, (p, j) in enumerate(zip(port_states, jax_states)):
        assert p == j, i


def test_fighter_helpers(pair):
    _, log = pair
    pf, _, _ = _replay(port_tl, port_stats, log)
    jf, _, _ = _replay(jax_tl, jax_stats, log)
    for a, b in zip(pf, jf):
        assert a.offset(pf[1 - a.fighter_id]) == b.offset(jf[1 - b.fighter_id])
        assert a.offset_str(pf[1 - a.fighter_id]) == b.offset_str(jf[1 - b.fighter_id])
        a.crop_confidence = b.crop_confidence = 0.5
        ia = a.interp(a, 0.25, 7)
        ib = b.interp(b, 0.25, 7)
        assert ia.crop.yolo_crop() == ib.crop.yolo_crop() and ia.frame_num == ib.frame_num
        assert str(ia) == str(ib)
    made = port_fighter.Fighter(3, yolo_string="2 0.5 0.4 0.1 0.2 0.8")
    ref = jax_fighter.Fighter(3, yolo_string="2 0.5 0.4 0.1 0.2 0.8")
    assert _state(made) == _state(ref)


def test_stats_and_narration(pair):
    _, log = pair
    pf, ps, _ = _replay(port_tl, port_stats, log)
    jf, js, _ = _replay(jax_tl, jax_stats, log)
    assert ps.stats.to_dict() == js.stats.to_dict()
    assert list(ps.stats.history.items()) == list(js.stats.history.items())
    assert len(ps.stats.history) > 5
    for a, b in zip(pf, jf):
        for move in ("ForwardSmash", "Jab", "Wait", "TechRoll", "Nothing"):
            assert ps.move_counters(a, move) == js.move_counters(b, move)
            assert ps.move_counter_str(a, move) == js.move_counter_str(b, move)
        for lo, hi in ((0, N), (10, 50), (60, 70)):
            assert sorted(ps.move_set(a, lo, hi)) == sorted(js.move_set(b, lo, hi))
            assert (sorted(ps.damage_causing_move_set(a, lo, hi))
                    == sorted(js.damage_causing_move_set(b, lo, hi)))
            assert (sorted(ps.frame_data_str(a, lo, hi).splitlines())
                    == sorted(js.frame_data_str(b, lo, hi).splitlines()))
            assert (sorted(ps.counter_summaries_str(a, lo, hi).splitlines())
                    == sorted(js.counter_summaries_str(b, lo, hi).splitlines()))
            assert (sorted(ps.punish_history(a, lo, hi).split("\n\n"))
                    == sorted(js.punish_history(b, lo, hi).split("\n\n")))
            assert (sorted(ps.success_history(a, lo, hi).split("\n\n"))
                    == sorted(js.success_history(b, lo, hi).split("\n\n")))
    assert ps.history_subset(0, N) == js.history_subset(0, N)
    assert ps.instances_of("started move") == js.instances_of("started move")
    assert ps.instances_of_hits_on_shield() == js.instances_of_hits_on_shield()


def test_write_all_stats_loads_as_jax(pair, tmp_path):
    """The port writes its snapshots without yaml; yaml.safe_load of each
    equals the JAX package's file's tree, and the port reads both back."""
    video, log = pair
    trees = {}
    for name, tl, mod in (("port", port_tl, port_stats), ("jax", jax_tl, jax_stats)):
        stats = mod.Stats(video)
        stats.output_dir = str(tmp_path / name)
        stats.write_all_stats(tl.load_ground_truth_from_path(log), [], interval=20)
        trees[name] = stats
    files = sorted(os.listdir(trees["jax"].output_dir))
    assert files == sorted(os.listdir(trees["port"].output_dir)) and len(files) == 6
    for f in files:
        with open(os.path.join(trees["port"].output_dir, f)) as a, \
                open(os.path.join(trees["jax"].output_dir, f)) as b:
            assert yaml.safe_load(a) == yaml.safe_load(b), f
    port_again = port_stats.Stats(video)
    port_again.output_dir = trees["port"].output_dir
    jax_again = jax_stats.Stats(video)
    jax_again.output_dir = trees["jax"].output_dir
    for frame in (0, 40, 100):
        assert port_again.load_stats(frame) and jax_again.load_stats(frame)
        assert port_again.stats.to_dict() == jax_again.stats.to_dict()
    ok_p, diff_p, _, _ = port_again.stat_diff(0, 100)
    ok_j, diff_j, _, _ = jax_again.stat_diff(0, 100)
    assert ok_p and ok_j and list(diff_p) == list(diff_j)
    assert port_again.get_stats(7) == (False, {})


def test_snapshot_keeps_a_null_key_and_lists(tmp_path):
    tree = {0: {"punished_action_count": {None: 2, "Jab": 1},
                "action_timeline": {3: {"starting_position_in_world": [-1.5, 0.0, 0]}}},
            "history": {3: "P1 Byleth started move Jab"}}
    path = str(tmp_path / "stats_0.yaml")
    ai_output.write(path, tree)
    with open(path) as f:
        assert yaml.safe_load(f) == tree
    assert ai_output.read(path, snapshot=True) == tree
    with pytest.raises(ValueError):
        ai_output.read(path)  # an ai_output.yaml holds neither


def _ai_tree():
    rng = np.random.default_rng(0)
    tree = {}
    for name, cls in (("Pikachu", 2), ("Joker", 3)):
        tree[name] = {i: {"crop": f"{cls} {rng.uniform(0.2, 0.8):.4f} 0.5 0.1 0.2 0.9",
                          "action": ["Jab", "Wait", "DashAttack"][i % 3],
                          "predicted_action_confidence": float(rng.uniform(50, 99))}
                      for i in range(12)}
    return tree


@pytest.mark.parametrize("max_frames", [None, 5])
def test_load_timeline_from_port_ai_output(tmp_path, max_frames):
    """The port's AIRunner writes ai_output.yaml with infer.ai_output; the
    port reads it without yaml into the timeline the JAX package reads from
    the same file with yaml."""
    path = str(tmp_path / "ai_output.yaml")
    ai_output.write(path, _ai_tree())
    port = port_tl.load_timeline_from_ai_output(path, max_frames=max_frames)
    ref = jax_tl.load_timeline_from_ai_output(path, max_frames=max_frames)
    assert port == ref and len(port) == (max_frames or 12)
    port_tl.precompute_timeline_projection(port)
    jax_tl.precompute_timeline_projection(ref)
    pf, jf = [], []
    for i in range(len(port)):
        pf = port_tl.update_fighters_from_timeline(i, port[i], pf)
        jf = jax_tl.update_fighters_from_timeline(i, ref[i], jf)
        assert [_state(f) for f in pf] == [_state(f) for f in jf]


def test_yield_generators(pair):
    video, log = pair
    port = [(i, [f.action for f in fs]) for fs, _, i in
            port_tl.yield_fighters_and_stats(port_stats.Stats(), video, log)]
    ref = [(i, [f.action for f in fs]) for fs, _, i in
           jax_tl.yield_fighters_and_stats(jax_stats.Stats(), video, log)]
    assert port == ref and len(port) == N
    port = [i for _, _, i in port_tl.yield_interval_fighters_and_stats(
        port_stats.Stats(), 10, video, log)]
    assert port == [i for _, _, i in jax_tl.yield_interval_fighters_and_stats(
        jax_stats.Stats(), 10, video, log)]


def test_pairings_and_gtvideo(pair, tmp_path):
    video, log = pair
    csv_path = tmp_path / "train.csv"
    csv_path.write_text("dir,video,log,offset\nd0,a.mp4,a.txt,5\n#skip,b,c,0\nd1,c.mp4,c.txt,-2\n")
    assert (port_tl.load_ground_truth_pairings_from_file(str(csv_path))
            == jax_tl.load_ground_truth_pairings_from_file(str(csv_path)))
    p, j = port_tl.GTVideo(video, log), jax_tl.GTVideo(video, log)
    assert p.get_fps() == j.get_fps() == 60.0
    for a, b in zip(p.get_frames(8, 3), j.get_frames(8, 3)):
        np.testing.assert_array_equal(a, b)
    assert p.get_ground_truth(2, 4) == j.get_ground_truth(2, 4)
