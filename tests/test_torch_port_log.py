"""The port's log path (playaid_core_torch.{timeline, fighter, geometry,
native} and ``infer.vod_pipeline.boxes_from_log``) against the JAX
package's, on the CPU, on synthetic ult_logger logs from
``tests/synthlog.py``.  Also: the copied game data is byte-identical, and
the native log parser builds with no FFmpeg library on its command line.
"""

import filecmp
import os

import numpy as np
import pytest

from playaid_core_tpu import native as jax_native
from playaid_core_tpu import timeline as jax_timeline
from playaid_core_tpu.infer.vod_pipeline import boxes_from_log as jax_boxes_from_log
from playaid_core_tpu.video import native_decoder as jax_native_decoder
from playaid_core_torch import native, timeline
from playaid_core_torch.infer.vod_pipeline import boxes_from_log
from playaid_core_torch.video import _native
from tests.synthlog import scripted_match, write_log

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_FRAMES = 120
TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def private_jax_native(tmp_path_factory):
    """The JAX package's native libraries (its log parser and decoder),
    built for this process alone.

    That package links each library straight onto its final path in a
    directory that every process shares (``/tmp/playaid_native`` by
    default), and the test files that call it run in parallel processes.
    When two of them find no library at once, both link it.  A process
    that loads the file while another link is writing it reports the
    library unavailable for the rest of its life; where the linker
    rewrites an existing output in place, a process that has already
    mapped the library may run code pages it had not touched yet from a
    half-written file.  Here the package gets a private directory and a
    fresh load at run time, before its first use in the module, so no
    other process writes the libraries the module's tests call.  The port
    test files that call the JAX libraries import this fixture.
    """
    with pytest.MonkeyPatch.context() as mp:
        for module in (jax_native, jax_native_decoder):
            mp.setattr(module, "_CACHE_DIR", str(tmp_path_factory.mktemp("jax_native")))
            mp.setattr(module, "_lib", None)
            mp.setattr(module, "_build_failed", False)
        yield


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    d = tmp_path_factory.mktemp("logs")
    plain, gap = str(d / "plain.txt"), str(d / "gap.txt")
    write_log(plain, scripted_match(NUM_FRAMES))
    write_log(gap, scripted_match(NUM_FRAMES), gap_at=50, gap_size=3)
    return {"plain": plain, "gap": gap}


def _assert_close(a, b, path="record"):
    """Equal dicts, tuples and arrays; numbers within TOL."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _assert_close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (tuple, list, np.ndarray)):
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                   rtol=0, atol=TOL, err_msg=path)
    else:
        assert abs(float(a) - float(b)) <= TOL, (path, a, b)


def test_game_data_is_a_byte_identical_copy():
    ref_dir = os.path.join(ROOT, "playaid_core_tpu", "game_data")
    port_dir = os.path.join(ROOT, "playaid_core_torch", "game_data")
    names = sorted(os.listdir(ref_dir))
    assert names == sorted(os.listdir(port_dir)) and len(names) == 9
    match, mismatch, errors = filecmp.cmpfiles(ref_dir, port_dir, names, shallow=False)
    assert match == names and not mismatch and not errors


@pytest.mark.parametrize("log_offset", [-2, 0, 3])
@pytest.mark.parametrize("log", ["plain", "gap"])
@pytest.mark.parametrize("parser", ["native", "python"])
def test_timeline_and_boxes_match_jax(logs, parser, log, log_offset):
    path = logs[log]
    ref = jax_timeline.precompute_timeline_projection(
        jax_timeline.load_ground_truth_from_path(path, log_offset=log_offset, parser=parser))
    out = timeline.precompute_timeline_projection(
        timeline.load_ground_truth_from_path(path, log_offset=log_offset, parser=parser))
    expected_frames = NUM_FRAMES - log_offset  # -N repeats the first frame N times
    assert len(out) == len(ref) == expected_frames
    for frame_out, frame_ref in zip(out, ref):
        assert len(frame_out) == len(frame_ref) == 2
        for rec_out, rec_ref in zip(frame_out, frame_ref):
            _assert_close(rec_out, rec_ref)
    boxes = boxes_from_log(path, log_offset=log_offset, parser=parser)
    ref_boxes = jax_boxes_from_log(path, log_offset=log_offset)
    assert boxes.shape == ref_boxes.shape == (expected_frames, 2, 4)
    assert boxes.dtype == np.float32
    np.testing.assert_allclose(boxes, ref_boxes, rtol=0, atol=TOL)


@pytest.mark.parametrize("log", ["plain", "gap"])
def test_native_and_python_parsers_agree(logs, log):
    path = logs[log]
    by_parser = {p: timeline.load_ground_truth_from_path(path, parser=p)
                 for p in ("native", "python", "auto")}
    assert len(by_parser["native"]) == len(by_parser["python"]) == len(by_parser["auto"])
    for frames in zip(*by_parser.values()):
        for recs in zip(*frames):
            for key in native.FIELDS[:16]:
                assert recs[0][key] == recs[1][key] == recs[2][key], key
            for cam in ("camera_position", "camera_target_position"):
                _assert_close(recs[0][cam], recs[1][cam])
    np.testing.assert_array_equal(boxes_from_log(path, parser="native"),
                                  boxes_from_log(path, parser="python"))


@pytest.mark.parametrize("precompute", [True, False])
def test_fighters_match_jax(logs, precompute):
    """Fighter.action and Fighter.crop (and the state beside them) frame by
    frame, through update_fighters_from_timeline: with the batched
    projection, and with each Fighter projecting its own record."""
    path = logs["gap"]
    ref_tl = jax_timeline.load_ground_truth_from_path(path, parser="python")
    out_tl = timeline.load_ground_truth_from_path(path, parser="native")
    if precompute:
        ref_tl = jax_timeline.precompute_timeline_projection(ref_tl)
        out_tl = timeline.precompute_timeline_projection(out_tl)
    assert all(("_pixel_crop" in rec) == precompute for frame in out_tl for rec in frame)
    ref_f, out_f = [], []
    actions = set()
    for i, (fr_ref, fr_out) in enumerate(zip(ref_tl, out_tl)):
        ref_f = jax_timeline.update_fighters_from_timeline(i, fr_ref, ref_f)
        out_f = timeline.update_fighters_from_timeline(i, fr_out, out_f)
        for a, b in zip(out_f, ref_f):
            assert a.action == b.action and a.fighter_name == b.fighter_name
            assert a.motion_hex == b.motion_hex and a.new_action == b.new_action
            assert a.animation_frame_num == b.animation_frame_num
            assert a.damage == b.damage and a.damage_delta == b.damage_delta
            np.testing.assert_allclose(a.crop.yolo_crop(), b.crop.yolo_crop(), rtol=0, atol=TOL)
            actions.add(a.action)
    assert {"ForwardSmash", "Damaged", "TechRoll", "LedgeHang", "Wait"} <= actions


def test_frame_data_matches_jax():
    from playaid_core_tpu.frame_data import FIGHTER_FRAME_DATA as ref
    from playaid_core_torch.frame_data import FIGHTER_FRAME_DATA as out

    assert out == ref and len(out) > 80
    move = next(iter(out["Byleth"]))
    assert out["Byleth"][move].startup == ref["Byleth"][move].startup
    assert not out["No Such Fighter"]["No Such Move"]  # missing keys are empty and falsy


def test_log_parser_builds_with_no_ffmpeg_flag(tmp_path, monkeypatch):
    for name in ("video_decoder", "video_encoder"):
        assert set(_native.FFMPEG_LINK) <= set(_native.command(name, tmp_path / "x.so"))
    cmd = _native.command("log_parser", tmp_path / "x.so")
    assert not [flag for flag in cmd if flag.startswith("-l")], cmd
    # A fresh build, through build(), runs exactly that command.
    ran = []
    run = _native.subprocess.run
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_native.subprocess, "run", lambda c, **kw: ran.append(c) or run(c, **kw))
    lib = _native.build("log_parser")
    assert lib.exists() and lib.parent == tmp_path
    assert len(ran) == 1 and not [f for f in ran[0] if f.startswith("-l")], ran


def test_native_parser_does_not_fall_back(logs, tmp_path, monkeypatch):
    """When g++ fails, "auto" and "native" raise with its output; only an
    explicit "python" parses."""
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_native, "_loaded", {})
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(_native, "NATIVE_SRC", tmp_path)
    (tmp_path / "log_parser.cpp").write_text("this is not C++\n")
    for parser in ("auto", "native"):
        with pytest.raises(RuntimeError, match="g\\+\\+ could not build native/log_parser.cpp:"):
            timeline.load_ground_truth_from_path(logs["plain"], parser=parser)
    assert len(timeline.load_ground_truth_from_path(logs["plain"], parser="python")) == NUM_FRAMES
    with pytest.raises(ValueError, match="parser must be"):
        timeline.load_ground_truth_from_path(logs["plain"], parser="json")


def test_a_frame_without_both_fighters_raises(tmp_path):
    """Validation raises (not an assert, which -O removes), as the JAX
    package's assert fails, on a log whose last frame has one record."""
    path = tmp_path / "odd.txt"
    write_log(path, scripted_match(4))
    lines = path.read_text().splitlines(keepends=True)
    path.write_text("".join(lines[:-1]))
    with pytest.raises(AssertionError):
        jax_timeline.load_ground_truth_from_path(str(path), parser="python")
    for parser in ("native", "python"):
        with pytest.raises(ValueError, match="2 players for every frame, found 1 for frame #3"):
            timeline.load_ground_truth_from_path(str(path), parser=parser)
        assert len(timeline.load_ground_truth_from_path(str(path), validate=False,
                                                        parser=parser)) == 4
