"""The port's annotated-match path against the JAX package: the
annotator's labels on both text paths, ``Manuscript.render`` frame for
frame (graphs, summaries and the timer on, both fed the same in-memory
frames through a stand-in ``VideoReader`` and writing to an in-memory
stand-in writer, so no codec enters the comparison), a render through the
port's own libavcodec encoder, the command lines, the multi-VOD batch, the
audio remux, the post-game report and the inspection report.
"""

import base64
import io
import os
import re

import cv2
import numpy as np
import pytest
from PIL import Image

from playaid_core_torch.pipeline import manuscript as port_ms
from playaid_core_torch.pipeline import multi as port_multi
from playaid_core_torch.render import annotator as port_ann
from playaid_core_torch.video import native_encoder as port_encoder
from playaid_core_torch.video import native_remux as port_remux
from playaid_core_torch.video import reader as port_reader
from playaid_core_torch.video import writer as port_writer
from playaid_core_torch.viz import manuscript_vis as port_vis
from playaid_core_torch.viz import postgame_report as port_report
from playaid_core_tpu.pipeline import manuscript as jax_ms
from playaid_core_tpu.render import annotator as jax_ann
from playaid_core_tpu.video import native_remux as jax_remux
from playaid_core_tpu.viz import manuscript_vis as jax_vis
from playaid_core_tpu.viz import postgame_report as jax_report
from tests.synthlog import scripted_match, write_log

W, H, N = 320, 180, 60


def _frames(n=N, w=W, h=H):
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        frame = np.full((h, w, 3), (i * 2) % 255, np.uint8)
        frame[:20, :20] = rng.integers(0, 255, (20, 20, 3), dtype=np.uint8)
        out.append(frame)
    return out


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    """test_manuscript_e2e.py's fixture: a 320x180 mp4v clip of 60 frames
    and the scripted match's log."""
    d = tmp_path_factory.mktemp("port_e2e")
    video_path, log_path = str(d / "match.mp4"), str(d / "match_log.txt")
    writer = cv2.VideoWriter(video_path, cv2.VideoWriter_fourcc(*"mp4v"), 60, (W, H))
    for frame in _frames():
        writer.write(frame)
    writer.release()
    write_log(log_path, scripted_match(N))
    return d, video_path, log_path


def _stand_ins(frames, fps=60.0):
    class Reader:
        def __init__(self, path):
            self.fps, self.frame_count = fps, len(frames)
            self.height, self.width = frames[0].shape[:2]

        def iter_frames(self, start=0, stop=None):
            for i in range(start, len(frames) if stop is None else min(stop, len(frames))):
                yield i, frames[i].copy()

        def release(self):
            pass

    class Writer:
        opened = []

        def __init__(self, path, fps, width, height, codec=None):
            self.frames, self.size = [], (width, height)
            Writer.opened.append(self)

        def write(self, frame, copy=True):
            self.frames.append(frame.copy())

        def release(self):
            pass

    return Reader, Writer


def _render(ms_mod, ann_mod, monkeypatch, frames, log_path, label_suffix="", **kw):
    Reader, Writer = _stand_ins(frames)
    monkeypatch.setattr(ms_mod, "VideoReader", Reader)
    monkeypatch.setattr(ann_mod, "VideoWriter", Writer)
    # Hold each post-game summary for 2 frames instead of 180.
    monkeypatch.setattr(ann_mod.Annotator, "write_num_seconds",
                        lambda self, n: [self.write() for _ in range(2)])
    if label_suffix:
        label = ms_mod.Manuscript.fighter_label
        monkeypatch.setattr(ms_mod.Manuscript, "fighter_label",
                            lambda self, f, i: label(self, f, i) + label_suffix)
    m = ms_mod.Manuscript("/clips/match.mp4", "/clips/out.mp4", ground_truth_path=log_path,
                          include_audio=False, progress=False, **kw)
    m.render()
    return Writer.opened[-1].frames, m


CASES = {
    "graphs_summaries_timer": dict(show_timer=True),
    "no_graphs": dict(skip_graphs=True, skip_summaries=True),
    "window_refresh": dict(start_frame=10, max_frames=40, chart_refresh=3,
                           skip_summaries=True),
    "pil_labels": dict(show_timer=True, label_suffix=" ✅"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_render_equals_jax_frame_for_frame(fixture_dir, monkeypatch, case):
    _, _, log_path = fixture_dir
    frames = _frames()
    kw = dict(CASES[case])
    got, m = _render(port_ms, port_ann, monkeypatch, frames, log_path, **kw)
    want, _ = _render(jax_ms, jax_ann, monkeypatch, frames, log_path, **kw)
    assert len(got) == len(want) > 0
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, i
        np.testing.assert_array_equal(a, b, err_msg=f"{case}: frame {i}")
    if not kw.get("skip_graphs"):
        assert got[0].shape == (H + 400, W + 800, 4)
        assert got[0][:, :400].mean() > 5  # the side panels drew into the padding
    if case == "graphs_summaries_timer":
        assert len(got) == N + 10 and m.stats.stats[0].action_count["Wait"] >= 1


@pytest.mark.parametrize("shape", [(180, 320), (720, 1280), (1080, 1920)])
@pytest.mark.parametrize("label", ["Wait | #12 | startup", "Jab ✅", ""])
def test_box_label_equals_jax(shape, label):
    """Both text paths at the default line width of each frame size, boxes
    drawn and not, labels inside and above the box."""
    rng = np.random.default_rng(shape[0])
    frame = np.ascontiguousarray(rng.integers(0, 256, shape + (4,), dtype=np.uint8))
    boxes = [(10, 5, 120, 90), (shape[1] - 60, shape[0] // 2, shape[1] - 2, shape[0] - 3),
             (50, 60, 70, 80)]
    outs = []
    for mod in (port_ann, jax_ann):
        a = mod.Annotator.__new__(mod.Annotator)
        a.input_width, a.input_height = shape[1], shape[0]
        a._text_font = None
        a.set_frame(frame.copy())
        for k, box in enumerate(boxes):
            a.box_label(box, label=label, color=(25, 58, 115) if k else (201, 99, 48),
                        draw_box=k != 1)
        outs.append(np.asarray(a.result()))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_render_through_the_native_encoder(fixture_dir, tmp_path):
    """The real reader (cv2's capture here) and the port's libavcodec
    writer: the file has every frame and the padded canvas, 800 px wider and
    400 px taller than the input, as the JAX package's has."""
    _, video_path, log_path = fixture_dir
    out = str(tmp_path / "out.mp4")
    port_ms.Manuscript(video_path, out, ground_truth_path=log_path, start_frame=10,
                       max_frames=30, skip_summaries=True, include_audio=False,
                       progress=False).render()
    cap = cv2.VideoCapture(out)
    assert int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)) == W + 800
    assert int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)) == H + 400
    n = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if n == 0:
            assert frame[:, :400].mean() > 5
        n += 1
    cap.release()
    assert n == 20


def test_command_line_writes_the_video(fixture_dir, tmp_path, capsys):
    _, video_path, log_path = fixture_dir
    out = str(tmp_path / "cli_out.mp4")
    port_ms.main(["--video-path", video_path, "--log-path", log_path, "--output-path", out,
                  "--frames", "0,20", "--skip-graphs", "--skip-summaries"])
    assert "COMPLETED" in capsys.readouterr().out
    cap = cv2.VideoCapture(out)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 20
    assert int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)) == W
    cap.release()


def test_multi_batch(fixture_dir, tmp_path):
    """run_batch renders its jobs (a bad one reports its error) and
    jobs_from_pairings reads the pairings CSV as the JAX module does."""
    _, video_path, log_path = fixture_dir
    jobs = [dict(input_video_path=video_path, output_video_path=str(tmp_path / f"{i}.mp4"),
                 ground_truth_path=log_path, max_frames=8, skip_summaries=True,
                 include_audio=False, progress=False) for i in range(2)]
    jobs.append(dict(input_video_path=video_path, output_video_path=str(tmp_path / "bad.mp4"),
                     progress=False))
    results = dict(port_multi.run_batch(jobs, workers=2))
    assert results[str(tmp_path / "0.mp4")] is None and results[str(tmp_path / "1.mp4")] is None
    assert "ground_truth_path or ai_output_path" in results[str(tmp_path / "bad.mp4")]
    csv_path = tmp_path / "train.csv"
    csv_path.write_text("dir,video,log,offset\nd0,a.mp4,a.txt,5\nd1,c.mp4,c.txt,-2\n")
    from playaid_core_tpu.pipeline import multi as jax_multi

    kw = dict(pairings_file=str(csv_path), output_dir="/out", skip_graphs=True)
    stamp = re.compile(r"_[0-9-]+\.mp4$")  # the time the jobs were made

    def unstamped(jobs):
        return [{k: stamp.sub(".mp4", v) if isinstance(v, str) else v for k, v in job.items()}
                for job in jobs]

    port_jobs = unstamped(port_multi.jobs_from_pairings([1, 0], **kw))
    assert port_jobs == unstamped(jax_multi.jobs_from_pairings([1, 0], **kw))
    assert port_jobs[0]["log_offset"] == -2 and port_jobs[0]["output_video_path"].endswith(
        "d1_1_c.mp4")


def test_prefetching_reader_and_transcode(fixture_dir, tmp_path):
    _, video_path, _ = fixture_dir
    r = port_reader.PrefetchingReader(video_path, start=0, stop=20)
    frames = list(r)
    r.release()
    assert [i for i, _ in frames] == list(range(20)) and frames[0][1].shape == (H, W, 3)
    out = str(tmp_path / "t.mp4")
    assert port_encoder.transcode(video_path, out, codec="mpeg4", preset=None, crf=4,
                                  max_frames=12) == 12
    cap = cv2.VideoCapture(out)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 12
    cap.release()


def _write_video(path, num_frames=30, size=64, seed=0):
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (size, size))
    rng = np.random.default_rng(seed)
    for _ in range(num_frames):
        w.write(rng.integers(0, 255, (size, size, 3), dtype=np.uint8))
    w.release()
    return str(path)


def _frame_count(path):
    cap = cv2.VideoCapture(str(path))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def test_remux_and_add_audio_as_jax(tmp_path, monkeypatch):
    """test_audio_remux.py's cases through the port: a tone track authored,
    remuxed into a silent render, add_audio without an ffmpeg binary, and
    the silent source that leaves the render as it was; the port's files
    carry what the JAX package's carry."""
    silent = _write_video(tmp_path / "src_silent.mp4")
    with_audio = str(tmp_path / "src_av.mp4")
    assert port_remux.add_tone(silent, with_audio)
    assert port_remux.count_audio_streams(with_audio) == 1 == \
        jax_remux.count_audio_streams(with_audio)
    assert _frame_count(with_audio) == 30
    rendered = _write_video(tmp_path / "annotated.mp4", seed=1)
    for name, mod in (("port", port_remux), ("jax", jax_remux)):
        out = str(tmp_path / f"out_{name}.mp4")
        assert mod.remux(rendered, with_audio, out)
        assert port_remux.count_audio_streams(out) == 1 and _frame_count(out) == 30
    assert os.path.getsize(tmp_path / "out_port.mp4") == os.path.getsize(tmp_path / "out_jax.mp4")
    silent_src = _write_video(tmp_path / "src.mp4", seed=2)
    assert not port_remux.remux(rendered, silent_src, str(tmp_path / "none.mp4"))
    assert not os.path.exists(tmp_path / "none.mp4")

    monkeypatch.setattr(port_writer, "ffmpeg_available", lambda: False)
    target = _write_video(tmp_path / "annotated2.mp4", seed=3)
    assert port_writer.add_audio(target, with_audio)
    assert port_remux.count_audio_streams(target) == 1 and _frame_count(target) == 30
    target = _write_video(tmp_path / "annotated3.mp4", seed=4)
    assert not port_writer.add_audio(target, silent_src)
    assert _frame_count(target) == 30


def _images(html_text, kind):
    return re.findall(rf"data:image/{kind};base64,([A-Za-z0-9+/=]+)", html_text)


def test_postgame_report_equals_jax(fixture_dir, tmp_path):
    """The same HTML apart from the inline PNGs, and every PNG decodes to
    the JAX report's pixels."""
    _, _, log_path = fixture_dir
    port_html = open(port_report.write_postgame_report(
        log_path, str(tmp_path / "p.html"), title="m")).read()
    jax_html = open(jax_report.write_postgame_report(
        log_path, str(tmp_path / "j.html"), title="m")).read()
    a, b = _images(port_html, "png"), _images(jax_html, "png")
    assert len(a) == len(b) == 10
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(base64.b64decode(x)))),
                                      np.asarray(Image.open(io.BytesIO(base64.b64decode(y)))))
    strip = re.compile(r"base64,[A-Za-z0-9+/=]+")
    assert strip.sub("", port_html) == strip.sub("", jax_html)
    port_report.main(["--log", log_path, "--out", str(tmp_path / "cli.html")])
    assert os.path.exists(tmp_path / "cli.html")


def test_manuscript_vis_equals_jax(fixture_dir, tmp_path, monkeypatch):
    """The inspection report: the same HTML apart from the inline JPEGs,
    which decode to the JAX report's pixels (one cv2 encodes both)."""
    _, video_path, log_path = fixture_dir
    frames = [0, 22, 45]
    port_html = open(port_vis.inspect_match(video_path, log_path, frames,
                                            str(tmp_path / "p.html"))).read()
    jax_html = open(jax_vis.inspect_match(video_path, log_path, frames,
                                          str(tmp_path / "j.html"))).read()
    a, b = _images(port_html, "jpeg"), _images(jax_html, "jpeg")
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        np.testing.assert_array_equal(
            cv2.imdecode(np.frombuffer(base64.b64decode(x), np.uint8), cv2.IMREAD_COLOR),
            cv2.imdecode(np.frombuffer(base64.b64decode(y), np.uint8), cv2.IMREAD_COLOR))
    strip = re.compile(r"base64,[A-Za-z0-9+/=]+")
    assert strip.sub("", port_html) == strip.sub("", jax_html)


def test_ai_output_route_equals_jax(tmp_path, monkeypatch):
    """Manuscript(ai_output_path=) on an ai_output.yaml the port wrote (the
    AIRunner's writer, no yaml): the port and the JAX package (which reads
    it with yaml) render the same frames, and each label opens with the
    file's action."""
    from playaid_core_torch.infer import ai_output

    rng = np.random.default_rng(5)
    tree = {name: {i: {"crop": f"{cls} {0.3 + 0.4 * k + 0.002 * i:.4f} 0.55 0.12 0.3 0.9",
                       "action": ["Jab", "Wait", "DashAttack", "Undefined"][(i // 5) % 4],
                       "predicted_action_confidence": float(rng.uniform(50, 99))}
                   for i in range(24)}
            for k, (name, cls) in enumerate((("Pikachu", 2), ("Joker", 3)))}
    path = str(tmp_path / "ai_output.yaml")
    ai_output.write(path, tree)
    frames = _frames(24)
    outs, labels = [], []
    for ms_mod, ann_mod in ((port_ms, port_ann), (jax_ms, jax_ann)):
        Reader, Writer = _stand_ins(frames)
        monkeypatch.setattr(ms_mod, "VideoReader", Reader)
        monkeypatch.setattr(ann_mod, "VideoWriter", Writer)
        m = ms_mod.Manuscript("/clips/match.mp4", "/clips/out.mp4", ai_output_path=path,
                              skip_summaries=True, include_audio=False, progress=False)
        seen = []
        plain = m.fighter_label
        m.fighter_label = lambda f, i, plain=plain, seen=seen: seen.append(
            (f.fighter_name, i, plain(f, i))) or seen[-1][2]
        m.render()
        outs.append(Writer.opened[-1].frames)
        labels.append(seen)
    assert len(outs[0]) == len(outs[1]) == 24 and labels[0] == labels[1]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    for name, i, label in labels[0]:
        assert label.split(" | ")[0] == tree[name][i]["action"].replace("Undefined", "")
