"""The port's ground-truth generators, raw-animation cleaner, char_loader,
gap_report and PNG codec against the JAX package's modules (and cv2) on
the same seeded inputs, on the CPU.

Fixtures: a 24-frame 1280x720 mp4v clip of seeded noise over a gradient
paired with ``tests/synthlog.scripted_match(24)`` (both packages read it
through cv2's VideoCapture), a raw animation dump of PNG files written by
cv2, a frame tree of three images a label.  Every comparison is exact:
trees byte for byte (jpg), the ``.npy`` crops and frames equal to the
arrays the JAX modules hand to ``cv2.imwrite`` (captured by
monkeypatching it), YOLO and action label files identical, cleaned PNGs
decoded equal, the loader's features and labels identical for a seed, the
gap report identical; the PNG reader equal to ``cv2.imread`` on files
written by cv2 and by PIL.
"""

import io
import os
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from playaid_core_torch import char_loader, imgcodec
from playaid_core_torch.datagen import gap_report, raw_anim_cleaner
from playaid_core_torch.datagen import gen_gt_action_detection as gt_action
from playaid_core_torch.datagen import gen_gt_char_detection as gt_char
from playaid_core_tpu import char_loader as jax_char_loader
from playaid_core_tpu.datagen import gap_report as jax_gap_report
from playaid_core_tpu.datagen import gen_gt_action_detection as jax_gt_action
from playaid_core_tpu.datagen import gen_gt_char_detection as jax_gt_char
from playaid_core_tpu.datagen import raw_anim_cleaner as jax_cleaner
from tests.synthlog import scripted_match, write_log

NUM_FRAMES, W, H = 24, 1280, 720
PAIRING = ("byleth_v_pikachu_1", "match.mp4", "log.txt", 0)


@pytest.fixture(scope="module")
def gt_root(tmp_path_factory):
    """A (video, log) pairing and its pairings CSV."""
    root = tmp_path_factory.mktemp("gt_root")
    d = root / PAIRING[0]
    d.mkdir()
    rng = np.random.default_rng(0)
    base = (np.add.outer(np.arange(H) // 3, np.arange(W) // 5) % 200).astype(np.uint8)
    writer = cv2.VideoWriter(str(d / PAIRING[1]), cv2.VideoWriter_fourcc(*"mp4v"), 60, (W, H))
    for i in range(NUM_FRAMES):
        frame = np.repeat(base[..., None], 3, 2) + rng.integers(0, 50, (H, W, 3), dtype=np.uint8)
        writer.write(np.roll(frame, 7 * i, axis=1))
    writer.release()
    write_log(d / PAIRING[2], scripted_match(NUM_FRAMES))
    csv = root / "pairings.csv"
    csv.write_text("dir,video,log,offset\n" + ",".join(str(v) for v in PAIRING) + "\n")
    return root, str(csv)


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.fixture
def captured_imwrite(monkeypatch):
    """cv2.imwrite kept lossless: {path: a copy of the array handed to it}
    (and the file written as before)."""
    seen = {}
    real = cv2.imwrite

    def imwrite(path, img, *args):
        seen[str(path)] = np.array(img, copy=True)
        return real(path, img, *args)

    monkeypatch.setattr(cv2, "imwrite", imwrite)
    return seen


# ---- gen_gt_action_detection ----


def test_action_tree_jpg_is_byte_identical_and_idempotent(gt_root, tmp_path):
    root, _ = gt_root
    ref = jax_gt_action.process_pairing(str(tmp_path / "jax"), PAIRING, str(root))
    got = gt_action.process_pairing(str(tmp_path / "port"), PAIRING, str(root))
    assert got == ref > 0
    jax_tree, port_tree = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert jax_tree == port_tree
    assert sorted(os.listdir(tmp_path / "port" / PAIRING[0])) == ["0_byleth", "1_pikachu"]
    labels = {v for k, v in port_tree.items() if k.endswith(".txt")}
    assert len(labels) > 1  # the scripted match changes moves
    assert gt_action.process_pairing(str(tmp_path / "port"), PAIRING, str(root)) == 0


def test_action_tree_npy_holds_the_arrays_the_jax_module_writes(gt_root, tmp_path,
                                                               captured_imwrite):
    root, csv = gt_root
    jax_gt_action.process_pairing(str(tmp_path / "jax"), PAIRING, str(root))
    crops = {os.path.relpath(p, tmp_path / "jax"): a for p, a in captured_imwrite.items()}
    captured_imwrite.clear()
    written = gt_action.generate_data(csv, "train", output_root=str(tmp_path / "port"),
                                      workers=2, fmt="npy", ground_truth_dir=str(root))
    assert not captured_imwrite  # no cv2 on the npy route
    port = _tree(tmp_path / "port" / "train")
    assert written == len(crops) == sum(k.endswith(".npy") for k in port)
    for rel, arr in crops.items():
        got = np.load(tmp_path / "port" / "train" / (rel[:-4] + ".npy"))
        assert got.dtype == np.uint8 and np.array_equal(got, arr), rel
    jax_labels = {k: v for k, v in _tree(tmp_path / "jax").items() if k.endswith(".txt")}
    assert jax_labels == {k: v for k, v in port.items() if k.endswith(".txt")}
    with pytest.raises(ValueError, match="fmt"):
        gt_action.process_pairing(str(tmp_path / "x"), PAIRING, str(root), fmt="png")


# ---- gen_gt_char_detection ----


@pytest.mark.parametrize("kw", [dict(interval=10), dict(interval=7, offset=3, max_frames=20)])
def test_char_detection_tree_matches(gt_root, tmp_path, captured_imwrite, kw):
    root, csv = gt_root
    common = dict(ground_truth_dir=str(root), **kw)
    ref = jax_gt_char.generate_data(csv, "train", output_root=str(tmp_path / "jax"), **common)
    frames = {os.path.relpath(p, tmp_path / "jax"): a for p, a in captured_imwrite.items()}
    got = gt_char.generate_data(csv, "train", output_root=str(tmp_path / "jpg"), **common)
    assert got == ref == len(frames) > 0
    jax_tree = _tree(tmp_path / "jax")
    assert _tree(tmp_path / "jpg") == jax_tree
    labels = [v.decode() for k, v in jax_tree.items() if k.endswith(".txt")]
    assert all(len(t.splitlines()) == 2 for t in labels)
    captured_imwrite.clear()
    got = gt_char.generate_data(csv, "train", output_root=str(tmp_path / "npy"), fmt="npy",
                                **common)
    assert got == ref and not captured_imwrite
    npy = _tree(tmp_path / "npy")
    assert {k: v for k, v in npy.items() if k.endswith(".txt")} == {
        k: v for k, v in jax_tree.items() if k.endswith(".txt")}
    for rel, arr in frames.items():
        assert np.array_equal(np.load(tmp_path / "npy" / (rel[:-4] + ".npy")), arr), rel
    # A second run stops at the first frame already written; overwrite writes again.
    assert gt_char.generate_data(csv, "train", output_root=str(tmp_path / "npy"), fmt="npy",
                                 **common) == 0
    assert gt_char.generate_data(csv, "train", output_root=str(tmp_path / "npy"), fmt="npy",
                                 overwrite=True, **common) == ref


def test_write_yolo_output_matches(tmp_path):
    rows = [(2, (0.5, 0.25, 0.125, 0.2222222222222222)), (-1, (1.0, 0.0, 0.3, 0.7))]
    jax_gt_char.write_yolo_output(str(tmp_path / "a.txt"), rows)
    gt_char.write_yolo_output(str(tmp_path / "b.txt"), rows)
    assert (tmp_path / "a.txt").read_bytes() == (tmp_path / "b.txt").read_bytes()


# ---- raw_anim_cleaner ----


def _raw_dump(root):
    """Raw dumps of two fighters: shapes on black (some near-black pixels
    at 1, which stay transparent, and at 2, which do not), an animation
    name the ontology names only by its prefix fallback, a non-PNG file."""
    rng = np.random.default_rng(3)
    for fighter, anims in (("byleth", ("c00attack1", "c00attackdash", "c00nothing")),
                           ("pikachu", ("c00attack1",))):
        for anim in anims:
            d = root / fighter / anim
            d.mkdir(parents=True)
            for i in range(3):
                img = np.zeros((90 + 10 * i, 120, 3), np.uint8)
                y, x = 10 + 5 * i, 15 + 7 * i
                img[y:y + 40, x:x + 50] = rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
                img[y + 5, x:x + 50] = 1
                img[y + 6, x:x + 50] = (0, 2, 0)
                cv2.imwrite(str(d / f"frame_{i}.png"), img)
            (d / "notes.txt").write_text("not an image")
    # An all-black frame crops to nothing and is skipped.
    cv2.imwrite(str(root / "pikachu" / "c00attack1" / "frame_9.png"),
                np.zeros((20, 20, 3), np.uint8))


def test_cleaned_pngs_decode_equal(tmp_path):
    _raw_dump(tmp_path / "raw")
    totals = []
    for package, out in ((jax_cleaner, "jax"), (raw_anim_cleaner, "port")):
        totals.append([package.clean_all_raw_fighter_anim_data(
            f, raw_dir=str(tmp_path / "raw"), clean_dir=str(tmp_path / out))
            for f in ("byleth", "pikachu", "nobody")])
    assert totals[0] == totals[1] == [9, 3, 0]
    jax_tree, port_tree = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert sorted(jax_tree) == sorted(port_tree) and len(port_tree) == 12
    for rel in jax_tree:
        ref = cv2.imread(str(tmp_path / "jax" / rel), cv2.IMREAD_UNCHANGED)
        got = cv2.imread(str(tmp_path / "port" / rel), cv2.IMREAD_UNCHANGED)
        assert ref.shape[2] == 4 and np.array_equal(got, ref), rel
        assert np.array_equal(imgcodec.read_sprite(str(tmp_path / "port" / rel)), ref)
    # Idempotent: an existing output stops an animation's loop.
    assert raw_anim_cleaner.clean_all_raw_fighter_anim_data(
        "byleth", raw_dir=str(tmp_path / "raw"), clean_dir=str(tmp_path / "port")) == 0


def test_cleaner_helpers_match():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 3, (30, 40, 3), dtype=np.uint8)
    assert np.array_equal(raw_anim_cleaner.remove_black_background(img),
                          jax_cleaner.remove_black_background(img))
    rgba = np.zeros((50, 60, 4), np.uint8)
    for box in ((10, 20, 30, 45), None):
        if box:
            rgba[box[0]:box[1], box[2]:box[3], 3] = 255
        assert raw_anim_cleaner.get_bounding_box(rgba) == jax_cleaner.get_bounding_box(rgba)
    assert raw_anim_cleaner.get_bounding_box(np.zeros((5, 7, 4), np.uint8)) == \
        jax_cleaner.get_bounding_box(np.zeros((5, 7, 4), np.uint8))


# ---- char_loader ----


def test_character_loader_matches_for_a_seed(tmp_path):
    rng = np.random.default_rng(0)
    for label in ("fox", "marth"):
        d = tmp_path / label
        d.mkdir()
        for i in range(3):
            frame = rng.integers(0, 255, (720, 1280, 3), dtype=np.uint8)
            if i == 2:
                cv2.imwrite(str(d / f"{i}.png"), frame)
            else:
                cv2.imwrite(str(d / f"{i}.jpg"), frame)
        (d / "skip.txt").write_text("")
    ref_df = jax_char_loader.dataframe_from_directory(str(tmp_path))
    table = char_loader.dataframe_from_directory(str(tmp_path))
    assert len(table) == len(ref_df) == 6
    assert table["frame_path"] == list(ref_df["frame_path"])
    assert table["label"] == list(ref_df["label"])
    for seed in (0, 7):
        ref = jax_char_loader.CharacterLoader(ref_df, seed=seed)
        got = char_loader.CharacterLoader(table, seed=seed)
        assert len(got) == len(ref)
        for i in range(5):
            (f_ref, l_ref), (f_got, l_got) = ref[i], got[i]
            assert l_got == l_ref and f_got.dtype == np.float32
            assert np.array_equal(f_got, f_ref)
    # A .npy frame reads as the array it holds.
    np.save(tmp_path / "fox" / "9.npy", cv2.imread(str(tmp_path / "fox" / "0.jpg")))
    table = char_loader.dataframe_from_directory(str(tmp_path))
    assert len(table) == 7 and table.iloc[3] == {"frame_path": str(tmp_path / "fox" / "9.npy"),
                                                 "label": "fox"}


@pytest.mark.parametrize("shape", [(720, 1280, 3), (1080, 1920, 3), (250, 480, 3), (97, 61)])
def test_crop_stock_info_is_bit_for_bit(shape):
    frame = np.random.default_rng(shape[0]).integers(0, 256, shape, dtype=np.uint8)
    assert np.array_equal(char_loader.crop_stock_info(frame),
                          jax_char_loader.crop_stock_info(frame))


def test_games_to_char_dataframe_matches():
    class Game:
        def __init__(self, label, paths):
            self.label, self.frame_paths = label, paths

        def char_label(self):
            return self.label

    games = [Game("a", ["x/1.jpg", "x/2.jpg"]), Game("b", ["y/1.jpg"])]
    ref = jax_char_loader.games_to_char_dataframe(games)
    got = char_loader.games_to_char_dataframe(games)
    assert [got.iloc[i] for i in range(len(got))] == ref.to_dict("records")


# ---- gap_report ----


def test_gap_report_is_identical(tmp_path, capsys, monkeypatch):
    store = tmp_path / "out"
    store.mkdir()
    for name in ("rep_a.mp4", "rep_b.YAML", "rep_e.yml", "notes.txt"):
        (store / name).write_text("")
    (store / "rep_c").mkdir()
    req = tmp_path / "req.csv"
    req.write_text("# comment\nrep_a, a@x\nrep_z,z@x\n\nrep_d,d@x\nrep_c,c@x\nrep_f, f@x\n")
    for path in (str(req), str(tmp_path / "nope")):
        for store_arg in (str(store), str(tmp_path / "missing")):
            ref = jax_gap_report.incomplete_games(jax_gap_report.load_requests(str(req)),
                                                  store_arg)
            assert gap_report.incomplete_games(gap_report.load_requests(str(req)),
                                               store_arg) == ref
    assert gap_report.completed_replay_ids(str(store)) == jax_gap_report.completed_replay_ids(
        str(store))
    monkeypatch.setattr(sys, "argv", ["gap_report", "--requests", str(req), "--store",
                                      str(store)])
    with pytest.raises(SystemExit) as done:
        jax_gap_report.main()
    assert done.value.code == 0
    ref_out = capsys.readouterr().out
    gap_report.main(["--requests", str(req), "--store", str(store)])
    out = capsys.readouterr().out
    assert out == ref_out and '"rep_z", // z@x' in out and out.endswith("# 3 incomplete\n")


# ---- the PNG codec ----


def _images(h=37, w=53):
    rng = np.random.default_rng(11)
    smooth = (np.add.outer(np.arange(h), 2 * np.arange(w)) * 3 % 256).astype(np.uint8)
    bgr = np.stack([smooth, rng.integers(0, 256, (h, w), dtype=np.uint8), smooth[::-1]], 2)
    bgra = np.concatenate([bgr, rng.integers(0, 256, (h, w, 1), dtype=np.uint8)], 2)
    return smooth, bgr, bgra


def _png_files(root):
    """PNG files of every colour type, written by cv2 and by PIL (whose
    adaptive filters use all five row filters)."""
    grey, bgr, bgra = _images()
    rgb, rgba = bgr[..., ::-1], bgra[..., [2, 1, 0, 3]]
    files = {}
    for name, img in (("cv2_grey", grey), ("cv2_bgr", bgr), ("cv2_bgra", bgra)):
        files[name] = str(root / f"{name}.png")
        cv2.imwrite(files[name], img)
    quant = Image.fromarray(rgb).quantize(64)
    pil = {"pil_L": (Image.fromarray(grey), {}),
           "pil_L_trns": (Image.fromarray(grey), {"transparency": 9}),
           "pil_LA": (Image.fromarray(np.stack([grey, bgra[..., 3]], 2), "LA"), {}),
           "pil_RGB": (Image.fromarray(rgb), {}),
           "pil_RGB_trns": (Image.fromarray(rgb),
                            {"transparency": tuple(int(v) for v in rgb[0, 0])}),
           "pil_RGBA": (Image.fromarray(rgba), {}),
           "pil_P": (quant, {}),
           "pil_P_trns": (quant, {"transparency": bytes(range(0, 250, 5))[:40]})}
    for name, (img, kw) in pil.items():
        files[name] = str(root / f"{name}.png")
        img.save(files[name], **kw)
    return files


def _filtered_png(img, filters):
    """An RGB image as PNG bytes with row r filtered by filters[r % 5]
    (PNG spec 9.2, against the unfiltered samples)."""
    h, w, bpp = img.shape
    x = img.astype(np.int32).reshape(h, w * bpp)
    rows = []
    for r in range(h):
        a = np.concatenate([np.zeros(bpp, np.int32), x[r, :-bpp]])
        b = x[r - 1] if r else np.zeros_like(x[r])
        c = np.concatenate([np.zeros(bpp, np.int32), b[:-bpp]])
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        kind = filters[r % len(filters)]
        pred = (0, a, b, (a + b) // 2, paeth)[kind]
        rows.append(np.concatenate([[kind], (x[r] - pred) & 0xFF]).astype(np.uint8))
    body = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", zlib.crc32(kind + data))

    return (imgcodec.PNG_SIGNATURE + chunk(b"IHDR", body)
            + chunk(b"IDAT", zlib.compress(np.concatenate(rows).tobytes())) + chunk(b"IEND", b""))


def test_png_reader_equals_cv2_for_every_colour_type(tmp_path):
    files = _png_files(tmp_path)
    files["every_filter"] = str(tmp_path / "every_filter.png")
    rgb = _images()[1][..., ::-1]
    with open(files["every_filter"], "wb") as f:
        f.write(_filtered_png(rgb, (3, 4, 1, 0, 2, 3)))
    assert np.array_equal(cv2.imread(files["every_filter"]), rgb[..., ::-1])
    filters = set()
    for name, path in files.items():
        data = open(path, "rb").read()
        ihdr = struct.unpack(">IIBBBBB", data[16:29])
        assert ihdr[2] == 8 and ihdr[6] == 0, name
        idat = b"".join(b for k, b in imgcodec._chunks(data, path) if k == b"IDAT")
        stride = 1 + ihdr[0] * imgcodec.PNG_CHANNELS[ihdr[3]]
        filters |= set(np.frombuffer(zlib.decompress(idat), np.uint8)[::stride].tolist())
        for flags in (cv2.IMREAD_COLOR, cv2.IMREAD_UNCHANGED):
            ref = cv2.imread(path, flags)
            got = imgcodec.read_image(path, flags)
            assert got.dtype == np.uint8 and got.shape == ref.shape, (name, flags)
            assert np.array_equal(got, ref), (name, flags)
    assert filters == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("which", [0, 1, 2])
def test_png_writer_round_trips_through_cv2(tmp_path, which):
    img = _images(29, 41)[which]
    path = str(tmp_path / "mine.png")
    imgcodec.write_image(path, img)
    assert np.array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    assert np.array_equal(imgcodec.read_image(path, imgcodec.IMREAD_UNCHANGED), img)
    assert np.array_equal(imgcodec.read_image(path), cv2.imread(path))


def _with_ihdr(data, **fields):
    """A PNG's bytes with IHDR fields replaced (its CRC recomputed)."""
    names = ("width", "height", "depth", "colour", "compression", "filter", "interlace")
    values = dict(zip(names, struct.unpack(">IIBBBBB", data[16:29])), **fields)
    body = struct.pack(">IIBBBBB", *(values[n] for n in names))
    return data[:16] + body + struct.pack(">I", zlib.crc32(b"IHDR" + body)) + data[33:]


def test_png_reader_names_what_it_does_not_support(tmp_path):
    grey, bgr, _ = _images()
    path = str(tmp_path / "deep.png")
    cv2.imwrite(path, grey.astype(np.uint16) * 257)
    with pytest.raises(ValueError, match="16-bit"):
        imgcodec.read_image(path)
    buf = io.BytesIO()
    Image.fromarray(bgr).quantize(16).save(buf, format="PNG")  # 4-bit palette
    with pytest.raises(ValueError, match="4-bit"):
        imgcodec.decode_png(buf.getvalue())
    with pytest.raises(ValueError, match="interlaced"):
        imgcodec.decode_png(_with_ihdr(imgcodec.encode_png(bgr), interlace=1))
    data = bytearray(imgcodec.encode_png(bgr))
    data[19] ^= 1  # the width's last byte, under the IHDR's CRC
    with pytest.raises(ValueError, match="CRC"):
        imgcodec.decode_png(bytes(data))
    with pytest.raises(ValueError, match="not a PNG"):
        imgcodec.decode_png(b"GIF89a")
    with pytest.raises(ValueError, match="IMREAD"):
        imgcodec.decode_png(imgcodec.encode_png(bgr), flags=0)


def test_png_trees_read_without_cv2(tmp_path, monkeypatch):
    """read_crop and read_sprite take PNG through the codec, with cv2
    blocked; a jpg still names cv2."""
    _, bgr, bgra = _images()
    cv2.imwrite(str(tmp_path / "s.png"), bgra)
    cv2.imwrite(str(tmp_path / "c.png"), bgr)
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert np.array_equal(imgcodec.read_sprite(str(tmp_path / "s.png")), bgra)
    sprite = imgcodec.read_sprite(str(tmp_path / "c.png"))
    assert np.array_equal(sprite[..., :3], bgr) and (sprite[..., 3] == 255).all()
    assert np.array_equal(imgcodec.read_crop(str(tmp_path / "s.png")), bgra[..., :3])
    with pytest.raises(ImportError, match="cv2"):
        imgcodec.read_crop(str(tmp_path / "x.jpg"))
