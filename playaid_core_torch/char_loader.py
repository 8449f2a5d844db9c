"""Character-predictor data loader.

The port's copy of ``playaid_core_tpu/char_loader.py`` (reference:
char_loader.py:1-103): a (frame_path, label) table, ``crop_stock_info``
that keeps only the bottom HUD strip where the stock icons identify the
characters, and an indexable loader yielding (feature, label).  Without
pandas or cv2: the table is :class:`CharTable` (``len``, ``iloc[i][col]``
and the two columns, what the loader uses of a DataFrame), frames are read
through ``imgcodec.read_crop`` (``.npy``, PNG without cv2, jpg through
cv2) and resized with ``imgproc.resize``, bit for bit ``cv2.resize``'s
INTER_LINEAR.  The loader draws rows from ``default_rng(seed)`` as the
JAX package's does.
"""

from __future__ import annotations

import os

import numpy as np

from playaid_core_torch import imgcodec, imgproc

# Width x height of the model input: the bottom strip of a resized frame.
CHAR_INPUT_SIZE = (480, 120)
COLUMNS = ("frame_path", "label")


class CharTable:
    """A two-column table: ``table["frame_path"]`` and ``table["label"]``
    are lists, ``len(table)`` their length and ``table.iloc[i]`` row i as a
    ``{column: value}`` dict."""

    def __init__(self, data):
        self.columns = {name: list(data[name]) for name in COLUMNS}
        if len(self.columns["frame_path"]) != len(self.columns["label"]):
            raise ValueError("frame_path and label columns differ in length")

    def __len__(self):
        return len(self.columns["frame_path"])

    def __getitem__(self, column):
        return self.columns[column]

    @property
    def iloc(self):
        return _Rows(self)


class _Rows:
    def __init__(self, table):
        self.table = table

    def __getitem__(self, i):
        return {name: values[i] for name, values in self.table.columns.items()}


def games_to_char_dataframe(games):
    """games: iterable of objects with ``char_label()`` and
    ``frame_paths`` (reference: char_loader.py:19-35)."""
    data = {"frame_path": [], "label": []}
    for game in games:
        label = game.char_label()
        for frame_path in game.frame_paths:
            data["frame_path"].append(frame_path)
            data["label"].append(label)
    return CharTable(data)


def dataframe_from_directory(root_dir):
    """Build a table from ``root_dir/<label>/*.{jpg,png,npy}`` trees."""
    data = {"frame_path": [], "label": []}
    for label_name in sorted(os.listdir(root_dir)):
        d = os.path.join(root_dir, label_name)
        if not os.path.isdir(d):
            continue
        for f in sorted(os.listdir(d)):
            if f.endswith((".jpg", ".png", ".npy")):
                data["frame_path"].append(os.path.join(d, f))
                data["label"].append(label_name)
    return CharTable(data)


def crop_stock_info(frame):
    """Resize and keep the bottom HUD strip (reference:
    char_loader.py:50-57)."""
    frame = imgproc.resize(frame, (CHAR_INPUT_SIZE[0], 250))
    return frame[-CHAR_INPUT_SIZE[1]:]


class CharacterLoader:
    """Random-sampling loader over the character table
    (reference: char_loader.py:60-95)."""

    def __init__(self, dataframe, augment=True, transform=None, seed=None):
        self.char_dataframe = dataframe
        self.augment = augment
        self.transform = transform
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.char_dataframe)

    def __getitem__(self, idx):
        row = self.char_dataframe.iloc[int(self.rng.integers(0, len(self.char_dataframe)))]
        feature = crop_stock_info(imgcodec.read_crop(row["frame_path"]))
        if self.transform:
            feature = self.transform(feature)
        else:
            feature = feature.astype(np.float32) / 255.0
        return feature, row["label"]
