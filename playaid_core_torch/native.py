"""ctypes binding for the native ult_logger log parser.

The port's own copy of ``playaid_core_tpu/native.py``.  It wraps
``native/log_parser.cpp``, which scans the known numeric fields of each
JSON line directly (about 20-40x faster than ``json.loads`` a line).  The
library is built by :mod:`playaid_core_torch.video._native` into
``build/native/`` at its first use; it links nothing beyond the C++
runtime.  When it cannot be built, the first use raises with ``g++``'s
error output: the Python parser runs only when a caller asks for it
(``timeline.load_ground_truth_from_path(parser="python")``).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from playaid_core_torch.video import _native

# Field order must match kScalarKeys + camera blocks in log_parser.cpp.
FIELDS = [
    "damage", "facing", "fighter_id", "motion_kind", "num_frames_left",
    "pos_x", "pos_y", "shield_size", "status_kind", "stock_count",
    "hitstun_left", "attack_connected", "can_act", "animation_frame_num",
    "stage_id", "fighter_name",
    "cam_x", "cam_y", "cam_z", "tgt_x", "tgt_y", "tgt_z",
]
_NUM_FIELDS = len(FIELDS)

_lib = None
_lib_lock = threading.Lock()


def get_library() -> ctypes.CDLL:
    """The parser library with its entry point's types declared; built at
    the first call, raising if it cannot be."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = _native.load("log_parser")
            lib.parse_log.restype = ctypes.c_long
            lib.parse_log.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
                                      ctypes.c_long, ctypes.c_long]
            _lib = lib
    return _lib


def _count_lines(path):
    count = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(1 << 22)
            if not block:
                return count
            count += block.count(b"\n")


def parse_log_records(path, max_records=None):
    """Parse an ult_logger file into a list of record dicts with the JSON
    structure the timeline and Fighter layers consume."""
    lib = get_library()
    if max_records is None:
        # An exact line count: the C parser stops at max_records without
        # any overflow signal.  +2 covers a last line with no newline.
        max_records = max(_count_lines(path) + 2, 64)
    buf = np.empty((max_records, _NUM_FIELDS), dtype=np.float64)
    n = lib.parse_log(str(path).encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                      max_records, _NUM_FIELDS)
    if n < 0:
        raise OSError(f"the native log parser could not read {path}")
    return [
        {
            "damage": float(row[0]),
            "facing": float(row[1]),
            "fighter_id": int(row[2]),
            "motion_kind": int(row[3]),
            "num_frames_left": int(row[4]),
            "pos_x": float(row[5]),
            "pos_y": float(row[6]),
            "shield_size": float(row[7]),
            "status_kind": int(row[8]),
            "stock_count": int(row[9]),
            "hitstun_left": float(row[10]),
            "attack_connected": bool(row[11]),
            "can_act": bool(row[12]),
            "animation_frame_num": float(row[13]),
            "stage_id": int(row[14]),
            "fighter_name": int(row[15]),
            "camera_position": {"x": float(row[16]), "y": float(row[17]), "z": float(row[18])},
            "camera_target_position": {"x": float(row[19]), "y": float(row[20]),
                                       "z": float(row[21])},
        }
        for row in buf[:n]
    ]
