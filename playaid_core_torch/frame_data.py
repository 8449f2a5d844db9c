"""Per-fighter frame-data database.

The port's own copy of ``playaid_core_tpu/frame_data.py``.

Loads the extracted frame-data JSON (89 fighters x moves, fields
startup/active_start/active_end/end_lag/advantage/shield_stun/shield_lag/
landing_lag/base_damage/total_frames/additional_notes) into an
attribute-access Dict, matching the reference's generated module
(reference: frame_data.py:3).

Missing fighters/moves/fields resolve to an empty, falsy Dict so call
sites can write ``FIGHTER_FRAME_DATA[name][move].startup or 0``
(reference: fighter.py:636-660, fighter.py:719-725).
"""

import gzip
import json

from playaid_core_torch import constants
from playaid_core_torch.adict import Dict


def _load():
    with gzip.open(constants.FRAME_DATA_JSON_GZ, "rt") as f:
        return Dict(json.load(f))


FIGHTER_FRAME_DATA = _load()
