"""Game-knowledge layer: move ontology, enums and derived lookup maps.

The port's own copy of ``playaid_core_tpu/ontology.py``.  Data-driven
rebuild of the reference module (reference: anim_ontology.py).
The reference embedded the ontology as Python literals; here the same facts
live as JSON assets under ``game_data/`` and this module builds the derived
maps at import:

* ``ONTOLOGY``                   — move taxonomy (reference: anim_ontology.py:7-393)
* ``HEX_TO_ACTION``              — motion-kind hex -> param string, loaded from
                                   params_labels.csv (reference: anim_ontology.py:574-578)
* ``ANIM_FILE_TO_ANIMATION``     — raw animation file prefix -> move
                                   (reference: anim_ontology.py:580-584)
* ``PARAM_STRING_TO_ANIMATION``  — param string -> move (reference: :586-590)
* ``MOVE_TO_CLASS_ID``           — model class ids (reference: :592-600)
* ``ONE_INDEXED_MOVE_TO_CLASS_ID`` — AVA-format ids (reference: :603-609)
* fighter / stage / status enums (reference: :395-570, :661-788)
"""

import csv
import json

from playaid_core_torch import constants


def _load_json(path):
    with open(path) as f:
        return json.load(f)


ONTOLOGY = _load_json(constants.ONTOLOGY_JSON)

FIGHTER_ENUM_TO_NAME = {int(k): v for k, v in _load_json(constants.FIGHTERS_JSON).items()}
FIGHTER_NAME_TO_ENUM = {v: k for k, v in FIGHTER_ENUM_TO_NAME.items()}

STAGE_ENUM_TO_DATA = {int(k): v for k, v in _load_json(constants.STAGES_JSON).items()}

STATUS_ENUM_TO_STRING = {
    int(k): v for k, v in _load_json(constants.STATUS_KINDS_JSON).items()
}

FIGHTER_STATUS_ENUM_TO_STRING = {
    fighter: {int(k): v for k, v in kinds.items()}
    for fighter, kinds in _load_json(constants.FIGHTER_STATUS_KINDS_JSON).items()
}

FIGHTER_SPECIAL_NAME_MAP = _load_json(constants.FIGHTER_SPECIAL_NAMES_JSON)

TRAINED_ACTIONS_2_17 = _load_json(constants.TRAINED_ACTIONS_JSON)

# Motion-kind hex -> param-string action table (87k rows of game telemetry
# data).  Keys keep their string form, e.g. "0x02302d482a".
HEX_TO_ACTION = {}
with open(constants.PARAMS_LABELS) as f:
    for row in csv.reader(f, delimiter=","):
        HEX_TO_ACTION[row[0]] = row[1] if len(row) > 1 else ""

ANIM_FILE_TO_ANIMATION = {}
PARAM_STRING_TO_ANIMATION = {}
for _fighter in ONTOLOGY:
    for _move in ONTOLOGY[_fighter]:
        for _anim_file in ONTOLOGY[_fighter][_move]["raw_animations"]:
            ANIM_FILE_TO_ANIMATION[_anim_file] = _move
        for _param in ONTOLOGY[_fighter][_move]["param_string"]:
            PARAM_STRING_TO_ANIMATION[_param] = _move

MOVE_TO_CLASS_ID = {}
MOVE_TO_ADVANTAGE_STATE = {}
_class_id = 0
for _fighter in ONTOLOGY:
    for _move in ONTOLOGY[_fighter]:
        if _move not in MOVE_TO_CLASS_ID:
            MOVE_TO_CLASS_ID[_move] = _class_id
            MOVE_TO_ADVANTAGE_STATE[_move] = ONTOLOGY[_fighter][_move]["advantage_state"]
            _class_id += 1

# Classes are 1-indexed to match the AVA annotation format.
ONE_INDEXED_MOVE_TO_CLASS_ID = {m: i + 1 for m, i in MOVE_TO_CLASS_ID.items()}

CLASS_ID_TO_MOVE = {v: k for k, v in MOVE_TO_CLASS_ID.items()}


def get_animation_type_in_dict(key: str, key_to_animation: dict) -> str:
    """Prefix-fallback lookup (reference: dataset_utils.py:23-37).

    If ``key`` is not present, every proper prefix is tried and the
    *shortest* matching prefix wins (the reference iterates longest to
    shortest, overwriting on each hit).  Returns "Undefined" when nothing
    matches.
    """
    if key in key_to_animation:
        return key_to_animation[key]
    match = "Undefined"
    # The reference iterates i = 0, -1, ... -(len-1) and keeps overwriting,
    # so the SHORTEST matching prefix ends up winning.  Reproduce exactly.
    for i in range(0, -1 * len(key), -1):
        if key[0:i] in key_to_animation:
            match = key_to_animation[key[0:i]]
    return match


def get_animation_type_for_param_string(param_string: str) -> str:
    return get_animation_type_in_dict(param_string, PARAM_STRING_TO_ANIMATION)


def get_animation_type_for_anim_file(anim_file: str) -> str:
    return get_animation_type_in_dict(anim_file, ANIM_FILE_TO_ANIMATION)


def get_anim_for_string_and_status_kind(action_string: str, status_kind: int) -> str:
    """Param string + status kind -> canonical move.

    Status 30 (GUARD_DAMAGE) overrides to "ShieldStun"
    (reference: dataset_utils.py:47-59).
    """
    raw_action = get_animation_type_for_param_string(action_string)
    if (
        status_kind in STATUS_ENUM_TO_STRING
        and STATUS_ENUM_TO_STRING[status_kind] == "FIGHTER_STATUS_KIND_GUARD_DAMAGE"
    ):
        return "ShieldStun"
    return raw_action
