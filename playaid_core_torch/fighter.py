"""Per-fighter per-frame state machine.

Rebuild of the reference Fighter entity (reference: fighter.py:393-739):
ingests one ult_logger record per frame, derives the canonical action from
the motion-kind hex + status kind, projects the fighter's world position to
a screen-space crop when no detector crop is available, and tracks frame-to-
frame deltas (damage taken, new actions, animation frame counters, combo
attribution, tech/ledge situations).

Differences from the reference (deliberate fixes, not behavior changes to
the derived per-frame signals):

* ``previous_*`` fields are initialised at construction, so frame-0 stats
  recording never touches unset attributes (the reference left them unset,
  reference: fighter.py:557-585);
* missing optional record fields get defaults instead of KeyErrors;
* camera projection can be precomputed in batch for a whole timeline
  (see :mod:`playaid_core_torch.timeline`) and injected via ``_pixel_crop``.

The port's own copy of the part of ``playaid_core_tpu/fighter.py`` that
``update_fighters_from_timeline`` uses on ground-truth records.  The
AI-predicted records (``crop``/``action`` fields), interpolation and the
stats properties wait for the manuscript and AIRunner work.
"""

from __future__ import annotations

import numpy as np

from playaid_core_torch.geometry import (
    YoloCrop,
    calculate_intrinsic_matrix,
    calculate_lookat_matrix,
    project_point_to_pixel,
)
from playaid_core_torch.ontology import (
    FIGHTER_ENUM_TO_NAME,
    HEX_TO_ACTION,
    ONTOLOGY,
    STAGE_ENUM_TO_DATA,
    get_anim_for_string_and_status_kind,
)

# Screen-space bbox of a fighter = projection of these world-space offsets
# around the fighter position (reference: fighter.py:507-526).
BBOX_WORLD_OFFSETS = np.array(
    [[-10.0, 20.0, 0.0], [10.0, 20.0, 0.0], [-10.0, -3.0, 0.0], [10.0, -3.0, 0.0]]
)


class Fighter:
    def __init__(self, frame_num: int, data):
        """@param data: dict with one ground-truth log record."""
        self.frame_num = frame_num
        self.fighter_name = ""
        self.fighter_id = -1
        self.crop = None
        self.action = ""
        self.damage = 0.0
        self.previous_damage = 0.0
        self.damage_delta = 0.0
        self.new_action = True
        self.num_frames_left = 25200
        self.previous_non_damaged_action = None
        self.frames_since_damaged = 0
        self.frames_since_hit = 0
        self.last_frame_in_tech_situation = -1
        self.last_frame_in_ledge_situation = -1
        self.hitstun_left = 0
        self.attack_connected = False
        self.previous_attack_connected = False
        self.status_kind = -1
        self.can_act = True
        self.previous_action = ""
        self.move_counter = 0

        # Raw animation frame number reported by the game (can be negative).
        self.raw_animation_frame_num = 0.0
        # Animation frame number we compute: resets to 1 on each new action.
        self.animation_frame_num = 1

        # Additional state with safe defaults so frame-0 consumers never see
        # unset attributes.
        self.position_in_world = [0.0, 0.0, 0.0]
        self.pos_x = 0.0
        self.pos_y = 0.0
        self.facing = 1.0
        self.motion_kind = 0
        self.motion_hex = "0x0000000000"
        self.action_string = ""
        self.shield_size = 0.0
        self.stock_count = 0
        self.stage_id = 0
        self.stage = STAGE_ENUM_TO_DATA[0]["name"]

        # The full previous_* family is part of the frame-0 contract (the
        # reference left these unset until the first update(),
        # reference: fighter.py:557-585).
        self.previous_position_in_world = list(self.position_in_world)
        self.previous_facing = self.facing
        self.previous_fighter_id = self.fighter_id
        self.previous_motion_kind = self.motion_kind
        self.previous_num_frames_left = self.num_frames_left
        self.previous_pos_x = self.pos_x
        self.previous_pos_y = self.pos_y
        self.previous_shield_size = self.shield_size
        self.previous_status_kind = self.status_kind
        self.previous_stock_count = self.stock_count
        self.previous_fighter_name = self.fighter_name
        self.previous_crop = self.crop
        self.previous_motion_hex = self.motion_hex
        self.previous_action_string = self.action_string

        self.set_from_record(data)

        assert self.crop, "No crop specified"
        assert self.fighter_name, "No fighter_name specified"

    def set_from_record(self, data):
        """Ingest one log record (reference: fighter.py:458-555)."""
        self.position_in_world = [data["pos_x"], data["pos_y"], 0]
        self.damage = data["damage"]
        self.facing = data["facing"]
        self.fighter_id = data["fighter_id"]
        self.motion_kind = data["motion_kind"]
        self.num_frames_left = data["num_frames_left"]
        self.pos_x = data["pos_x"]
        self.pos_y = data["pos_y"]
        self.shield_size = data["shield_size"]
        self.status_kind = data["status_kind"]
        self.stock_count = data["stock_count"]
        self.can_act = data.get("can_act", True)
        self.attack_connected = data.get("attack_connected", False)
        self.raw_animation_frame_num = data.get("animation_frame_num", 0)
        self.stage_id = data.get("stage_id", 0)
        if self.stage_id not in STAGE_ENUM_TO_DATA:
            self.stage_id = 0
        self.stage = STAGE_ENUM_TO_DATA[self.stage_id]["name"]

        if "fighter_name" in data:
            raw_name = data["fighter_name"]
            self.fighter_name = FIGHTER_ENUM_TO_NAME.get(raw_name, str(raw_name))

        # The game lies about Kalos' FOV, so trust the per-stage table
        # instead of the logged camera_fov (reference: fighter.py:487-491).
        camera_fov = STAGE_ENUM_TO_DATA[self.stage_id]["fov"]

        precomputed = data.get("_pixel_crop")
        if precomputed is not None:
            # Batched camera projection already ran over the whole timeline.
            self.point_in_pixel = data["_point_in_pixel"]
            self.crop = YoloCrop.from_pixel_coordinates(1280, 720, *precomputed)
        else:
            camera_position = data["camera_position"]
            target_position = data["camera_target_position"]
            self.extrinsics = calculate_lookat_matrix(
                list(camera_position.values()), list(target_position.values())
            )
            self.intrinsics = calculate_intrinsic_matrix(
                camera_fov, image_width=1280, image_height=720
            )
            self.point_in_pixel = project_point_to_pixel(
                self.position_in_world, self.intrinsics, self.extrinsics
            )
            corners = [
                project_point_to_pixel(
                    np.asarray(self.position_in_world) + off, self.intrinsics, self.extrinsics
                )
                for off in BBOX_WORLD_OFFSETS
            ]
            self.crop = YoloCrop.from_pixel_coordinates(
                1280,
                720,
                corners[0][0],
                corners[0][1],
                corners[1][0],
                corners[1][1],
                corners[2][0],
                corners[2][1],
                corners[3][0],
                corners[3][1],
            )

        # Zero-padded 12-char hex so it matches params_labels.csv keys
        # (reference: fighter.py:541-547).
        self.motion_hex = f"{self.motion_kind:#012x}"
        self.action_string = HEX_TO_ACTION.get(self.motion_hex, "")
        self.action = get_anim_for_string_and_status_kind(self.action_string, self.status_kind)

        self.hitstun_left = data.get("hitstun_left", 0)

    def update(self, frame_number: int, data):
        """Shift current state into previous_*, ingest the new record and
        compute deltas (reference: fighter.py:557-612)."""
        self.frame_num = frame_number
        self.previous_position_in_world = self.position_in_world
        self.previous_damage = self.damage
        self.previous_facing = self.facing
        self.previous_fighter_id = self.fighter_id
        self.previous_motion_kind = self.motion_kind
        self.previous_num_frames_left = self.num_frames_left
        self.previous_pos_x = self.pos_x
        self.previous_pos_y = self.pos_y
        self.previous_shield_size = self.shield_size
        self.previous_status_kind = self.status_kind
        self.previous_stock_count = self.stock_count
        self.previous_fighter_name = self.fighter_name
        self.previous_crop = self.crop
        self.previous_motion_hex = self.motion_hex
        self.previous_action_string = self.action_string
        self.previous_attack_connected = self.attack_connected
        self.previous_action = self.action

        self.set_from_record(data)

        # max() guards the respawn case: dying resets damage to 0, which
        # would otherwise produce a huge negative delta on "Wait"
        # (reference: fighter.py:590-592).
        self.damage_delta = max(self.damage - self.previous_damage, 0)
        self.new_action = self.previous_action != self.action
        if self.new_action:
            self.move_counter += 1

        self.animation_frame_num = 1 if self.new_action else self.animation_frame_num + 1
        self.frames_since_damaged = 0 if self.damage_delta else self.frames_since_damaged + 1
        self.frames_since_hit = 0 if self.damage_delta else self.frames_since_hit + 1

        # Combo attribution: damage taken while in "Damaged" belongs to the
        # victim's last *non-damaged* move (reference: fighter.py:602-606).
        if self.previous_action != "Damaged":
            self.previous_non_damaged_action = self.previous_action

        if self.in_tech_situation:
            self.last_frame_in_tech_situation = frame_number
        if self.in_ledge_situation:
            self.last_frame_in_ledge_situation = frame_number

    @property
    def in_tech_situation(self) -> bool:
        return ONTOLOGY["all"].get(self.action, {}).get("option_group", "") == "tech"

    @property
    def in_ledge_situation(self) -> bool:
        return ONTOLOGY["all"].get(self.action, {}).get("option_group", "") == "ledge"
