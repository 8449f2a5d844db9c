"""Analytics layer: streaming two-fighter stat accumulation.

Rebuild of the reference Stats engine (reference: stats.py:58-372).  Stats
stay on the host: the state is a nested attribute-dict keyed by dynamic move
names, O(2 fighters/frame) of trivial dict work — forcing it into XLA would
be slower and unreadable.  The device side feeds it derived per-frame
signals.

Tracked per fighter (reference: stats.py:78-144):
* punished_action_count / punished_action_damage /
  punished_action_by_action_count / punish_history — keyed by the victim's
  last non-damaged move;
* action_count + ordered action_timeline (start/end frames and world
  positions);
* successful_action_count (first hit only; multihit-guarded by
  previous_attack_connected) / successful_action_damage / success_history;
* latest_action/latest_action_frame + an English narration history
  (reference: stats.py:146-218).

The port's own copy of ``playaid_core_tpu/stats.py``.  The per-frame
snapshots are YAML that :mod:`playaid_core_torch.infer.ai_output` writes and
reads without a YAML package (``yaml.safe_load`` of a snapshot gives the
tree the JAX package's ``yaml.dump`` gives).

Deliberate fixes vs the reference:
* constructible without a video path (the reference's own stats_test calls
  ``Stats()``, which its __init__ didn't allow — reference: stats.py:59 vs
  stats_test.py:21);
* ``action_timeline[f].end_frame`` stores an int frame number; the
  reference stored the tuple ``(frame, -1)`` (reference: stats.py:116),
  which crashed the pie-chart fade math that subtracts it from an int
  (reference: graphs/onscreen.py:98).
"""

from __future__ import annotations

import os
from functools import lru_cache

from playaid_core_torch import constants
from playaid_core_torch.adict import Dict
from playaid_core_torch.fighter import Fighter
from playaid_core_torch.frame_data import FIGHTER_FRAME_DATA
from playaid_core_torch.infer import ai_output
from playaid_core_torch.timeline import (
    load_ground_truth_from_path,
    precompute_timeline_projection,
    update_fighters_from_timeline,
)

IGNOREABLE_ACTIONS = [
    "Undefined",
]


@lru_cache(maxsize=2)
def get_stats_at_frame(frame_num: int, video_path: str, label_path: str, log_offset=0):
    """Replay stats up to ``frame_num`` (reference: stats.py:27-38)."""
    timeline = load_ground_truth_from_path(label_path, log_offset=log_offset)
    precompute_timeline_projection(timeline)
    fighters = [Fighter(frame_num=0, data=json_data) for json_data in timeline[0]]
    stats = Stats(video_path)
    for i in range(frame_num):
        if i >= len(timeline):
            break
        update_fighters_from_timeline(i, timeline[i], fighters)
        stats.record_frame(fighters)
    return stats


def frame_subset_from_dict(d, start_frame, end_frame):
    """Keys of a frame-keyed dict within [start, end] (reference: stats.py:41-55)."""
    valid_frames = []
    for frame_num in d.keys():
        if frame_num < start_frame:
            continue
        if frame_num > end_frame:
            break
        valid_frames.append(frame_num)
    return valid_frames


def dict_diff(first, second, node=None):
    """Minimal recursive diff in dictdiffer's (op, path, detail) shape
    (replaces the reference's dictdiffer dependency, reference: stats.py:7)."""
    node = node or []
    dotted = ".".join(str(n) for n in node)
    if isinstance(first, dict) and isinstance(second, dict):
        added = [k for k in second if k not in first]
        removed = [k for k in first if k not in second]
        if added:
            yield ("add", dotted, [(k, second[k]) for k in added])
        if removed:
            yield ("remove", dotted, [(k, first[k]) for k in removed])
        for k in first:
            if k in second:
                yield from dict_diff(first[k], second[k], node + [k])
    elif first != second:
        yield ("change", dotted, (first, second))


class Stats:
    def __init__(self, input_video_path: str = ""):
        self.input_video_path = input_video_path
        if input_video_path:
            self.src_folder, self.file_name = os.path.split(input_video_path)
            self.video_name, _ = os.path.splitext(self.file_name)
            parent_folder = os.path.basename(self.src_folder)
            self.exp_name = os.path.join(parent_folder, self.video_name)
        else:
            self.exp_name = "default"
        self.output_dir = os.path.join(constants.AI_CACHE, self.exp_name, "stats")
        self.stats = Dict()

    def record_frame(self, fighters):
        self.update_fighter(fighters[0], fighters[1])
        self.update_fighter(fighters[1], fighters[0])
        self.post_update(fighters)

    def update_fighter(self, fighter, other_fighter):
        """Accumulate one frame for one fighter.

        The three accumulations are independent and may all fire in one
        frame (e.g. trading hits while starting a move).  The nested KEY
        PATHS (punished_action_count[move], action_timeline[frame], ...)
        are the bit-matched output schema (reference: stats.py:78-144 via
        the stats-dict parity tests) and cannot diverge; the expression
        here is this rebuild's own.
        """
        mine = self.stats[fighter.fighter_id]
        if fighter.damage_delta:
            self._record_punish(mine, fighter, other_fighter)
        if fighter.new_action:
            self._record_action_start(mine, fighter)
        if other_fighter.damage_delta:
            self._record_success(mine, fighter, other_fighter)

    @staticmethod
    def _record_punish(mine, victim, attacker):
        """The victim took damage: blame their last non-damaged move
        (combo attribution — mid-combo hitstun actions aren't 'choices')."""
        blamed = victim.previous_non_damaged_action
        frame = victim.frame_num
        mine.punished_action_count[blamed] += 1
        mine.punished_action_damage[blamed] += victim.damage_delta
        mine.punished_action_by_action_count[blamed][attacker.action] += 1
        mine.punish_history[blamed][frame] = {
            "action": attacker.action,
            "damage_delta": victim.damage_delta,
            "frame_number": frame,
        }

    @staticmethod
    def _record_action_start(mine, fighter):
        """A new action began: bump its count, close the previous timeline
        entry (end frame + world position) and open this one."""
        mine.action_count[fighter.action] += 1
        timeline = mine.action_timeline
        open_frames = list(timeline.keys())
        if open_frames:
            prior = timeline[open_frames[-1]]
            prior.end_frame = fighter.frame_num
            prior.ending_position_in_world = fighter.position_in_world
        entry = timeline[fighter.frame_num]
        entry.action = fighter.action
        entry.starting_position_in_world = fighter.position_in_world
        entry.start_frame = fighter.frame_num

    @staticmethod
    def _record_success(mine, actor, victim):
        """The opponent took damage: the actor's current move connected.
        A move only counts as successful on its FIRST hit —
        previous_attack_connected guards multihit moves from inflating
        the count — but damage accrues every hit."""
        if not actor.previous_attack_connected:
            mine.successful_action_count[actor.action] += 1
        mine.successful_action_damage[actor.action] += victim.damage_delta
        mine.success_history[actor.previous_non_damaged_action][actor.frame_num] = {
            "action": victim.previous_non_damaged_action,
            "damage_delta": victim.damage_delta,
            "frame_number": actor.frame_num,
        }

    def post_update(self, fighters):
        """Latest-action tracking + the English narration history.

        Narration precedence per (actor, opponent) ordering: a shield hit
        short-circuits the frame entirely (including the death check — a
        quirk kept for parity); otherwise damage > new-action, and a
        death line overwrites whatever else landed on the frame.  The
        narration TEXT is byte-pinned to the reference's strings
        (reference: stats.py:146-207; exercised by the narration tests).
        """
        for fighter in fighters:
            mine = self.stats[fighter.fighter_id]
            if mine.latest_action != fighter.action:
                mine.latest_action_frame = fighter.frame_num
                mine.latest_action = fighter.action

        history = self.stats.history
        for actor, opponent in ((fighters[0], fighters[1]),
                                (fighters[1], fighters[0])):
            frame = actor.frame_num
            took_shield_hit = (opponent.new_action
                               and opponent.action == "ShieldStun"
                               # Projectile guard: only narrate shield hits
                               # the actor's own move could have caused.
                               and actor.using_damage_move)
            if took_shield_hit:
                history[frame] = self._shield_line(actor, opponent)
                continue
            if opponent.damage_delta:
                history[frame] = self._punish_line(actor, opponent)
            elif (actor.new_action
                  # A-vs-B and B-vs-A are both visited; don't double-write.
                  and not history[frame]
                  and actor.action not in IGNOREABLE_ACTIONS):
                if actor.previous_action:
                    history[frame] = self.to_sentence(
                        actor, opponent, f"ended move {actor.action}"
                    )
                history[frame] = self.to_sentence(
                    actor, opponent, f"started move {actor.action}"
                )
            if actor.previous_damage and not actor.damage:
                history[frame] = (
                    f"P{actor.fighter_id + 1} {actor.fighter_name} died"
                )

    @staticmethod
    def _shield_line(actor, opponent):
        hit, blocked = actor.fighter_name, opponent.fighter_name
        return (f"{hit} hit {blocked}'s shield with {actor.action}, "
                f"putting {blocked} into ShieldStun")

    @staticmethod
    def _punish_line(actor, opponent):
        return (f"{actor.fighter_name}, who is at {actor.damage:.2f} damage, "
                f"used {actor.action} to punish {opponent.fighter_name} use "
                f"of {opponent.previous_action} for "
                f"{opponent.damage_delta:.2f} damage")

    def to_sentence(self, fighter, other_fighter, specific_string):
        """One whitespace-normalized narration sentence (text byte-pinned
        to the reference's narration contract)."""
        clauses = (
            f"P{fighter.fighter_id + 1} {fighter.fighter_name}",
            specific_string,
            f"at position {fighter.pos_x:.2f}x,{fighter.pos_y:.2f}y",
            f"with {fighter.damage:.2f}% damage.",
            f"Opponent P{other_fighter.fighter_id + 1} {other_fighter.fighter_name}",
            f"is at frame {other_fighter.animation_frame_num}",
            f"of move {other_fighter.action}",
            f"and is {other_fighter.offset_str(fighter)}",
            f"from {fighter.fighter_name}",
            f"with {other_fighter.damage:.2f}% damage.",
        )
        return " ".join(" ".join(clauses).split())

    # ---------------- query API (reference: stats.py:220-308) ----------------

    def move_counters(self, fighter, move):
        total = self.stats[fighter.fighter_id].action_count[move] or 0
        success = self.stats[fighter.fighter_id].successful_action_count[move] or 0
        punished = self.stats[fighter.fighter_id].punished_action_count[move] or 0
        missed = max(total - success - punished, 0)
        return (success, punished, missed, total)

    def move_counter_str(self, fighter, move):
        (success, punished, missed, total) = self.move_counters(fighter, move)
        return f"{success}✅, {punished}❌, {missed}⭕️, {total}"

    def move_set(self, fighter, start_frame, end_frame):
        action_timeline = self.stats[fighter.fighter_id].action_timeline
        moves = []
        for frame_num in frame_subset_from_dict(action_timeline, start_frame, end_frame):
            moves.append(action_timeline[frame_num].action)
        return list(set(moves))

    def damage_causing_move_set(self, fighter, start_frame, end_frame):
        move_set = self.move_set(fighter, start_frame, end_frame)
        return [move for move in move_set if move in FIGHTER_FRAME_DATA[fighter.fighter_name]]

    def frame_data_str(self, fighter, start_frame, end_frame):
        moves = self.damage_causing_move_set(fighter, start_frame, end_frame)
        frame_data = {
            move: FIGHTER_FRAME_DATA[fighter.fighter_name][move] for move in moves
        }
        return "\n".join(f"{move} - {str(data)}" for move, data in frame_data.items())

    def counter_summaries_str(self, fighter, start_frame, end_frame):
        moves = self.damage_causing_move_set(fighter, start_frame, end_frame)
        counter_data = []
        for move in moves:
            (success, punished, missed, total) = self.move_counters(fighter, move)
            counter_data.append(
                f"{move} has landed successfully {success} times, punished {punished} times, and "
                f"whiffed {missed} times"
            )
        return "\n".join(counter_data)

    def granular_history(self, fighter, moves, history):
        str_history = []
        for move in moves:
            if not history[move]:
                continue
            move_history_str = f"{move}:\n"
            for _, move_history in history[move].items():
                move_history_str += f"- {str(move_history)}\n"
            str_history.append(move_history_str)
        return "\n".join(str_history)

    def punish_history(self, fighter, start_frame, end_frame):
        moves = self.damage_causing_move_set(fighter, start_frame, end_frame)
        return self.granular_history(fighter, moves, self.stats[fighter.fighter_id].punish_history)

    def success_history(self, fighter, start_frame, end_frame):
        moves = self.damage_causing_move_set(fighter, start_frame, end_frame)
        return self.granular_history(fighter, moves, self.stats[fighter.fighter_id].success_history)

    def history_subset(self, start_frame, end_frame):
        history = []
        for frame_num in frame_subset_from_dict(self.stats.history, start_frame, end_frame):
            history.append((frame_num, self.stats.history[frame_num]))
        return history

    # ------------- snapshot / resume (reference: stats.py:310-353) -------------

    def stats_path(self, frame_num: int):
        return os.path.join(self.output_dir, f"stats_{frame_num}.yaml")

    def write_all_stats(self, timeline, fighters, interval=1):
        """Replay a timeline and write per-frame YAML snapshots; idempotent
        (reference: stats.py:313-331)."""
        os.makedirs(self.output_dir, exist_ok=True)
        if os.path.exists(self.stats_path(0)):
            return
        for i in range(len(timeline)):
            update_fighters_from_timeline(i, timeline[i], fighters)
            self.record_frame(fighters)
            if i % interval != 0:
                continue
            ai_output.write(self.stats_path(i), self.stats.to_dict())

    def get_stats(self, frame_num: int):
        path = self.stats_path(frame_num)
        if not os.path.exists(path):
            return False, {}
        try:
            return True, Dict(ai_output.read(path, snapshot=True))
        except ValueError:
            return False, {}

    def load_stats(self, frame_num: int):
        res, self.stats = self.get_stats(frame_num)
        return res

    def stat_diff(self, start_frame: int, end_frame: int):
        res1, start_stat = self.get_stats(start_frame)
        res2, end_stat = self.get_stats(end_frame)
        diff_results = dict_diff(start_stat, end_stat)
        return res1 and res2, diff_results, start_stat, end_stat

    def instances_of_hits_on_shield(self):
        return self.instances_of("into ShieldStun")

    def instances_of(self, instance_key, offset=13):
        """Narration windows around each occurrence of ``instance_key``
        (reference: stats.py:361-372)."""
        instances = []
        timestamps = list(self.stats.history.keys())
        for i, key in enumerate(timestamps):
            if instance_key in self.stats.history[key]:
                instance = []
                for j in range(max(0, i - offset), min(i + offset, len(timestamps))):
                    timestamp = timestamps[j]
                    instance.append((timestamp, self.stats.history[timestamp]))
                instances.append(instance)
        return instances
