"""Chart library: pies, bar charts, stacked bars, history strips.

Rebuild of the reference chart stack (reference: graphs/bar_charts.py,
graphs/onscreen.py, graphs/timeline.py) with matplotlib-Agg rasterisation
instead of bokeh + selenium screenshots.  The chart *semantics* — which
stats feed which chart, colors, stacking order, fade behavior, 5-slot
history strips — match the reference; pixel output is matplotlib's.

All renderers are pure (stats data in, RGBA array out) and cached on their
data tuples, mirroring the reference's lru_caches
(reference: bar_charts.py:95,135,334; onscreen.py:37).

Two rasterizer backends share these chart semantics:

* ``"fast"`` (default) — the array-native renderers in
  :mod:`playaid_core_torch.render.fastcharts`: cached static chrome +
  cv2 bar fills, ~10-30x cheaper per render.  This is what makes the
  every-frame charts-on GT path real-time on a 1-core host.
* ``"mpl"`` — matplotlib-Agg rasterization (the round-1..3 backend).

Select with ``set_chart_backend()`` or ``PLAYAID_CHART_BACKEND``.

The port's own copy of ``playaid_core_tpu/render/charts.py``.  The ``fast``
backend and the history strips draw without matplotlib, cv2 or PIL (the
strips through :mod:`playaid_core_torch.text`), bit for bit as the JAX
package; the ``mpl`` backend imports matplotlib when it renders and names
it when it is missing.
"""

from __future__ import annotations

import math
import os
import threading
from functools import lru_cache

import numpy as np

from playaid_core_torch import text as pil_text
from playaid_core_torch.constants import TEXT_FONT_PATH
from playaid_core_torch.render.compositing import figure_to_rgba, make_white_transparent

SYMBOL_TO_WORD = {
    "F": "Forward",
    "D": "Down",
    "B": "Back",
    "U": "Up",
    "N": "Neutral",
    "Z": "Z",
}

IGNORE_GROUP = ["Movement", "Defensive"]

ANIM_TO_CATEGORY = {
    "Jump": ["Jump", "Landing", "Fall", "ShortHop"],
    "Grnd": ["Wait", "Squat", "Turn", "Roll"],
    "Dash": ["DashAttack"],
}

PIE_CHART_IGNORED_MOVES = [
    "Landing",
    "Walk",
    "Run",
    "Turn",
    "Wait",
    "Jump",
    "ShortHop",
    "Dash",
    "Shield",
    "ShieldDrop",
    "Fall",
    "PlatformDrop",
    "Undefined",
    "Damaged",
]

# A move stays on screen fading out for this many frames
# (reference: graphs/onscreen.py:83).
MAX_VISIBILITY_FRAMES = 60

# Categorical palette standing in for bokeh's TolRainbow20.
_PALETTE = [
    "#e8601c", "#f1932d", "#f6c141", "#cae0ab", "#90c987", "#4eb265",
    "#7bafde", "#5289c7", "#1965b0", "#882e72", "#ae76a3", "#d1bbd7",
    "#777777", "#dc050c", "#72190e", "#f7f056", "#b17ba6", "#1c9099",
    "#a6611a", "#018571",
]


def _move_labels(moves):
    """Render the reference's (group, symbol) move tuples as short labels."""
    labels = []
    for move in moves:
        if isinstance(move, str):
            labels.append(move)
        else:
            a, b = move
            labels.append(f"{b}{a}" if b else a)
    return labels


def data_to_ys(data, symbol_to_word, anim_to_category, moves):
    """Expand (group, symbol) move tuples into counts from a stats dict
    (reference: bar_charts.py:66-92)."""
    ys = []
    for move in moves:
        if move[0] == "?":
            total = sum(data.values())
            accounted = sum(ys)
            ys.append(total - accounted)
        elif move[0] in IGNORE_GROUP:
            ys.append(data[move[1]] or 0)
        elif move[0] in anim_to_category:
            ys.append(sum(data[key] or 0 for key in anim_to_category[move[0]]))
        else:
            key = (
                symbol_to_word[move[1]] + move[0]
                if move[1] in symbol_to_word
                else move[1] + move[0]
            )
            ys.append(data[key] or 0)
    return ys


# Rasterizer backend: "fast" (array-native, default) or "mpl".
_CHART_BACKEND = os.environ.get("PLAYAID_CHART_BACKEND", "fast")


def set_chart_backend(name):
    """Switch the chart rasterizer ("fast" or "mpl") process-wide."""
    global _CHART_BACKEND
    if name not in ("fast", "mpl"):
        raise ValueError(f"unknown chart backend {name!r}")
    _CHART_BACKEND = name


def get_chart_backend():
    return _CHART_BACKEND


_FIG_POOL = threading.local()


def _matplotlib():
    """matplotlib's Agg ``Figure`` and ``FigureCanvasAgg``, imported when the
    ``mpl`` backend first renders."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the mpl chart backend needs matplotlib; the fast backend "
                          "(the default) does not") from e
    matplotlib.use("Agg")
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure

    return Figure, FigureCanvasAgg


def _new_axes(width, height, title):
    # Object-oriented Figure API (not pyplot): no global figure registry, so
    # chart rendering is safe under the multi-VOD thread pool
    # (pipeline/multi.py).  Figures are REUSED per thread: Figure +
    # FigureCanvasAgg construction dominates a cache-miss redraw (~70 ms
    # per miss measured on the GT path), while clf + replot is a fraction
    # of it; pixel output is identical.
    Figure, FigureCanvasAgg = _matplotlib()
    pool = getattr(_FIG_POOL, "figs", None)
    if pool is None:
        pool = _FIG_POOL.figs = {}
    fig = pool.get((width, height))
    if fig is None:
        fig = Figure(dpi=100)
        FigureCanvasAgg(fig)
        pool[(width, height)] = fig
    else:
        fig.clf()
    ax = fig.add_subplot(111)
    ax.set_title(title, fontsize=8)
    ax.tick_params(labelsize=6)
    return fig, ax


def _hex_to_rgb(h):
    return tuple(int(h[i:i + 2], 16) for i in (1, 3, 5))


@lru_cache(maxsize=32)
def _bar_graph_image_mpl(actions, counts, width, height, title, orientation):
    fig, ax = _new_axes(width, height, title)
    labels = _move_labels(actions)
    xs = np.arange(len(labels))
    colors = [_PALETTE[i % len(_PALETTE)] for i in range(len(labels))]
    ax.bar(xs, counts, width=0.9, color=colors, edgecolor="white")
    ax.set_xticks(xs)
    rotation = math.degrees(orientation) if orientation else 0
    ax.set_xticklabels(labels, rotation=rotation, ha="right" if rotation else "center")
    ax.set_ylim(bottom=0)
    return figure_to_rgba(fig, width, height)


def bar_graph_image(actions, counts, width=400, height=360, title="actions", orientation=0.0):
    """Simple colored bar chart (reference: bar_charts.py:34-63)."""
    if _CHART_BACKEND == "fast":
        from playaid_core_torch.render import fastcharts

        labels = tuple(_move_labels(actions))
        palette = tuple(_hex_to_rgb(_PALETTE[i % len(_PALETTE)])
                        for i in range(len(labels)))
        return fastcharts.bar_graph_image(
            labels, tuple(counts), width=width, height=height, title=title,
            rotated=bool(orientation), palette=palette,
        )
    return _bar_graph_image_mpl(tuple(actions), tuple(counts), width, height,
                                title, orientation)


@lru_cache(maxsize=32)
def _success_vs_punished_image_mpl(
    moves, success, punished, title, width, height,
    punished_label, success_label,
):
    fig, ax = _new_axes(width, height, title)
    labels = _move_labels(moves)
    xs = np.arange(len(labels))
    ax.bar(xs, punished, width=0.9, color="red", label=punished_label)
    ax.bar(xs, success, width=0.9, bottom=punished, color="blue", label=success_label)
    ax.set_xticks(xs)
    ax.set_xticklabels(labels, rotation=45, ha="right")
    ax.set_ylim(bottom=0)
    ax.legend(fontsize=6)
    return figure_to_rgba(fig, width, height)


def _success_vs_punished_image(
    moves, success, punished, title, width=400, height=240,
    punished_label="punished", success_label="success",
):
    """Stacked red/blue bar chart (reference: bar_charts.py:135-175)."""
    if _CHART_BACKEND == "fast":
        from playaid_core_torch.render import fastcharts

        return fastcharts.success_vs_punished_image(
            tuple(_move_labels(moves)), tuple(success), tuple(punished),
            title, width=width, height=height,
            punished_label=punished_label, success_label=success_label,
        )
    return _success_vs_punished_image_mpl(
        tuple(moves), tuple(success), tuple(punished), title, width, height,
        punished_label, success_label,
    )


@lru_cache(maxsize=32)
def _success_punished_missed_image_mpl(
    moves, success, punished, missed, title, width, height, orientation
):
    fig, ax = _new_axes(width, height, title)
    labels = _move_labels(moves)
    xs = np.arange(len(labels))
    missed = np.asarray(missed)
    punished_arr = np.asarray(punished)
    ax.bar(xs, missed, width=0.9, color="gray", label="missed")
    ax.bar(xs, punished_arr, width=0.9, bottom=missed, color="red", label="punished")
    ax.bar(xs, success, width=0.9, bottom=missed + punished_arr, color="blue", label="success")
    ax.set_xticks(xs)
    rotation = math.degrees(orientation) if orientation else 0
    ax.set_xticklabels(labels, rotation=rotation, ha="right" if rotation else "center")
    ax.set_ylim(bottom=0)
    ax.legend(fontsize=6)
    return figure_to_rgba(fig, width, height)


def _success_punished_missed_image(
    moves, success, punished, missed, title, width=720, height=400, orientation=0.0
):
    """Gray/red/blue stacked bars (reference: bar_charts.py:334-376)."""
    if _CHART_BACKEND == "fast":
        from playaid_core_torch.render import fastcharts

        return fastcharts.success_punished_missed_image(
            tuple(_move_labels(moves)), tuple(success), tuple(punished),
            tuple(missed), title, width=width, height=height,
            rotated=bool(orientation),
        )
    return _success_punished_missed_image_mpl(
        tuple(moves), tuple(success), tuple(punished), tuple(missed), title,
        width, height, orientation,
    )


@lru_cache(maxsize=20)
def _move_pie_chart_mpl(success, punished, missed, size):
    Figure, FigureCanvasAgg = _matplotlib()
    fig = Figure(dpi=100)
    FigureCanvasAgg(fig)
    ax = fig.add_subplot(111)
    values = [success, punished, missed]
    colors = ["blue", "red", "gray"]
    if sum(values) == 0:
        values = [1, 0, 0]
    ax.pie(values, colors=colors, wedgeprops={"edgecolor": "white", "linewidth": 1})
    ax.set_axis_off()
    fig.patch.set_alpha(0.0)
    img = figure_to_rgba(fig, size, size)
    return None, img


def _move_pie_chart(success, punished, missed, size):
    """Blue/red/gray move-outcome pie (reference: graphs/onscreen.py:37-78)."""
    if _CHART_BACKEND == "fast":
        from playaid_core_torch.render import fastcharts

        return None, fastcharts.move_pie_image(success, punished, missed, size)
    return _move_pie_chart_mpl(success, punished, missed, size)


def move_pie_chart(fighter, stats, size):
    """Fading per-fighter move pie (reference: graphs/onscreen.py:86-118).

    Walks the action timeline newest-first, skips ignored moves, fades
    opacity linearly over MAX_VISIBILITY_FRAMES after the move ended.
    """
    for frame, history in reversed(stats.stats[fighter.fighter_id].action_timeline.items()):
        if not history.action or history.action in PIE_CHART_IGNORED_MOVES:
            continue

        opacity = 255
        if history.end_frame:
            frame_diff = fighter.frame_num - history.end_frame
            opacity = max(
                int(255 * ((MAX_VISIBILITY_FRAMES - frame_diff) / MAX_VISIBILITY_FRAMES)), 0
            )
        if not opacity:
            break

        (success, punished, missed, total) = stats.move_counters(fighter, history.action)
        chart, pie_chart_image = _move_pie_chart(success, punished, missed, size)
        pie_chart_image = pie_chart_image.copy()
        pie_chart_image = make_white_transparent(pie_chart_image)
        mask = pie_chart_image[:, :, 3] > 0
        pie_chart_image[mask, 3] = opacity
        return chart, pie_chart_image

    return None, None


def move_pie_chart_history(fighter, stats, size):
    """Most recent non-ignored move's pie, no fade
    (reference: graphs/onscreen.py:121-134)."""
    for frame, history in reversed(stats.stats[fighter.fighter_id].action_timeline.items()):
        if not history.action or history.action in PIE_CHART_IGNORED_MOVES:
            continue
        (success, punished, missed, total) = stats.move_counters(fighter, history.action)
        chart, img = _move_pie_chart(success, punished, missed, size)
        return chart, make_white_transparent(img.copy())
    return None, None


def defensive_option_chart(fighter, stats, width=400, height=320):
    """Movement/defensive option counts (reference: bar_charts.py:107-132)."""
    moves = (
        ("Movement", "Jump"),
        ("Movement", "ShortHop"),
        ("Movement", "Walk"),
        ("Movement", "Run"),
        ("Movement", "Squat"),
        ("Movement", "Wait"),
        ("Defensive", "Shield"),
        ("Defensive", "SpotDodge"),
        ("Defensive", "Roll"),
        ("Defensive", "AirDodge"),
        ("Defensive", "Parry"),
    )
    counts = tuple(stats.stats[fighter.fighter_id].action_count[m[1]] or 0 for m in moves)
    img = bar_graph_image(
        moves,
        counts,
        width=width,
        height=height,
        title=f"{fighter.fighter_name.title()} Defensive Options",
        orientation=math.pi / 4,
    )
    return None, img


# The 19-move board shared by the damage and outcome charts
# (reference: bar_charts.py:179-199, :380-411).
_MOVE_BOARD = (
    ("Jab", ""),
    ("Dash", ""),
    ("Tilt", "F"),
    ("Tilt", "U"),
    ("Tilt", "D"),
    ("Smash", "F"),
    ("Smash", "U"),
    ("Smash", "D"),
    ("Special", "N"),
    ("Special", "F"),
    ("Special", "U"),
    ("Special", "D"),
    ("Air", "N"),
    ("Air", "F"),
    ("Air", "B"),
    ("Air", "U"),
    ("Air", "D"),
    ("Air", "Z"),
    ("Grab", ""),
)


def move_damage_graph(fighter, stats, width=400, height=480):
    """Damage dealt vs received per move (reference: bar_charts.py:178-226)."""
    success = data_to_ys(
        stats.stats[fighter.fighter_id]["successful_action_damage"],
        SYMBOL_TO_WORD, ANIM_TO_CATEGORY, _MOVE_BOARD,
    )
    punished = data_to_ys(
        stats.stats[fighter.fighter_id]["punished_action_damage"],
        SYMBOL_TO_WORD, ANIM_TO_CATEGORY, _MOVE_BOARD,
    )
    img = _success_vs_punished_image(
        _MOVE_BOARD,
        tuple(success),
        tuple(punished),
        title=(
            f"{fighter.fighter_name.title()} Sum damage output for move / "
            "sum damage received for move"
        ),
        width=width,
        height=height,
        punished_label="damaged received",
        success_label="damage output",
    )
    return None, img


def move_success_punished_missed_bar_graph(fighter, stats, width=720, height=400):
    """Per-move outcome stacks (reference: bar_charts.py:379-448)."""
    fid = fighter.fighter_id
    success = data_to_ys(
        stats.stats[fid]["successful_action_count"], SYMBOL_TO_WORD, ANIM_TO_CATEGORY, _MOVE_BOARD
    )
    punished = data_to_ys(
        stats.stats[fid]["punished_action_count"], SYMBOL_TO_WORD, ANIM_TO_CATEGORY, _MOVE_BOARD
    )
    total = data_to_ys(
        stats.stats[fid]["action_count"], SYMBOL_TO_WORD, ANIM_TO_CATEGORY, _MOVE_BOARD
    )
    missed = tuple(
        max(total[i] - success[i] - punished[i], 0) for i in range(len(_MOVE_BOARD))
    )
    img = _success_punished_missed_image(
        _MOVE_BOARD,
        tuple(success),
        tuple(punished),
        missed,
        title=f"{fighter.fighter_name.title()} Successful / Punished / Missed Count",
        width=width,
        height=height,
        orientation=math.pi / 4,
    )
    return None, img


def disadvantage_tech_option_chart(fighter, stats, width=400, height=360):
    """(reference: bar_charts.py:229-252)"""
    moves = (
        ("", "TechInPlace"),
        ("", "TechRoll"),
        ("", "NormalGetUp"),
        ("", "GetUpAttack"),
        ("", "DownWait"),
    )
    total = [stats.stats[fighter.fighter_id].action_count[m[1]] or 0 for m in moves]
    punished = [stats.stats[fighter.fighter_id].punished_action_count[m[1]] or 0 for m in moves]
    successful = tuple(total[i] - punished[i] for i in range(len(total)))
    img = _success_vs_punished_image(
        moves,
        successful,
        tuple(punished),
        title=f"{fighter.fighter_name.title()} Disadvantage Tech Options",
        width=width,
        height=height,
    )
    return None, img


def disadvantage_ledge_option_chart(fighter, stats, width=400, height=360):
    """(reference: bar_charts.py:255-279)"""
    moves = (
        ("Disadvantage Ledge Option", "Attack"),
        ("Disadvantage Ledge Option", "NormalGetUp"),
        ("Disadvantage Ledge Option", "Hang"),
        ("Disadvantage Ledge Option", "Roll"),
        ("Disadvantage Ledge Option", "Jump"),
    )
    total = [
        stats.stats[fighter.fighter_id].action_count["Ledge" + m[1]] or 0 for m in moves
    ]
    punished = [
        stats.stats[fighter.fighter_id].punished_action_count["Ledge" + m[1]] or 0 for m in moves
    ]
    successful = tuple(total[i] - punished[i] for i in range(len(total)))
    labels = tuple(("", m[1]) for m in moves)
    img = _success_vs_punished_image(
        labels,
        successful,
        tuple(punished),
        title=f"{fighter.fighter_name.title()} Disadvantage Ledge Options",
        width=width,
        height=height,
    )
    return None, img


def action_chart(fighter, stats):
    """21-move action-count chart (reference: bar_charts.py:288-331)."""
    moves = (
        ("Jab", "N"),
        ("Tilt", "F"), ("Tilt", "U"), ("Tilt", "D"),
        ("Smash", "F"), ("Smash", "U"), ("Smash", "D"),
        ("Special", "N"), ("Special", "F"), ("Special", "U"), ("Special", "D"),
        ("Throw", "F"), ("Throw", "B"), ("Throw", "U"), ("Throw", "D"),
        ("Air", "N"), ("Air", "F"), ("Air", "B"), ("Air", "U"), ("Air", "D"), ("Air", "Z"),
    )
    counts = tuple(
        stats.stats[fighter.fighter_id].action_count[
            SYMBOL_TO_WORD[m[1]] + m[0] if m[0] != "Jab" else "Jab"
        ]
        or 0
        for m in moves
    )
    img = bar_graph_image(moves, counts, title="Actions")
    return None, img


# ---------------------------------------------------------------------------
# 5-slot history strips (reference: graphs/timeline.py:16-141)
# ---------------------------------------------------------------------------

import re as _re


def _split_camel_case(s):
    return _re.findall(r"[A-Z](?:[a-z]+|[A-Z]*(?=[A-Z]|$))", s)


def _timeline_strip(title, fighter, stats, moves, removed_words=()):
    """PIL-drawn 400x120 strip with the last 5 tech/ledge options and their
    success/punish counts (reference: graphs/timeline.py:16-102).

    Returns RGB (not RGBA) with the reference's B<->R swap preserved since
    the annotator writes it straight into an RGBA canvas's RGB channels.

    The drawing is cached on its visible data (last 5 entries + their
    live counters): strips were redrawn every frame — ~6 ms/frame on the
    GT path — while their pixels change only on new events or counter
    updates.
    """
    history_entries = []
    for frame, history in stats.stats[fighter.fighter_id].action_timeline.items():
        if history.action in moves:
            counters = stats.move_counters(fighter, history.action)
            history_entries.append((history.action, frame, counters))

    # Returned array is the lru-cached object itself — read-only by
    # contract (the annotator only blits it, and the identity lets its
    # blit-skip detect unchanged panels).
    return _timeline_strip_image(
        title, tuple(history_entries[-5:]), tuple(removed_words)
    )


@lru_cache(maxsize=64)
def _timeline_strip_image(title, history_entries, removed_words):
    title_height = 20
    image_width = 400
    image_height = 120
    num_sections = 5
    section_width = image_width // num_sections
    border_size = 2

    image = np.full((image_height, image_width, 3), 255, np.uint8)
    black = (0, 0, 0)

    for i in range(num_sections):
        if i != 0:
            pil_text.line(
                image,
                [(i * section_width, title_height), (i * section_width, image_height)],
                fill=black,
                width=border_size,
            )
        if i == num_sections - 1:
            pil_text.rectangle(
                image,
                [(0, 0), (image_width - border_size, image_height - border_size)],
                outline=black,
                width=border_size,
            )
            pil_text.rectangle(
                image,
                [(0, title_height), (image_width - border_size, image_height - border_size)],
                outline=black,
                width=border_size,
            )

    fnt = pil_text.truetype(TEXT_FONT_PATH, 15)
    pil_text.text(image, (3, 2), title, fnt, (0, 0, 0))

    for i in range(num_sections):
        if i >= len(history_entries):
            break
        text, frame_num, (success, punished, missed, total) = history_entries[
            len(history_entries) - i - 1
        ]
        x = i * section_width + 3
        pil_text.text(image, (x, title_height), "#" + str(i + 1), fnt, (0, 0, 0))
        # Reference draws success+missed in red and punished in blue
        # (its acknowledged count/color quirk, graphs/timeline.py:80-88).
        pil_text.text(image, (x, image_height - 20), str(success + missed), fnt, (255, 0, 0))
        pil_text.text(
            image,
            (x + section_width - 17, image_height - 20),
            str(punished),
            fnt,
            (0, 0, 255),
        )

        for word in removed_words:
            text = text.replace(word, "")
        text_split = _split_camel_case(text)
        bbox = pil_text.textbbox((0, 0), text, fnt)
        text_height = bbox[3] - bbox[1]
        starting_y = (image_height - text_height) // 2
        for j, part in enumerate(text_split):
            pil_text.text(image, (x + (section_width // 3), starting_y + j * 20), part, fnt,
                          (0, 0, 0))

    # Reference swaps B and R on output (graphs/timeline.py:104-105).
    return image[:, :, ::-1]


def disadvantage_tech_history(fighter, stats):
    moves = {
        "TechInPlace",
        "TechRoll",
        "NormalGetUp",
        "GetUpAttack",
        "DownWait",
        "MissedTech",
    }
    return _timeline_strip(
        f"{fighter.fighter_name.capitalize()} Disadvantage Tech History", fighter, stats, moves
    )


def disadvantage_ledge_history(fighter, stats):
    moves = {"LedgeAttack", "LedgeNormalGetUp", "LedgeRoll", "LedgeJump"}
    return _timeline_strip(
        f"{fighter.fighter_name.capitalize()} Disadvantage Ledge History",
        fighter,
        stats,
        moves,
        ("Ledge",),
    )
