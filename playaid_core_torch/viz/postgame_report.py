"""Post-game match report: the annotator's five summary charts plus the
narration history and per-move counter tables, rendered as one static
HTML artifact (instead of being watchable only as trailing video frames,
reference: annotator.py:315-347).

The port's own copy of ``playaid_core_tpu/viz/postgame_report.py``: the
charts come from the port's ``fast`` backend and the PNGs from the port's
zlib writer (``viz/eval_dashboard._png_b64``), so the report needs no PIL;
its command line is argparse (``python -m
playaid_core_torch.viz.postgame_report``)."""

from __future__ import annotations

import argparse
import html
import os

import numpy as np

from playaid_core_torch.render.charts import (
    defensive_option_chart,
    disadvantage_ledge_option_chart,
    disadvantage_tech_option_chart,
    move_damage_graph,
    move_success_punished_missed_bar_graph,
)
from playaid_core_torch.stats import Stats
from playaid_core_torch.timeline import (
    load_ground_truth_from_path,
    precompute_timeline_projection,
    update_fighters_from_timeline,
)
from playaid_core_torch.viz import eval_dashboard


def _png_b64(img):
    return eval_dashboard._png_b64(np.asarray(img)[:, :, :3])


SUMMARY_CHARTS = [
    ("Successful / punished / missed", move_success_punished_missed_bar_graph),
    ("Damage by move", move_damage_graph),
    ("Defensive options", defensive_option_chart),
    ("Tech options", disadvantage_tech_option_chart),
    ("Ledge options", disadvantage_ledge_option_chart),
]


def replay_stats(log_path, log_offset=0, max_frames=None):
    timeline = load_ground_truth_from_path(log_path, log_offset=log_offset)
    precompute_timeline_projection(timeline)
    stats = Stats()
    fighters = []
    total = len(timeline) if max_frames is None else min(max_frames, len(timeline))
    for i in range(total):
        fighters = update_fighters_from_timeline(i, timeline[i], fighters)
        stats.record_frame(fighters)
    return stats, fighters, total


def write_postgame_report(log_path, out_path, log_offset=0, max_frames=None,
                          title=None):
    stats, fighters, total = replay_stats(log_path, log_offset, max_frames)

    parts = [
        "<html><head><meta charset='utf-8'><style>"
        "body{font-family:sans-serif;background:#111;color:#eee;max-width:1700px}"
        "img{margin:4px;background:#fff}"
        "table{border-collapse:collapse}td,th{border:1px solid #555;padding:4px 8px}"
        "</style><title>Post-game report</title></head><body>",
        f"<h1>{html.escape(title or os.path.basename(log_path))}</h1>",
        f"<p>{total} frames | "
        + " vs ".join(f.fighter_name for f in fighters[:2]) + "</p>",
    ]

    # Per-move counters.
    for fighter in fighters[:2]:
        moves = sorted(
            m for m, c in stats.stats[fighter.fighter_id].action_count.items() if c
        )
        parts.append(f"<h2>{html.escape(fighter.fighter_name)} move counters</h2>")
        parts.append("<table><tr><th>move</th><th>success</th><th>punished</th>"
                     "<th>missed</th><th>total</th></tr>")
        for move in moves:
            s, p, m, t = stats.move_counters(fighter, move)
            parts.append(
                f"<tr><td>{html.escape(move)}</td><td>{s}</td><td>{p}</td>"
                f"<td>{m}</td><td>{t}</td></tr>"
            )
        parts.append("</table>")

    # Summary charts side by side per fighter.
    for name, chart_fn in SUMMARY_CHARTS:
        parts.append(f"<h2>{html.escape(name)}</h2>")
        for fighter in fighters[:2]:
            _, img = chart_fn(fighter, stats, width=760, height=420)
            parts.append(f"<img src='data:image/png;base64,{_png_b64(img)}'>")

    # Narration.
    parts.append("<h2>Narration</h2><ul>")
    for frame_num, text in stats.history_subset(0, total):
        parts.append(f"<li>#{frame_num}: {html.escape(text)}</li>")
    parts.append("</ul></body></html>")

    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        f.write("\n".join(parts))
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m playaid_core_torch.viz.postgame_report")
    p.add_argument("--log", "-l", dest="log_path", required=True)
    p.add_argument("--out", "-o", default="postgame_report.html")
    p.add_argument("--log-offset", default=0, type=int)
    args = p.parse_args(argv)
    path = write_postgame_report(args.log_path, args.out, log_offset=args.log_offset)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
