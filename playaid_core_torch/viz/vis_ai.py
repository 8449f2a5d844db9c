"""vis_ai: what the AI pipeline predicted on a clip, as a static HTML report.

Counterpart of ``playaid_core_tpu/viz/vis_ai.py`` (the reference's
``vis_ai`` dashboard, visualizations/cnn_action_detector_vis.py:156-184)
over the port's ``AIRunner``: sampled frames' detector crops with the
predicted action and confidence, and, given ground-truth labels, ✅/❌
marks and the agreement over every frame.  Crops are read through
``imgcodec.read_crop`` (the port's ``.npy`` crops directly; a jpg of an
external detector needs cv2) and inlined as PNGs written with the standard
library.
"""

from __future__ import annotations

import html
import os

import numpy as np

from playaid_core_torch import imgcodec
from playaid_core_torch.viz.eval_dashboard import _png_b64, _write


def collect_vis_records(runner, gt_labels=None, sample_every=10, max_strips=40):
    """Sample the runner's per-frame predictions into display records.

    runner: an AIRunner whose run_detection_setup and run_action_recognition
    have completed.  gt_labels: optional {fighter: [action per frame]}, or
    an [F, num_fighters] array in runner.fighters order.
    Returns (records, aggregates).
    """
    fighters = runner.fighters
    if gt_labels is not None and not isinstance(gt_labels, dict):
        arr = np.asarray(gt_labels, object)
        gt_labels = {f: arr[:, k] for k, f in enumerate(fighters)}

    records = []
    hits = scored = 0
    for frame_num in range(1, runner.max_frames, sample_every):
        if len(records) >= max_strips:
            break
        row = {"frame": frame_num, "fighters": []}
        for fighter in fighters:
            data = runner.ai_output_data[fighter][frame_num - 1]
            crop_img = None
            crop_path = runner.get_crop_path(fighter, frame_num)
            if os.path.exists(crop_path):
                bgr = imgcodec.read_crop(crop_path)
                if bgr is not None:
                    crop_img = bgr[:, :, ::-1].copy()
            correct = None
            gt = None
            if gt_labels is not None and frame_num - 1 < len(gt_labels[fighter]):
                gt = gt_labels[fighter][frame_num - 1]
                correct = bool(data.action == gt)
                scored += 1
                hits += int(correct)
            row["fighters"].append({
                "fighter": fighter,
                "crop": crop_img,
                "action": data.action,
                "confidence": float(data.predicted_action_confidence or 0.0),
                "gt": gt,
                "correct": correct,
            })
        records.append(row)

    # Agreement over every frame, not only the sampled strips.
    full_hits = full_total = 0
    if gt_labels is not None:
        for fighter in fighters:
            labels = gt_labels[fighter]
            for i in range(min(runner.max_frames - 1, len(labels))):
                full_total += 1
                full_hits += int(runner.ai_output_data[fighter][i].action == labels[i])
    aggregates = {
        "sampled": len(records),
        "sampled_agreement": hits / scored if scored else None,
        "full_agreement": full_hits / full_total if full_total else None,
        "frames": runner.max_frames - 1,
    }
    return records, aggregates


def write_vis_ai_report(path, runner, gt_labels=None, sample_every=10,
                        max_strips=40, title="vis_ai — pixels-only pipeline"):
    """Static HTML report of an AIRunner run; returns (path, aggregates)."""
    records, aggregates = collect_vis_records(
        runner, gt_labels, sample_every=sample_every, max_strips=max_strips
    )
    parts = [
        "<html><head><meta charset='utf-8'>",
        "<style>body{font-family:sans-serif;background:#111;color:#eee}"
        "table{border-collapse:collapse}td{padding:4px 10px}"
        ".strip img{height:96px;margin:2px;border:1px solid #333}"
        ".ok{color:#7c7}.bad{color:#e77}.na{color:#aaa}</style>",
        f"<title>{html.escape(title)}</title></head><body>",
        f"<h1>{html.escape(title)}</h1>",
        f"<p>video: {html.escape(str(runner.input_video_path))} | "
        f"{aggregates['frames']} frames analyzed</p>",
    ]
    if aggregates["full_agreement"] is not None:
        parts.append(
            f"<p><b>action agreement vs ground truth: "
            f"{aggregates['full_agreement']:.2%}</b> (all frames)</p>"
        )
    for row in records:
        parts.append(f"<div class='strip'><h3>frame {row['frame']}</h3><table><tr>")
        for f in row["fighters"]:
            if f["correct"] is None:
                mark, cls = "", "na"
            elif f["correct"]:
                mark, cls = " ✅", "ok"
            else:
                mark, cls = f" ❌ (gt: {html.escape(str(f['gt']))})", "bad"
            img_html = (
                f"<img src='data:image/png;base64,{_png_b64(f['crop'])}'>"
                if f["crop"] is not None else "<i>no crop</i>"
            )
            parts.append(
                f"<td>{img_html}<br><span class='{cls}'>"
                f"{html.escape(f['fighter'])}: {html.escape(str(f['action']))} "
                f"({f['confidence']:.0f}%){mark}</span></td>"
            )
        parts.append("</tr></table></div><hr>")
    parts.append("</body></html>")
    _write(path, parts)
    return path, aggregates
