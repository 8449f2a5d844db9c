"""Model evaluation dashboards.

Counterpart of ``playaid_core_tpu/viz/eval_dashboard.py`` (the reference's
streamlit eval apps, visualizations/{cnn,rnn,resnet_transformer}_action_
detector_vis.py): sample dataset items, run a model, show per-frame strips
with ✅/❌ captions, accuracy and mean-confidence aggregates, and a
confusion matrix.

* the default backend is a self-contained static HTML report, its images
  inlined as base64 PNGs written with the standard library (``zlib``),
  since the card's machine has no PIL;
* ``streamlit``, when installed, drives a live app from the same records.

matplotlib (the confusion matrix, the training curves) and streamlit are
imported inside the functions that draw, so :func:`evaluate_samples` and
the PNG writer run where neither is installed.
"""

from __future__ import annotations

import base64
import html
import json
import os
import struct
import zlib

import numpy as np
import torch

_PNG_COLOUR_TYPES = {1: 0, 3: 2, 4: 6}  # channels -> grey, RGB, RGBA


def _png_chunk(tag, data):
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))


def _png_b64(img_u8):
    """A uint8 image ``[H, W]``, ``[H, W, 3]`` (RGB) or ``[H, W, 4]`` (RGBA) as
    a base64 PNG: 8 bits a sample, every row unfiltered, one zlib stream."""
    img = np.ascontiguousarray(img_u8)
    channels = 1 if img.ndim == 2 else img.shape[2]
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or channels not in _PNG_COLOUR_TYPES:
        raise TypeError(f"a PNG takes uint8 [H, W], [H, W, 3] or [H, W, 4], got {img.dtype} "
                        f"{img.shape}")
    h, w = img.shape[:2]
    rows = np.zeros((h, 1 + w * channels), np.uint8)  # filter byte 0: none
    rows[:, 1:] = img.reshape(h, -1)
    header = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOUR_TYPES[channels], 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
           + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _png_chunk(b"IEND", b""))
    return base64.b64encode(png).decode()


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _figure_rgba(plt, fig):
    fig.canvas.draw()
    out = np.asarray(fig.canvas.buffer_rgba()).copy()
    plt.close(fig)
    return out


def confusion_matrix_image(labels, preds, num_classes):
    """Confusion-matrix heatmap as an RGBA array (reference:
    visualizations/cnn_action_detector_vis.py:30-45)."""
    plt = _pyplot()
    cm = np.zeros((num_classes, num_classes), np.int64)
    for label, pred in zip(labels, preds):
        cm[label, pred] += 1
    fig, ax = plt.subplots(figsize=(8, 6), dpi=100)
    im = ax.imshow(cm, cmap="viridis")
    ax.set_xlabel("Predicted")
    ax.set_ylabel("Actual")
    fig.colorbar(im)
    return _figure_rgba(plt, fig)


def write_training_report(metrics_jsonl, out_path):
    """Static HTML training-curves report from a Trainer metrics JSONL: loss
    and accuracy curves, the gradient and parameter norms, and the train
    throughput (steps/s), one panel each where the records hold them."""
    with open(metrics_jsonl) as f:
        records = [json.loads(line) for line in f if line.strip()]
    if not records:
        raise ValueError(f"no records in {metrics_jsonl}")
    plt = _pyplot()
    epochs = [r.get("epoch", i) for i, r in enumerate(records)]
    panels = [
        ("loss", ["train_loss", "val_loss"]),
        ("accuracy", ["train_acc", "val_acc"]),
        ("gradient/param norms", ["grad_norm", "param_norm"]),
        ("throughput (steps/s)", ["steps_per_sec"]),
    ]
    parts = ["<html><head><title>Training report</title></head><body>",
             f"<h1>Training report</h1><p>{html.escape(str(metrics_jsonl))} "
             f"&mdash; {len(records)} epochs</p>"]
    for title, keys in panels:
        present = [k for k in keys if any(k in r for r in records)]
        if not present:
            continue
        fig, ax = plt.subplots(figsize=(7, 3), dpi=100)
        for k in present:
            ys = [r.get(k) for r in records]
            xs = [e for e, y in zip(epochs, ys) if y is not None]
            ax.plot(xs, [y for y in ys if y is not None], label=k)
        ax.set_title(title, fontsize=10)
        ax.set_xlabel("epoch", fontsize=8)
        ax.legend(fontsize=8)
        ax.tick_params(labelsize=7)
        fig.tight_layout()
        img = _figure_rgba(plt, fig)[:, :, :3]
        parts.append(f"<h2>{html.escape(title)}</h2>"
                     f"<img src='data:image/png;base64,{_png_b64(img)}'>")
    parts.append("</body></html>")
    _write(out_path, parts)
    return out_path


def _write(path, parts):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(parts))


def evaluate_samples(model_apply, dataset, total=16, center_supervised=True):
    """Run a model over the first ``total`` dataset samples; returns
    per-sample records and aggregates (the eval harness the reference ran
    in streamlit, visualizations/cnn_action_detector_vis.py:90-148).

    ``dataset[i]`` gives ``(frames [T, H, W, 3], char_id, labels [T],
    meta)``, the frames uint8 or float in [0, 1]; ``model_apply`` is any
    callable that takes ``torch.from_numpy(frames)[None]`` (on the CPU; it
    moves the batch where its model lives) and returns log-probs ``[1, C]``
    or ``[1, T, C]``, read back with ``.cpu()``."""
    records, labels, preds, confidences = [], [], [], []
    num_correct = 0
    actions = dataset.animations
    for i in range(total):
        frames, char_id, action_label, meta = dataset[i]
        center = frames.shape[0] // 2
        with torch.no_grad():
            log_probs = torch.as_tensor(model_apply(torch.from_numpy(frames)[None]))
        log_probs = log_probs.detach().cpu().numpy()
        flat = log_probs.reshape(-1, log_probs.shape[-1])
        if center_supervised and flat.shape[0] == 1:
            frame_logp = flat[0]
        else:
            frame_logp = flat[min(center, flat.shape[0] - 1)]
        predicted_id = int(np.argmax(frame_logp))
        confidence = float(np.exp(frame_logp[predicted_id])) * 100.0

        gt_id = int(action_label[center])
        is_accurate = predicted_id == gt_id
        num_correct += is_accurate
        labels.append(gt_id)
        preds.append(predicted_id)
        confidences.append(confidence)
        caption = f"{'✅' if is_accurate else '❌'} Pred: {actions[predicted_id]} "
        caption += f"{confidence:.2f}%"
        if not is_accurate:
            caption += f" | GT: {actions[gt_id]}"
        records.append({
            "frames": frames if frames.dtype == np.uint8 else (frames * 255).astype(np.uint8),
            "caption": caption,
            "correct": is_accurate,
            "confidence": confidence,
            "meta": {k: v for k, v in meta.items() if k != "frames"},
        })
    aggregates = {
        "total": total,
        "accuracy": num_correct / float(total),
        "mean_confidence": float(np.mean(confidences)) if confidences else 0.0,
        "labels": labels,
        "preds": preds,
    }
    return records, aggregates


def write_html_report(path, records, aggregates, actions, title="Action model eval"):
    """Static HTML dashboard with inline frame strips and the confusion
    matrix."""
    cm_img = confusion_matrix_image(aggregates["labels"], aggregates["preds"], len(actions))
    parts = [
        "<html><head><meta charset='utf-8'>",
        "<style>body{font-family:sans-serif;background:#111;color:#eee}"
        ".strip img{height:128px;margin:2px}"
        ".ok{color:#7c7}.bad{color:#e77}</style>",
        f"<title>{html.escape(title)}</title></head><body>",
        f"<h1>{html.escape(title)}</h1>",
        f"<p>{aggregates['total']} samples | "
        f"accuracy {aggregates['accuracy']:.2%} | "
        f"mean confidence {aggregates['mean_confidence']:.2f}%</p>",
    ]
    for rec in records:
        cls = "ok" if rec["correct"] else "bad"
        parts.append(f"<div class='strip'><p class='{cls}'>{html.escape(rec['caption'])}</p>")
        for frame in rec["frames"]:
            parts.append(f"<img src='data:image/png;base64,{_png_b64(frame)}'>")
        parts.append("</div><hr>")
    parts.append("<h2>Confusion matrix</h2>")
    parts.append(f"<img src='data:image/png;base64,{_png_b64(cm_img[:, :, :3])}'>")
    parts.append("</body></html>")
    _write(path, parts)
    return path


def streamlit_app(model_apply, dataset, total=16):
    """Live dashboard when streamlit is installed (reference behaviour)."""
    import streamlit as st

    records, aggregates = evaluate_samples(model_apply, dataset, total)
    st.title("Action model eval")
    for rec in records:
        st.image(list(rec["frames"]), caption=[rec["caption"]] + [" "] *
                 (len(rec["frames"]) - 1), width=200, clamp=True)
        st.write("-" * 80)
    st.write(f"% correct: {aggregates['accuracy']:.2f}")
    st.write(f"mean confidence: {aggregates['mean_confidence']:.2f}")
    st.image(confusion_matrix_image(aggregates["labels"], aggregates["preds"],
                                    len(dataset.animations)))
