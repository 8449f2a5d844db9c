"""Learned HUD digit reader: a small conv classifier over segmented
components.

Counterpart of ``playaid_core_tpu/infer/ocr_conv.py`` at inference: the
digit net (three 3x3 stride-2 convs with Flax's SAME padding, 0 before and
1 after at these even sizes, then two dense layers on the NHWC-flattened
map) runs on the card; segmentation and the letterboxed 48-px patches
(``INTER_AREA``, through ``imgproc.resize``) are made on the host.  The
weights are the port's own copy of the committed ``ocr_digits.npz``
(``assets/``), loaded into the module on its device once.  Synthetic fonts
and training wait for the training slice (ROADMAP.md).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from playaid_core_torch import imgproc
from playaid_core_torch.convert import from_jax_digits
from playaid_core_torch.device import full_float32, resolve_device
from playaid_core_torch.infer.ocr import assemble_reading, segment_digit_components

PATCH = 48
WEIGHTS_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "assets", "ocr_digits.npz")


def patch_from_component(comp, size=PATCH):
    """Letterbox a component's grayscale patch to ``[size, size]`` float
    in [0, 1], aspect kept."""
    patch = comp["patch"]
    h, w = patch.shape
    scale = (size - 2) / max(h, w)
    nh, nw = max(1, int(round(h * scale))), max(1, int(round(w * scale)))
    resized = imgproc.resize(patch, (nw, nh), "area")
    out = np.zeros((size, size), np.float32)
    y0, x0 = (size - nh) // 2, (size - nw) // 2
    out[y0:y0 + nh, x0:x0 + nw] = resized / 255.0
    return out


def _same_pad(x, kernel=3, stride=2):
    """Flax's SAME padding for a strided conv: the odd pixel goes after."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class DigitNet(nn.Module):
    """Patches ``[B, PATCH, PATCH, 1]`` -> digit logits ``[B, 10]``."""

    def __init__(self):
        super().__init__()
        self.c1 = nn.Conv2d(1, 24, 3, stride=2)
        self.c2 = nn.Conv2d(24, 48, 3, stride=2)
        self.c3 = nn.Conv2d(48, 96, 3, stride=2)
        self.d1 = nn.Linear(6 * 6 * 96, 96)
        self.out = nn.Linear(96, 10)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for conv in (self.c1, self.c2, self.c3):
            x = torch.relu(conv(_same_pad(x)))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC order, as Flax
        return self.out(torch.relu(self.d1(x)))


def load_params(path=WEIGHTS_PATH):
    """The npz of '/'-joined tree paths -> a nested dict of arrays."""
    params = {}
    with np.load(path) as data:
        for key in data.files:
            node = params
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return params


class ConvDigitOCR:
    """Damage reader: ``(bgr_crop) -> (ok, (value, raw, confidence,
    details))``, the learned classifier on the components of the shared
    segmentation.  ``params`` is the digit net's tree (the committed
    weights by default); ``device=None`` means the CUDA device."""

    def __init__(self, params=None, threshold=128, min_area=12, device=None):
        self.device = resolve_device(device)
        self.model = DigitNet()
        self.model.load_state_dict(from_jax_digits(params if params is not None
                                                   else load_params()))
        self.model = self.model.to(self.device).eval()
        self.threshold = threshold
        self.min_area = min_area

    @torch.inference_mode()
    def logits(self, patches):
        """Patches ``[B, PATCH, PATCH, 1]`` float32 (numpy) -> logits
        ``[B, 10]`` (numpy), computed on the reader's device."""
        with full_float32():
            x = torch.from_numpy(np.ascontiguousarray(patches, np.float32)).to(self.device)
            return self.model(x).cpu().numpy()

    def __call__(self, bgr_crop):
        comps, _ = segment_digit_components(bgr_crop, self.threshold, self.min_area)
        if not comps:
            return False, (-1, "", 0.0, {"components": 0})
        patches = np.stack([patch_from_component(c) for c in comps])[..., None]
        logits = self.logits(patches)
        probs = np.exp(logits - logits.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        digits = [str(int(i)) for i in probs.argmax(-1)]
        scores = [float(p.max()) for p in probs]
        return assemble_reading(comps, digits, scores)
