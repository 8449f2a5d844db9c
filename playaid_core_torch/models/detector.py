"""Character detector: CenterNet-style keypoint detection.

Counterpart of ``playaid_core_tpu/models/detector.py``:

* a ResNet-18 trunk returning its stride-32 map (its identity blocks run as
  the fused residual-block kernel on the card, 64x112x64 to 8x14x512 at
  the 256x448 input);
* three transpose convs (4x4, stride 2) with batch norm and ReLU, to
  stride 4 (batch norm with Flax's training update, ``resnet.BatchNorm2d``,
  as in the trunk);
* three heads on the shared map, each a 3x3 conv, ReLU and a 1x1 conv:
  class heatmap logits (bias prior -2.19, a sigmoid of about 0.1), box
  size and sub-pixel centre offset, all float32;
* :func:`decode_detections`: 3x3 max-pool peak test and top-k on the
  device, no anchors and no NMS;
* training: :func:`gaussian_radius` and :func:`build_targets` (numpy, on
  the host, copied bit for bit), and :func:`focal_loss`,
  :func:`reg_l1_loss` and :func:`detector_loss` on the NHWC maps, with the
  JAX package's reductions.

Images come in NHWC float ``[B, H, W, 3]`` in [0, 1] and the maps go out
NHWC, as in the JAX package.  The network runs in full float32 (float64
weights and input stay float64: a reference run).  Flax's
``ConvTranspose`` with SAME padding is ``ConvTranspose2d(k=4, stride=2,
padding=1)`` on the spatially flipped kernel (``convert.py``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from playaid_core_torch.device import full_float32
from playaid_core_torch.models.resnet import BatchNorm2d, ResNet18, at_least_float32

HEATMAP_PRIOR = -2.19


class CenterNetDetector(nn.Module):
    def __init__(self, num_classes, head_channels=128):
        super().__init__()
        self.num_classes = num_classes
        self.trunk = ResNet18(num_classes=0, return_feature_map=True)
        ups, in_ch = [], 512
        for ch in (256, 128, head_channels):
            ups += [nn.ConvTranspose2d(in_ch, ch, 4, stride=2, padding=1),
                    BatchNorm2d(ch), nn.ReLU()]
            in_ch = ch
        self.up = nn.Sequential(*ups)
        self.heads = nn.ModuleDict({
            name: nn.Sequential(nn.Conv2d(head_channels, head_channels, 3, padding=1), nn.ReLU(),
                                nn.Conv2d(head_channels, out_ch, 1))
            for name, out_ch in (("heatmap", num_classes), ("size", 2), ("offset", 2))
        })

    def forward(self, images):
        """images ``[B, H, W, 3]`` float -> dict of stride-4 NHWC maps:
        heatmap ``[B, H/4, W/4, C]`` (logits), size ``[..., 2]`` (w, h in
        output cells), offset ``[..., 2]``."""
        with full_float32():
            x = self.up(self.trunk(at_least_float32(images.permute(0, 3, 1, 2))))
            return {name: at_least_float32(head(x).permute(0, 2, 3, 1))
                    for name, head in self.heads.items()}


# ---------------------------------------------------------------------------
# Targets and losses
# ---------------------------------------------------------------------------

def gaussian_radius(height, width, min_overlap=0.7):
    """CenterNet's minimum Gaussian radius such that corner-shifted boxes
    keep IoU >= min_overlap."""
    a1 = 1
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 - np.sqrt(max(b1**2 - 4 * a1 * c1, 0))) / 2

    a2 = 4
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 - np.sqrt(max(b2**2 - 4 * a2 * c2, 0))) / 2

    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + np.sqrt(max(b3**2 - 4 * a3 * c3, 0))) / 2
    return max(1.0, min(r1, r2, r3))


def build_targets(boxes, classes, valid, out_h, out_w, num_classes):
    """Host-side target splatting for one image.

    boxes: [M, 4] normalized yolo (cx, cy, w, h); classes: [M]; valid [M].
    Returns (heatmap [out_h, out_w, C], size [out_h, out_w, 2],
    offset [out_h, out_w, 2], mask [out_h, out_w]), float32 numpy.

    Gaussians are splatted only inside a (6*sigma)-radius window around
    each center (CenterNet's formulation); a box whose centre falls off the
    grid is skipped.
    """
    heat = np.zeros((out_h, out_w, num_classes), np.float32)
    size = np.zeros((out_h, out_w, 2), np.float32)
    offset = np.zeros((out_h, out_w, 2), np.float32)
    mask = np.zeros((out_h, out_w), np.float32)

    for m in range(boxes.shape[0]):
        if not valid[m]:
            continue
        cx, cy, w, h = boxes[m]
        cxs, cys = cx * out_w, cy * out_h
        ws, hs = w * out_w, h * out_h
        ci, cj = int(cys), int(cxs)
        if not (0 <= ci < out_h and 0 <= cj < out_w):
            continue
        radius = gaussian_radius(hs, ws)
        sigma = radius / 3.0
        r = max(int(np.ceil(3 * radius)), 1)
        y0, y1 = max(ci - r, 0), min(ci + r + 1, out_h)
        x0, x1 = max(cj - r, 0), min(cj + r + 1, out_w)
        ys, xs = np.ogrid[y0:y1, x0:x1]
        g = np.exp(-(((ys - ci) ** 2) + ((xs - cj) ** 2)) / (2 * sigma**2))
        c = int(classes[m])
        heat[y0:y1, x0:x1, c] = np.maximum(heat[y0:y1, x0:x1, c], g)
        size[ci, cj] = (ws, hs)
        offset[ci, cj] = (cxs - cj, cys - ci)
        mask[ci, cj] = 1.0
    return heat, size, offset, mask


def focal_loss(pred_logits, gt_heat, alpha=2.0, beta=4.0):
    """CenterNet's penalty-reduced pixel-wise focal loss: the sum over every
    cell and class, over the number of positives (cells at 0.999 or more),
    at least 1."""
    pred = torch.sigmoid(pred_logits).clamp(1e-6, 1 - 1e-6)
    pos = (gt_heat >= 0.999).to(pred.dtype)
    neg = 1.0 - pos
    pos_loss = -pos * ((1 - pred) ** alpha) * torch.log(pred)
    neg_loss = -neg * ((1 - gt_heat) ** beta) * (pred**alpha) * torch.log(1 - pred)
    num_pos = torch.clamp(pos.sum(), min=1.0)
    return (pos_loss.sum() + neg_loss.sum()) / num_pos


def reg_l1_loss(pred, gt, mask):
    """L1 at annotated centers only, over their number (at least 1)."""
    m = mask[..., None]
    num = torch.clamp(mask.sum(), min=1.0)
    return (torch.abs(pred - gt) * m).sum() / num


def detector_loss(outputs, targets, size_weight=0.1, offset_weight=1.0):
    """``targets = (heat, size, offset, mask)`` as :func:`build_targets`
    gives them, batched.  Returns the total and its parts (0-d tensors)."""
    heat, size, offset, mask = targets
    loss_h = focal_loss(outputs["heatmap"], heat)
    loss_s = reg_l1_loss(outputs["size"], size, mask)
    loss_o = reg_l1_loss(outputs["offset"], offset, mask)
    total = loss_h + size_weight * loss_s + offset_weight * loss_o
    return total, {"heatmap": loss_h, "size": loss_s, "offset": loss_o}


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------

def decode_detections(outputs, max_det=8, class_mask=None):
    """Peak extraction: 3x3 max-pool NMS and top-k, on the maps' device.

    ``class_mask`` (``[C]`` of 0/1) restricts decoding to the allowed class
    channels before the peaks are found, so a location whose best class is
    not allowed is re-attributed to its best allowed class.  Peaks are
    ranked as ``lax.top_k`` ranks them: by score, ties to the lower index of
    the NHWC-flattened heatmap (a stable descending sort).

    Returns (boxes ``[B, K, 4]`` normalised yolo, scores ``[B, K]``,
    classes ``[B, K]``).
    """
    heat = torch.sigmoid(outputs["heatmap"])  # [B, H, W, C]
    if class_mask is not None:
        heat = heat * class_mask.to(heat.dtype)[None, None, None, :]
    b, h, w, c = heat.shape
    pooled = F.max_pool2d(heat.permute(0, 3, 1, 2), 3, stride=1, padding=1).permute(0, 2, 3, 1)
    peaks = torch.where(torch.abs(pooled - heat) < 1e-6, heat, torch.zeros_like(heat))
    scores, idx = torch.sort(peaks.reshape(b, h * w * c), dim=1, descending=True, stable=True)
    scores, idx = scores[:, :max_det], idx[:, :max_det]
    cls = idx % c
    cell = idx // c
    cy, cx = cell // w, cell % w
    off = torch.gather(outputs["offset"].reshape(b, h * w, 2), 1, cell[..., None].expand(-1, -1, 2))
    sz = torch.gather(outputs["size"].reshape(b, h * w, 2), 1, cell[..., None].expand(-1, -1, 2))
    boxes = torch.stack([(cx.float() + off[..., 0]) / w, (cy.float() + off[..., 1]) / h,
                         sz[..., 0] / w, sz[..., 1] / h], dim=-1)
    return boxes, scores, cls
