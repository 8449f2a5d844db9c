"""Character detector: CenterNet-style keypoint detection, inference half.

Counterpart of ``playaid_core_tpu/models/detector.py``:

* a ResNet-18 trunk returning its stride-32 map (``layer4[1]`` runs as the
  fused residual-block kernel on the card, 8x14x512 at the 256x448 input);
* three transpose convs (4x4, stride 2) with batch norm and ReLU, to
  stride 4;
* three heads on the shared map, each a 3x3 conv, ReLU and a 1x1 conv:
  class heatmap logits (bias prior -2.19, a sigmoid of about 0.1), box
  size and sub-pixel centre offset, all float32;
* :func:`decode_detections`: 3x3 max-pool peak test and top-k on the
  device, no anchors and no NMS.

Images come in NHWC float ``[B, H, W, 3]`` in [0, 1] and the maps go out
NHWC, as in the JAX package.  The network runs in full float32.  Flax's
``ConvTranspose`` with SAME padding is ``ConvTranspose2d(k=4, stride=2,
padding=1)`` on the spatially flipped kernel (``convert.py``).  Targets,
Gaussian radii and the losses wait for the training slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from playaid_core_torch.device import full_float32
from playaid_core_torch.models.resnet import BN_EPS, ResNet18

HEATMAP_PRIOR = -2.19


class CenterNetDetector(nn.Module):
    def __init__(self, num_classes, head_channels=128):
        super().__init__()
        self.num_classes = num_classes
        self.trunk = ResNet18(num_classes=0, return_feature_map=True)
        ups, in_ch = [], 512
        for ch in (256, 128, head_channels):
            ups += [nn.ConvTranspose2d(in_ch, ch, 4, stride=2, padding=1),
                    nn.BatchNorm2d(ch, eps=BN_EPS), nn.ReLU()]
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
            x = self.up(self.trunk(images.permute(0, 3, 1, 2).float()))
            return {name: head(x).permute(0, 2, 3, 1).float() for name, head in self.heads.items()}


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
