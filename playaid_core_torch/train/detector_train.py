"""The character detector's inference surface.

Counterpart of ``DetectorTrainer`` in ``playaid_core_tpu/train/
detector_train.py`` as far as serving needs it: the model at
``num_classes=6`` and ``input_hw=(256, 448)``, seeded weights
(:meth:`DetectorTrainer.init`), weights carried from the JAX package
(:meth:`DetectorTrainer.load_variables`) and :meth:`DetectorTrainer.detect`.
``fit``, ``evaluate`` and ``DetectionDataset`` wait for the training slice
(ROADMAP.md, queue 1).
"""

from __future__ import annotations

import numpy as np
import torch

from playaid_core_torch.convert import from_jax_detector
from playaid_core_torch.device import resolve_device
from playaid_core_torch.imgproc import resize_linear_u8
from playaid_core_torch.infer.vod_pipeline import PinnedStager
from playaid_core_torch.models.detector import HEATMAP_PRIOR, CenterNetDetector, decode_detections


class DetectorTrainer:
    """``device=None`` means the CUDA device, and raises without one."""

    def __init__(self, num_classes=6, input_hw=(256, 448), device=None):
        self.num_classes = num_classes
        self.input_hw = tuple(input_hw)
        self.device = resolve_device(device)
        self.model = CenterNetDetector(num_classes).to(self.device).eval()
        self.initialized = False
        self._stager = PinnedStager(self.device)

    @torch.no_grad()
    def init(self, seed=0):
        """Seeded random weights, drawn on the CPU from one
        ``torch.Generator`` in parameter order, so every device gets the
        same ones: weights ~ N(0, 1/fan_in), biases 0, batch-norm scales 1,
        running mean 0 and variance 1; the heatmap's bias at the -2.19
        prior."""
        gen = torch.Generator().manual_seed(seed)
        for name, p in self.model.named_parameters():
            if name == "heads.heatmap.2.bias":
                value = torch.full(p.shape, HEATMAP_PRIOR)
            elif name.endswith("bias"):
                value = torch.zeros(p.shape)
            elif p.dim() == 1:
                value = torch.ones(p.shape)
            else:
                value = torch.randn(p.shape, generator=gen) / p[0].numel() ** 0.5
            p.copy_(value)
        for name, buf in self.model.named_buffers():
            if name.endswith("running_mean"):
                buf.zero_()
            elif name.endswith("running_var"):
                buf.fill_(1.0)
        self.initialized = True
        return self

    def load_variables(self, variables):
        """Load the JAX ``DetectorTrainer``'s ``{params, batch_stats}`` numpy
        tree, or the port's state dict, into the model on its device.
        Nothing of ``variables`` is kept."""
        if all(isinstance(v, torch.Tensor) for v in variables.values()):
            state = variables
        else:
            state = from_jax_detector(variables)
        self.model.load_state_dict(state)
        self.initialized = True
        return self

    @torch.inference_mode()
    def detect(self, images_u8, max_det=8, score_threshold=0.3, classes=None):
        """images ``[B, H, W, 3]`` uint8 RGB (any size) -> per image
        ``[(class, score, yolo_box), ...]``.

        The uint8 frames are copied to the device as they are, through a
        pinned staging buffer on the card; there they are resized to ``input_hw`` with OpenCV's bilinear rule, bit for bit
        (``imgproc.resize_linear_u8``), divided by 255 and run.
        ``classes``: allowed class ids; decoding is restricted to those
        heatmap channels (see ``decode_detections``).
        """
        x = self._stager.to_device(np.ascontiguousarray(images_u8))[0]
        if tuple(x.shape[1:3]) != self.input_hw:
            x = resize_linear_u8(x, self.input_hw)
        outputs = self.model(x.float() / 255.0)
        mask = None
        if classes is not None:
            mask = torch.zeros(self.num_classes, device=self.device)
            mask[list(classes)] = 1.0
        boxes, scores, cls = (t.cpu().numpy() for t in decode_detections(outputs, max_det, mask))
        results = []
        for i in range(boxes.shape[0]):
            keep = scores[i] >= score_threshold
            results.append([(int(cls[i, k]), float(scores[i, k]), tuple(boxes[i, k]))
                            for k in np.nonzero(keep)[0]])
        return results
