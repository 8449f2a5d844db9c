"""Character-detector training: a dataset over YOLO-format trees, the train
step, and the trainer that serves ``detect``.

Counterpart of ``playaid_core_tpu/train/detector_train.py``:

* :class:`DetectionDataset` reads ``{root}/images/*.jpg`` (through cv2) or
  ``*.npy`` (BGR uint8, as ``cv2.imread`` gives the jpg; no cv2 needed)
  with labels at ``{root}/labels/<stem>.txt``, resizes with OpenCV's
  bilinear rule bit for bit (``imgproc.resize``), flips BGR to RGB and
  splats CenterNet targets on the host (``models/detector.py``
  ``build_targets``).  Every draw comes from one
  ``numpy.random.Generator`` (``seed``) in the JAX package's order, so a
  seed gives the JAX dataset's samples bit for bit.  ``sample_augment``'s
  photometric jitter (HSV, resize, JPEG round trip) runs on cv2, and the
  constructor refuses it where cv2 is missing.
* :func:`make_detector_train_step`: uint8 images divided by 255 on the
  device, the forward in training mode and the backward in full float32,
  ``detector_loss`` and one optimiser step; the loss and its parts stay
  on the device.
* :class:`DetectorTrainer`: the model (``CenterNetDetector``), AdamW with
  optax's semantics, Flax's seeded initialisers (:meth:`init`), weights
  carried from the JAX package (:meth:`load_variables`), :meth:`fit`
  (batches assembled in a background thread, copied two steps ahead
  through pinned slots, the JAX trainer's log records), :meth:`detect`
  (on the device: resize to the model input, the network with its
  identity blocks on the fused residual-block kernel, peak decoding) and
  :meth:`evaluate`.
* :func:`main`: the detector-training command line,
  ``python -m playaid_core_torch.train.detector_train``.

Every entry point runs on the CUDA device unless given ``device="cpu"``
(``--device cpu``), in float32 with TF32 off.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from glob import glob

import numpy as np
import torch

from playaid_core_torch import constants, imgcodec, imgproc
from playaid_core_torch.convert import from_jax_detector
from playaid_core_torch.device import full_float32, resolve_device
from playaid_core_torch.models.detector import (
    HEATMAP_PRIOR,
    CenterNetDetector,
    build_targets,
    decode_detections,
    detector_loss,
)
from playaid_core_torch.models.resnet import init_flax_
from playaid_core_torch.parallel.staging import BackgroundIterator, PinnedStager, device_prefetch
from playaid_core_torch.train.train import bump_versions_after_step


def _cv2_for_augment():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("DetectionDataset(sample_augment=True) needs cv2 (HSV jitter, "
                          "resize, JPEG round trip), which is not installed") from e
    return cv2


class DetectionDataset:
    """YOLO-format (images/, labels/) directory pair.

    ``sample_augment=True`` applies identity-safe geometric jitter (flip,
    zoom-crop) on the source image and photometric jitter and codec-style
    degradation on the resized input, per draw: a finite composite pool
    otherwise lets the class head memorise each exact pixel pattern."""

    def __init__(self, root, input_hw=(256, 448), num_classes=6, max_boxes=8,
                 stride=4, seed=None, sample_augment=False):
        self.images = sorted(glob(os.path.join(root, "images", "*.jpg"))
                             + glob(os.path.join(root, "images", "*.npy")))
        if not self.images:
            raise RuntimeError(f"no detection images under {root}")
        self.input_h, self.input_w = input_hw
        self.num_classes = num_classes
        self.max_boxes = max_boxes
        self.stride = stride
        self.sample_augment = sample_augment
        self._cv2 = _cv2_for_augment() if sample_augment else None
        self.rng = np.random.default_rng(seed)

    def _augment_input(self, img):
        """Identity-safe per-draw jitter on the resized uint8 RGB input."""
        cv2, rng = self._cv2, self.rng
        # brightness/contrast
        if rng.random() < 0.6:
            a = rng.uniform(0.85, 1.15)
            b = rng.uniform(-25, 25)
            img = np.clip(img.astype(np.float32) * a + b, 0, 255).astype(np.uint8)
        # mild hue/sat drift (identity-safe bounds)
        if rng.random() < 0.4:
            hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV).astype(np.int16)
            hsv[..., 0] = (hsv[..., 0] + rng.integers(-6, 7)) % 180
            hsv[..., 1] = np.clip(hsv[..., 1] + rng.integers(-20, 21), 0, 255)
            img = cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)
        # codec-style degradation: downscale/upscale then JPEG roundtrip
        if rng.random() < 0.5:
            if rng.random() < 0.5:
                f = rng.uniform(0.6, 0.9)
                h, w = img.shape[:2]
                img = cv2.resize(cv2.resize(img, (int(w * f), int(h * f))), (w, h))
            q = int(rng.integers(40, 95))
            ok, buf = cv2.imencode(".jpg", img[:, :, ::-1],
                                   [cv2.IMWRITE_JPEG_QUALITY, q])
            if ok:
                img = cv2.imdecode(buf, cv2.IMREAD_COLOR)[:, :, ::-1]
        # sensor noise
        if rng.random() < 0.3:
            noise = rng.normal(0, rng.uniform(2, 9), img.shape)
            img = np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)
        return img

    def __len__(self):
        return len(self.images)

    def _label_path(self, image_path):
        path = image_path.replace(os.sep + "images" + os.sep, os.sep + "labels" + os.sep)
        return os.path.splitext(path)[0] + ".txt"

    def _augment_geom(self, img, boxes, valid):
        """Per-draw horizontal flip and zoom-crop on the source-resolution
        image, with the normalised boxes remapped."""
        rng = self.rng
        if rng.random() < 0.5:
            img = img[:, ::-1]
            boxes = boxes.copy()
            boxes[:, 0] = 1.0 - boxes[:, 0]
        if rng.random() < 0.7:
            z = float(rng.uniform(0.72, 0.97))
            h, w = img.shape[:2]
            cw, ch = int(w * z), int(h * z)
            x0 = int(rng.integers(0, w - cw + 1))
            y0 = int(rng.integers(0, h - ch + 1))
            img = img[y0:y0 + ch, x0:x0 + cw]
            nb = boxes.copy()
            nb[:, 0] = (boxes[:, 0] * w - x0) / cw
            nb[:, 1] = (boxes[:, 1] * h - y0) / ch
            nb[:, 2] = boxes[:, 2] / z
            nb[:, 3] = boxes[:, 3] / z
            inside = ((nb[:, 0] > 0.01) & (nb[:, 0] < 0.99)
                      & (nb[:, 1] > 0.01) & (nb[:, 1] < 0.99))
            valid = valid & inside
            boxes = nb
        return np.ascontiguousarray(img), boxes, valid

    def sample(self, uint8=False):
        """One draw: (image ``[H, W, 3]`` RGB, uint8 or float32 / 255,
        targets ``(heat, size, offset, mask)``, ``(boxes, classes, valid)``)."""
        path = self.images[int(self.rng.integers(0, len(self.images)))]
        img = imgcodec.read_crop(path)

        boxes = np.zeros((self.max_boxes, 4), np.float32)
        classes = np.zeros((self.max_boxes,), np.int32)
        valid = np.zeros((self.max_boxes,), bool)
        with open(self._label_path(path)) as f:
            for i, line in enumerate(f):
                parts = line.split()
                if len(parts) < 5 or i >= self.max_boxes:
                    continue
                classes[i] = int(float(parts[0]))
                boxes[i] = [float(v) for v in parts[1:5]]
                valid[i] = 0 <= classes[i] < self.num_classes

        if self.sample_augment:
            img, boxes, valid = self._augment_geom(img, boxes, valid)
        img = imgproc.resize(img, (self.input_w, self.input_h))[..., ::-1]
        if self.sample_augment:
            img = self._augment_input(np.ascontiguousarray(img))
        img = np.ascontiguousarray(img)
        if not uint8:
            img = img.astype(np.float32) / 255.0

        out_h, out_w = self.input_h // self.stride, self.input_w // self.stride
        heat, size, offset, mask = build_targets(
            boxes, classes, valid, out_h, out_w, self.num_classes
        )
        return img, (heat, size, offset, mask), (boxes, classes, valid)

    def batches(self, batch_size, num_batches, uint8=True):
        """uint8 batches by default (the wire format: the train step divides
        by 255 on the device): ``(images [B, H, W, 3], (heat, size, offset,
        mask))``."""
        for _ in range(num_batches):
            imgs, heats, sizes, offsets, masks = [], [], [], [], []
            for _ in range(batch_size):
                img, (heat, size, offset, mask), _ = self.sample(uint8=uint8)
                imgs.append(img)
                heats.append(heat)
                sizes.append(size)
                offsets.append(offset)
                masks.append(mask)
            yield (
                np.stack(imgs),
                (np.stack(heats), np.stack(sizes), np.stack(offsets), np.stack(masks)),
            )


def make_detector_train_step(model, optimizer):
    """``train_step(images, targets) -> (loss, parts)``: one update of
    ``model`` by ``optimizer`` in training mode.  ``images`` ``[B, H, W,
    3]`` uint8 (divided by 255 here, in the weights' type) or float;
    ``targets`` the batched
    ``(heat, size, offset, mask)``; the results are 0-d tensors on the
    device (no host synchronisation)."""
    def train_step(images, targets):
        if not model.training:
            model.train()
        if images.dtype == torch.uint8:  # to the weights' type: float64 in a reference run
            images = images.to(next(model.parameters()).dtype) / 255.0
        with full_float32():
            outputs = model(images)
            loss, parts = detector_loss(outputs, targets)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        optimizer.step()
        return loss.detach(), {k: v.detach() for k, v in parts.items()}

    return train_step


class DetectorTrainer:
    """The CenterNet detector, its optimiser and its serving surface, on one
    device.  ``device=None`` means the CUDA device, and raises without one.

    The optimiser is ``torch.optim.AdamW`` (fused) with optax.adamw's
    semantics: b1 0.9, b2 0.999, eps 1e-8 outside the square root, and
    decoupled decay ``lr * weight_decay * p`` on every parameter."""

    def __init__(self, dataset=None, num_classes=6, learning_rate=5e-4, input_hw=(256, 448),
                 weight_decay=1e-4, device=None):
        self.dataset = dataset
        self.num_classes = num_classes
        self.input_hw = tuple(input_hw)
        self.device = resolve_device(device)
        self.model = CenterNetDetector(num_classes).to(self.device).eval()
        self.optimizer = bump_versions_after_step(torch.optim.AdamW(
            self.model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=weight_decay, fused=True))
        self.train_step = make_detector_train_step(self.model, self.optimizer)
        self.metrics_log = []
        self.initialized = False
        self._stager = PinnedStager(self.device)
        self._resize_tables = {}  # source (height, width) -> imgproc.linear_u8_tables
        self._class_masks = {}    # allowed class ids -> [C] mask on the device

    @torch.no_grad()
    def init(self, seed=0):
        """Seeded weights as Flax initialises the JAX model, drawn on the
        CPU from one ``torch.Generator`` in module order
        (``resnet.init_flax_``), so every device gets the same ones:
        lecun_normal kernels (a transposed conv's fan in is ``in * 16``),
        zero biases, unit batch-norm scales but a zero scale on each
        residual block's last, running mean 0 and variance 1; the heatmap's
        bias at the -2.19 prior."""
        model = init_flax_(CenterNetDetector(self.num_classes),
                           torch.Generator().manual_seed(seed))
        model.heads["heatmap"][2].bias.fill_(HEATMAP_PRIOR)
        self.model.load_state_dict(model.state_dict())
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

    def fit(self, num_steps, batch_size=8, log_every=20, log_path=None, verbose=False):
        """``num_steps`` steps on ``dataset.batches`` (assembled in a
        background thread, copied two steps ahead), from the seeded init
        (``init(0)``) when no weights were set.  Steps ``0, log_every, ...``
        and the last append a record ``{step, loss, heatmap, offset, size,
        seconds}`` (the JAX trainer's keys, in its order) to ``metrics_log``
        and to the JSONL at ``log_path``."""
        if not self.initialized:
            self.init(0)
        start = time.time()
        with BackgroundIterator(self.dataset.batches(batch_size, num_steps), maxsize=4) as batches:
            wire = ((images, *targets) for images, targets in batches)
            for step, (images, *targets) in enumerate(device_prefetch(wire, 2, self.device)):
                loss, parts = self.train_step(images, tuple(targets))
                if step % log_every == 0 or step == num_steps - 1:
                    rec = {
                        "step": step,
                        "loss": float(loss),
                        **{k: float(parts[k]) for k in sorted(parts)},
                        "seconds": round(time.time() - start, 1),
                    }
                    self.metrics_log.append(rec)
                    if verbose:
                        print(f"detector step {rec['step']}: loss {rec['loss']:.4f} "
                              f"({rec['seconds']}s)", flush=True)
                    if log_path:
                        with open(log_path, "a") as f:
                            f.write(json.dumps(rec) + "\n")
        return self

    def _class_mask(self, classes):
        key = tuple(sorted(set(classes)))
        if key not in self._class_masks:
            mask = np.zeros(self.num_classes, np.float32)
            mask[list(key)] = 1.0
            self._class_masks[key] = torch.from_numpy(mask).to(self.device)
        return self._class_masks[key]

    @torch.inference_mode()
    def detect(self, images_u8, max_det=8, score_threshold=0.3, classes=None):
        """images ``[B, H, W, 3]`` uint8 RGB (any size) -> per image
        ``[(class, score, yolo_box), ...]``, in eval mode.

        The uint8 frames are copied to the device as they are, through a
        pinned staging buffer; there they are resized to ``input_hw`` with
        OpenCV's bilinear rule, bit for bit (``imgproc.resize_linear_u8``,
        its tables built once per source size and kept on the device),
        divided by 255 and run.  ``classes``: allowed class ids; decoding is
        restricted to those heatmap channels (see ``decode_detections``).
        """
        if self.model.training:
            self.model.eval()
        x = self._stager.to_device(np.ascontiguousarray(images_u8))[0]
        src_hw = tuple(x.shape[1:3])
        if src_hw != self.input_hw:
            if src_hw not in self._resize_tables:
                self._resize_tables[src_hw] = imgproc.linear_u8_tables(
                    src_hw, self.input_hw, device=self.device)
            x = imgproc.resize_linear_u8(x, self.input_hw, tables=self._resize_tables[src_hw])
        outputs = self.model(x.float() / 255.0)
        mask = None if classes is None else self._class_mask(classes)
        boxes, scores, cls = (t.cpu().numpy() for t in decode_detections(outputs, max_det, mask))
        results = []
        for i in range(boxes.shape[0]):
            keep = scores[i] >= score_threshold
            results.append([(int(cls[i, k]), float(scores[i, k]), tuple(boxes[i, k]))
                            for k in np.nonzero(keep)[0]])
        return results

    def evaluate(self, dataset, num_images=64, score_threshold=0.05, tol=(0.06, 0.08)):
        """Centre-localisation and loc+class rates over ``num_images`` drawn
        from a (held-out) ``DetectionDataset`` in batches of 16: a box is
        found when a detection's centre is within ``tol`` of it, and
        classed when that first detection's class is its class.  The
        dataset's per-draw augmentation applies."""
        loc_hits, cls_hits, total = 0, 0, 0
        batch = 16
        done = 0
        while done < num_images:
            imgs, gts = [], []
            for _ in range(min(batch, num_images - done)):
                img, _t, (boxes, classes, valid) = dataset.sample(uint8=True)
                imgs.append(img)
                gts.append((boxes, classes, valid))
            done += len(imgs)
            dets = self.detect(np.stack(imgs), score_threshold=score_threshold)
            for d, (boxes, classes, valid) in zip(dets, gts):
                for m in range(len(valid)):
                    if not valid[m]:
                        continue
                    total += 1
                    for (c, _s, bb) in d:
                        if (abs(bb[0] - boxes[m][0]) < tol[0]
                                and abs(bb[1] - boxes[m][1]) < tol[1]):
                            loc_hits += 1
                            if c == int(classes[m]):
                                cls_hits += 1
                            break
        return {
            "loc": loc_hits / max(total, 1),
            "loc_class": cls_hits / max(total, 1),
            "boxes": total,
        }


def _parser():
    p = argparse.ArgumentParser(prog="python -m playaid_core_torch.train.detector_train",
                                description="Train the CenterNet character detector on a "
                                            "YOLO-format tree.")
    p.add_argument("--data-root", default=None, help="YOLO-format tree (images/, labels/)")
    p.add_argument("--num-steps", default=2000, type=int)
    p.add_argument("--batch-size", default=8, type=int)
    p.add_argument("--num-classes", default=len(constants.CHAR_LIST), type=int)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device; 'cpu' for the CPU)")
    return p


def main(argv=None):
    """Train on ``--data-root`` (default ``COMPOSITES_DIR/train``) and print
    the last log record."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    root = args.data_root or os.path.join(constants.COMPOSITES_DIR, "train")
    trainer = DetectorTrainer(DetectionDataset(root, num_classes=args.num_classes),
                              num_classes=args.num_classes, device=device)
    trainer.fit(args.num_steps, batch_size=args.batch_size)
    print(trainer.metrics_log[-1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
