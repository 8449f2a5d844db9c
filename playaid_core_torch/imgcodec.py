"""The one image-codec seam of the port.

The port keeps the images it makes without loss (``.npy``: crops, sprites
and stage textures, each holding what ``cv2.imread`` gives for the image
file it stands for); image files (an external YOLOv5's jpg crops, PNG
sprite trees) pass through here.  Decoding an image file needs cv2; where
cv2 is not installed (the card's machine) this raises an ``ImportError``
that says so.
"""

from __future__ import annotations

import numpy as np


def _cv2(path):
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"reading the image file {path} needs cv2, which is not "
                          "installed; the port's own images are .npy files") from e
    return cv2


def read_crop(path):
    """A crop or stage texture as a BGR uint8 array: ``.npy`` directly, an
    image file through cv2.  None when cv2 cannot decode the file, as
    cv2.imread."""
    if path.endswith(".npy"):
        return np.load(path)
    return _cv2(path).imread(path)


def read_sprite(path):
    """A sprite as BGRA uint8: ``.npy`` directly, an image file as
    ``cv2.imread(path, IMREAD_UNCHANGED)`` gives it, a 3-channel image made
    opaque as ``cv2.COLOR_BGR2BGRA`` makes it.  None when cv2 cannot
    decode the file."""
    if path.endswith(".npy"):
        img = np.load(path)
    else:
        cv2 = _cv2(path)
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is not None and img.shape[2] == 3:
        img = np.concatenate([img, np.full(img.shape[:2] + (1,), 255, np.uint8)], 2)
    return img
