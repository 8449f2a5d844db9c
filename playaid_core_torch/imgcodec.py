"""The one image-codec seam of the pixels-only path.

The port keeps the crops it makes without loss (``.npy``); only crops that
an external YOLOv5 wrote as jpg files pass through here.  Decoding a jpg
needs cv2; where cv2 is not installed (the card's machine) this raises an
``ImportError`` that says so.
"""

from __future__ import annotations

import numpy as np


def read_crop(path):
    """A crop file as a BGR uint8 array: ``.npy`` directly, an image file
    through cv2.  None when cv2 cannot decode the file, as cv2.imread."""
    if path.endswith(".npy"):
        return np.load(path)
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"reading the image file {path} needs cv2, which is not "
                          "installed; the port's own crops are .npy files") from e
    return cv2.imread(path)
