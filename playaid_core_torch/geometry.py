"""Crop geometry and camera projection.

The port's own copy of the projection functions and the ``YoloCrop`` box
of ``playaid_core_tpu/geometry.py``, as far as :mod:`playaid_core_torch.fighter`,
:mod:`playaid_core_torch.timeline` and the pixels-only path (label lines,
interpolation, square crops, :func:`aspect_resize`) use them.  The image
helpers compute the JAX package's pixels without PIL or cv2, through
:mod:`playaid_core_torch.imgproc`.  Rebuild of the
reference's YoloCrop bbox type and pinhole camera model (reference:
fighter.py:31-390).  Two paths are provided:

* scalar host path — identical semantics to the reference, used by the
  Fighter state machine and file-based tools;
* vectorized batch path (``project_points_batch``,
  ``lookat_matrices_batch``) — numpy-broadcast projection of *all frames of
  a log at once*, which replaces the reference's 5-matrix-inversions-per-
  fighter-per-frame hot loop (reference: fighter.py:494-539) with one
  closed-form batched pass.  The look-at matrix [R|t] with orthonormal R is
  inverted analytically instead of with ``np.linalg.inv``.
"""

from __future__ import annotations

import numpy as np

from playaid_core_torch import imgproc


def calculate_focal_length(fov, image_width):
    """Focal length in pixels from horizontal FOV in degrees
    (reference: fighter.py:31-48)."""
    fov_rad = np.deg2rad(fov)
    return image_width / (2 * np.tan(fov_rad / 2))


def calculate_intrinsic_matrix(fov, image_width, image_height):
    """3x3 pinhole intrinsics (reference: fighter.py:66-84)."""
    f = calculate_focal_length(fov, image_width)
    return np.array(
        [[f, 0, image_width / 2], [0, f, image_height / 2], [0, 0, 1]], dtype=np.float64
    )


def calculate_lookat_matrix(camera_position, target_position):
    """4x4 look-at camera pose (reference: fighter.py:87-120).

    Rows are [right; up; -forward] with the translation column equal to the
    camera position (matching the reference's unconventional but load-bearing
    construction).
    """
    forward = np.asarray(camera_position, dtype=np.float64) - np.asarray(
        target_position, dtype=np.float64
    )
    forward = forward / np.linalg.norm(forward)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(up, forward)
    right = right / np.linalg.norm(right)
    up = np.cross(forward, right)
    lookat = np.eye(4)
    lookat[0, :3] = right
    lookat[1, :3] = up
    lookat[2, :3] = -forward
    lookat[:3, 3] = camera_position
    return lookat


def project_point_to_pixel(point_world, intrinsic_matrix, camera_pose, image_height=720):
    """World-space point -> integer pixel coordinate (reference:
    fighter.py:123-155), including the y-flip at the end."""
    point_world_homogeneous = np.append(point_world, 1)
    camera_pose_inverse = np.linalg.inv(camera_pose)
    point_camera = camera_pose_inverse @ point_world_homogeneous
    point_image_normalized = point_camera[:3] / point_camera[2]
    point_image_pixel = intrinsic_matrix @ point_image_normalized
    point_image_pixel[1] = image_height - point_image_pixel[1]
    return np.round(point_image_pixel[:2]).astype(int)


# ---------------------------------------------------------------------------
# Vectorized batch path
# ---------------------------------------------------------------------------

def lookat_matrices_batch(camera_positions, target_positions):
    """[N,3],[N,3] -> [N,4,4] look-at poses, matching
    :func:`calculate_lookat_matrix` element-wise."""
    cam = np.asarray(camera_positions, dtype=np.float64)
    tgt = np.asarray(target_positions, dtype=np.float64)
    forward = cam - tgt
    forward = forward / np.linalg.norm(forward, axis=-1, keepdims=True)
    up0 = np.array([0.0, 1.0, 0.0])
    right = np.cross(np.broadcast_to(up0, forward.shape), forward)
    right = right / np.linalg.norm(right, axis=-1, keepdims=True)
    up = np.cross(forward, right)
    n = cam.shape[0]
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, 0, :3] = right
    poses[:, 1, :3] = up
    poses[:, 2, :3] = -forward
    poses[:, :3, 3] = cam
    return poses


def invert_pose_batch(poses):
    """Analytic inverse of [N,4,4] poses whose upper-left 3x3 block R is
    orthonormal: inv = [[R^T, -R^T t],[0,1]]."""
    rot = poses[:, :3, :3]
    t = poses[:, :3, 3]
    inv = np.tile(np.eye(4), (poses.shape[0], 1, 1))
    rot_t = np.swapaxes(rot, 1, 2)
    inv[:, :3, :3] = rot_t
    inv[:, :3, 3] = -np.einsum("nij,nj->ni", rot_t, t)
    return inv


def project_points_batch(
    points_world, intrinsics, pose_inverses, image_height=720
):
    """Batched world->pixel projection.

    points_world   [N,3]
    intrinsics     [N,3,3] (or [3,3] broadcast)
    pose_inverses  [N,4,4] from :func:`invert_pose_batch`
    returns        [N,2] int pixel coords (rounded), same math as
                   :func:`project_point_to_pixel`.
    """
    pts = np.asarray(points_world, dtype=np.float64)
    homo = np.concatenate([pts, np.ones((pts.shape[0], 1))], axis=-1)
    cam_pts = np.einsum("nij,nj->ni", pose_inverses, homo)
    norm = cam_pts[:, :3] / cam_pts[:, 2:3]
    intr = np.asarray(intrinsics, dtype=np.float64)
    if intr.ndim == 2:
        pix = np.einsum("ij,nj->ni", intr, norm)
    else:
        pix = np.einsum("nij,nj->ni", intr, norm)
    pix[:, 1] = image_height - pix[:, 1]
    return np.round(pix[:, :2]).astype(int)


class YoloCrop:
    """Normalized [0,1] bbox with YOLO center/size representation
    (reference: fighter.py:158-390)."""

    def __init__(self, center_x, center_y, crop_width, crop_height, confidence=0, class_id=-1):
        self.center_x = center_x
        self.center_y = center_y
        self.crop_width = crop_width
        self.crop_height = crop_height
        self.confidence = confidence
        self.class_id = class_id

    @classmethod
    def from_pixel_coordinates(cls, image_width, image_height, x1, y1, x2, y2, x3, y3, x4, y4):
        """From 4 corner points in pixel space (reference: fighter.py:170-190)."""
        center_x = (x1 + x2 + x3 + x4) / 4
        center_y = (y1 + y2 + y3 + y4) / 4
        crop_width = max(x1, x2, x3, x4) - min(x1, x2, x3, x4)
        crop_height = max(y1, y2, y3, y4) - min(y1, y2, y3, y4)
        return cls(
            center_x / image_width,
            center_y / image_height,
            crop_width / image_width,
            crop_height / image_height,
        )

    @classmethod
    def from_string(cls, yolo_string):
        """A YOLOv5 label line ``class cx cy w h confidence``."""
        class_id, center_x, center_y, width, height, confidence = yolo_string.split(" ")
        return cls(
            float(center_x),
            float(center_y),
            float(width),
            float(height),
            confidence=float(confidence),
            class_id=int(class_id),
        )

    def interp(self, b, percent):
        """Linear interpolation toward crop ``b`` (reference: fighter.py:220-231)."""
        assert self.class_id == b.class_id, "Interpolating between two different class ids"
        return YoloCrop(
            self.center_x + percent * (b.center_x - self.center_x),
            self.center_y + percent * (b.center_y - self.center_y),
            self.crop_width + percent * (b.crop_width - self.crop_width),
            self.crop_height + percent * (b.crop_height - self.crop_height),
            confidence=self.confidence + percent * (b.confidence - self.confidence),
            class_id=self.class_id,
        )

    def yolo_crop(self):
        return (self.center_x, self.center_y, self.crop_width, self.crop_height)

    def xyxy_norm(self):
        return (
            self.center_x - self.crop_width / 2,
            self.center_y - self.crop_height / 2,
            self.center_x + self.crop_width / 2,
            self.center_y + self.crop_height / 2,
        )

    def xyxy_pixels(self, image_width, image_height):
        (x1, y1, x2, y2) = self.xyxy_norm()
        return (
            max(0, int(x1 * image_width)),
            max(0, int(y1 * image_height)),
            min(image_width, int(x2 * image_width)),
            min(image_height, int(y2 * image_height)),
        )

    def yolo_pixels(self, image_width, image_height):
        return (
            int(self.center_x * image_width),
            int(self.center_y * image_height),
            int(self.crop_width * image_width),
            int(self.crop_height * image_height),
        )

    def crop_img(self, image):
        (x1, y1, x2, y2) = self.xyxy_pixels(image.shape[1], image.shape[0])
        return image[y1:y2, x1:x2]

    def square_crop(self, image, output_size=128, padding=0):
        """Square letterboxed crop around the bbox centre (reference:
        fighter.py:323-381), pixel for pixel as the JAX package's, which
        goes through PIL and cv2: the window of ``2 * (max(w, h) // 2 +
        padding)`` pixels (cut at the frame's edges) is fitted into
        ``max(w, h)`` pixels by ``ImageOps.pad`` (bicubic, centred on
        black), then resized to ``output_size`` by ``aspect_resize``
        (``INTER_AREA``) and padded again if it is not square.

        ``padding`` in pixels (int), or as a fraction of the box's square
        dimension when a float in (0, 1).  Returns (ok, crop) with crop
        ``[output_size, output_size, 3]``; (False, None) when the fighter
        is off screen.
        """
        (center_x, center_y, crop_width, crop_height) = self.yolo_pixels(
            image.shape[1], image.shape[0]
        )
        square_dim = max(crop_width, crop_height)
        square_half = int(square_dim / 2)
        if isinstance(padding, float) and 0 < padding < 1:
            padding = int(round(padding * square_dim))

        raw_crop = image[
            max(center_y - square_half - padding, 0):min(
                center_y + square_half + padding, image.shape[0]
            ),
            max(center_x - square_half - padding, 0):min(
                center_x + square_half + padding, image.shape[1]
            ),
            :,
        ]

        if raw_crop.shape[0] != square_dim or raw_crop.shape[1] != square_dim:
            try:
                raw_crop = imgproc.pad(raw_crop, (square_dim, square_dim))
            except ValueError:
                return False, None

        if raw_crop.shape[0] == 0 or raw_crop.shape[1] == 0:
            return False, None  # the fighter is entirely off screen

        crop = aspect_resize(raw_crop, width=output_size)
        if crop.shape[0] != output_size or crop.shape[1] != output_size:
            crop = imgproc.pad(crop, (output_size, output_size))

        expected = (output_size, output_size, 3)
        if crop.shape != expected:
            raise ValueError(
                f"Bad output shape, expected {expected} got {crop.shape} "
                f"(raw_crop shape {raw_crop.shape})"
            )
        return True, crop

    def __str__(self):
        return (
            f"{self.class_id} {self.center_x} {self.center_y} {self.crop_width} "
            f"{self.crop_height} {self.confidence}"
        )

    def __repr__(self):
        return str(self)


def aspect_resize(image, width=None, height=None, interpolation="area"):
    """Aspect-preserving resize, ``cv2.INTER_AREA`` by default; ``width``
    wins when both are given (the imutils.resize behaviour the reference
    relies on, fighter.py:364)."""
    (h, w) = image.shape[:2]
    if width is None and height is None:
        return image
    if width is None:
        r = height / float(h)
        dim = (int(w * r), height)
    else:
        r = width / float(w)
        dim = (width, int(h * r))
    return imgproc.resize(image, dim, interpolation)
