"""Crop geometry and camera projection.

The port's own copy of the projection functions and the ``YoloCrop`` box
of ``playaid_core_tpu/geometry.py``, as far as :mod:`playaid_core_torch.fighter`
and :mod:`playaid_core_torch.timeline` use them; the image helpers (square
crops, resizes, which need PIL and cv2) are not ported.  Rebuild of the
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

    def yolo_crop(self):
        return (self.center_x, self.center_y, self.crop_width, self.crop_height)
