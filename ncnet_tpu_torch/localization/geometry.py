"""Camera geometry for the localization stage (a numpy copy of
``ncnet_tpu/localization/geometry.py``).

Pose convention (matches the reference MATLAB code throughout lib_matlab/):
``P = [R | t]`` is a 3×4 world→camera map, ``x_cam = R @ X_world + t``; the
projective pixel is ``K @ x_cam``.  The camera center in world coordinates is
``C = -Rᵀ t`` (lib_matlab/p2c.m).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def camera_center(P: np.ndarray) -> np.ndarray:
    """World-coordinate camera center ``-Rᵀ t`` (lib_matlab/p2c.m)."""
    P = np.asarray(P, dtype=np.float64)
    return -P[:3, :3].T @ P[:3, 3]


def pose_distance(P1: np.ndarray, P2: np.ndarray) -> Tuple[float, float]:
    """(position error [m], orientation error [rad]) between two poses.

    Position error is the camera-center distance; orientation error is the
    geodesic angle ``acos((tr(R1⁻¹R2) − 1)/2)`` (lib_matlab/p2dist.m).
    """
    P1 = np.asarray(P1, dtype=np.float64)
    P2 = np.asarray(P2, dtype=np.float64)
    dpos = float(np.linalg.norm(camera_center(P1) - camera_center(P2)))
    R = np.linalg.solve(P1[:3, :3], P2[:3, :3])
    cos = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    return dpos, float(np.arccos(cos))


def intrinsics(focal: float, height: int, width: int) -> np.ndarray:
    """Pinhole K with the principal point at the image center — the query
    camera model of the PnP stage (parfor_NC4D_PE_pnponly.m builds
    ``Kq = [fl 0 W/2; 0 fl H/2; 0 0 1]``)."""
    return np.array(
        [
            [focal, 0.0, width / 2.0],
            [0.0, focal, height / 2.0],
            [0.0, 0.0, 1.0],
        ],
        dtype=np.float64,
    )


def iphone7_focal(height: int, width: int) -> float:
    """Default query focal length in pixels from the iPhone 7's 28 mm
    (35 mm-equivalent) lens: ``long_side · 28/36``.  The 35 mm-equivalence
    is defined against the sensor's LONG side (36 mm of a 36×24 frame), so
    portrait-stored queries (4032×3024 H×W) must use the height — keying on
    width alone would be ~33% low for them.  The reference reads a single
    constant ``params.data.q.fl`` from its external InLoc_demo setup; this
    reconstruction from the camera's EXIF spec is exposed as an overridable
    default (LocalizationConfig.query_focal_length)."""
    return max(height, width) * 28.0 / 36.0


def pixel_rays(K: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """Unit-norm viewing rays ``K⁻¹ [x; y; 1]`` for pixel coords ``xy (N,2)``.

    The reference keeps the un-normalized ray (parfor_NC4D_PE_pnponly.m
    ``Kq^-1 * [x;y;1]``) and lets the angular-threshold RANSAC normalize;
    normalizing here once keeps every downstream dot product a cosine.
    """
    xy = np.asarray(xy, dtype=np.float64)
    ones = np.ones((xy.shape[0], 1))
    rays = np.linalg.solve(
        np.asarray(K, dtype=np.float64), np.concatenate([xy, ones], axis=1).T
    ).T
    return rays / np.linalg.norm(rays, axis=1, keepdims=True)


def project_points(
    P: np.ndarray, K: np.ndarray, X: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Project world points ``X (N,3)`` through ``K @ [R|t]``.

    Returns ``(xy (N,2), depth (N,))``; points behind the camera get negative
    depth (callers mask on it).
    """
    P = np.asarray(P, dtype=np.float64)
    x_cam = X @ P[:3, :3].T + P[:3, 3]
    depth = x_cam[:, 2]
    uvw = x_cam @ np.asarray(K, dtype=np.float64).T
    with np.errstate(divide="ignore", invalid="ignore"):
        xy = uvw[:, :2] / uvw[:, 2:3]
    return xy, depth


def cap_longest_side_shape(
    height: int, width: int, max_side: int = 1920
) -> Tuple[int, int]:
    """Output shape of the localization-stage image cap: longest side scaled
    down to ``max_side``, aspect preserved; never upscales
    (lib_matlab/at_imageresize_nc4d.m)."""
    longest = max(height, width)
    if longest <= max_side:
        return height, width
    scale = max_side / longest
    if height >= width:
        return max_side, int(round(width * scale))
    return int(round(height * scale)), max_side
