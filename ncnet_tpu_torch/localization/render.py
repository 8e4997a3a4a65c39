"""Point-cloud → perspective z-buffer render (the reference's external
``ht_Points2Persp``, used by parfor_nc4d_PV.m to synthesize the query view
from a pose candidate for pose verification).  A numpy copy of
``ncnet_tpu/localization/render.py``: the z-buffer stays on the host, where
a depth-descending scatter writes duplicate pixels in order (CUDA
``index_put_`` promises no order for duplicates)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def render_points_perspective(
    rgb: np.ndarray,
    xyz: np.ndarray,
    KP: np.ndarray,
    height: int,
    width: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Splat a colored point cloud through a 3×4 projective camera ``KP``.

    ``rgb (N,3) uint8``, ``xyz (N,3)`` world points.  Each point lands on its
    rounded pixel; the nearest-depth point per pixel wins (z-buffer via a
    depth-descending scatter — later writes are nearer).  Returns
    ``(RGBpersp (H,W,3) uint8, XYZpersp (H,W,3) float64)`` with zeros / NaN
    where no point projects — the NaN convention parfor_nc4d_PV.m keys its
    validity mask on (``RGB_flag = all(~isnan(XYZpersp), 3)``).
    """
    KP = np.asarray(KP, dtype=np.float64)
    uvw = np.asarray(xyz, dtype=np.float64) @ KP[:, :3].T + KP[:, 3]
    depth = uvw[:, 2]
    front = depth > 1e-9
    with np.errstate(divide="ignore", invalid="ignore"):
        u = uvw[:, 0] / depth
        v = uvw[:, 1] / depth
    col = np.round(u).astype(np.int64)
    row = np.round(v).astype(np.int64)
    ok = front & (col >= 0) & (col < width) & (row >= 0) & (row < height)
    ok &= np.isfinite(u) & np.isfinite(v)

    flat = row[ok] * width + col[ok]
    order = np.argsort(-depth[ok], kind="stable")  # nearest written last
    flat = flat[order]

    rgb_img = np.zeros((height * width, 3), dtype=np.uint8)
    xyz_img = np.full((height * width, 3), np.nan)
    rgb_img[flat] = np.asarray(rgb)[ok][order]
    xyz_img[flat] = np.asarray(xyz, dtype=np.float64)[ok][order]
    return (
        rgb_img.reshape(height, width, 3),
        xyz_img.reshape(height, width, 3),
    )
