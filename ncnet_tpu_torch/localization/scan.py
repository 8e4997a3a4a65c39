"""InLoc scan assets: cutout names, scan transformations, depth back-projection
(a numpy/scipy copy of ``ncnet_tpu/localization/scan.py``).

The reference resolves a database cutout (e.g. ``DUC1/DUC_cutout_024_30_0.jpg``)
to its RGBD scan and the scan's local→global rigid transformation via two
external InLoc_demo helpers (``parse_WUSTL_cutoutname``,
``load_WUSTL_transformation``, called from parfor_NC4D_PE_pnponly.m and
at_pv_wrapper.m).  This module carries self-contained equivalents:

  * cutout filename → (floor, scene_id, scan_id), pattern
    ``<floor>/<scene>_cutout_<scan>_<pan>_<tilt>.<ext>``;
  * transformation text files: all whitespace rows of 4 floats are collected
    and the LAST 4×4 block is the local→global matrix ``P_after`` (the file's
    earlier block(s) hold the inverse/auxiliary transforms);
  * per-cutout ``XYZcut`` depth maps (.mat, one 3-vector per pixel, NaN where
    the scan has no return) gathered at match coordinates and mapped to global
    coordinates — the reference recipe (parfor_NC4D_PE_pnponly.m):
    db pixel = floor(size · normalized coord), zeros bumped to the first
    pixel, and only matches whose 3D is finite survive;
  * whole-scan point clouds (.mat with the scan's point list) transformed to
    global coordinates for the pose-verification render (at_pv_wrapper.m).
"""

from __future__ import annotations

import os
import re
from typing import NamedTuple, Tuple

import numpy as np

_CUTOUT_RE = re.compile(
    r"(?P<scene>[A-Za-z0-9]+)_cutout_(?P<scan>[A-Za-z0-9]+)_[^_]+_[^_.]+\.\w+$"
)


class CutoutInfo(NamedTuple):
    floor: str      # e.g. 'DUC1' — the path's leading directory
    scene_id: str   # e.g. 'DUC'
    scan_id: str    # e.g. '024'


def parse_cutout_name(name: str) -> CutoutInfo:
    """Split a cutout path into floor/scene/scan ids
    (parse_WUSTL_cutoutname + the floor split in parfor_NC4D_PE_pnponly.m)."""
    floor = name.replace("\\", "/").split("/")[0]
    m = _CUTOUT_RE.search(os.path.basename(name))
    if not m:
        raise ValueError(f"unrecognized cutout name: {name!r}")
    return CutoutInfo(floor, m.group("scene"), m.group("scan"))


def transformation_path(trans_dir: str, name: str) -> str:
    """Path of the scan transformation for a cutout:
    ``<trans_dir>/<floor>/transformations/<scene>_trans_<scan>.txt``
    (parfor_NC4D_PE_pnponly.m)."""
    info = parse_cutout_name(name)
    return os.path.join(
        trans_dir,
        info.floor,
        "transformations",
        f"{info.scene_id}_trans_{info.scan_id}.txt",
    )


def scan_path(scan_dir: str, name: str, suffix: str = ".ptx.mat") -> str:
    """Path of the full scan point cloud for a cutout:
    ``<scan_dir>/<floor>/<scene>_scan_<scan><suffix>``
    (ht_top10_NC4D_PV_localization.m)."""
    info = parse_cutout_name(name)
    return os.path.join(
        scan_dir, info.floor, f"{info.scene_id}_scan_{info.scan_id}{suffix}"
    )


def load_transformation(path: str) -> np.ndarray:
    """Local→global 4×4 from a WUSTL transformation text file.

    The file mixes prose/header lines with numeric rows; every maximal run of
    rows with exactly 4 floats is a matrix block, and the last 4-row block is
    ``P_after`` (the second return of the reference's
    ``load_WUSTL_transformation``).
    """
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            vals = []
            for p in parts:
                try:
                    vals.append(float(p))
                except ValueError:
                    vals = None
                    break
            rows.append(vals if vals and len(vals) == 4 else None)
    blocks = []
    run = []
    for r in rows + [None]:
        if r is not None:
            run.append(r)
        else:
            if len(run) >= 4:
                blocks.append(np.asarray(run[-4:], dtype=np.float64))
            run = []
    if not blocks:
        raise ValueError(f"no 4x4 block found in {path}")
    return blocks[-1]


def load_xyzcut(path: str) -> np.ndarray:
    """Per-pixel 3D map ``(H, W, 3)`` from a cutout's depth .mat
    (``XYZcut`` variable, parfor_NC4D_PE_pnponly.m)."""
    from scipy.io import loadmat

    mat = loadmat(path)
    xyz = np.asarray(mat["XYZcut"], dtype=np.float64)
    if xyz.ndim != 3 or xyz.shape[2] != 3:
        raise ValueError(f"XYZcut in {path} has shape {xyz.shape}")
    return xyz


def load_scan_pointcloud(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Whole-scan point list from a ``*_scan_*.ptx.mat``: returns
    ``(XYZ (N,3) float64, RGB (N,3) uint8)`` in SCAN-LOCAL coordinates.

    The reference's scan files store a cell array ``A`` with columns
    ``{X, Y, Z, ?, R, G, B}`` (at_pv_wrapper.m ``RGB=[A{5},A{6},A{7}]``,
    ``XYZ=[A{1},A{2},A{3}]``); scipy sees it as an object array.
    """
    from scipy.io import loadmat

    mat = loadmat(path)
    A = mat["A"]
    cols = [np.asarray(A[0, i]).reshape(-1) for i in range(A.shape[1])]
    xyz = np.stack(cols[0:3], axis=1).astype(np.float64)
    rgb = np.stack(cols[4:7], axis=1)
    return xyz, np.clip(rgb, 0, 255).astype(np.uint8)


def transform_points(P_after: np.ndarray, xyz: np.ndarray) -> np.ndarray:
    """Apply a 4×4 homogeneous transform to ``(N,3)`` points (at_pv_wrapper.m
    homogeneous divide included)."""
    h = xyz @ P_after[:3, :3].T + P_after[:3, 3]
    w = xyz @ P_after[3, :3].T + P_after[3, 3]
    return h / w[:, None]


def backproject_matches(
    xyzcut: np.ndarray,
    xy_norm: np.ndarray,
    P_after: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Database-side 3D points for matches in normalized [0,1] coordinates.

    Reference recipe (parfor_NC4D_PE_pnponly.m): pixel index =
    ``floor(size · coord)`` in MATLAB's 1-based indexing with zeros bumped to
    1 — equivalently, 0-based ``floor(size·coord) − 1`` clamped into range —
    then a global-coordinate map through the scan transformation, keeping only
    matches with finite 3D.

    Returns ``(X_global (M,3), keep (N,) bool, db_pixels (N,2) int)``.
    """
    H, W = xyzcut.shape[:2]
    xy = np.asarray(xy_norm, dtype=np.float64)
    col = np.floor(W * xy[:, 0]).astype(int)
    row = np.floor(H * xy[:, 1]).astype(int)
    col = np.clip(col, 1, W) - 1  # the reference's zero-fix, made 0-based
    row = np.clip(row, 1, H) - 1
    pts = xyzcut[row, col]  # (N,3) local scan coords
    pts_g = transform_points(np.asarray(P_after, dtype=np.float64), pts)
    keep = np.all(np.isfinite(pts_g), axis=1)
    return pts_g[keep], keep, np.stack([col, row], axis=1)
