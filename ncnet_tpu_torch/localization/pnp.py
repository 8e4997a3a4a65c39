"""Per-pair pose estimation from dense matches (parfor_NC4D_PE_pnponly.m);
the port of ``ncnet_tpu/localization/pnp.py``.

Takes one query↔cutout match table (the ``(N,5)`` rows eval_inloc wrote),
thresholds by score, lifts query matches to viewing rays and database matches
to global 3D via the cutout's depth map, and runs the batched LO-RANSAC P3P.
Artifacts are saved per pair with a resume-by-artifact guard, mirroring the
reference's ``exist(...)~=2`` skip.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import numpy as np

from ncnet_tpu_torch.localization import geometry
from ncnet_tpu_torch.localization.p3p import lo_ransac_p3p
from ncnet_tpu_torch.localization.scan import backproject_matches


class PnPResult(NamedTuple):
    P: np.ndarray               # (3,4) pose (NaN when not estimable)
    inliers: np.ndarray         # (M,) bool over the surviving tentatives
    tentatives_2d: np.ndarray   # (4,M) [xq; yq; xdb; ydb] pixel coords
    tentatives_3d: np.ndarray   # (6,M) [ray; X_global]
    idx_3d: np.ndarray          # (K,) bool: which thresholded matches had 3D


def estimate_pose_from_matches(
    matches: np.ndarray,
    query_size: Tuple[int, int],
    xyzcut: np.ndarray,
    P_after: np.ndarray,
    focal: float,
    score_thr: float = 0.75,
    inlier_thr_deg: float = 0.2,
    ransac_iters: int = 10000,
    seed: int = 0,
    max_tentatives: int = 0,
    device=None,
) -> PnPResult:
    """The reference's per-pair flow (parfor_NC4D_PE_pnponly.m):

      1. keep matches with ``score > score_thr``;
      2. query coords: ``pixel = size · normalized`` against the FULL-RES
         query image, rays through ``Kq⁻¹`` with the center principal point;
      3. db coords: floor-gather the cutout depth map, map through the scan
         transformation, drop non-finite 3D;
      4. LO-RANSAC P3P at the angular threshold (0.2° default, 10k samples).

    ``max_tentatives``: optional random subsample cap (the reference's
    ``params.ncnet.N_subsample`` branch); 0 = keep all.  The RANSAC scores
    its hypotheses on ``device`` (CUDA unless the caller passes another).
    """
    m = np.asarray(matches, dtype=np.float64).reshape(-1, 5)
    m = m[m[:, 4] > score_thr]
    if max_tentatives and len(m) > max_tentatives:
        sel = np.random.default_rng(seed).permutation(len(m))[:max_tentatives]
        m = m[sel]
    qh, qw = query_size
    xq = np.stack([qw * m[:, 0], qh * m[:, 1]], axis=1)  # (K,2) query pixels

    X_global, keep, db_px = backproject_matches(xyzcut, m[:, 2:4], P_after)
    xq = xq[keep]
    db_px = db_px[keep]
    K = geometry.intrinsics(focal, qh, qw)
    rays = geometry.pixel_rays(K, xq)

    tent_2d = np.concatenate([xq.T, db_px.T.astype(np.float64)], axis=0)
    tent_3d = np.concatenate([rays.T, X_global.T], axis=0)

    if X_global.shape[0] < 3:
        return PnPResult(
            np.full((3, 4), np.nan),
            np.zeros((X_global.shape[0],), dtype=bool),
            tent_2d,
            tent_3d,
            keep,
        )
    res = lo_ransac_p3p(
        rays,
        X_global,
        np.deg2rad(inlier_thr_deg),
        iters=ransac_iters,
        seed=seed,
        device=device,
    )
    return PnPResult(res.P, res.inliers, tent_2d, tent_3d, keep)


def artifact_stem(db_fn: str) -> str:
    """Collision-free flat filename stem for a db cutout path: directory
    components (floor etc.) joined into the name with ``__``.  The reference
    keys artifacts on the basename only (params.output.pnp_nc4d.matformat),
    so ``DUC1/X.jpg`` and ``DUC2/X.jpg`` collide — fatal here because the
    artifact is also the resume source of truth.  When a path segment itself
    contains ``__`` the join is ambiguous; a short path hash is appended to
    keep the mapping injective while leaving InLoc-style names readable."""
    rel = os.path.splitext(db_fn)[0].replace("\\", "/").strip("/")
    parts = [p for p in rel.split("/") if p]
    stem = "__".join(parts)
    # the join is uniquely decodable iff no part contains "__" and no part
    # starts/ends with "_" (the latter shows up as a ≥3-underscore run)
    if any("__" in p for p in parts) or "___" in stem:
        import hashlib

        stem += "." + hashlib.sha1(rel.encode()).hexdigest()[:8]
    return stem


def pnp_artifact_path(out_dir: str, query_fn: str, db_fn: str) -> str:
    """``<out_dir>/<query>/<floor>__<db-basename>.pnp_nc4d_inlier.mat``."""
    return os.path.join(
        out_dir, query_fn, artifact_stem(db_fn) + ".pnp_nc4d_inlier.mat"
    )


def run_pair_pnp(
    out_dir: str,
    query_fn: str,
    db_fn: str,
    matches: np.ndarray,
    query_size: Tuple[int, int],
    xyzcut: np.ndarray,
    P_after: np.ndarray,
    focal: float,
    **kwargs,
) -> Tuple[np.ndarray, np.ndarray]:
    """Estimate (or reload) the pose for one pair; persists the result .mat
    and skips work whose artifact exists — the resume-by-artifact behavior
    the reference uses as failure recovery (SURVEY §5.3).  Returns
    ``(P, inliers)``."""
    from scipy.io import loadmat

    from ncnet_tpu_torch.utils.io import atomic_savemat

    path = pnp_artifact_path(out_dir, query_fn, db_fn)
    if os.path.exists(path):
        mat = loadmat(path)
        return np.asarray(mat["P"]), np.asarray(mat["inls"]).ravel().astype(bool)
    res = estimate_pose_from_matches(
        matches, query_size, xyzcut, P_after, focal, **kwargs
    )
    os.makedirs(os.path.dirname(path), exist_ok=True)
    atomic_savemat(
        path,
        {
            "P": res.P,
            "inls": res.inliers,
            "tentatives_2d": res.tentatives_2d,
            "tentatives_3d": res.tentatives_3d,
            "idx_3d": res.idx_3d,
        },
        do_compression=True,
    )
    return res.P, res.inliers
