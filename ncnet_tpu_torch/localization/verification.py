"""Pose verification by synthetic-view rendering (the reference's densePV
stage: ht_top10_NC4D_PV_localization.m + at_pv_wrapper.m + parfor_nc4d_PV.m).

Each query's top-N pose candidates are re-scored by rendering the candidate's
scan into the query camera at 1/8 scale and comparing dense RootSIFT
descriptors between the real query and the render; candidates are re-ranked
by descending score.  Work is grouped by unique scan so each point cloud
loads once.  The port of ``ncnet_tpu/localization/verification.py``: the
render, the inpainting and the score stay numpy on the host, the dense
SIFT runs on the caller's device.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ncnet_tpu_torch.localization import geometry
from ncnet_tpu_torch.localization.dsift import (
    pose_verification_score,
    rgb_to_gray,
)
from ncnet_tpu_torch.localization.render import render_points_perspective
from ncnet_tpu_torch.localization.scan import (
    load_scan_pointcloud,
    load_transformation,
    parse_cutout_name,
    scan_path,
    transformation_path,
    transform_points,
)
from ncnet_tpu_torch.observability import get_logger

log = get_logger("localization")

DOWNSAMPLE = 8  # the reference's dslevel = 8^-1 (parfor_nc4d_PV.m)


class PVItem(NamedTuple):
    query_fn: str
    db_fn: str
    P: np.ndarray


def downsample_image(img: np.ndarray, factor: int = DOWNSAMPLE) -> np.ndarray:
    """Box-filter 1/factor downsample (the render-vs-query comparison runs at
    1/8 scale).  Trailing rows/cols that do not fill a box are dropped."""
    h = img.shape[0] // factor * factor
    w = img.shape[1] // factor * factor
    x = np.asarray(img, dtype=np.float64)[:h, :w]
    x = x.reshape(h // factor, factor, w // factor, factor, -1).mean(axis=(1, 3))
    return x.squeeze(-1) if img.ndim == 2 else x


def verify_pose(
    query_img: np.ndarray,
    P: np.ndarray,
    scan_xyz: np.ndarray,
    scan_rgb: np.ndarray,
    focal: float,
    device=None,
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Score one pose candidate against one FULL-RESOLUTION query image
    (downsamples internally; see :func:`verify_pose_downsampled`)."""
    return verify_pose_downsampled(
        downsample_image(query_img), P, scan_xyz, scan_rgb, focal, device
    )


def verify_pose_downsampled(
    q_small: np.ndarray,
    P: np.ndarray,
    scan_xyz: np.ndarray,
    scan_rgb: np.ndarray,
    focal: float,
    device=None,
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Score one pose candidate against an already 1/8-downsampled query.

    ``q_small``: RGB float (H/8, W/8, 3); ``P``: 3×4 candidate; ``focal``:
    the FULL-resolution query focal (scaled internally, parfor_nc4d_PV.m
    ``fl·dslevel``); ``scan_xyz/rgb``: the candidate cutout's scan in GLOBAL
    coordinates.  Returns ``(score, RGBpersp, valid_mask)`` — score 0.0 for
    NaN poses, as in the reference.  The descriptors are computed on
    ``device`` (CUDA unless the caller passes another).
    """
    P = np.asarray(P, dtype=np.float64)
    if not np.all(np.isfinite(P)):
        return 0.0, np.zeros((0, 0, 3), np.uint8), np.zeros((0, 0), bool)
    h, w = q_small.shape[:2]
    K = geometry.intrinsics(focal / DOWNSAMPLE, h, w)
    rgb_persp, xyz_persp = render_points_perspective(
        scan_rgb, scan_xyz, K @ P, h, w
    )
    valid = np.all(np.isfinite(xyz_persp), axis=2)
    score = pose_verification_score(
        rgb_to_gray(q_small), rgb_to_gray(rgb_persp), valid, device=device
    )
    return score, rgb_persp, valid


def group_items_by_scan(items: Sequence[PVItem]) -> Dict[str, List[PVItem]]:
    """Bucket verification jobs by their cutout's (floor, scene, scan) so each
    scan point cloud is loaded exactly once
    (ht_top10_NC4D_PV_localization.m's unique-scan parfor grouping)."""
    groups: Dict[str, List[PVItem]] = {}
    for it in items:
        info = parse_cutout_name(it.db_fn)
        key = f"{info.floor}/{info.scene_id}_{info.scan_id}"
        groups.setdefault(key, []).append(it)
    return groups


def run_pose_verification(
    items: Sequence[PVItem],
    query_loader: Callable[[str], np.ndarray],
    scan_dir: str,
    trans_dir: str,
    focal_fn: Callable[[str, np.ndarray], float],
    out_dir: str = "",
    scan_suffix: str = ".ptx.mat",
    progress: bool = True,
    prepared_queries: Optional[Dict[str, Tuple[np.ndarray, float]]] = None,
    device=None,
) -> Dict[Tuple[str, str], float]:
    """Score every (query, db, P) item, grouped by scan.  Returns
    ``{(query_fn, db_fn): score}``.

    ``query_loader(fn)`` → RGB uint8 array; ``focal_fn(fn, img)`` → query
    focal in pixels at full resolution.  When ``out_dir`` is set, per-item
    ``.pv.mat`` artifacts (score + render) are written and reloaded on rerun
    (resume-by-artifact, parfor_nc4d_PV.m's exist guard).

    ``prepared_queries``: ``{query_fn: (downsampled image, full-res focal)}``
    — callers that split the work across processes pass these so each query
    is decoded/downsampled once globally instead of once per scan group.
    ``device``: where the dense SIFT runs (CUDA unless the caller passes
    another).
    """
    from scipy.io import loadmat

    from ncnet_tpu_torch.localization.pnp import artifact_stem
    from ncnet_tpu_torch.utils.io import atomic_savemat

    scores: Dict[Tuple[str, str], float] = {}
    # cache the 1/8-downsampled query (+ its full-res focal), not the full
    # image: 356 iPhone7 queries at full resolution would hold ~13 GB
    query_cache: Dict[str, Tuple[np.ndarray, float]] = dict(
        prepared_queries or {}
    )
    groups = group_items_by_scan(items)
    for gi, (key, group) in enumerate(sorted(groups.items())):
        scan_loaded = None
        for it in group:
            art = ""
            if out_dir:
                art = os.path.join(
                    out_dir, it.query_fn, artifact_stem(it.db_fn) + ".pv.mat"
                )
                if os.path.exists(art):
                    scores[(it.query_fn, it.db_fn)] = float(
                        loadmat(art)["score"].ravel()[0]
                    )
                    continue
            if scan_loaded is None:
                xyz_local, rgb = load_scan_pointcloud(
                    scan_path(scan_dir, it.db_fn, scan_suffix)
                )
                P_after = load_transformation(
                    transformation_path(trans_dir, it.db_fn)
                )
                scan_loaded = (transform_points(P_after, xyz_local), rgb)
            if it.query_fn not in query_cache:
                qimg = query_loader(it.query_fn)
                query_cache[it.query_fn] = (
                    downsample_image(qimg),
                    focal_fn(it.query_fn, qimg),
                )
            q_small, focal = query_cache[it.query_fn]
            score, rgb_persp, valid = verify_pose_downsampled(
                q_small, it.P, scan_loaded[0], scan_loaded[1], focal, device
            )
            scores[(it.query_fn, it.db_fn)] = score
            if art:
                os.makedirs(os.path.dirname(art), exist_ok=True)
                atomic_savemat(
                    art,
                    {"score": score, "RGBpersp": rgb_persp, "RGB_flag": valid},
                    do_compression=True,
                )
        if progress:
            log.info(f"ncnetPV: scan {key} ({gi + 1} / {len(groups)}) done.")
    return scores


def rerank_by_scores(
    topN_names: Sequence[str],
    poses: Sequence[np.ndarray],
    scores: Sequence[float],
):
    """Descending-score rerank of one query's candidate list
    (ht_top10_NC4D_PV_localization.m's sort).  Returns
    ``(names, poses, scores)`` reordered."""
    order = np.argsort(-np.asarray(scores, dtype=np.float64), kind="stable")
    return (
        [topN_names[i] for i in order],
        [poses[i] for i in order],
        [float(scores[i]) for i in order],
    )
