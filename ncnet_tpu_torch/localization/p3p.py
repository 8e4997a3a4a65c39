"""Absolute pose from 3 ray↔point correspondences, and LO-RANSAC around it.

The port of ``ncnet_tpu/localization/p3p.py``.  The reference solves PnP
per image pair with an external MATLAB routine
``ht_lo_ransac_p3p(rays, X, thr_rad, 10000)`` (parfor_NC4D_PE_pnponly.m) —
10,000 sequential minimal samples with local optimization.  Here the whole
RANSAC is batched:

  * the minimal samples are drawn and solved on the host in float64 numpy,
    as in the JAX package, so one seed gives the same triples and poses —
    Grunert's P3P reduces each sample to a quartic, whose roots come from
    one stacked companion-matrix ``eigvals`` call, and all candidate poses
    come from one stacked Kabsch (3×3 SVDs);
  * hypothesis scoring — the actual FLOPs, |hypotheses| × |points| angular
    residuals — runs in torch on the device, in chunks of hypotheses, as
    explicit f32 products and sums (no matmul, so no TF32 switch can reach
    the 0.2° threshold, ~100 f32 ulps of the cosine wide);
  * local optimization refines the best hypothesis on its inliers with the
    object-space orthogonal iteration of Lu-Hager-Mjolsness, re-scoring
    until the inlier set stops growing.

Pose convention: see geometry.py (``x_cam = R X + t``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ncnet_tpu_torch.models.ncnet import resolve_device

_REAL_ROOT_TOL = 1e-6  # |imag| ≤ tol·max(1,|real|) counts as a real root


def _quartic_roots(coeffs: np.ndarray) -> np.ndarray:
    """Roots of stacked quartics ``(H,5)`` (highest degree first) via the
    companion matrix; returns ``(H,4)`` complex (NaN-filled for degenerate
    leading coefficients)."""
    c = np.asarray(coeffs, dtype=np.float64)
    finite = np.isfinite(c).all(axis=1)  # degenerate samples (e.g. duplicate
    c = np.where(finite[:, None], c, 0.0)  # points) produce NaN coefficients
    lead_ok = finite & (np.abs(c[:, 0]) > 1e-12 * np.max(np.abs(c), axis=1))
    safe = np.where(lead_ok, c[:, 0], 1.0)
    monic = c / safe[:, None]
    H = c.shape[0]
    comp = np.zeros((H, 4, 4))
    comp[:, 1, 0] = comp[:, 2, 1] = comp[:, 3, 2] = 1.0
    comp[:, :, 3] = -monic[:, [4, 3, 2, 1]]
    roots = np.linalg.eigvals(comp)
    roots[~lead_ok] = np.nan
    return roots


def _kabsch(X: np.ndarray, Y: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Stacked rigid alignment: for each item find (R, t) minimizing
    ``‖Y − (R X + t)‖``.  ``X, Y: (..., N, 3)`` → ``R (...,3,3), t (...,3)``."""
    Xc = X - X.mean(axis=-2, keepdims=True)
    Yc = Y - Y.mean(axis=-2, keepdims=True)
    C = np.swapaxes(Yc, -1, -2) @ Xc  # (...,3,3) cross-covariance (Y·Xᵀ)
    U, _, Vt = np.linalg.svd(C)
    det = np.linalg.det(U @ Vt)
    D = np.zeros_like(C)
    D[..., 0, 0] = 1.0
    D[..., 1, 1] = 1.0
    D[..., 2, 2] = det
    R = U @ D @ Vt
    t = Y.mean(axis=-2) - np.squeeze(R @ X.mean(axis=-2)[..., None], -1)
    return R, t


def p3p_solve(rays: np.ndarray, X: np.ndarray) -> np.ndarray:
    """Grunert's P3P, batched: ``rays (H,3,3)`` unit viewing rays and
    ``X (H,3,3)`` world points → candidate poses ``(H,4,3,4)`` (≤4 real
    solutions per sample, invalid slots NaN).

    Method (Grunert 1841, in the formulation of Haralick et al., "Review and
    Analysis of Solutions of the Three Point Perspective Pose Estimation
    Problem", IJCV 1994): with point-camera distances s₁,s₂,s₃ and
    inter-point distances a,b,c, the law of cosines gives three equations;
    substituting u = s₂/s₁, v = s₃/s₁ eliminates to a quartic in v.  Each
    real root yields camera-frame points sᵢ·rayᵢ, and Kabsch aligns the world
    triangle onto them.
    """
    rays = np.asarray(rays, dtype=np.float64)
    X = np.asarray(X, dtype=np.float64)
    if rays.ndim == 2:
        rays, X = rays[None], X[None]
    H = rays.shape[0]

    a2 = np.sum((X[:, 1] - X[:, 2]) ** 2, axis=1)
    b2 = np.sum((X[:, 0] - X[:, 2]) ** 2, axis=1)
    c2 = np.sum((X[:, 0] - X[:, 1]) ** 2, axis=1)
    cos_a = np.sum(rays[:, 1] * rays[:, 2], axis=1)
    cos_b = np.sum(rays[:, 0] * rays[:, 2], axis=1)
    cos_g = np.sum(rays[:, 0] * rays[:, 1], axis=1)

    with np.errstate(divide="ignore", invalid="ignore"):
        ac_b = (a2 - c2) / b2  # (a²−c²)/b²
        apc_b = (a2 + c2) / b2
        A4 = (ac_b - 1.0) ** 2 - 4.0 * (c2 / b2) * cos_a**2
        A3 = 4.0 * (
            ac_b * (1.0 - ac_b) * cos_b
            - (1.0 - apc_b) * cos_a * cos_g
            + 2.0 * (c2 / b2) * cos_a**2 * cos_b
        )
        A2 = 2.0 * (
            ac_b**2
            - 1.0
            + 2.0 * ac_b**2 * cos_b**2
            + 2.0 * ((b2 - c2) / b2) * cos_a**2
            - 4.0 * apc_b * cos_a * cos_b * cos_g
            + 2.0 * ((b2 - a2) / b2) * cos_g**2
        )
        A1 = 4.0 * (
            -ac_b * (1.0 + ac_b) * cos_b
            + 2.0 * (a2 / b2) * cos_g**2 * cos_b
            - (1.0 - apc_b) * cos_a * cos_g
        )
        A0 = (1.0 + ac_b) ** 2 - 4.0 * (a2 / b2) * cos_g**2

    roots = _quartic_roots(np.stack([A4, A3, A2, A1, A0], axis=1))  # (H,4)
    real = (
        np.abs(roots.imag) <= _REAL_ROOT_TOL * np.maximum(1.0, np.abs(roots.real))
    ) & np.isfinite(roots.real)
    v = np.where(real, roots.real, np.nan)  # (H,4)

    with np.errstate(divide="ignore", invalid="ignore"):
        u = (
            (-1.0 + ac_b)[:, None] * v**2
            - 2.0 * (ac_b * cos_b)[:, None] * v
            + (1.0 + ac_b)[:, None]
        ) / (2.0 * (cos_g[:, None] - v * cos_a[:, None]))
        s1 = np.sqrt(
            b2[:, None] / (1.0 + v**2 - 2.0 * v * cos_b[:, None])
        )
        s2 = u * s1
        s3 = v * s1

    ok = (
        np.isfinite(s1) & np.isfinite(s2) & np.isfinite(s3)
        & (s1 > 0) & (s2 > 0) & (s3 > 0)
    )  # (H,4)
    s = np.stack([s1, s2, s3], axis=-1)  # (H,4,3) distances per solution
    s = np.where(ok[..., None], s, 1.0)
    Y = s[..., None] * rays[:, None, :, :]  # (H,4,3pts,3) camera-frame points
    Xr = np.broadcast_to(X[:, None], Y.shape)
    R, t = _kabsch(Xr.reshape(-1, 3, 3), Y.reshape(-1, 3, 3))
    P = np.concatenate([R, t[:, :, None]], axis=2).reshape(H, 4, 3, 4)
    P[~ok] = np.nan
    return P


def refine_pose_object_space(
    rays: np.ndarray, X: np.ndarray, P0: np.ndarray, iters: int = 20
) -> np.ndarray:
    """Object-space pose refinement (Lu, Hager & Mjolsness, PAMI 2000):
    alternate the closed-form optimal translation with a Procrustes rotation
    update, minimizing ``Σ‖(I − fᵢfᵢᵀ)(R Xᵢ + t)‖²``.  Used as the LO step of
    the RANSAC."""
    rays = np.asarray(rays, dtype=np.float64)
    X = np.asarray(X, dtype=np.float64)
    V = rays[:, :, None] * rays[:, None, :]  # (N,3,3) line-of-sight projectors
    I = np.eye(3)
    try:
        S = np.linalg.inv((I - V).sum(axis=0))  # (Σ(I−Vᵢ))⁻¹
    except np.linalg.LinAlgError:
        # all rays coincident (e.g. every tentative maps to one query pixel):
        # translation along the common ray is unobservable — keep the
        # hypothesis pose rather than aborting the caller's whole run
        return np.asarray(P0, dtype=np.float64)[:3, :4].copy()
    R = np.asarray(P0[:3, :3], dtype=np.float64).copy()
    t = np.asarray(P0[:3, 3], dtype=np.float64).copy()
    for _ in range(iters):
        t = -S @ np.einsum("nij,nj->i", I - V, X @ R.T)
        q = np.einsum("nij,nj->ni", V, X @ R.T + t)  # ray-projected targets
        R, t = _kabsch(X[None], q[None])
        R, t = R[0], t[0]
        t = -S @ np.einsum("nij,nj->i", I - V, X @ R.T)
    return np.concatenate([R, t[:, None]], axis=1)


class RansacResult(NamedTuple):
    P: np.ndarray          # (3,4) pose, NaN-filled when no model found
    inliers: np.ndarray    # (N,) bool
    num_inliers: int


def _inlier_mask(R: torch.Tensor, t: torch.Tensor, rays: torch.Tensor,
                 X: torch.Tensor, valid: torch.Tensor,
                 cos_thr: torch.Tensor) -> torch.Tensor:
    """``(h, n)`` angular inliers of ``h`` poses ``R (h,3,3)``, ``t (h,3)``
    over ``n`` points: ``cos∠(R X + t, ray) > cos_thr``, all in f32.

    Each row of ``R X + t`` and the dot with the ray are written out as
    elementwise products and sums (three ``(h, n)`` planes), in the order
    the JAX package's einsums sum them, so no matmul precision setting
    (TF32) changes a decision."""
    xc = []
    for i in range(3):
        x = R[:, i, 0, None] * X[:, 0]
        x += R[:, i, 1, None] * X[:, 1]
        x += R[:, i, 2, None] * X[:, 2]
        x += t[:, i, None]
        xc.append(x)
    norm = xc[0] * xc[0]
    norm += xc[1] * xc[1]
    norm += xc[2] * xc[2]
    norm = norm.sqrt_().clamp_min_(1e-12)
    dot = xc[0] * rays[:, 0]
    dot += xc[1] * rays[:, 1]
    dot += xc[2] * rays[:, 2]
    return (dot / norm > cos_thr) & valid


def _score_hypotheses(
    P: np.ndarray,
    rays: np.ndarray,
    X: np.ndarray,
    thr_rad: float,
    chunk: int = 2048,
    device=None,
) -> Tuple[int, int, np.ndarray]:
    """Best hypothesis index, its inlier count and mask, over ``P (M,3,4)``.

    Scored on ``device`` (CUDA unless the caller says otherwise) in chunks
    of ``chunk`` hypotheses, with the points padded to a power-of-two
    bucket (``valid`` masks the pad).  Every chunk's counts stay on the
    device and the best is read once: ``torch.argmax`` returns the first
    maximum, which is the JAX package's rule (``argmax`` within a chunk,
    a strict ``>`` across chunks: the lowest index wins a tie).  The
    hypotheses are not padded, so no zero pose can win.  NaN poses
    (invalid P3P roots) score zero through the cosine comparison.
    """
    dev = resolve_device(device)
    M, N = P.shape[0], rays.shape[0]
    n_pad = 1 << max(6, int(np.ceil(np.log2(max(N, 1)))))
    rays_p = np.zeros((n_pad, 3), dtype=np.float32)
    X_p = np.zeros((n_pad, 3), dtype=np.float32)
    rays_p[:N] = rays
    X_p[:N] = X
    valid = torch.zeros((n_pad,), dtype=torch.bool, device=dev)
    valid[:N] = True
    rays_t = torch.from_numpy(rays_p).to(dev)
    X_t = torch.from_numpy(X_p).to(dev)
    Pf = torch.from_numpy(
        np.nan_to_num(P.astype(np.float32), nan=0.0)).to(dev)
    cos_thr = torch.tensor(np.float32(np.cos(thr_rad)), device=dev)

    counts = torch.cat([
        _inlier_mask(Pf[lo:lo + chunk, :, :3], Pf[lo:lo + chunk, :, 3],
                     rays_t, X_t, valid, cos_thr).sum(dim=1)
        for lo in range(0, M, chunk)])
    best = torch.argmax(counts)
    mask = _inlier_mask(Pf[best, None, :, :3], Pf[best, None, :, 3], rays_t,
                        X_t, valid, cos_thr)[0, :N]
    best_idx, best_count = torch.stack([best, counts[best]]).tolist()
    return best_idx, best_count, mask.cpu().numpy()


def sample_triples(rng: np.random.Generator, iters: int, n: int) -> np.ndarray:
    """``(iters, 3)`` distinct index triples: draw ``(iters, n)``
    priorities, take the 3 smallest (kth=2 keeps ``n == 3`` legal) — exact
    sampling without rejection loops."""
    return rng.random((iters, n)).argpartition(2, axis=1)[:, :3]


def lo_ransac_p3p(
    rays: np.ndarray,
    X: np.ndarray,
    thr_rad: float,
    iters: int = 10000,
    seed: int = 0,
    lo_rounds: int = 3,
    rng: Optional[np.random.Generator] = None,
    device=None,
) -> RansacResult:
    """LO-RANSAC absolute pose (the ``ht_lo_ransac_p3p`` contract): unit
    ``rays (N,3)``, world points ``X (N,3)``, angular inlier threshold
    ``thr_rad``, ``iters`` minimal samples.  Degenerate input (<3 points)
    returns a NaN pose, as the caller does in the reference
    (parfor_NC4D_PE_pnponly.m ``P = nan(3,4)``).  The scoring runs on
    ``device``: CUDA unless the caller passes another (``"cpu"``)."""
    dev = resolve_device(device)
    rays = np.asarray(rays, dtype=np.float64)
    X = np.asarray(X, dtype=np.float64)
    N = rays.shape[0]
    nan_result = RansacResult(
        np.full((3, 4), np.nan), np.zeros((N,), dtype=bool), 0
    )
    if N < 3:
        return nan_result

    rng = rng or np.random.default_rng(seed)
    pri = sample_triples(rng, iters, N)
    poses = p3p_solve(rays[pri], X[pri]).reshape(-1, 3, 4)
    keep = np.isfinite(poses[:, 0, 0])
    poses = poses[keep]
    if poses.shape[0] == 0:
        return nan_result

    best_idx, best_count, best_mask = _score_hypotheses(poses, rays, X, thr_rad,
                                                         device=dev)
    if best_count < 3:
        return nan_result
    P = poses[best_idx]

    # local optimization: refine on the current inlier set, keep if the
    # refit's consensus does not shrink, stop when it stops growing
    for _ in range(lo_rounds):
        P_ref = refine_pose_object_space(rays[best_mask], X[best_mask], P)
        _, count_ref, mask_ref = _score_hypotheses(
            P_ref[None], rays, X, thr_rad, device=dev
        )
        if count_ref < best_count:
            break
        improved = count_ref > best_count
        P, best_count, best_mask = P_ref, count_ref, mask_ref
        if not improved:
            break
    return RansacResult(P, best_mask, int(best_count))
