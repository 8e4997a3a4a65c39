"""Temporal candidate selection for streaming (tracked) matching.

The port of ``ncnet_tpu/ops/temporal.py``.  Frame ``t-1``'s match table is
a prior for frame ``t``: this module turns it into candidate rows of the
exact ``(B, N, K)`` shape and coverage contract of
``sparse_topk.topk_candidates``, so the tracked frame runs the gathered-tile
fine pass without a coarse pass.

  * :func:`temporal_candidates`: dilation of a per-cell prior by a static
    ``(2r+1)²`` search window, clamped into the coarse grid (edge
    duplicates are harmless: the sparse scatter resolves them by max);
  * :func:`prior_from_table`: host-side inversion of a served ``(5|6, N)``
    match table into the prior pair the next frame seeds from;
  * :func:`tracking_recall_proxy`: the candidate-containment proxy of
    ``sparse_topk.candidate_recall`` on a tracked frame.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# every trunk downsamples by 16: the serving layer maps image sizes to
# feature grids with this constant
FEATURE_STRIDE = 16


def window_size(radius: int) -> int:
    """Candidates per prior cell: the ``(2r+1)²`` search window."""
    r = int(radius)
    if r < 0:
        raise ValueError(f"track radius must be >= 0, got {radius}")
    return (2 * r + 1) ** 2


def temporal_candidates(prior, hc: int, wc: int,
                        radius: int) -> torch.Tensor:
    """``(B, N, (2r+1)²)`` int32 candidate rows from a ``(B, N)`` prior of
    flattened coarse target indices (row-major ``i·wc + j``; out-of-grid
    values are clipped), every window clamped into the ``hc×wc`` grid and
    containing its prior cell."""
    k = window_size(radius)
    r = int(radius)
    prior = torch.as_tensor(prior)
    prior = torch.clamp(prior.to(torch.int32), 0, hc * wc - 1)
    ic = torch.div(prior, wc, rounding_mode="floor")
    jc = prior % wc
    d = torch.arange(-r, r + 1, dtype=torch.int32, device=prior.device)
    di = d.repeat_interleave(2 * r + 1)
    dj = d.repeat(2 * r + 1)
    wi = torch.clamp(ic[..., None] + di, 0, hc - 1)
    wj = torch.clamp(jc[..., None] + dj, 0, wc - 1)
    out = (wi * wc + wj).to(torch.int32)
    assert out.shape[-1] == k
    return out


def _cells_from_coords(x: np.ndarray, y: np.ndarray, h: int, w: int,
                       scale: str) -> Tuple[np.ndarray, np.ndarray]:
    """Invert ``corr_to_matches``' normalized coordinates onto integer grid
    cells (the ``linspace(lo, 1, n)`` convention, k_size 1)."""
    lo = -1.0 if scale == "centered" else 0.0
    span = 1.0 - lo
    j = np.rint((np.asarray(x, np.float64) - lo) * (w - 1) / span) \
        if w > 1 else np.zeros_like(x)
    i = np.rint((np.asarray(y, np.float64) - lo) * (h - 1) / span) \
        if h > 1 else np.zeros_like(y)
    return (np.clip(i, 0, h - 1).astype(np.int64),
            np.clip(j, 0, w - 1).astype(np.int64))


def identity_prior(n_src_coarse: int, wc_src: int, hc_tgt: int,
                   wc_tgt: int) -> np.ndarray:
    """Zero-motion prior: every coarse source cell looks at the same (row,
    col) of the target grid, clamped."""
    c = np.arange(n_src_coarse)
    i = np.minimum(c // wc_src, hc_tgt - 1)
    j = np.minimum(c % wc_src, wc_tgt - 1)
    return (i * wc_tgt + j).astype(np.int32)


def prior_from_table(table: np.ndarray, grid_a: Tuple[int, int],
                     grid_b: Tuple[int, int], factor: int,
                     scale: str = "centered"
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """``(prior_ab, prior_ba)`` int32 from one served ``(5|6, N)`` table
    (``N == hB·wB``, one entry per fine target cell; a quality row 5 is
    ignored): per coarse source cell the coarse target cell of its
    best-scoring claimant, per coarse target cell the coarse source cell of
    its best-scoring entry; unclaimed cells take :func:`identity_prior`."""
    t = np.asarray(table, dtype=np.float32)
    if t.ndim != 2 or t.shape[0] < 5:
        raise ValueError(f"match table must be (5|6, N), got {t.shape}")
    ha, wa = grid_a
    hb, wb = grid_b
    if t.shape[1] != hb * wb:
        raise ValueError(
            f"table has {t.shape[1]} rows, target grid {hb}x{wb} needs "
            f"{hb * wb}")
    xa, ya, xb, yb, score = t[0], t[1], t[2], t[3], t[4]
    ia, ja = _cells_from_coords(xa, ya, ha, wa, scale)
    ib, jb = _cells_from_coords(xb, yb, hb, wb, scale)
    hac, wac = ha // factor, wa // factor
    hbc, wbc = hb // factor, wb // factor
    ca = (ia // factor) * wac + (ja // factor)
    cb = (ib // factor) * wbc + (jb // factor)
    # score-ascending order: the last write per cell is the max-score entry
    order = np.argsort(score, kind="stable")
    prior_ba = identity_prior(hbc * wbc, wbc, hac, wac)
    prior_ba[cb[order]] = ca[order]
    prior_ab = identity_prior(hac * wac, wac, hbc, wbc)
    prior_ab[ca[order]] = cb[order]
    return prior_ab.astype(np.int32), prior_ba.astype(np.int32)


def tracking_recall_proxy(prior_ab: np.ndarray, table: np.ndarray,
                          grid_a: Tuple[int, int], grid_b: Tuple[int, int],
                          factor: int, radius: int,
                          scale: str = "centered") -> float:
    """The fraction of served entries whose (source → target) coarse
    pairing falls inside the search window the frame was seeded with
    (host-side numpy)."""
    t = np.asarray(table, dtype=np.float32)
    ha, wa = grid_a
    hb, wb = grid_b
    ia, ja = _cells_from_coords(t[0], t[1], ha, wa, scale)
    ib, jb = _cells_from_coords(t[2], t[3], hb, wb, scale)
    wac = wa // factor
    wbc = wb // factor
    ca = (ia // factor) * wac + (ja // factor)
    cb_i, cb_j = (ib // factor), (jb // factor)
    prior = np.asarray(prior_ab).reshape(-1)[ca]
    di = np.abs(cb_i - prior // wbc)
    dj = np.abs(cb_j - prior % wbc)
    r = int(radius)
    return float(np.mean((di <= r) & (dj <= r)))
