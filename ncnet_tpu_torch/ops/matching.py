"""Mutual matching and match extraction over the 4D volume.

Reference semantics (and ``ncnet_tpu/ops/matching.py``, which this mirrors):
  * MutualMatching         lib/model.py:155-175
  * corr_to_matches        lib/point_tnf.py:12-80
  * nearest/bilinear tnf   lib/point_tnf.py:82-148
  * axis (un)normalization lib/point_tnf.py:6-10,151-167
  * scatter_sparse_scores  the coarse-to-fine pipeline's dense readout
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


def mutual_matching(corr: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Soft mutual-nearest-neighbour gating of the ``(B, hA, wA, hB, wB)``
    volume: ``corr * ((corr / (max_over_B + eps)) * (corr / (max_over_A +
    eps)))`` with the reference's eps and parenthesization."""
    max_over_a = torch.amax(corr, dim=(1, 2), keepdim=True)
    max_over_b = torch.amax(corr, dim=(3, 4), keepdim=True)
    ratio_b = corr / (max_over_a + eps)
    ratio_a = corr / (max_over_b + eps)
    return corr * (ratio_a * ratio_b)


def mutual_argmax_agreement(corr: torch.Tensor) -> torch.Tensor:
    """``(B,)`` fraction of B cells whose argmax A cell points back at them
    (the hard twin of :func:`mutual_matching`)."""
    b, ha, wa, hb, wb = corr.shape
    flat = corr.reshape(b, ha * wa, hb * wb)
    best_a = torch.argmax(flat, dim=1)   # (B, n_b)
    best_b = torch.argmax(flat, dim=2)   # (B, n_a)
    back = torch.gather(best_b, 1, best_a)
    agree = back == torch.arange(hb * wb, device=corr.device)[None, :]
    return agree.to(torch.float32).mean(dim=1)


def scatter_sparse_scores(values: torch.Tensor, ia: torch.Tensor,
                          ja: torch.Tensor, ib: torch.Tensor,
                          jb: torch.Tensor, shape: tuple) -> torch.Tensor:
    """Scatter sparse tile scores onto a zero-initialized dense
    ``(B, hA, wA, hB, wB)`` volume, cells covered by several tiles resolved
    by max (``ncnet_tpu/ops/matching.py::scatter_sparse_scores``).

    ``values`` ``(B, N, K, p, p, p, p)`` (source rows, source cols, target
    rows, target cols); ``ia``/``ja`` ``(N, p)`` fine source indices;
    ``ib``/``jb`` ``(B, N, K, p)`` fine target indices.  The index is the
    pair (source cell, target cell) linearized in int64, so it cannot wrap
    at any resolution.  The max is taken in float32 and cast back, which is
    exact for bf16 values."""
    b = values.shape[0]
    ha, wa, hb, wb = (int(d) for d in shape)
    lin_a = (ia.long()[None, :, None, :, None, None, None] * wa
             + ja.long()[None, :, None, None, :, None, None])
    lin_b = (ib.long()[:, :, :, None, None, :, None] * wb
             + jb.long()[:, :, :, None, None, None, :])
    lin = (lin_a * (hb * wb) + lin_b).expand(values.shape).reshape(b, -1)
    flat = torch.zeros((b, ha * wa * hb * wb), dtype=torch.float32,
                       device=values.device)
    flat.scatter_reduce_(1, lin, values.reshape(b, -1).to(torch.float32),
                         reduce="amax", include_self=True)
    return flat.to(values.dtype).reshape(b, ha, wa, hb, wb)


def normalize_axis(x, length):
    """Pixel coord (1-indexed convention) → [-1, 1] (point_tnf.py:6-7)."""
    return (x - 1 - (length - 1) / 2) * 2 / (length - 1)


def unnormalize_axis(x, length):
    """[-1, 1] → pixel coord (1-indexed convention) (point_tnf.py:9-10)."""
    return x * (length - 1) / 2 + 1 + (length - 1) / 2


class Matches(NamedTuple):
    """Dense matches extracted from a corr volume; all fields ``(B, N)``."""

    xA: torch.Tensor
    yA: torch.Tensor
    xB: torch.Tensor
    yB: torch.Tensor
    score: torch.Tensor


def _grid(lo: float, n: int, device) -> torch.Tensor:
    """``n`` float32 points from ``lo`` to 1, rounded as ``jnp.linspace(lo,
    1, n)`` is inside a jitted JAX program: ``t = i·f32(1/(n−1))``, then
    ``lo·(1−t) + t``, each step rounded to float32, endpoint appended.
    Match coordinates then agree with the JAX package's programs bit for
    bit (``torch.linspace`` rounds some points differently).  The
    reciprocal is rounded on the host (a number copied to the card would
    make the host wait for the card's queue)."""
    if n == 1:
        return torch.full((1,), lo, dtype=torch.float32, device=device)
    recip = float(np.float32(1.0) / np.float32(n - 1))
    t = torch.arange(n - 1, dtype=torch.float32, device=device) * recip
    head = lo * (1 - t) + t
    return torch.cat([head, torch.ones(1, dtype=torch.float32, device=device)])


def corr_to_matches(corr: torch.Tensor, delta4d=None, k_size: int = 1,
                    do_softmax: bool = False, scale: str = "centered",
                    invert_matching_direction: bool = False,
                    return_indices: bool = False):
    """Hard matches + scores out of the (filtered) ``(B, hA, wA, hB, wB)``
    volume.

    ``invert_matching_direction`` False picks the best A cell for every B
    cell (the reference default), True the best B cell for every A cell.
    ``scale`` 'centered' gives coordinates in [-1, 1], 'positive' in [0, 1].
    ``delta4d``: the relocalization offsets of
    :func:`~ncnet_tpu_torch.ops.pooling.maxpool4d_with_argmax`; with them
    the coordinates live on the ``k_size``× finer grid (fine = coarse·k +
    the offset at the matched coarse cell).
    """
    if scale not in ("centered", "positive"):
        raise ValueError(f"unknown scale {scale!r}")
    b, fs1, fs2, fs3, fs4 = corr.shape
    lo = -1.0 if scale == "centered" else 0.0
    dev = corr.device
    nc = corr.reshape(b, fs1 * fs2, fs3 * fs4)
    if invert_matching_direction:
        if do_softmax:
            nc = torch.softmax(nc, dim=2)
        score = torch.amax(nc, dim=2)
        idx = torch.argmax(nc, dim=2)            # into flattened B dims
        i_b, j_b = idx // fs4, idx % fs4
        cells = torch.arange(fs1 * fs2, device=dev)[None, :].expand_as(idx)
        i_a, j_a = cells // fs2, cells % fs2
    else:
        if do_softmax:
            nc = torch.softmax(nc, dim=1)
        score = torch.amax(nc, dim=1)
        idx = torch.argmax(nc, dim=1)            # into flattened A dims
        i_a, j_a = idx // fs2, idx % fs2
        cells = torch.arange(fs3 * fs4, device=dev)[None, :].expand_as(idx)
        i_b, j_b = cells // fs4, cells % fs4
    if delta4d is not None:  # relocalization onto the fine grid (point_tnf.py:61-70)
        bidx = torch.arange(b, device=dev)[:, None]
        d_ia, d_ja, d_ib, d_jb = (d[bidx, i_a, j_a, i_b, j_b].long()
                                  for d in delta4d)
        i_a = i_a * k_size + d_ia
        j_a = j_a * k_size + d_ja
        i_b = i_b * k_size + d_ib
        j_b = j_b * k_size + d_jb
    m = Matches(
        _grid(lo, fs2 * k_size, dev)[j_a],
        _grid(lo, fs1 * k_size, dev)[i_a],
        _grid(lo, fs4 * k_size, dev)[j_b],
        _grid(lo, fs3 * k_size, dev)[i_b],
        score,
    )
    if return_indices:
        return m, (i_a, j_a, i_b, j_b)
    return m


def nearest_neighbor_point_tnf(matches: Matches,
                               target_points_norm: torch.Tensor
                               ) -> torch.Tensor:
    """Warp normalized ``(B, 2, N)`` target points by snapping each to the
    nearest match's B coordinate and emitting its A coordinate
    (point_tnf.py:82-94)."""
    dx = target_points_norm[:, 0, :, None] - matches.xB[:, None, :]
    dy = target_points_norm[:, 1, :, None] - matches.yB[:, None, :]
    dist = torch.sqrt(dx ** 2 + dy ** 2)  # (B, N, M)
    idx = torch.argmin(dist, dim=2)
    return torch.stack([torch.gather(matches.xA, 1, idx),
                        torch.gather(matches.yA, 1, idx)], dim=1)


def bilinear_interp_point_tnf(matches: Matches,
                              target_points_norm: torch.Tensor,
                              grid_hw: Optional[Tuple[int, int]] = None
                              ) -> torch.Tensor:
    """Warp normalized ``(B, 2, N)`` target points by inverse-bilinear
    interpolation of the match field at the 4 surrounding B-grid corners
    (point_tnf.py:96-148).

    The matches come from the default (B→A) direction of
    :func:`corr_to_matches`, so ``(xB, yB)`` is the regular row-major B
    grid; ``grid_hw`` gives its ``(hB, wB)`` shape, square when None (the
    reference's ``sqrt(len(xB))``), and a ``ValueError`` says when it does
    not tile the matches.  The grid nodes are :func:`_grid`'s, as the JAX
    package's jitted programs round them."""
    n_match = matches.xB.shape[-1]
    if grid_hw is None:
        fs_h = fs_w = int(round(math.sqrt(n_match)))
    else:
        fs_h, fs_w = int(grid_hw[0]), int(grid_hw[1])
    if fs_h * fs_w != n_match:
        raise ValueError(f"grid {fs_h}x{fs_w} does not tile {n_match} matches")
    dev = target_points_norm.device
    grid_y = _grid(-1.0, fs_h, dev)
    grid_x = _grid(-1.0, fs_w, dev)

    def lower_index(coords, grid, fs):  # (B, N) → the node strictly below
        cnt = ((coords[:, :, None] - grid[None, None, :]) > 0).sum(dim=2) - 1
        return cnt.clamp(0, fs - 2)

    x_minus = lower_index(target_points_norm[:, 0, :], grid_x, fs_w)
    y_minus = lower_index(target_points_norm[:, 1, :], grid_y, fs_h)
    x_plus, y_plus = x_minus + 1, y_minus + 1

    def at(field_x, field_y, x, y):
        idx = y * fs_w + x  # row-major B grid
        return torch.stack([torch.gather(field_x, 1, idx),
                            torch.gather(field_y, 1, idx)], dim=1)

    corners = ((x_minus, y_minus), (x_plus, y_plus), (x_plus, y_minus),
               (x_minus, y_plus))  # mm, pp, pm, mp
    p_mm, p_pp, p_pm, p_mp = (at(matches.xB, matches.yB, x, y)
                              for x, y in corners)
    q_mm, q_pp, q_pm, q_mp = (at(matches.xA, matches.yA, x, y)
                              for x, y in corners)

    def area(d):
        return (d[:, 0, :] * d[:, 1, :]).abs()

    f_pp = area(target_points_norm - p_mm)
    f_mm = area(target_points_norm - p_pp)
    f_mp = area(target_points_norm - p_pm)
    f_pm = area(target_points_norm - p_mp)
    num = (q_mm * f_mm[:, None, :] + q_pp * f_pp[:, None, :]
           + q_mp * f_mp[:, None, :] + q_pm * f_pm[:, None, :])
    den = (f_pp + f_mm + f_mp + f_pm)[:, None, :]
    return num / den


def points_to_unit_coords(points: torch.Tensor,
                          im_size: torch.Tensor) -> torch.Tensor:
    """Pixel → [-1, 1] coordinates (point_tnf.py:151-158).  ``points``
    ``(B, 2, N)``, row 0 x (normalized by the width), row 1 y (by the
    height); ``im_size`` ``(B, 2+)`` as (h, w, ...)."""
    h, w = im_size[:, 0], im_size[:, 1]
    x = normalize_axis(points[:, 0, :], w[:, None])
    y = normalize_axis(points[:, 1, :], h[:, None])
    return torch.stack([x, y], dim=1)


def points_to_pixel_coords(points: torch.Tensor,
                           im_size: torch.Tensor) -> torch.Tensor:
    """[-1, 1] → pixel coordinates, the inverse of
    :func:`points_to_unit_coords` (point_tnf.py:160-167)."""
    h, w = im_size[:, 0], im_size[:, 1]
    x = unnormalize_axis(points[:, 0, :], w[:, None])
    y = unnormalize_axis(points[:, 1, :], h[:, None])
    return torch.stack([x, y], dim=1)
