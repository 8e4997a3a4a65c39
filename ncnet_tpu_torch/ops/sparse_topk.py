"""Coarse-pass candidate selection for coarse-to-fine sparse correlation.

The port of ``ncnet_tpu/ops/sparse_topk.py``: the selection half of the
coarse-to-fine pipeline (the gathered fine evaluation is
``ops/sparse_corr.py``).

  * :func:`pool_features`: stride-f average pooling of the backbone grid,
    re-L2-normalized, so the coarse correlation stays a cosine similarity;
  * :func:`topk_candidates`: per-row top-k over the FILTERED coarse volume,
    one candidate row per coarse source cell, best first, ties broken
    towards the lower index as ``lax.top_k`` breaks them;
  * the coverage-padding contract (:func:`topk_candidates`,
    :func:`candidate_origins`, :func:`block_origins`): every shape is
    static whatever ``k`` or wherever a candidate sits.  ``k`` beyond the
    coarse target grid repeats the top-1 candidate, and every candidate's
    fine patch origin is clamped into the grid so that the patch always
    contains the candidate's full ``factor×factor`` fine block.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ncnet_tpu_torch.ops.norm import feature_l2_norm


def resolve_halo(halo: int, factor: int) -> int:
    """The fine-cell patch halo: ``halo < 0`` means one coarse ring
    (``factor`` fine cells)."""
    return factor if halo < 0 else halo


def patch_side(factor: int, halo: int) -> int:
    """Fine patch side: the candidate's ``factor``-cell block plus the halo
    on each side."""
    return factor + 2 * halo


def pool_features(f: torch.Tensor, factor: int,
                  renormalize: bool = True) -> torch.Tensor:
    """Average-pool a ``(B, H, W, C)`` feature grid by ``factor`` (the dims
    must divide) and optionally re-L2-normalize per location.  Pooling runs
    in f32 and the result is cast back to the input dtype."""
    b, h, w, c = f.shape
    if h % factor or w % factor:
        raise ValueError(f"feature grid {h}x{w} does not pool by {factor}")
    pooled = f.to(torch.float32).reshape(
        b, h // factor, factor, w // factor, factor, c).mean(dim=(2, 4))
    if renormalize:
        pooled = feature_l2_norm(pooled)
    return pooled.to(f.dtype)


def topk_candidates(coarse_corr: torch.Tensor, k: int) -> torch.Tensor:
    """``(B, Hc·Wc, k)`` int32 flattened coarse target indices (row-major
    ``i·wc + j``), best first, of the ``(B, Hc, Wc, hc, wc)`` filtered
    coarse volume.

    ``torch.topk`` promises no order among equal values, and the filtered
    volume is full of exact zeros; a stable descending sort keeps equal
    values in index order, which is ``lax.top_k``'s order.  When ``k``
    exceeds the coarse target grid the trailing slots repeat the top-1
    candidate."""
    b, ha, wa, hb, wb = coarse_corr.shape
    flat = coarse_corr.reshape(b, ha * wa, hb * wb).to(torch.float32)
    k_eff = min(int(k), hb * wb)
    idx = torch.sort(flat, dim=2, descending=True, stable=True).indices
    idx = idx[:, :, :k_eff].to(torch.int32)
    if k > k_eff:
        pad = idx[:, :, :1].expand(b, ha * wa, k - k_eff)
        idx = torch.cat([idx, pad], dim=2)
    return idx


def block_origins(n_coarse: int, factor: int, patch: int,
                  length: int) -> np.ndarray:
    """Static fine-grid patch origins of every coarse cell along one axis:
    ``clip(c·factor − halo, 0, length − patch)`` (a patch at the border
    shifts inward instead of shrinking)."""
    halo = (patch - factor) // 2
    c = np.arange(n_coarse) * factor - halo
    return np.clip(c, 0, length - patch).astype(np.int32)


def candidate_origins(cand: torch.Tensor, wc: int, factor: int, patch: int,
                      hb: int, wb: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fine-grid patch origins ``(oi, oj)`` of the ``(B, N, K)`` candidate
    coarse cells (decoded as ``(c // wc, c % wc)``), clamped by the rule of
    :func:`block_origins`; int32, shaped like ``cand``."""
    halo = (patch - factor) // 2
    ic = torch.div(cand, wc, rounding_mode="floor")
    jc = cand % wc
    oi = torch.clamp(ic * factor - halo, 0, hb - patch).to(torch.int32)
    oj = torch.clamp(jc * factor - halo, 0, wb - patch).to(torch.int32)
    return oi, oj


def candidate_recall(cand, dense_corr, factor: int) -> float:
    """Selection-quality diagnostic: the fraction of fine source cells
    whose dense fine-volume argmax target cell falls inside one of their
    coarse source cell's candidate neighbourhoods (host-side numpy; takes
    tensors or arrays)."""
    cand = _numpy(cand)
    dense_corr = _numpy(dense_corr).astype(np.float64)
    b, ha, wa, hb, wb = dense_corr.shape
    wc = wb // factor
    wac = wa // factor
    flat = dense_corr.reshape(b, ha * wa, hb * wb)
    best = np.argmax(flat, axis=2)
    bi, bj = best // wb, best % wb
    best_coarse = (bi // factor) * wc + (bj // factor)
    a = np.arange(ha * wa)
    coarse_a = (a // wa // factor) * wac + ((a % wa) // factor)
    hit = 0.0
    for bb in range(b):
        rows = cand[bb, coarse_a]
        hit += np.mean(np.any(rows == best_coarse[bb][:, None], axis=1))
    return float(hit / b)


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32 if x.is_floating_point()
                             else x.dtype).numpy()
    return np.asarray(x)
