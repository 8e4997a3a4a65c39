"""Coarse-volume retrieval scoring: the cheap proxy for full matching, the
port of ``ncnet_tpu/retrieval/scoring.py`` (numpy, bit-equal to it).

Per Dual-Resolution Correspondence Networks (PAPERS.md), a low-resolution
correlation is a faithful stand-in for the full 4D match — so retrieval
scores a query's POOLED coarse descriptor against each pano's cached
coarse volume instead of running the O((hw)^2) dense pipeline per
candidate.  The cached unit is 1/factor^4 the size of a dense feature
entry (~117 MB/pano at 3200 px), which is what makes a millions-of-panos
sweep a memory-resident numpy pass per shard.

Conventions (shared by the index builder, the shard scorer, and the InLoc
in-system shortlist — one module so they can never drift):

  * a **coarse volume** is ``(h, w, c) float32``, L2-normalized per
    location (the port's trunk returns channels-last ``(B, h, w, C)``
    features, as the JAX package's does; entries store the same layout:
    a caller on the card hands ``features.float().cpu().numpy()``);
  * a **query descriptor** is ``(c,) float32``, unit-norm — the pooled
    coarse query;
  * the **score** is the max cosine similarity over the pano's coarse
    locations: "somewhere in this pano looks like the query", the
    retrieval analog of the match-volume max the fine stage ranks by.

Two extractors feed the same formats: :func:`coarse_volume_from_features`
pools real backbone features by ``factor`` (the coarse pass's
resolution), and :func:`raw_coarse_volume` builds a model-free local
color/gradient-statistics grid straight from the uint8 image — the CPU
path the chaos suite and the ``--raw`` index builder run with zero
compiles.  The store fingerprint records which extractor built an index
(``store/feature_store.py::coarse_fingerprint``), so mixing them is a
MISS, never a wrong shortlist.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = [
    "coarse_volume_from_features",
    "pooled_descriptor",
    "raw_coarse_volume",
    "score_coarse_volume",
]

_EPS = 1e-8


def _l2_normalize(a: np.ndarray, axis: int) -> np.ndarray:
    n = np.sqrt(np.sum(np.square(a), axis=axis, keepdims=True))
    return a / np.maximum(n, _EPS)


def coarse_volume_from_features(feat: np.ndarray,
                                factor: int) -> np.ndarray:
    """Backbone features ``(h, w, c)`` (or batched ``(1, h, w, c)``) →
    coarse volume: average-pool by ``factor`` per spatial axis (trailing
    remainder rows/cols folded into the last cell, so no location is
    silently dropped), then L2-normalize per coarse location."""
    a = np.asarray(feat, dtype=np.float32)
    if a.ndim == 4:
        if a.shape[0] != 1:
            raise ValueError(f"expected a single feature map, got batch "
                             f"{a.shape[0]}")
        a = a[0]
    if a.ndim != 3:
        raise ValueError(f"features must be (h, w, c), got {a.shape}")
    f = max(1, int(factor))
    h, w, c = a.shape
    ch, cw = max(1, h // f), max(1, w // f)
    out = np.zeros((ch, cw, c), np.float32)
    for i in range(ch):
        i0, i1 = i * f, ((i + 1) * f if i < ch - 1 else h)
        for j in range(cw):
            j0, j1 = j * f, ((j + 1) * f if j < cw - 1 else w)
            out[i, j] = a[i0:i1, j0:j1].mean(axis=(0, 1))
    return _l2_normalize(out, axis=-1)


def raw_coarse_volume(image: np.ndarray, factor: int,
                      grid: int = 16) -> np.ndarray:
    """Model-free coarse volume straight from a uint8 ``(H, W, 3)`` image
    (batched ``(1, H, W, 3)`` accepted): a ``(grid/factor)²`` cell grid of
    local statistics — per-channel mean, per-channel std, and two gradient
    magnitudes — L2-normalized per cell.  Deterministic, numpy-only,
    no torch work: the extractor the chaos suite and ``build_coarse_index
    --raw`` run.  ``grid`` fixes the FINE grid the factor pools from, so
    volumes from differently-sized images stay comparable."""
    a = np.asarray(image)
    if a.ndim == 4:
        if a.shape[0] != 1:
            raise ValueError(f"expected one image, got batch {a.shape[0]}")
        a = a[0]
    if a.ndim != 3 or a.shape[-1] != 3:
        raise ValueError(f"image must be (H, W, 3), got {a.shape}")
    a = a.astype(np.float32) / 255.0
    f = max(1, int(factor))
    cells = max(1, int(grid) // f)
    H, W = a.shape[:2]
    ys = np.linspace(0, H, cells + 1).astype(int)
    xs = np.linspace(0, W, cells + 1).astype(int)
    gy = np.abs(np.diff(a.mean(axis=-1), axis=0))
    gx = np.abs(np.diff(a.mean(axis=-1), axis=1))
    out = np.zeros((cells, cells, 8), np.float32)
    for i in range(cells):
        for j in range(cells):
            tile = a[ys[i]:max(ys[i + 1], ys[i] + 1),
                     xs[j]:max(xs[j + 1], xs[j] + 1)]
            ty = gy[ys[i]:max(ys[i + 1] - 1, ys[i] + 1),
                    xs[j]:max(xs[j + 1], xs[j] + 1)]
            tx = gx[ys[i]:max(ys[i + 1], ys[i] + 1),
                    xs[j]:max(xs[j + 1] - 1, xs[j] + 1)]
            out[i, j, :3] = tile.mean(axis=(0, 1))
            out[i, j, 3:6] = tile.std(axis=(0, 1))
            out[i, j, 6] = ty.mean() if ty.size else 0.0
            out[i, j, 7] = tx.mean() if tx.size else 0.0
    return _l2_normalize(out, axis=-1)


def pooled_descriptor(volume: np.ndarray) -> np.ndarray:
    """Coarse volume ``(h, w, c)`` → unit-norm pooled query descriptor
    ``(c,)`` (mean over locations, then L2) — the few-hundred-float
    payload a query fans out to every shard."""
    v = np.asarray(volume, dtype=np.float32)
    if v.ndim != 3:
        raise ValueError(f"coarse volume must be (h, w, c), got {v.shape}")
    d = v.mean(axis=(0, 1))
    return np.asarray(_l2_normalize(d[None], axis=-1)[0], np.float32)


def score_coarse_volume(desc: np.ndarray, volume: np.ndarray) -> float:
    """Max cosine similarity of the query descriptor over the pano's
    coarse locations.  A channel-count mismatch is a caller bug (index
    built under a different extractor/config than the query descriptor)
    and raises — a silently-wrong ranking is the one failure retrieval
    may never produce."""
    d = np.asarray(desc, dtype=np.float32).ravel()
    v = np.asarray(volume, dtype=np.float32)
    if v.ndim != 3 or v.shape[-1] != d.shape[0]:
        raise ValueError(
            f"descriptor dim {d.shape[0]} does not match coarse volume "
            f"{v.shape} — index and query were built under different "
            "extractors")
    return float(np.max(v.reshape(-1, d.shape[0]) @ d))


def top_k(scores, k: int) -> Tuple[Tuple[str, float], ...]:
    """Deterministic top-``k`` of ``{pano: score}`` / ``[(pano, score)]``:
    descending score, pano id as the tie-break (two hosts ranking the same
    scores must return the same list, or the gather merge would be
    replica-order dependent)."""
    items = scores.items() if hasattr(scores, "items") else scores
    ranked = sorted(((str(p), float(s)) for p, s in items),
                    key=lambda ps: (-ps[1], ps[0]))
    return tuple(ranked[:max(0, int(k))])
