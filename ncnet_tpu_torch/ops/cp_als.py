"""HOSVD + ALS canonical-polyadic factorization of conv4d kernels.

A copy of ``ncnet_tpu/ops/cp_als.py`` (plain numpy, offline host work): the
port keeps its own so that it imports nothing of the JAX package.  HOSVD
initialization (the leading left singular vectors of each mode unfolding)
refined by alternating least squares, each mode solved exactly per sweep,
so the Frobenius reconstruction error never increases over sweeps.  The
factor layout is ``ops/conv4d_cp.py``'s::

    w[p,q,r,s,c,o] ≈ Σ_ρ ka[p,ρ]·kwa[q,ρ]·kb[r,ρ]·kwb[s,ρ]·cin[c,ρ]·cout[ρ,o]

The arithmetic is the JAX package's line for line, so the factors are
bitwise its factors; the results come back as float32 torch tensors.
:func:`nested_decompose` warm-starts each rank from the previous one with
the new components' ``cout`` rows zeroed, so the error is non-increasing in
rank.

No entry point of the port calls this module yet (the port loads no
checkpoint, so CP factors reach ``nc_stack_cp`` only from the tests);
ROADMAP §D asks whether to drop it or give it a caller.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

_FACTOR_KEYS = ("ka", "kwa", "kb", "kwb", "cin", "cout")
DEFAULT_ALS_ITERS = 60


def _unfold(t: np.ndarray, mode: int) -> np.ndarray:
    """Mode-``mode`` unfolding: ``(d_mode, prod(other dims))``, remaining
    modes flattened row-major in original order."""
    return np.moveaxis(t, mode, 0).reshape(t.shape[mode], -1)


def _khatri_rao(mats: Sequence[np.ndarray]) -> np.ndarray:
    """Column-wise Kronecker of ``(d_j, R)`` factors, first factor slowest."""
    out = mats[0]
    for m in mats[1:]:
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, out.shape[1])
    return out


def _hosvd_init(w: np.ndarray, rank: int, seed: int = 0) -> List[np.ndarray]:
    """Per-mode leading left singular vectors, padded with small seeded
    Gaussian columns where a mode is thinner than the rank."""
    rng = np.random.RandomState(seed)
    factors = []
    for mode in range(w.ndim):
        u, _, _ = np.linalg.svd(_unfold(w, mode), full_matrices=False)
        u = u[:, :rank]
        if u.shape[1] < rank:
            pad = rng.standard_normal((u.shape[0], rank - u.shape[1]))
            u = np.concatenate([u, 0.01 * pad], axis=1)
        factors.append(u)
    return factors


def _reconstruct(factors: Sequence[np.ndarray]) -> np.ndarray:
    return np.einsum("pr,qr,sr,tr,cr,or->pqstco", *factors)


def _rel_err(w: np.ndarray, factors: Sequence[np.ndarray]) -> float:
    denom = float(np.linalg.norm(w)) or 1.0
    return float(np.linalg.norm(w - _reconstruct(factors))) / denom


def _als(w: np.ndarray, factors: List[np.ndarray],
         iters: int) -> List[np.ndarray]:
    """Exact per-mode least-squares sweeps."""
    for _ in range(iters):
        for mode in range(w.ndim):
            others = [factors[j] for j in range(w.ndim) if j != mode]
            gram = np.ones((factors[0].shape[1],) * 2)
            for u in others:
                gram *= u.T @ u
            kr = _khatri_rao(others)
            factors[mode] = _unfold(w, mode) @ kr @ np.linalg.pinv(gram)
    return factors


def _decompose_numpy(w: np.ndarray, rank: int, iters: int,
                     init: Optional[List[np.ndarray]]):
    w64 = np.asarray(w, dtype=np.float64)
    if init is None:
        factors = _hosvd_init(w64, rank)
    else:
        rng = np.random.RandomState(1)
        factors = []
        for mode, u in enumerate(init):
            u = np.asarray(u, dtype=np.float64)
            if u.shape[1] < rank:
                extra = rank - u.shape[1]
                if mode == w64.ndim - 1:
                    # zero cout rows: the new components start invisible
                    pad = np.zeros((u.shape[0], extra))
                else:
                    pad = 0.01 * rng.standard_normal((u.shape[0], extra))
                u = np.concatenate([u, pad], axis=1)
            factors.append(u[:, :rank])
    factors = _als(w64, factors, iters)
    cp = {key: factors[m].astype(np.float32)
          for m, key in enumerate(_FACTOR_KEYS[:5])}
    cp["cout"] = factors[5].T.astype(np.float32)
    return cp, _rel_err(w64, factors)


def _to_torch(cp: Dict[str, np.ndarray], device=None) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in cp.items()}


def _kernel_numpy(w) -> np.ndarray:
    if isinstance(w, torch.Tensor):
        return w.detach().to("cpu", torch.float32).numpy()
    return np.asarray(w, np.float32)


def decompose_kernel(w, rank: int, iters: int = DEFAULT_ALS_ITERS,
                     init: Optional[List[np.ndarray]] = None
                     ) -> Tuple[Dict[str, torch.Tensor], float]:
    """Rank-``rank`` CP factors of one dense conv4d kernel (a tensor or an
    array).  Returns ``(cp_dict, relative_error)``: float32 CPU tensors in
    the ``ops/conv4d_cp.py`` layout.  ``init``: optional warm-start factor
    list (6 mode matrices, ``cout`` transposed to ``(C_out, R')``)."""
    cp, err = _decompose_numpy(_kernel_numpy(w), rank, iters, init)
    return _to_torch(cp), err


def nested_decompose(w, ranks: Sequence[int], iters: int = DEFAULT_ALS_ITERS
                     ) -> List[Tuple[Dict[str, torch.Tensor], float]]:
    """Decompose at each rank (ascending), warm-starting every rank from
    the previous one."""
    if list(ranks) != sorted(ranks):
        raise ValueError(f"ranks must ascend, got {list(ranks)}")
    w = _kernel_numpy(w)
    results = []
    init = None
    for rank in ranks:
        cp, err = _decompose_numpy(w, rank, iters, init)
        results.append((_to_torch(cp), err))
        init = [cp[k].astype(np.float64) for k in _FACTOR_KEYS[:5]]
        init.append(cp["cout"].T.astype(np.float64))
    return results


def decompose_stack(nc_params: Sequence[dict], rank: int,
                    iters: int = DEFAULT_ALS_ITERS):
    """Attach ``"cp"`` factors to every layer of an NC stack at ``rank``,
    on each layer's weight device.  Returns ``(new_params,
    per_layer_rel_errs)``; the dense ``"w"``/``"b"`` ride along untouched."""
    out, errs = [], []
    for layer in nc_params:
        cp, err = _decompose_numpy(_kernel_numpy(layer["w"]), rank, iters,
                                   None)
        device = layer["w"].device if isinstance(layer["w"], torch.Tensor) else None
        new_layer = dict(layer)
        new_layer["cp"] = _to_torch(cp, device)
        out.append(new_layer)
        errs.append(err)
    return out, errs
