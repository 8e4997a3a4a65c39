"""CP-decomposed conv4d: the rank-R separable tier of the NC filter.

Port of ``ncnet_tpu/ops/conv4d_cp.py``.  A dense NC layer contracts a
``(k, k, k, k, C_in, C_out)`` kernel against every cell; a rank-R canonical
polyadic (CP) factorization (Lebedev et al., *Speeding-up Convolutional
Neural Networks Using Fine-tuned CP-Decomposition*)::

    w[p,q,r,s,c,o] = Σ_ρ  ka[p,ρ]·kwa[q,ρ]·kb[r,ρ]·kwb[s,ρ]·cin[c,ρ]·cout[ρ,o]

turns the layer into a C_in→R pointwise map, four 1-D "same"
cross-correlations (one per spatial dim, k taps over the R rank channels)
and an R→C_out pointwise map + bias: ``2·cells·R·(C_in + C_out + 4k)``
FLOPs against ``2·cells·k⁴·C_in·C_out``.

A layer opts in by carrying a ``"cp"`` factor dict beside ``"w"``/``"b"``
(``ops/cp_als.py::decompose_stack`` attaches one); the chooser considers
the tier only when every layer has factors (:func:`cp_stack_ranks`) and
:func:`cp_feasible` predicts a FLOP win of at least ``_CP_GATE_MARGIN``.
The chain is plain differentiable PyTorch.  :func:`exact_cp_factors`
builds a rank-``k⁴·C_in`` factorization that reconstructs any kernel
exactly (the tests' parity fixture).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

# the checkpoint conversion's default rank (tools/cp_decompose.py, the JAX
# package's constant): at the k=5 16→16 layer R=16 keeps the rank channels
# as wide as the dense channels
DEFAULT_CP_RANK = 16

# the arithmetic gate's win margin (the JAX package's constant)
_CP_GATE_MARGIN = 0.75

_FACTOR_KEYS = ("ka", "kwa", "kb", "kwb", "cin", "cout")


def cp_stack_ranks(nc_params: Sequence[dict]) -> Optional[Tuple[int, ...]]:
    """Per-layer CP ranks when EVERY layer carries factors, else None."""
    ranks = []
    for layer in nc_params:
        cp = layer.get("cp") if isinstance(layer, dict) else None
        if not cp or any(k not in cp for k in _FACTOR_KEYS):
            return None
        ranks.append(int(cp["cout"].shape[0]))
    return tuple(ranks) if ranks else None


def _corr1d_same(y: torch.Tensor, taps: torch.Tensor, axis: int
                 ) -> torch.Tensor:
    """Per-rank-channel 1-D "same" cross-correlation along ``axis``:
    ``out[i] = Σ_p y[i + p - k//2] · taps[p]`` with zero padding.  ``y``:
    ``(..., R)`` with the rank dim last; ``taps``: ``(k, R)``."""
    k = taps.shape[0]
    d = k // 2
    n = y.shape[axis]
    pad = [0, 0] * y.dim()
    # F.pad lists pads from the last dim backwards
    pad[2 * (y.dim() - 1 - axis)] = d
    pad[2 * (y.dim() - 1 - axis) + 1] = d
    yp = F.pad(y, pad)
    out = None
    for p in range(k):
        term = yp.narrow(axis, p, n) * taps[p]
        out = term if out is None else out + term
    return out


def cp_apply_layer(x: torch.Tensor, cp: Dict[str, torch.Tensor],
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One CP-decomposed conv4d layer ("same", stride 1) on ``x`` ``(B, hA,
    wA, hB, wB, C_in)`` → ``(..., C_out)``."""
    dtype = x.dtype
    fac = {k: cp[k].to(dtype) for k in _FACTOR_KEYS}
    y = torch.einsum("...c,cr->...r", x, fac["cin"])
    for axis, key in ((1, "ka"), (2, "kwa"), (3, "kb"), (4, "kwb")):
        y = _corr1d_same(y, fac[key], axis)
    y = torch.einsum("...r,ro->...o", y, fac["cout"])
    if bias is not None:
        y = y + bias.to(dtype)
    return y


def nc_stack_cp(nc_params: List[dict], x: torch.Tensor) -> torch.Tensor:
    """The full [conv4d_same + bias + ReLU]×N stack through each layer's CP
    factors: the "cp" tier's stack body."""
    for layer in nc_params:
        x = torch.relu(cp_apply_layer(x, layer["cp"], layer["b"]))
    return x


def cp_reconstruct(cp: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The dense ``(kA, kWA, kB, kWB, C_in, C_out)`` kernel a factor dict
    represents."""
    return torch.einsum("pr,qr,sr,tr,cr,ro->pqstco", cp["ka"], cp["kwa"],
                        cp["kb"], cp["kwb"], cp["cin"], cp["cout"])


def exact_cp_factors(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """A rank-``k⁴·C_in`` CP factorization that is exact for any kernel:
    component ``ρ = (p,q,r,s,c)`` gets one-hot spatial/input factors and
    ``cout[ρ] = w[p,q,r,s,c,:]``."""
    dims = tuple(w.shape[:5])  # (kA, kWA, kB, kWB, C_in)
    c_out = w.shape[5]
    rank = 1
    for n in dims:
        rank *= n

    def mode_factor(mode: int) -> torch.Tensor:
        # (dim_mode, rank): e_{idx_mode(ρ)} per component ρ, row-major
        n = dims[mode]
        shape = [1] * 5
        shape[mode] = n
        eye = torch.eye(n, dtype=w.dtype, device=w.device)
        return eye.reshape((n,) + tuple(shape)).expand((n,) + dims).reshape(
            n, rank)

    factors = {key: mode_factor(m)
               for m, key in enumerate(("ka", "kwa", "kb", "kwb", "cin"))}
    factors["cout"] = w.reshape(rank, c_out)
    return factors


# ---------------------------------------------------------------------------
# the arithmetic gate
# ---------------------------------------------------------------------------


def cp_layer_flops(cells: int, k: int, c_in: int, c_out: int,
                   rank: int) -> int:
    """Predicted FLOPs of one CP layer on a ``cells``-cell volume."""
    return 2 * cells * rank * (c_in + c_out + 4 * k)


def dense_layer_flops(cells: int, k: int, c_in: int, c_out: int) -> int:
    """Direct-k⁴ FLOPs of one dense conv4d layer (the baseline both
    arithmetic tiers' gates compare against)."""
    return 2 * cells * (k ** 4) * c_in * c_out


def cp_feasible(ha: int, wa: int, hb: int, wb: int, kernels: Sequence[int],
                channels: Sequence[int], ranks: Sequence[int]) -> bool:
    """The CP tier's arithmetic gate: odd kernels and a predicted
    whole-stack FLOP win of at least ``_CP_GATE_MARGIN`` over the dense
    stack."""
    if len(ranks) != len(kernels) or any(k % 2 == 0 for k in kernels):
        return False
    cells = ha * wa * hb * wb
    cp = dense = 0
    c_in = 1
    for k, c_out, r in zip(kernels, channels, ranks):
        cp += cp_layer_flops(cells, k, c_in, c_out, r)
        dense += dense_layer_flops(cells, k, c_in, c_out)
        c_in = c_out
    return cp <= _CP_GATE_MARGIN * dense
