"""Gathered fine-level correlation and NC refinement (coarse-to-fine).

The port of ``ncnet_tpu/ops/sparse_corr.py``, the fine half of the
coarse-to-fine pipeline (selection: ``ops/sparse_topk.py``).  Given each
coarse source cell's candidate target neighbourhoods, correlation is
evaluated and filtered only on the gathered ``(source patch × candidate
patch)`` tiles.  The tile contract is the JAX module's:

  * one tile per ``(coarse source cell n, candidate c)``: the cell's
    ``patch×patch`` fine block (halo-expanded, origin-clamped) against the
    candidate's;
  * tile values are the dense correlation restricted to the tile (f32
    sums of the gathered features);
  * mutual matching uses cross-tile scatter-max vectors: the dense formula
    with "max over all" relaxed to "max over covered" cells;
  * the NC stack runs on the tiles as a folded batch of small volumes, and
    only each tile's core (the coarse cell's own ``factor×factor`` block on
    both sides) is read out;
  * filtered scores scatter back onto a zero-initialized dense volume
    (``ops/matching.py::scatter_sparse_scores``).

The tile contraction (B4):

  * :func:`gather_tile_corr_pallas` keeps the JAX signature ``(fa_p2, fb,
    row_blocks, col_starts, *, patch, factor)``.  On a CUDA tensor it
    launches the hand-written kernel ``csrc/gather_tile_corr.cu``, which
    reads each candidate's window straight from ``fb``; on a CPU tensor it
    runs the plain twin :func:`gather_tile_corr_reference`.  ``launches``
    counts the kernel's launches.
  * :func:`gather_tile_corr_reference` is also the port of the JAX
    package's XLA tier ``gather_tile_corr``: f32 features take it on either
    device.

bf16 features always take :func:`gather_tile_corr_pallas`.  The kernel
gathers any origin, so ``sparse_gather_feasible`` (band alignment, VMEM
budget) is not ported, and a bf16 shape that the JAX package sends to its
XLA tier (a halo that is not a multiple of the factor) runs the kernel
here: the two agree up to the order of the f32 sums.  The demotion
registry, tier cache, tier stamps, ``sparse_gather_compiles`` and the
``NCNET_SPARSE_GATHER`` switch are TPU compiler machinery and are not
ported either; :func:`choose_match_pipeline` and
:func:`choose_tracked_pipeline` are the geometry tests alone.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ncnet_tpu_torch.ops import kernel_build
from ncnet_tpu_torch.ops.sparse_topk import (
    block_origins,
    candidate_origins,
    patch_side,
)

SOURCE = "gather_tile_corr.cu"

# mutual-matching epsilon: ops/matching.py::mutual_matching's, so that the
# sparse gating at full coverage is the dense one
_MM_EPS = 1e-5

#: kernel launches since the process started (or the caller last reset it)
launches = 0


class SparseTiles(NamedTuple):
    """Gathered correlation tiles and their fine-grid indices.

    ``values`` ``(B, N, K, p, p, p, p)`` (source rows, source cols, target
    rows, target cols); ``ia``/``ja`` ``(N, p)`` fine source row/col
    indices of each source patch; ``ib``/``jb`` ``(B, N, K, p)`` those of
    each candidate patch.  All index tensors are int32 on the values'
    device."""

    values: Optional[torch.Tensor]
    ia: torch.Tensor
    ja: torch.Tensor
    ib: torch.Tensor
    jb: torch.Tensor


def source_patch_index(ha: int, wa: int, factor: int,
                       patch: int) -> Tuple[np.ndarray, np.ndarray]:
    """Static ``(ia, ja)`` int32 arrays ``(Hc·Wc, p)``: per coarse source
    cell (row-major), the fine row/col indices of its patch."""
    oi = block_origins(ha // factor, factor, patch, ha)
    oj = block_origins(wa // factor, factor, patch, wa)
    rows = oi[:, None] + np.arange(patch)[None, :]
    cols = oj[:, None] + np.arange(patch)[None, :]
    hc, wc = len(oi), len(oj)
    ia = np.repeat(rows, wc, axis=0)
    ja = np.tile(cols, (hc, 1))
    return ia.astype(np.int32), ja.astype(np.int32)


def gather_source_patches(fa: torch.Tensor, ia, ja) -> torch.Tensor:
    """``(B, N, p, p, C)`` source feature patches."""
    ia, ja = (torch.as_tensor(x, device=fa.device).long() for x in (ia, ja))
    return fa[:, ia[:, :, None], ja[:, None, :], :]


def gather_target_patches(fb: torch.Tensor, ib: torch.Tensor,
                          jb: torch.Tensor) -> torch.Tensor:
    """``(B, N, K, p, p, C)`` candidate feature patches."""
    bidx = torch.arange(fb.shape[0], device=fb.device)[:, None, None, None, None]
    return fb[bidx, ib.long()[..., :, None], jb.long()[..., None, :], :]


def gather_tile_corr_reference(fa_p2: torch.Tensor, fb: torch.Tensor,
                               row_blocks: torch.Tensor,
                               col_starts: torch.Tensor, *, patch: int,
                               factor: int) -> torch.Tensor:
    """The plain twin of the kernel and the f32 tier: gather each
    candidate's window of ``fb``, multiply in f32 and round the sums to
    ``fa_p2``'s dtype; ``(B, N, K, p², p²)``."""
    b, n, p2, c = fa_p2.shape
    rng = torch.arange(patch, device=fb.device)
    ib = row_blocks.long()[..., None] * factor + rng
    jb = col_starts.long()[..., None] + rng
    fb_p2 = gather_target_patches(fb, ib, jb).reshape(b, n, -1, p2, c)
    out = torch.matmul(fa_p2.to(torch.float32)[:, :, None],
                       fb_p2.to(torch.float32).transpose(-1, -2))
    return out.to(fa_p2.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = kernel_build.load(SOURCE)
    lib.gather_tile_corr_bf16.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.gather_tile_corr_bf16.restype = ctypes.c_int
    lib.gather_tile_corr_error_string.argtypes = [ctypes.c_int]
    lib.gather_tile_corr_error_string.restype = ctypes.c_char_p
    return lib


def _check(fa_p2, fb, row_blocks, col_starts, patch: int, factor: int) -> None:
    if fa_p2.dim() != 4 or fb.dim() != 4:
        raise ValueError(f"gather_tile_corr_pallas takes fa_p2 (B, N, p², C) "
                         f"and fb (B, hB, wB, C), got {tuple(fa_p2.shape)} "
                         f"and {tuple(fb.shape)}")
    b, n, p2, c = fa_p2.shape
    if (p2 != patch * patch or fb.shape[0] != b or fb.shape[3] != c
            or patch > min(fb.shape[1], fb.shape[2]) or factor < 1):
        raise ValueError(f"gather_tile_corr_pallas: fa_p2 {tuple(fa_p2.shape)},"
                         f" fb {tuple(fb.shape)}, patch {patch} and factor "
                         f"{factor} disagree")
    if (row_blocks.shape != col_starts.shape or row_blocks.dim() != 3
            or tuple(row_blocks.shape[:2]) != (b, n)):
        raise ValueError(f"row_blocks {tuple(row_blocks.shape)} and col_starts "
                         f"{tuple(col_starts.shape)} must both be (B, N, K) "
                         f"with (B, N) = {(b, n)}")
    # on the card the kernel traps on such a window instead: checking here
    # would synchronise the stream
    if row_blocks.device.type == "cpu" and row_blocks.numel():
        rows = row_blocks.long() * factor
        if (rows.min() < 0 or col_starts.min() < 0
                or rows.max() + patch > fb.shape[1]
                or col_starts.max() + patch > fb.shape[2]):
            raise ValueError(f"gather_tile_corr_pallas: a {patch}×{patch} "
                             f"window lies outside fb {tuple(fb.shape)}")


def gather_tile_corr_pallas(fa_p2: torch.Tensor, fb: torch.Tensor,
                            row_blocks: torch.Tensor, col_starts: torch.Tensor,
                            *, patch: int, factor: int) -> torch.Tensor:
    """Tile correlations ``(B, N, K, p², p²)`` (B4).

    ``fa_p2`` ``(B, N, p², C)``: the pre-gathered source patches; ``fb``
    ``(B, hB, wB, C)``: the full target feature map; ``row_blocks``
    ``(B, N, K)``: each candidate window's origin row divided by
    ``factor``; ``col_starts`` ``(B, N, K)``: its origin column.  Windows
    must lie inside ``fb`` (``sparse_topk.candidate_origins`` clamps them):
    one that does not raises on the CPU and traps the kernel on the card.

    On a CUDA tensor: one launch of ``csrc/gather_tile_corr.cu`` (bf16
    only) on the current stream, without synchronising.  On a CPU tensor:
    :func:`gather_tile_corr_reference`."""
    global launches
    _check(fa_p2, fb, row_blocks, col_starts, patch, factor)
    if fa_p2.device.type == "cpu":
        return gather_tile_corr_reference(fa_p2, fb, row_blocks, col_starts,
                                          patch=patch, factor=factor)
    if fa_p2.device.type != "cuda":
        raise RuntimeError(f"gather_tile_corr_pallas runs on CUDA or CPU "
                           f"tensors, got {fa_p2.device}")
    if any(t.device != fa_p2.device for t in (fb, row_blocks, col_starts)):
        raise RuntimeError("gather_tile_corr_pallas: tensors on different devices")
    if fa_p2.dtype != torch.bfloat16 or fb.dtype != torch.bfloat16:
        raise TypeError(f"the gather kernel takes bf16 features, got "
                        f"{fa_p2.dtype} and {fb.dtype}")
    b, n, p2, c = (int(d) for d in fa_p2.shape)
    k = int(row_blocks.shape[2])
    hb, wb = int(fb.shape[1]), int(fb.shape[2])
    fa_p2, fb = fa_p2.contiguous(), fb.contiguous()
    rows = row_blocks.to(torch.int32).contiguous()
    cols = col_starts.to(torch.int32).contiguous()
    out = torch.empty((b, n, k, p2, p2), dtype=torch.bfloat16,
                      device=fa_p2.device)
    lib = _library()
    with torch.cuda.device(fa_p2.device):
        stream = torch.cuda.current_stream(fa_p2.device).cuda_stream
        rc = lib.gather_tile_corr_bf16(
            fa_p2.data_ptr(), fb.data_ptr(), rows.data_ptr(), cols.data_ptr(),
            out.data_ptr(), b, n, k, c, hb, wb, patch, factor, stream)
    if rc != 0:
        raise RuntimeError("gather_tile_corr launch failed: "
                           + lib.gather_tile_corr_error_string(rc).decode())
    launches += 1
    return out


# ---------------------------------------------------------------------------
# sparse mutual matching and the refinement
# ---------------------------------------------------------------------------


def _scatter_max(values: torch.Tensor, index: torch.Tensor,
                 size: int) -> torch.Tensor:
    """Per batch row, the max of ``values`` (B, M) landing on each of
    ``size`` cells through ``index`` (B, M); -inf where nothing lands.  In
    float32, exact for bf16 values."""
    out = torch.full((values.shape[0], size), float("-inf"),
                     dtype=torch.float32, device=values.device)
    return out.scatter_reduce_(1, index, values.to(torch.float32),
                               reduce="amax", include_self=True)


def sparse_mutual_matching(t: SparseTiles, eps: float = _MM_EPS,
                           grid_a: Tuple[int, int] = None,
                           grid_b: Tuple[int, int] = None) -> SparseTiles:
    """Mutual-matching gating on the tiles: the dense formula (same eps
    and parenthesization) with its maxima taken by scatter-max over every
    covered cell across tiles.  Equal to the dense gating whenever the
    coverage holds the row and column maxima (always at full coverage)."""
    v = t.values
    b = v.shape[0]
    ha, wa = grid_a
    hb, wb = grid_b
    lin_a = (t.ia.long()[:, :, None] * wa + t.ja.long()[:, None, :])
    lin_a = lin_a.reshape(1, -1).expand(b, -1).contiguous()       # (B, N·p²)
    lin_b = (t.ib.long()[..., :, None] * wb
             + t.jb.long()[..., None, :]).reshape(b, -1)          # (B, N·K·p²)
    # max over covered target cells per fine source cell (dense max_over_b)
    per_a = v.amax(dim=(2, 5, 6)).reshape(b, -1)
    max_b = _scatter_max(per_a, lin_a, ha * wa)
    # max over covered source cells per fine target cell (dense max_over_a)
    per_b = v.amax(dim=(3, 4)).reshape(b, -1)
    max_a = _scatter_max(per_b, lin_b, hb * wb)
    g_b = max_b.gather(1, lin_a).to(v.dtype).reshape(v.shape[:2] + v.shape[3:5])
    g_a = max_a.gather(1, lin_b).to(v.dtype).reshape(
        v.shape[:3] + v.shape[5:7])
    ratio_b = v / (g_a[:, :, :, None, None, :, :] + eps)
    ratio_a = v / (g_b[:, :, None, :, :, None, None] + eps)
    return t._replace(values=v * (ratio_a * ratio_b))


def sparse_fine_corr(fa: torch.Tensor, fb: torch.Tensor, cand: torch.Tensor,
                     *, factor: int, halo: int) -> SparseTiles:
    """Raw fine correlation tiles of the ``(B, N, K)`` candidate set: bf16
    features through :func:`gather_tile_corr_pallas` (the kernel on the
    card), f32 ones through :func:`gather_tile_corr_reference`."""
    b, ha, wa, c_dim = fa.shape
    hb, wb = fb.shape[1], fb.shape[2]
    patch = patch_side(factor, halo)
    wc = wb // factor
    ia, ja = (torch.from_numpy(x).to(fa.device)
              for x in source_patch_index(ha, wa, factor, patch))
    oi, oj = candidate_origins(cand.to(fa.device), wc, factor, patch, hb, wb)
    rng = torch.arange(patch, dtype=torch.int32, device=fa.device)
    ib = oi[..., None] + rng
    jb = oj[..., None] + rng
    n, k = cand.shape[1], cand.shape[2]
    fa_p2 = gather_source_patches(fa, ia, ja).reshape(
        b, n, patch * patch, c_dim)
    # the origin rows themselves (factor 1): the kernel takes any origin,
    # aligned to the factor's grid or not
    corr = (gather_tile_corr_pallas if fa.dtype == torch.bfloat16
            else gather_tile_corr_reference)
    v = corr(fa_p2, fb, oi, oj, patch=patch, factor=1)
    return SparseTiles(v.reshape(b, n, k, patch, patch, patch, patch),
                       ia, ja, ib, jb)


def core_mask(tiles: SparseTiles, cand: torch.Tensor, wc: int, wac: int,
              factor: int) -> torch.Tensor:
    """``(B, N, K, p, p, p, p)``-broadcastable boolean mask of each tile's
    core: the coarse cell's own ``factor×factor`` fine block on the source
    and the candidate side.  Core cells are the readout (their conv support
    lies inside the patch when the halo covers the stack's receptive
    radius); halo cells are support only."""
    cand = cand.to(tiles.ib.device).long()
    ic = torch.div(cand, wc, rounding_mode="floor")
    jc = cand % wc
    n = tiles.ia.shape[0]
    a_cell = torch.arange(n, device=tiles.ia.device)
    ra = (tiles.ia.long() // factor) == (a_cell // wac)[:, None]
    ca = (tiles.ja.long() // factor) == (a_cell % wac)[:, None]
    rb = (tiles.ib.long() // factor) == ic[..., None]
    cb = (tiles.jb.long() // factor) == jc[..., None]
    return (ra[None, :, None, :, None, None, None]
            & ca[None, :, None, None, :, None, None]
            & rb[:, :, :, None, None, :, None]
            & cb[:, :, :, None, None, None, :])


def sparse_refine(fa: torch.Tensor, fb: torch.Tensor, cand: torch.Tensor, *,
                  factor: int, halo: int,
                  stack_fn: Callable[[torch.Tensor], torch.Tensor]
                  ) -> torch.Tensor:
    """The sparse fine pass: gather → gate → NC-filter the folded tiles
    (``stack_fn`` maps ``(T, p, p, p, p)`` through the NC stack) → core
    readout → gate → scatter onto the dense ``(B, hA, wA, hB, wB)`` volume
    (zeros off the support, duplicates by max)."""
    from ncnet_tpu_torch.ops.matching import scatter_sparse_scores

    b, ha, wa, _ = fa.shape
    hb, wb = fb.shape[1], fb.shape[2]
    patch = patch_side(factor, halo)
    wc = wb // factor
    tiles = sparse_fine_corr(fa, fb, cand, factor=factor, halo=halo)
    tiles = sparse_mutual_matching(tiles, grid_a=(ha, wa), grid_b=(hb, wb))
    n, k = cand.shape[1], cand.shape[2]
    folded = tiles.values.reshape(b * n * k, patch, patch, patch, patch)
    filtered = stack_fn(folded).reshape(b, n, k, patch, patch, patch, patch)
    # filtered values are post-ReLU non-negative, so a zeroed halo cell is
    # the identity of every max downstream
    filtered = filtered * core_mask(tiles, cand, wc, wa // factor,
                                    factor).to(filtered.dtype)
    tiles = sparse_mutual_matching(tiles._replace(values=filtered),
                                   grid_a=(ha, wa), grid_b=(hb, wb))
    return scatter_sparse_scores(tiles.values, tiles.ia, tiles.ja, tiles.ib,
                                 tiles.jb, (ha, wa, hb, wb))


# ---------------------------------------------------------------------------
# pipeline choice: the geometry tests
# ---------------------------------------------------------------------------


def _fine_grids_fit(ha: int, wa: int, hb: int, wb: int, *, factor: int,
                    halo: int, reloc_k: int) -> bool:
    """Relocalization pooling is off, every fine dim pools by the factor,
    and the patches fit the fine grids."""
    if factor <= 1 or reloc_k > 1:
        return False
    if any(d % factor for d in (ha, wa, hb, wb)):
        return False
    patch = patch_side(factor, halo)
    return min(ha, wa) >= patch and min(hb, wb) >= patch


def coarse2fine_feasible(ha: int, wa: int, hb: int, wb: int, *,
                         sparse_topk: int, factor: int, halo: int,
                         reloc_k: int = 0) -> bool:
    """Whether the coarse-to-fine pipeline applies: the knob is on and
    :func:`_fine_grids_fit` holds."""
    return sparse_topk > 0 and _fine_grids_fit(
        ha, wa, hb, wb, factor=factor, halo=halo, reloc_k=reloc_k)


def choose_match_pipeline(ha: int, wa: int, hb: int, wb: int, *,
                          sparse_topk: int, factor: int, halo: int,
                          reloc_k: int = 0) -> Optional[str]:
    """``"coarse2fine"`` where :func:`coarse2fine_feasible` holds, else
    ``None`` (dense)."""
    if coarse2fine_feasible(ha, wa, hb, wb, sparse_topk=sparse_topk,
                            factor=factor, halo=halo, reloc_k=reloc_k):
        return "coarse2fine"
    return None


def tracking_feasible(ha: int, wa: int, hb: int, wb: int, *, factor: int,
                      halo: int, radius: int, reloc_k: int = 0) -> bool:
    """Whether the tracked pipeline applies: a search radius and
    :func:`_fine_grids_fit`."""
    return radius >= 0 and _fine_grids_fit(
        ha, wa, hb, wb, factor=factor, halo=halo, reloc_k=reloc_k)


def choose_tracked_pipeline(ha: int, wa: int, hb: int, wb: int, *,
                            factor: int, halo: int, radius: int,
                            reloc_k: int = 0) -> Optional[str]:
    """``"tracked"`` where :func:`tracking_feasible` holds, else ``None``
    (the caller falls back to :func:`choose_match_pipeline`)."""
    if tracking_feasible(ha, wa, hb, wb, factor=factor, halo=halo,
                         radius=radius, reloc_k=reloc_k):
        return "tracked"
    return None
