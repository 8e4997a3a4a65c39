"""Batched warm matcher: the device-facing half of the match service.

The port of ``ncnet_tpu/serving/engine.py::BatchMatchEngine``: raw uint8
pairs in, ImageNet-normalized on the device, the forward, and compact
per-pair match tables out with the pair's quality signals
(``observability/quality.py``) as one extra row, so one device→host copy
per batch carries matches and accuracy telemetry.

Two programs: ``dispatch`` (the pair forward; with ``sparse_topk`` > 0 it
runs the coarse-to-fine pipeline, coarse pass included) and
``dispatch_tracked`` (a streaming frame: source features resolved once per
stream through a digest memo, the target extracted per frame, candidates
from the previous frame's priors, no coarse pass).

**Store-backed pair path** (``store=``, ``ncnet_tpu_torch/store/``): with a
persistent feature store attached, each dispatched batch resolves its
SOURCE rows' backbone features through verified cached entries (content
digest of the padded uint8 row, under the store's fingerprint) and runs the
feature-pair program (``ncnet_forward_from_features``).  A miss extracts
the row alone, copies its float32 features to the host, commits them and
feeds those bytes to the same program a hit feeds, so a hit is bitwise
what a miss computes.  The store's ladder (``FeatureStore.resolve``) can
only make a batch slower, never wrong.

**Live weight swap** (:meth:`BatchMatchEngine.swap_params`, the rollout's
per-replica seam) re-stages a new tree on the engine's device.  The JAX
retrace seam is not ported (ROADMAP D4): the port compiles no program, and
its NC route is decided from the shapes at every call.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ncnet_tpu_torch.config import ModelConfig
from ncnet_tpu_torch.data.loader import stage_array
from ncnet_tpu_torch.models.ncnet import (
    NCNetOutput,
    check_ported,
    extract_features,
    ncnet_forward,
    ncnet_forward_from_features,
    ncnet_forward_tracked,
    params_to,
    resolve_device,
    tree_map,
)
from ncnet_tpu_torch.observability.quality import (
    append_quality_rows,
    split_quality_rows,
)
from ncnet_tpu_torch.ops.image import normalize_imagenet
from ncnet_tpu_torch.ops.matching import corr_to_matches
from ncnet_tpu_torch.utils import faults

# the digest→features memo of the tracked path: a stream re-matches one
# reference image for many frames, so a few entries cover a replica's streams
_TRACKED_FEATURE_CACHE_ENTRIES = 16


def _tree_signature(tree):
    """A tree's structure: its leaf paths with each tensor's shape and
    dtype (the JAX engine's abstract-value comparison)."""
    if isinstance(tree, dict):
        return tuple((k, _tree_signature(tree[k])) for k in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return ("seq",) + tuple(_tree_signature(v) for v in tree)
    if torch.is_tensor(tree):
        return (tuple(tree.shape), tree.dtype)
    return (type(tree).__name__,)


class BatchMatchEngine:
    """Resident batched matcher over weights staged on ``device`` (CUDA
    unless ``device="cpu"`` is passed).

    ``dispatch(src_u8, tgt_u8)`` takes ``(B, H, W, 3)`` uint8 batches and
    returns the on-device ``(B, 6, N)`` float32 table without waiting for
    it; ``fetch`` copies it to the host.  Rows 0-4 are the match table (xA,
    yA, xB, yB, score), row 5 carries the pair's quality signals in its
    first ``len(QUALITY_SIGNALS)`` slots (``(B, 5, N)`` when the grid is too
    narrow for the row; :meth:`split` detects which).

    Spies: ``coarse_passes`` counts pair dispatches (each pays the coarse
    or the dense filter), ``tracked_dispatches`` tracked ones, and
    ``feature_extractions`` the source rows the store and tracked paths
    extracted.  Each dispatch passes ``faults.device_error_hook``
    (label ``serve_batch``), the JAX engine's injected-failure seam.
    """

    def __init__(self, config: ModelConfig, params, *,
                 do_softmax: bool = True, scale: str = "centered",
                 device=None, store=None):
        check_ported(config)
        self.config = config
        self.device = resolve_device(device)
        self.do_softmax = do_softmax
        self.scale = scale
        self._params = params_to(params, self.device)  # staged once
        # the persistent feature store (fail-open: trouble means recompute)
        self._store = store
        self.feature_extractions = 0
        self.coarse_passes = 0
        self.tracked_dispatches = 0
        # same-structure weight swaps (the JAX engine's fast-path count;
        # the port has no compiled program to keep, see swap_params)
        self.swap_fastpath_hits = 0
        self._feat_cache: "collections.OrderedDict[str, torch.Tensor]" = (
            collections.OrderedDict())

    def _upload(self, u8) -> torch.Tensor:
        """A host uint8 batch normalized on the device; on CUDA staged from
        pinned memory without waiting, so a dispatch never waits for the
        card."""
        return normalize_imagenet(stage_array(u8, self.device))

    def _tables(self, out: NCNetOutput) -> torch.Tensor:
        """The match-extraction tail of both programs (the JAX
        ``tables_from``): a relocalized volume's matches land on the
        ``k``× finer grid through its offsets."""
        m = corr_to_matches(out.corr, delta4d=out.delta4d,
                            k_size=max(self.config.relocalization_k_size, 1),
                            do_softmax=self.do_softmax, scale=self.scale)
        table = torch.stack([v.to(torch.float32) for v in m], dim=1)  # (B, 5, N)
        return append_quality_rows(table, out.corr)

    @torch.no_grad()
    def dispatch(self, src_u8: np.ndarray, tgt_u8: np.ndarray,
                 src_digests: Optional[Sequence[Optional[str]]] = None
                 ) -> torch.Tensor:
        """Enqueue upload + forward + match extraction; returns the
        on-device table (the CUDA work runs asynchronously).

        With a feature store attached, each SOURCE row resolves through it
        first (verified hit, or extract + commit) and the batch runs the
        feature-pair program; a miss is the one host wait (its features
        are copied to the host to be committed).  ``src_digests`` lets a
        caller that already knows a row's content digest skip its sha256;
        ``None`` entries are hashed."""
        self.coarse_passes += 1
        if self._store is None:
            faults.device_error_hook("serve_batch")
            out = ncnet_forward(self.config, self._params,
                                self._upload(src_u8), self._upload(tgt_u8))
            return self._tables(out)
        fa = torch.stack([
            self._store_features(
                src_u8[i], src_digests[i] if src_digests is not None
                else None)
            for i in range(src_u8.shape[0])])
        faults.device_error_hook("serve_batch")
        out = ncnet_forward_from_features(self.config, self._params, fa,
                                          self._upload(tgt_u8))
        return self._tables(out)

    def _extract_row(self, row: np.ndarray) -> torch.Tensor:
        """One source row's float32 backbone features ``(h, w, C)`` on the
        device (the program a store miss replays)."""
        self.feature_extractions += 1
        return extract_features(self.config, self._params,
                                self._upload(row[None]))[0]

    def _store_features(self, row: np.ndarray,
                        digest: Optional[str]) -> torch.Tensor:
        """One source row's features through the store: the committed
        float32 bytes on the device, hit or miss alike."""
        from ncnet_tpu_torch.store import content_digest

        row = np.ascontiguousarray(row)
        if digest is None:
            digest = content_digest(row)
        arr, _status = self._store.resolve(
            digest, lambda: self._extract_row(row).cpu().numpy())
        return stage_array(arr, self.device)

    def _resolve_src_features(self, row: np.ndarray,
                              digest: Optional[str]) -> torch.Tensor:
        """One source row's float32 backbone features ``(h, w, C)`` on the
        device for the tracked path: the persistent store when attached,
        else a small digest memo; either way a steady stream extracts its
        reference trunk once, not per frame."""
        from ncnet_tpu_torch.store import content_digest

        row = np.ascontiguousarray(row)
        if digest is None:
            digest = content_digest(row)
        if self._store is not None:
            return self._store_features(row, digest)
        hit = self._feat_cache.get(digest)
        if hit is not None:
            self._feat_cache.move_to_end(digest)
            return hit
        feats = self._extract_row(row)
        self._feat_cache[digest] = feats
        while len(self._feat_cache) > _TRACKED_FEATURE_CACHE_ENTRIES:
            self._feat_cache.popitem(last=False)
        return feats

    @torch.no_grad()
    def dispatch_tracked(self, src_u8: np.ndarray, tgt_u8: np.ndarray,
                         prior_ab: np.ndarray, prior_ba: np.ndarray, *,
                         src_digests: Optional[Sequence[Optional[str]]]
                         = None) -> torch.Tensor:
        """Enqueue a tracked batch: per-row source features from the memo,
        target frames extracted here, candidates seeded from the rows'
        ``(B, Nc)`` int32 priors (``ops/temporal.prior_from_table``); no
        coarse pass (``coarse_passes`` stays flat).  Callers gate the shape
        with :meth:`tracking_feasible`."""
        self.tracked_dispatches += 1
        fa = torch.stack([
            self._resolve_src_features(
                src_u8[i], src_digests[i] if src_digests is not None else None)
            for i in range(src_u8.shape[0])])
        faults.device_error_hook("serve_batch")
        out = ncnet_forward_tracked(
            self.config, self._params, fa, self._upload(tgt_u8),
            torch.as_tensor(np.asarray(prior_ab, dtype=np.int32)),
            torch.as_tensor(np.asarray(prior_ba, dtype=np.int32)))
        return self._tables(out)

    def tracking_feasible(self, src_hw: Tuple[int, int],
                          tgt_hw: Tuple[int, int]) -> bool:
        """Whether the tracked pipeline applies to an image shape (feature
        grids follow from the stride-16 trunks)."""
        from ncnet_tpu_torch.ops.sparse_corr import tracking_feasible
        from ncnet_tpu_torch.ops.sparse_topk import resolve_halo
        from ncnet_tpu_torch.ops.temporal import FEATURE_STRIDE

        ha, wa = (d // FEATURE_STRIDE for d in src_hw)
        hb, wb = (d // FEATURE_STRIDE for d in tgt_hw)
        if min(ha, wa, hb, wb) <= 0:
            return False
        return tracking_feasible(
            ha, wa, hb, wb, factor=self.config.sparse_factor,
            halo=resolve_halo(self.config.sparse_halo,
                              self.config.sparse_factor),
            radius=self.config.track_radius,
            reloc_k=self.config.relocalization_k_size)

    @property
    def feature_stride(self) -> int:
        from ncnet_tpu_torch.ops.temporal import FEATURE_STRIDE

        return FEATURE_STRIDE

    def fetch(self, handle: torch.Tensor) -> np.ndarray:
        """Wait for the device result; one copy per batch."""
        return handle.to("cpu", torch.float32).numpy()

    def swap_params(self, params) -> None:
        """Live weight swap (the rollout controller's per-replica seam):
        stage ``params`` on this engine's device and drop every reference
        to the old tree.

        Each host tensor goes up from pinned memory with a non-blocking
        copy on the device's current stream (``data/loader.stage_array``),
        the stream every dispatch of this engine enqueues on, so the next
        dispatch is ordered after the copy without a host wait.  The
        digest→features memo is flushed: its features were computed under
        the old trunk.  A tree of the same structure (leaf paths, shapes
        and dtypes) counts ``swap_fastpath_hits``, the JAX engine's event
        field; a structurally different tree (a CP-rank fine-tune) needs
        nothing more, as the NC route is chosen from the new shapes at the
        next call and no decision outlives the tree it was made for.  Must
        only be called on a DRAINED replica: a dispatch racing the swap
        would mix old and new weights."""
        same = _tree_signature(self._params) == _tree_signature(params)
        self._params = tree_map(lambda t: stage_array(t, self.device), params)
        self._feat_cache.clear()
        if same:
            self.swap_fastpath_hits += 1

    def attach_store(self, store) -> None:
        """Attach (or detach with ``None``) the persistent feature store.
        The rollout controller detaches it from a replica swapped to
        different trunk weights: resolving through the old generation would
        commit features of the new weights under the old fingerprint;
        recompute-only until the pod converges is the safe degradation."""
        self._store = store

    @property
    def half_precision(self) -> bool:
        return bool(self.config.half_precision)

    @staticmethod
    def split(table: np.ndarray
              ) -> Tuple[np.ndarray, Optional[List[Dict[str, float]]]]:
        """``(B, 5|6, N)`` fetched table → ``(match_tables (B, 5, N),
        per-pair quality dicts | None)``."""
        return split_quality_rows(table)
