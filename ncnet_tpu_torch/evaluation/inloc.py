"""InLoc dense-matching evaluation, the port of ``ncnet_tpu/evaluation/
inloc.py``.

For each query, match against its top-``n_panos`` shortlisted database
cutouts at high resolution (max side 3200 px) with bf16 and k = 2
relocalization, extract matches in both directions, dedup, and write one
``matches/<experiment>/<q+1>.mat`` per query: the hand-off to the
localization stage.

Reference behaviour being matched (``eval_inloc.py``):

  * aspect-preserving resize with feature dims quantized to k·16 (:83-89);
  * bf16 + ``relocalization_k_size`` forward (:50-57);
  * both-direction ``corr_to_matches``, ``scale='positive'``, softmax
    (:151-158);
  * sort by descending score, then ``np.unique`` dedup over the
    (xA, yA, xB, yB) columns, keeping the max-score duplicate (:159-173);
  * recentering of [0, 1] grid coordinates onto cell centres (:179-189);
  * a fixed-capacity (1, n_panos, N, 5) zero-padded matches array,
    N = (S/16/k)·floor((S/16/k)·3/4), doubled for both directions
    (:116-118);
  * a compressed savemat of ``{'matches', 'query_fn', 'pano_fn'}`` (:221).

On the card: images upload raw (uint8) and are normalized and resized
there (:func:`device_preprocess`, the device resize of ``ops/image.py``); a
query's trunk runs once and is reused across its pairs
(:class:`PreparedQuery`); a pair's forward,
match extraction and quality row end in one ``(6, N)`` tensor fetched by
one copy; sorting and dedup run on the host in numpy.  An InLoc volume is
rectangular (a portrait query against a landscape cutout), and its
symmetric NC pass is the tap-swap chain on B6
(``models/ncnet.py::neigh_consensus``).

The loop (:func:`run_inloc_eval`) keeps the JAX package's fault isolation
under ROADMAP decision D4: per-query retry with backoff, quarantine into a
per-host manifest, the consecutive-quarantine breaker, resume by artifact
with validation, the fetch watchdog and the adaptive pipeline depth; a
device failure re-runs the same program under the retry budget and no tier
is ever demoted.  With ``spatial_shards`` > 1 a pair whose target shards
runs the hB-sharded forward (``parallel/spatial.py``) over the local
devices (ROADMAP D7).  With ``feature_store_dir`` the pano features resolve
through the persistent feature store (``store/``): a warm query runs one
backbone extraction, its own; the store is off under sharding, whose
forward takes images, as in the JAX package.  With ``retrieval_index`` a
coarse index (``retrieval/``) re-ranks each query's whole ``.mat`` row
before matching: the query's descriptor comes from its own trunk features
(or its pixels, for a raw index), scoring is numpy through the verified
coarse store, and the top ``retrieval_topk`` cutouts are matched in
retrieval order, recorded as the ``.mat``'s ``shortlist``; a row that
cannot be scored to ``retrieval_min_coverage`` falls back to the ``.mat``
order with a ``retrieval_fallback`` event.
"""

from __future__ import annotations

import math
import os
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ncnet_tpu_torch.config import EvalInLocConfig, ModelConfig
from ncnet_tpu_torch.data.datasets import load_image, normalize_imagenet_np
from ncnet_tpu_torch.data.loader import stage_array
from ncnet_tpu_torch.evaluation.pipeline import PipelineDepthController
from ncnet_tpu_torch.observability import events as obs_events
from ncnet_tpu_torch.observability.logging import get_logger
from ncnet_tpu_torch.observability.tracing import span
from ncnet_tpu_torch.ops.image import (
    normalize_imagenet,
    resize_bilinear_align_corners,
    resize_bilinear_align_corners_np,
)
from ncnet_tpu_torch.ops.matching import Matches, corr_to_matches

log = get_logger("eval.inloc")

FEATURE_STRIDE = 16  # backbone stride: scale_factor 0.0625 (eval_inloc.py:77)


def quantized_resize_shape(h: int, w: int, image_size: int,
                           k_size: int) -> Tuple[int, int]:
    """Output (H', W') for the InLoc resize: longest side scaled to
    ``image_size`` preserving aspect ratio; for k > 1 both dims floored to
    multiples of ``k·16`` so the pooled feature grid is integral
    (eval_inloc.py:83-89)."""
    scale = max(h, w) / image_size
    if k_size == 1:
        return int(h / scale), int(w / scale)
    sf = 1.0 / FEATURE_STRIDE
    q = FEATURE_STRIDE * k_size
    out_h = int(math.floor(h / scale * sf / k_size) * q)
    out_w = int(math.floor(w / scale * sf / k_size) * q)
    return out_h, out_w


def load_and_preprocess(path: str, image_size: int, k_size: int) -> np.ndarray:
    """Read → ImageNet-normalize → quantized aspect-preserving resize, on
    the host, in the reference's order (normalize then resize,
    eval_inloc.py:129).  Returns ``(1, H', W', 3)`` float32."""
    img = normalize_imagenet_np(load_image(path).astype(np.float32))
    out_h, out_w = quantized_resize_shape(img.shape[0], img.shape[1],
                                          image_size, k_size)
    return resize_bilinear_align_corners_np(img, out_h, out_w)[None]


def load_raw(path: str) -> np.ndarray:
    """Decode only: ``(1, H, W, 3)`` uint8 (the image's raw file, ROADMAP
    D1) for the matcher's device preprocessing."""
    return load_image(path)[None]


def device_preprocess(img: torch.Tensor, image_size: int,
                      k_size: int) -> torch.Tensor:
    """:func:`load_and_preprocess` minus the decode, where ``img`` lives:
    uint8 ``(1, H, W, 3)`` → ImageNet-normalize → quantized align-corners
    resize (the device form of ``ops/image.py``), same normalize-then-
    resize order as the reference.  Returns float32."""
    out_h, out_w = quantized_resize_shape(img.shape[1], img.shape[2],
                                          image_size, k_size)
    return resize_bilinear_align_corners(normalize_imagenet(img), out_h,
                                         out_w)


def match_capacity(image_size: int, k_size: int, both_directions: bool) -> int:
    """Fixed row capacity of the per-pair match table (eval_inloc.py:116-118),
    for the reference's 3:4 portrait aspect."""
    side = image_size / FEATURE_STRIDE / k_size
    n = int(side * math.floor(side * 3 / 4))
    return 2 * n if both_directions else n


def recenter(coord, n: int):
    """[0, 1] grid-endpoint coordinate → cell-centre coordinate on an
    ``n``-cell axis (eval_inloc.py:179-189): x·(n−1)/n + 0.5/n."""
    return coord * (n - 1) / n + 0.5 / n


class PreparedQuery(NamedTuple):
    """A query readied by ``matcher.preprocess``: the preprocessed image on
    the device and its backbone features, computed once and reused across
    the query's pairs (the reference recomputes the query trunk per pair,
    eval_inloc.py:124-132)."""

    image: torch.Tensor
    features: torch.Tensor


class PreparedDb(NamedTuple):
    """A database image resolved through the persistent feature store by
    ``matcher.prepare_db``: its backbone features on the device (a verified
    store hit, or a recompute that was committed) and how they were
    obtained, ``"hit"`` / ``"miss"`` / ``"recompute"``.  A ``(PreparedQuery,
    PreparedDb)`` pair runs the feature-pair program: no backbone
    extraction for the pair."""

    features: torch.Tensor
    status: str


def extract_match_table(out, *, k_size: int, do_softmax: bool,
                        both_directions: bool,
                        flip_direction: bool = False) -> torch.Tensor:
    """Filtered ``NCNetOutput`` → stacked ``(5, N)`` float32 match table
    (xA, yA, xB, yB, score), cell-centre recentred: the B→A direction
    unless ``flip_direction``, both (B→A first) with ``both_directions``.
    The volume is read in float32."""
    corr, delta4d = out.corr.to(torch.float32), out.delta4d
    fs1, fs2, fs3, fs4 = corr.shape[1:]
    k = max(k_size, 1)
    ms = []
    if both_directions or not flip_direction:
        ms.append(corr_to_matches(corr, delta4d=delta4d, k_size=k,
                                  do_softmax=do_softmax, scale="positive"))
    if both_directions or flip_direction:
        ms.append(corr_to_matches(corr, delta4d=delta4d, k_size=k,
                                  do_softmax=do_softmax, scale="positive",
                                  invert_matching_direction=True))
    xa, ya, xb, yb, score = (torch.cat([getattr(m, f) for m in ms], dim=1)
                             for f in Matches._fields)
    ya = recenter(ya, fs1 * k)
    xa = recenter(xa, fs2 * k)
    yb = recenter(yb, fs3 * k)
    xb = recenter(xb, fs4 * k)
    return torch.stack([v.to(torch.float32).reshape(-1)
                        for v in (xa, ya, xb, yb, score)])


def make_pair_matcher(config: ModelConfig, params, *, do_softmax: bool,
                      both_directions: bool, flip_direction: bool,
                      preprocess_image_size: Optional[int] = None,
                      quality_cb=None, device=None, mesh=None, store=None):
    """``matcher(src, tgt) -> (xA, yA, xB, yB, score)`` numpy arrays, with
    the weights staged on ``device`` (CUDA by default) once.

    A pair runs the forward (bf16 and relocalization per ``config``), the
    match extraction in the requested direction(s) and the recentring on
    the device; the result lands on the host for the numpy sort and dedup.

    ``preprocess_image_size``: when set, the matcher takes raw uint8 images
    ``(1, H, W, 3)`` and normalizes and resizes them on the device
    (:func:`device_preprocess`); otherwise it takes preprocessed float32
    tensors.  ``matcher.preprocess(raw)`` returns a :class:`PreparedQuery`
    (the query's trunk run once); a pair with one runs the features path.
    ``matcher.feature_extractions`` counts trunk runs outside a pair's
    forward.

    ``store``: a :class:`~ncnet_tpu_torch.store.FeatureStore` for the
    database side.  ``matcher.prepare_db(raw_u8)`` resolves a pano's
    features through it (verified hit, or the query path's preprocessing
    and trunk, then an atomic commit) and returns a :class:`PreparedDb`; a
    hit is bitwise what a miss computes, as both feed the committed
    float32 bytes to the feature-pair program.

    ``quality_cb``: when given, every fetched pair's quality signals
    (``observability/quality.py``, computed on the same filtered volume and
    carried as a sixth row of the table, so the pair's one fetch stays one)
    are passed to it as ``{signal: float}``.

    ``dispatch``/``fetch`` split a call: ``dispatch`` enqueues the pair on
    the card and returns its table tensor without waiting (after
    ``utils/faults.device_error_hook("inloc_pair")``), ``fetch`` copies it
    to the host.

    ``mesh`` (``parallel/mesh.py``, with a ``spatial`` axis > 1): a pair
    whose target's fine hB shards over it runs
    :func:`~ncnet_tpu_torch.parallel.spatial.spatial_forward` (the trunk on
    the mesh's first device, the weights staged there, the query's trunk
    run again inside); any other shape falls back to the one-device
    forward, with one warning a shape."""
    from ncnet_tpu_torch.models.ncnet import (
        check_ported,
        extract_features,
        ncnet_forward,
        ncnet_forward_from_feature_pair,
        ncnet_forward_from_features,
        params_to,
        resolve_device,
    )
    from ncnet_tpu_torch.observability.quality import (
        append_quality_row,
        split_quality_row,
    )
    from ncnet_tpu_torch.utils import faults
    from ncnet_tpu_torch.utils.profiling import annotate

    check_ported(config)
    n_shards = 1 if mesh is None else mesh.shape["spatial"]
    dev = (mesh.row(0)[0] if n_shards > 1 and device is None
           else resolve_device(device))
    staged = params_to(params, dev)
    k = max(config.relocalization_k_size, 1)
    warned_shapes = set()

    def can_shard(tgt_shape, raw: bool) -> bool:
        """Whether the target's fine hB shards over the mesh (a one-time
        warning a shape where not)."""
        if n_shards <= 1:
            return False
        from ncnet_tpu_torch.parallel.spatial import shardable_hb

        h = (quantized_resize_shape(tgt_shape[1], tgt_shape[2],
                                    preprocess_image_size, k)[0]
             if raw else tgt_shape[1])
        hb = h // FEATURE_STRIDE
        ok = shardable_hb(hb, config.relocalization_k_size, n_shards,
                          config.ncons_kernel_sizes)
        if not ok and tuple(tgt_shape) not in warned_shapes:
            warned_shapes.add(tuple(tgt_shape))
            log.warning(f"target shape {tuple(tgt_shape)} (fine hB={hb}) "
                        f"does not shard over {n_shards} devices; falling "
                        "back to the single-device forward for this shape "
                        "bucket", kind="validation")
        return ok

    def prep_input(img) -> torch.Tensor:
        """The one preprocessing both input paths share."""
        return device_preprocess(stage_array(img, dev), preprocess_image_size,
                                 k)

    @torch.no_grad()
    def preprocess(img: np.ndarray) -> PreparedQuery:
        """Raw uint8 ``(1, H, W, 3)`` → :class:`PreparedQuery`."""
        if preprocess_image_size is None:
            raise ValueError("preprocess needs preprocess_image_size")
        x = prep_input(img)
        matcher.feature_extractions += 1
        return PreparedQuery(x, extract_features(config, staged, x))

    @torch.no_grad()
    def prepare_db(img: np.ndarray) -> PreparedDb:
        """Raw uint8 ``(1, H, W, 3)`` database image → :class:`PreparedDb`
        through the store's ladder."""
        if store is None:
            raise ValueError("prepare_db needs a FeatureStore")
        from ncnet_tpu_torch.store import content_digest

        def compute() -> np.ndarray:
            matcher.feature_extractions += 1
            return extract_features(config, staged, prep_input(img)).to(
                "cpu", torch.float32).numpy()

        arr, status = store.resolve(content_digest(np.asarray(img)), compute)
        return PreparedDb(torch.from_numpy(np.ascontiguousarray(arr)).to(dev),
                          status)

    def to_model_input(x) -> torch.Tensor:
        if isinstance(x, PreparedQuery):
            return x.image
        if preprocess_image_size is not None and np.asarray(x).dtype == np.uint8:
            return prep_input(x)
        return stage_array(x, dev)

    @torch.no_grad()
    def run(src, tgt) -> torch.Tensor:
        if isinstance(tgt, PreparedDb):
            # both sides' features precomputed (never sharded: the caller
            # turns the store off under spatial sharding)
            if not isinstance(src, PreparedQuery):
                raise ValueError("a PreparedDb target needs a PreparedQuery "
                                 "source (both sides' features precomputed)")
            out = ncnet_forward_from_feature_pair(config, staged, src.features,
                                                  tgt.features)
            table = extract_match_table(out, k_size=k, do_softmax=do_softmax,
                                        both_directions=both_directions,
                                        flip_direction=flip_direction)
            if quality_cb is None:
                return table
            return append_quality_row(table, out.corr)
        if isinstance(tgt, PreparedQuery):
            tgt_shape, tgt_raw = tgt.image.shape, False
        else:
            tgt_shape = tuple(np.shape(tgt))
            tgt_raw = (preprocess_image_size is not None
                       and not torch.is_tensor(tgt)
                       and np.asarray(tgt).dtype == np.uint8)
        sharded = can_shard(tgt_shape, tgt_raw)
        tgt = to_model_input(tgt)
        if sharded:
            from ncnet_tpu_torch.parallel.spatial import spatial_forward

            # the sharded forward runs the trunk itself, on the images
            out = spatial_forward(config, staged, to_model_input(src), tgt,
                                  mesh)
        elif isinstance(src, PreparedQuery):
            out = ncnet_forward_from_features(config, staged, src.features, tgt)
        else:
            out = ncnet_forward(config, staged, to_model_input(src), tgt)
        table = extract_match_table(out, k_size=k, do_softmax=do_softmax,
                                    both_directions=both_directions,
                                    flip_direction=flip_direction)
        if quality_cb is None:
            return table
        return append_quality_row(table, out.corr)

    def dispatch(src, tgt) -> torch.Tensor:
        """Enqueue one pair (upload, preprocess, forward, match
        extraction) and return its ``(5 | 6, N)`` table on the device
        without waiting for the card."""
        with annotate("inloc_pair_dispatch"):
            faults.device_error_hook("inloc_pair")
            return run(src, tgt)

    def fetch(handle):
        """Copy a dispatched table to the host: five numpy vectors (the
        quality row, when present, goes to ``quality_cb``)."""
        table, quality = split_quality_row(
            handle.to("cpu", torch.float32).numpy())
        if quality is not None and quality_cb is not None:
            quality_cb(quality)
        return tuple(table[i] for i in range(5))

    def matcher(src, tgt):
        return fetch(dispatch(src, tgt))

    matcher.preprocess = preprocess
    matcher.prepare_db = prepare_db
    matcher.dispatch = dispatch
    matcher.fetch = fetch
    matcher.feature_extractions = 0
    matcher.store = store
    return matcher


def sort_and_dedup(xa, ya, xb, yb, score):
    """Sort matches by descending score, then drop duplicate (xA, yA, xB,
    yB) rows keeping the max-score instance, the reference's recipe
    (eval_inloc.py:159-173): ``np.unique`` over the coordinate columns of
    the score-sorted table returns first-occurrence indices, and the first
    occurrence in a descending-score table is the max-score duplicate.
    Output order is ``np.unique``'s lexicographic order."""
    order = np.argsort(-score, kind="stable")
    xa, ya, xb, yb, score = (v[order] for v in (xa, ya, xb, yb, score))
    coords = np.stack([xa, ya, xb, yb], axis=0)
    _, unique_index = np.unique(coords, axis=1, return_index=True)
    return tuple(v[unique_index] for v in (xa, ya, xb, yb, score))


def manifest_name(host_index: int, host_count: int) -> str:
    """The run-manifest filename of one host stripe (one manifest per
    stripe: hosts share the output directory).  The CLI's degraded-run
    check reads exactly this file."""
    if host_count == 1:
        return "manifest.json"
    return f"manifest.host{host_index}_of_{host_count}.json"


def resolve_host_stripe(config: EvalInLocConfig) -> Tuple[int, int]:
    """``(host_index, host_count)``, with -1 / 0 taken from
    ``torch.distributed`` (rank, world size) when it is initialised, else
    the one stripe ``(0, 1)``.  Raises on incoherent explicit stripes (an
    index without a count, an index out of range), which would drop or
    duplicate queries."""
    dist = torch.distributed
    up = dist.is_available() and dist.is_initialized()
    host_count = config.host_count or (dist.get_world_size() if up else 1)
    host_index = (config.host_index if config.host_index >= 0
                  else (dist.get_rank() if up else 0))
    if config.host_index >= 0 and not config.host_count:
        raise ValueError("host_index given without host_count")
    if not 0 <= host_index < host_count:
        raise ValueError(
            f"host_index {host_index} out of range for host_count {host_count}")
    return host_index, host_count


def validate_matches_mat(path: str, n_panos: int, n_cap: int) -> bool:
    """Whether an existing per-query artifact is a loadable matches ``.mat``
    with the expected keys and table shape (a foreign or truncated file is
    recomputed, never trusted and never a crash)."""
    try:
        from scipy.io import loadmat

        mat = loadmat(path)
    except Exception:
        return False
    m = mat.get("matches")
    if m is None or "query_fn" not in mat or "pano_fn" not in mat:
        return False
    if n_panos == 0:  # a zero-dim table round-trips through .mat as empty
        return m.size == 0
    return m.shape == (1, n_panos, n_cap, 5)


def output_folder_name(config: EvalInLocConfig) -> str:
    """Experiment folder name encoding the eval settings
    (eval_inloc.py:60-71)."""
    name = os.path.basename(config.inloc_shortlist).split(".")[0]
    name += f"_SZ_NEW_{config.image_size}_K_{config.k_size}"
    if config.sparse_topk and config.k_size <= 1 and config.spatial_shards <= 1:
        # the coarse-to-fine tier changes the tables: its runs must not
        # share a dense run's folder (appended only where it engages)
        name += f"_SPARSE{config.sparse_topk}"
    if config.retrieval_index:
        name += f"_RETR{config.retrieval_topk or config.n_panos}"
    if config.matching_both_directions:
        name += "_BOTHDIRS"
    elif config.flip_matching_direction:
        name += "_AtoB"
    else:
        name += "_BtoA"
    if config.softmax:
        name += "_SOFTMAX"
    if config.checkpoint:
        ckpt = os.path.basename(config.checkpoint.rstrip("/")).split(".")[0]
        name += "_CHECKPOINT_" + ckpt
    return name


def _as_str(x) -> str:
    """Unwrap loadmat's nested name cells (str | str-array | object scalar)."""
    while isinstance(x, np.ndarray):
        x = x.ravel()[0] if x.size else ""
    return str(x)


def load_shortlist(path: str):
    """Parse the densePE shortlist ``.mat``: per-query filename and its
    ranked database cutouts (eval_inloc.py:97-101).  Returns ``(query_fns,
    pano_fns)``, ``pano_fns[q]`` the array of cutout names of query ``q``."""
    from scipy.io import loadmat

    db = loadmat(path)["ImgList"][0, :]
    query_fns = [_as_str(db[q][0]) for q in range(len(db))]
    pano_fns = [np.asarray(db[q][1]).ravel() for q in range(len(db))]
    return query_fns, pano_fns


def run_inloc_eval(config: EvalInLocConfig,
                   model_config: Optional[ModelConfig] = None, params=None,
                   progress: bool = True, device=None) -> str:
    """The InLoc matching loop; returns the output matches directory.

    Per query (this host's stripe of the first ``n_queries``): match against
    its top ``n_panos`` shortlisted cutouts and write one compressed
    ``<q+1>.mat`` with the fixed-capacity match table (eval_inloc.py:
    124-221).  Without ``params`` the model comes from ``config.checkpoint``
    (bf16, k = ``config.k_size``, as the reference hard-codes), else from
    ``init_ncnet`` at seed 1.  The run is on CUDA unless ``device`` says
    otherwise (``"cpu"`` for the tests).

    Fault tolerance: each query runs under ``evaluation/resilience.
    run_isolated`` (bounded retry with backoff of the same program,
    watchdogged fetches); an exhausted budget quarantines the query into
    the host's manifest instead of aborting the run.  ``skip_existing``
    resumes by artifact, validating an artifact the manifest does not
    vouch for (:func:`validate_matches_mat`)."""
    from concurrent.futures import ThreadPoolExecutor

    from ncnet_tpu_torch.evaluation.pipeline import call_with_watchdog
    from ncnet_tpu_torch.evaluation.resilience import (
        FaultPolicy,
        QuarantineBreaker,
        RunManifest,
        run_isolated,
    )
    from ncnet_tpu_torch.observability.device import DeviceMonitor
    from ncnet_tpu_torch.observability.memory import (
        LeakSentinel,
        hbm_stats,
        is_oom,
    )
    from ncnet_tpu_torch.observability.metrics import MetricsRegistry
    from ncnet_tpu_torch.observability.quality import active_tier, emit_quality
    from ncnet_tpu_torch.utils.io import atomic_savemat

    if params is None:
        base = ModelConfig(
            checkpoint=config.checkpoint,
            half_precision=True,  # the reference hard-codes it (eval_inloc.py:50)
            relocalization_k_size=config.k_size)
        if config.checkpoint:
            from ncnet_tpu_torch.models.checkpoint import load_params

            model_config, params = load_params(config.checkpoint, base)
            model_config = model_config.replace(
                half_precision=True, relocalization_k_size=config.k_size)
        else:
            from ncnet_tpu_torch.models.ncnet import init_ncnet

            model_config = base
            params = init_ncnet(model_config, seed=1)
    if model_config is None:
        raise ValueError("params given without their model_config")
    if model_config.relocalization_k_size != config.k_size:
        # the flag drives the model, as in the reference (eval_inloc.py:
        # 50-57): the resize quantization, the capacity and the folder name
        # must all agree on one k
        model_config = model_config.replace(relocalization_k_size=config.k_size)
    if config.sparse_topk:
        if config.k_size > 1:
            log.warning(
                f"sparse_topk={config.sparse_topk} with k_size="
                f"{config.k_size}: relocalization pooling keeps the dense "
                "path (pass --k_size 1 to run the coarse2fine tier)",
                kind="validation")
        if config.spatial_shards > 1:
            # the sharded forward is dense while an unshardable shape
            # bucket would take the pipeline chooser: one run must not mix
            # sparse and dense tables, so the knob is dropped wholesale
            log.warning(
                f"sparse_topk={config.sparse_topk} ignored under "
                f"spatial_shards={config.spatial_shards} (the hB-sharded "
                "forward is dense; a mixed sparse/dense run would be "
                "per-pair inconsistent)", kind="validation")
        else:
            model_config = model_config.replace(
                sparse_topk=config.sparse_topk)
    mesh = None
    if config.spatial_shards > 1:
        from ncnet_tpu_torch.parallel import make_mesh

        # this process's devices only: under host striping each rank runs
        # its own queries, so a shard cannot also be a rank (D7).  A CPU
        # run names the CPU once a shard; a CUDA run needs a card a shard
        cpu = device is not None and torch.device(device).type == "cpu"
        mesh = make_mesh(data=1, spatial=config.spatial_shards,
                         devices=["cpu"] * config.spatial_shards if cpu
                         else None)

    query_fns, pano_fns = load_shortlist(config.inloc_shortlist)
    pano_fn_all = np.vstack([p[:, None] for p in pano_fns])
    out_dir = os.path.join(config.output_root, output_folder_name(config))
    os.makedirs(out_dir, exist_ok=True)
    n_queries = min(config.n_queries, len(query_fns))
    host_index, host_count = resolve_host_stripe(config)

    own_sink = prev_sink = None
    store = None  # the feature store, when configured (built below)
    retrieval = retrieval_store = None  # the coarse index, when configured
    n_done = 0
    if config.telemetry_dir:
        # one file per host under striping: an event log has one writer
        log_name = ("events.jsonl" if host_count == 1
                    else f"events.host{host_index}.jsonl")
        own_sink = obs_events.EventLog(
            os.path.join(config.telemetry_dir, log_name),
            run_meta={"eval": "inloc",
                      "experiment": output_folder_name(config),
                      "host_index": host_index, "host_count": host_count})
        prev_sink = obs_events.set_global_sink(own_sink)
        own_sink.emit("run_start",
                      envelope=obs_events.run_envelope(own_sink.run_id),
                      eval="inloc", n_queries=n_queries)
    try:
        quality_registry = MetricsRegistry(scope="inloc_eval")
        # memory at query boundaries: rate-limited device snapshots and the
        # live-tensor leak sentinel (silent on the CPU)
        dev_monitor = DeviceMonitor(every_s=30.0)
        leak_sentinel = LeakSentinel(window=4, min_interval_s=1.0,
                                     scope="inloc_eval")

        def on_pair_quality(signals):
            emit_quality("inloc_eval", signals,
                         tier=active_tier(model_config.half_precision),
                         registry=quality_registry)

        # the persistent database-side feature store: pano features resolve
        # through verified entries keyed by (image content digest, backbone
        # fingerprint), so a warm query pays one extraction, its own.  Off
        # under spatial sharding (the sharded forward takes images); any
        # store trouble only means a recompute
        if config.feature_store_dir:
            if mesh is not None:
                log.warning(
                    "feature_store_dir ignored under spatial_shards > 1 (the "
                    "hB-sharded forward consumes images, not cached features)",
                    kind="validation")
            else:
                from ncnet_tpu_torch.models.ncnet import resolve_device
                from ncnet_tpu_torch.store import (
                    FeatureStore,
                    backbone_fingerprint,
                )

                fp = backbone_fingerprint(
                    params, image_size=config.image_size, k_size=config.k_size,
                    dtype="bf16" if model_config.half_precision else "f32",
                    device=resolve_device(device))
                store = FeatureStore(
                    config.feature_store_dir, fp,
                    budget_bytes=config.feature_store_budget_mb * 2 ** 20,
                    scope="inloc_eval")
                # entries of other weights can never be read again
                store.gc_superseded()

        # the in-system retrieval shortlist: a coarse index and its
        # verified store re-rank each query's whole .mat row before fine
        # matching.  Fail-open like the feature store: index, store or
        # descriptor trouble falls back to the .mat order with a warning
        # and a retrieval_fallback event, never failing or silently
        # truncating a query.  The store opens under the index's own
        # fingerprint, so an index either package built is read alike
        if config.retrieval_index:
            import re

            from ncnet_tpu_torch.retrieval.index import load_index_manifests
            from ncnet_tpu_torch.store import FeatureStore as CoarseStore

            r_index = load_index_manifests(config.retrieval_index)
            # a raw index names its fine grid in its synthetic fingerprint
            # (raw-s<grid>-k0-f32-c<factor>); the query pools from the same
            m = re.search(r"^raw-s(\d+)-", r_index["fingerprint"])
            retrieval_store = CoarseStore(
                os.path.dirname(os.path.abspath(r_index["sources"][0])),
                r_index["fingerprint"], scope="inloc_retrieval")
            retrieval = {"index": r_index,
                         "grid": int(m.group(1)) if m else 16,
                         "topk": int(config.retrieval_topk or config.n_panos)}
            log.info(
                f"retrieval shortlist on: {len(r_index['panos'])} indexed "
                f"panos, extractor={r_index['extractor']}, topk="
                f"{retrieval['topk']}, min_coverage="
                f"{config.retrieval_min_coverage}")

        matcher = make_pair_matcher(
            model_config, params, do_softmax=config.softmax,
            both_directions=config.matching_both_directions,
            flip_direction=config.flip_matching_direction,
            # raw uint8 in, normalize and resize on the card
            preprocess_image_size=config.image_size,
            quality_cb=on_pair_quality, device=device, mesh=mesh,
            store=store)
        n_cap = match_capacity(config.image_size, config.k_size,
                               config.matching_both_directions)
        manifest = None
        if config.write_manifest:
            manifest = RunManifest(
                os.path.join(out_dir, manifest_name(host_index, host_count)),
                meta={"experiment": output_folder_name(config),
                      "n_queries": n_queries, "n_panos": config.n_panos,
                      "host_index": host_index, "host_count": host_count})
        policy = FaultPolicy(retries=config.query_retries,
                             backoff_s=config.retry_backoff_s,
                             quarantine=config.quarantine)
        breaker = QuarantineBreaker(policy.max_consecutive_quarantines)
        depth_ctl = PipelineDepthController(config.pipeline_depth)
    except BaseException:
        # construction failed after the sink was bound: restore it here
        if store is not None:
            store.close()
        if retrieval_store is not None:
            retrieval_store.close()
        if own_sink is not None:
            obs_events.set_global_sink(prev_sink)
            own_sink.close()
        raise

    def pano_jobs(q):
        n_panos = min(config.n_panos, len(pano_fns[q]))
        return [os.path.join(config.pano_path, _as_str(pano_fns[q][idx]))
                for idx in range(n_panos)]

    def retrieval_plan(q, raw_q, src):
        """Score query ``q``'s whole ``.mat`` row by coarse similarity
        (``retrieval/index.py::local_shortlist`` through the verified store)
        and return ``(top-k pano names, coverage)``, or ``(None,
        coverage)`` when the row cannot be covered to
        ``config.retrieval_min_coverage`` (the caller then matches the
        ``.mat`` order: a reported fallback, never a silent truncation)."""
        from ncnet_tpu_torch.retrieval.index import local_shortlist
        from ncnet_tpu_torch.retrieval.scoring import (
            coarse_volume_from_features,
            pooled_descriptor,
            raw_coarse_volume,
        )

        row = [_as_str(pano_fns[q][i]) for i in range(len(pano_fns[q]))]
        r_index = retrieval["index"]
        sub = dict(r_index)
        sub["panos"] = {n: r_index["panos"][n] for n in row
                        if n in r_index["panos"]}
        try:
            if r_index["extractor"] == "raw":
                desc = pooled_descriptor(raw_coarse_volume(
                    raw_q, r_index["factor"], grid=retrieval["grid"]))
            else:
                # the query's trunk features, channels-last, to the host
                desc = pooled_descriptor(coarse_volume_from_features(
                    src.features.float().cpu().numpy(), r_index["factor"]))
            res = local_shortlist(retrieval_store, sub, desc,
                                  topk=retrieval["topk"])
        except Exception as e:  # noqa: BLE001 — fail-open: retrieval
            # trouble must never fail a query, only un-reorder it
            log.warning(f"retrieval scoring failed for query {q + 1} ({e}); "
                        "matching the precomputed .mat order",
                        kind="retrieval")
            obs_events.emit("retrieval_fallback", query=q + 1,
                            reason="error", error=str(e)[:200])
            return None, 0.0
        # outcome-total coverage over the row: panos absent from the index
        # count against it exactly like unreadable entries
        coverage = res["consulted"] / max(1, len(row))
        if coverage < config.retrieval_min_coverage:
            log.warning(
                f"retrieval coverage {coverage:.3f} < "
                f"{config.retrieval_min_coverage} for query {q + 1} "
                f"({res['consulted']}/{len(row)} row panos scored); "
                "matching the precomputed .mat order", kind="retrieval")
            obs_events.emit("retrieval_fallback", query=q + 1,
                            reason="coverage", coverage=round(coverage, 6),
                            consulted=res["consulted"], row=len(row))
            return None, coverage
        names = [p for p, _s in res["scores"]][:config.n_panos]
        obs_events.emit("retrieval_shortlist", query=q + 1,
                        coverage=round(coverage, 6),
                        consulted=res["consulted"], row=len(row),
                        topk=len(names), unavailable=len(res["unavailable"]))
        return names, coverage

    def process_query(q, io_pool):
        out_path = os.path.join(out_dir, f"{q + 1}.mat")
        if progress:
            log.info(str(q))
        matches = np.zeros((1, config.n_panos, n_cap, 5))
        jobs = pano_jobs(q)
        shortlist_names = retrieval_coverage = None
        if retrieval is None:
            # one decode-ahead worker: the next cutout decodes while the
            # card works on the current pair (an empty row still writes
            # its table)
            pending = io_pool.submit(load_raw, jobs[0]) if jobs else None
            # the query's trunk once, reused across its pairs
            src = matcher.preprocess(
                load_raw(os.path.join(config.query_path, query_fns[q])))
        else:
            # retrieval may reorder the jobs, so the decode-ahead submit
            # waits for the plan; the descriptor needs the query first
            raw_q = load_raw(os.path.join(config.query_path, query_fns[q]))
            src = matcher.preprocess(raw_q)
            with span("retrieval_plan", query=q + 1):
                names, retrieval_coverage = retrieval_plan(q, raw_q, src)
            if names is not None:
                shortlist_names = names
                jobs = [os.path.join(config.pano_path, n) for n in names]
            pending = io_pool.submit(load_raw, jobs[0]) if jobs else None
        depth_ctl.note_gap()  # the query's preprocess is not a pair wall
        in_flight = []  # [(idx, handle)]

        def store_pair(idx, xa, ya, xb, yb, score):
            if config.matching_both_directions:
                # single-direction outputs stay in grid order, as in the
                # reference (eval_inloc.py:151-177)
                xa, ya, xb, yb, score = sort_and_dedup(xa, ya, xb, yb, score)
            if len(xa) > n_cap:
                # a cutout whose aspect overflows the nominal table: keep
                # the n_cap best rows in their current order
                log.warning(f"{len(xa)} matches exceed capacity {n_cap}; "
                            "keeping highest-scoring rows", kind="validation")
                sel = np.sort(np.argsort(-score, kind="stable")[:n_cap])
                xa, ya, xb, yb, score = (v[sel] for v in (xa, ya, xb, yb, score))
            npts = len(xa)
            for c, v in enumerate((xa, ya, xb, yb, score)):
                matches[0, idx, :npts, c] = v[:npts]
            if progress and idx % 10 == 0:
                log.info(">>>" + str(idx))

        def drain_one(sample: bool = True):
            idx0, handle = in_flight.pop(0)
            # the watchdog turns a hung fetch into a retryable timeout
            with span("fetch", pair=idx0):
                xa, ya, xb, yb, score = call_with_watchdog(
                    matcher.fetch, (handle,), timeout=config.fetch_timeout_s,
                    label=f"InLoc query {q + 1} pair {idx0}")
            if sample:
                depth_ctl.note_drain()
            else:
                # the query's tail fetches back to back: not a pair wall
                depth_ctl.note_gap()
            store_pair(idx0, xa, ya, xb, yb, score)

        for idx in range(len(jobs)):
            with span("decode", pair=idx):
                tgt = pending.result()
            if idx + 1 < len(jobs):
                pending = io_pool.submit(load_raw, jobs[idx + 1])
            if store is not None:
                # the database side through the store: verified hit, or
                # recompute + commit; the pair then runs the feature-pair
                # program either way
                with span("store_resolve", pair=idx):
                    tgt = matcher.prepare_db(tgt)
            with span("dispatch", pair=idx):
                in_flight.append((idx, matcher.dispatch(src, tgt)))
            # a depth shrunk mid-query drains its extra slots too; only the
            # first drain of an iteration is a pair-wall sample
            first = True
            while len(in_flight) >= depth_ctl.depth:
                drain_one(sample=first)
                first = False
        while in_flight:
            drain_one(sample=False)
        payload = {"matches": matches, "query_fn": query_fns[q],
                   "pano_fn": pano_fn_all}
        if shortlist_names is not None:
            # retrieval reordered the row: the matches rows follow this
            # list (not pano_fn), recorded with the coverage it was made at
            payload["shortlist"] = np.asarray(
                [[n] for n in shortlist_names], dtype=object)
            payload["retrieval_coverage"] = float(retrieval_coverage)
        atomic_savemat(out_path, payload, do_compression=True)

    def query_loop(io_pool):
        nonlocal n_done
        for q in range(host_index, n_queries, host_count):
            qid = f"query_{q + 1}"
            out_path = os.path.join(out_dir, f"{q + 1}.mat")
            if config.skip_existing and os.path.exists(out_path):
                # resume by artifact: the .mat is renamed into place when
                # its query is done; the manifest vouches for what this
                # writer completed, validation for anything else
                vouched = manifest is not None and manifest.is_completed(qid)
                if vouched or not config.validate_existing \
                        or validate_matches_mat(out_path, config.n_panos, n_cap):
                    if progress:
                        log.info(f"{q} (exists, skipped)")
                    if manifest is not None and not vouched \
                            and config.validate_existing:
                        manifest.complete(qid, skipped=True)
                    # a skipped unit is a completed unit: reset the streak
                    breaker.note(False)
                    continue
                log.warning(f"{out_path} exists but failed validation "
                            "(foreign or truncated artifact); recomputing",
                            kind="validation")

            def on_failure(exc, kind, q=q):
                # an aborted drain leaves the controller's interval anchor
                # on a torn cadence: clear it before the retry
                depth_ctl.note_failure()
                if kind == "device":
                    obs_events.emit("device_failure", unit=f"query_{q + 1}",
                                    oom=is_oom(exc), hbm=hbm_stats())

            def traced_query(q=q):
                # one span per attempt: the trace shows a retry's cost
                with span("inloc_query", query=q + 1):
                    return process_query(q, io_pool)

            t_q = time.perf_counter()
            ok, _ = run_isolated(qid, traced_query, policy=policy,
                                 manifest=manifest, on_failure=on_failure,
                                 label=f"InLoc query {q + 1}")
            # consecutive quarantines mean the rig, not the queries, is
            # broken: SystemicEvalError aborts the run
            breaker.note(not ok)
            if ok:
                n_done += 1
            obs_events.emit("eval_query", query=q + 1, ok=bool(ok),
                            wall_s=round(time.perf_counter() - t_q, 6),
                            pipeline_depth=depth_ctl.depth)
            dev_monitor.maybe_emit(step=q + 1)
            leak_sentinel.observe(step=q + 1)

    try:
        with ThreadPoolExecutor(max_workers=1) as io_pool:
            query_loop(io_pool)
        if manifest is not None and manifest.quarantined_ids:
            log.warning("quarantined queries (see "
                        f"{manifest_name(host_index, host_count)}): "
                        + ", ".join(manifest.quarantined_ids),
                        kind="quarantine")
        # a warm run's summary shows hits == pairs, misses == 0 and one
        # extraction a completed query
        summary_extra = {}
        if store is not None:
            summary_extra = {"store": store.health(),
                             "feature_extractions": matcher.feature_extractions}
        if retrieval_store is not None:
            summary_extra["retrieval_store"] = retrieval_store.health()
        quality_registry.flush(
            event="eval_summary", eval="inloc", completed=n_done,
            quarantined=(list(manifest.quarantined_ids)
                         if manifest is not None else []), **summary_extra)
    finally:
        if store is not None:
            store.flush_stats(eval="inloc")
            store.close()
        if retrieval_store is not None:
            retrieval_store.flush_stats(eval="inloc_retrieval")
            retrieval_store.close()
        if own_sink is not None:
            obs_events.set_global_sink(prev_sink)
            own_sink.close()
    return out_dir
