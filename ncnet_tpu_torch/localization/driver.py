"""The InLoc localization driver (compute_densePE_NCNet.m, end to end).

Consumes the ``matches/<experiment>/<q>.mat`` tables written by
``eval_inloc``, estimates a pose per (query, top-10 cutout) with the batched
LO-RANSAC P3P, optionally re-ranks the candidates by synthetic-view pose
verification, and emits the localization-rate curves against the reference
poses.  Every stage persists .mat artifacts and resumes from them — the
reference's resume-by-artifact failure story (SURVEY §5.3) — and the PnP
stage adds per-query fault isolation (retry → quarantine into a stage
manifest, evaluation/resilience.py) so one broken query's inputs cannot
abort the whole localization run.

The port of ``ncnet_tpu/localization/driver.py``.  Images are read as raw
uint8 arrays (ROADMAP D1: ``<name>.npy`` beside each query).  The run
resolves its device once (CUDA unless the caller passes another) and hands
it, explicitly, to every pool worker, which opens its own CUDA context on
it (ROADMAP D6); no worker moves to the CPU on its own.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ncnet_tpu_torch.config import LocalizationConfig
from ncnet_tpu_torch.localization import geometry
from ncnet_tpu_torch.localization.curves import (
    MethodResult,
    load_reference_poses,
    plot_localization_curves,
)
from ncnet_tpu_torch.localization.pnp import run_pair_pnp
from ncnet_tpu_torch.localization.scan import (
    load_transformation,
    load_xyzcut,
    transformation_path,
)
from ncnet_tpu_torch.localization.verification import (
    PVItem,
    rerank_by_scores,
    run_pose_verification,
)
from ncnet_tpu_torch.models.ncnet import resolve_device
from ncnet_tpu_torch.observability import get_logger
from ncnet_tpu_torch.observability.tracing import span

log = get_logger("localization")


def image_size(path: str) -> Tuple[int, int]:
    """(height, width) of the image at ``path``, from its raw array's
    header (``data/datasets.py::raw_path``), without reading pixels."""
    from ncnet_tpu_torch.data.datasets import raw_path

    return tuple(np.load(raw_path(path), mmap_mode="r").shape[:2])


def query_focal(config: LocalizationConfig, height: int, width: int) -> float:
    """Configured query focal length, or the iPhone 7 EXIF-derived default
    (the reference reads ``params.data.q.fl`` from its external project
    setup).  Derived from the image's long side — see
    :func:`geometry.iphone7_focal`."""
    if config.query_focal_length > 0:
        return config.query_focal_length
    return geometry.iphone7_focal(height, width)


def _cell_row(items) -> np.ndarray:
    """(1, N) object array — a MATLAB cell row.  Built element-wise because
    ``np.array(list_of_equal_shape_arrays, dtype=object)`` would broadcast
    into one numeric block instead of N cells."""
    out = np.empty((1, len(items)), dtype=object)
    for i, v in enumerate(items):
        out[0, i] = v
    return out


def _save_imglist(path: str, imglist: List[dict]) -> None:
    from ncnet_tpu_torch.utils.io import atomic_savemat as savemat

    savemat(
        path,
        {
            "ImgList": np.array(
                [
                    (
                        e["queryname"],
                        _cell_row(e["topNname"]),
                        np.asarray(e.get("topNscore", []), dtype=np.float64
                                   ).reshape(1, -1),
                        _cell_row(e["P"]),
                    )
                    for e in imglist
                ],
                dtype=[
                    ("queryname", object),
                    ("topNname", object),
                    ("topNscore", object),
                    ("P", object),
                ],
            ).reshape(1, -1)
        },
        do_compression=True,
    )


def _load_imglist(path: str) -> List[dict]:
    from scipy.io import loadmat

    mat = loadmat(path, simplify_cells=True)
    entries = mat["ImgList"]
    if isinstance(entries, dict):
        entries = [entries]
    out = []
    for e in entries:
        names = e["topNname"]
        if isinstance(names, str):
            names = [names]
        poses = e["P"]
        if isinstance(poses, np.ndarray) and poses.ndim == 2:
            poses = [poses]
        scores = e.get("topNscore", [])
        if isinstance(scores, (int, float)):
            scores = [scores]
        out.append(
            {
                "queryname": str(e["queryname"]),
                "topNname": [str(n) for n in names],
                "topNscore": list(np.asarray(scores, dtype=np.float64).ravel()),
                "P": [np.asarray(p, dtype=np.float64) for p in poses],
            }
        )
    return out


def _spawn_pool(num_workers: int):
    """Spawn-based process pool shared by the PnP (per-query) and PV
    (per-scan-group) stages.  Each task carries the run's device; a worker
    given CUDA opens its own context on the card (ROADMAP D6)."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    return ProcessPoolExecutor(
        max_workers=num_workers, mp_context=mp.get_context("spawn"))


def _pnp_one_query(config: LocalizationConfig, qi: int, qname: str,
                   top_names: List[str], device: str) -> dict:
    """All top-N pose estimates for one query — the unit of host-side task
    parallelism (the reference's ``parfor ii = 1:Nq``,
    ir_top100_NC4D_localization_pnponly.m).

    A ``.mat`` written under the retrieval shortlist holds its ``matches``
    rows in retrieval order and records that order as ``shortlist``: the
    cutout names then come from it, so row ``jj`` is lifted through its own
    cutout's ``XYZcut`` and transformation.  (The JAX driver pairs rows with
    the DensePE row's names whatever the ``.mat`` says: ROADMAP C4.)
    Without the key the names are the DensePE row's, ``top_names``."""
    from scipy.io import loadmat

    from ncnet_tpu_torch.evaluation.inloc import _as_str

    pnp_dir = os.path.join(config.output_dir, _pnp_dirname(config))
    qsize = image_size(os.path.join(config.query_path, qname))
    focal = query_focal(config, qsize[0], qsize[1])
    mat = loadmat(os.path.join(config.matches_dir, f"{qi + 1}.mat"))
    match_mat = mat["matches"]
    if "shortlist" in mat:
        top_names = [_as_str(n) for n in np.asarray(mat["shortlist"]).ravel()]
    # the match table's pano depth bounds how many candidates exist
    top_names = top_names[: min(config.pnp_topN, match_mat.shape[1])]
    poses: List[np.ndarray] = []
    for jj, db_fn in enumerate(top_names):
        xyzcut = load_xyzcut(
            os.path.join(config.cutout_path, db_fn + config.cutout_mat_suffix)
        )
        P_after = load_transformation(
            transformation_path(config.transformation_path, db_fn)
        )
        P, _ = run_pair_pnp(
            pnp_dir,
            qname,
            db_fn,
            match_mat[0, jj],
            qsize,
            xyzcut,
            P_after,
            focal,
            score_thr=config.match_score_thr,
            inlier_thr_deg=config.pnp_inlier_thr_deg,
            ransac_iters=config.ransac_iters,
            seed=config.seed,
            max_tentatives=config.max_tentatives,
            device=device,
        )
        poses.append(P)
        if config.progress:
            log.info(f"nc4dPE: {qname} vs {db_fn} DONE.")
    return {"queryname": qname, "topNname": top_names, "P": poses}


def run_pnp_stage(config: LocalizationConfig, device=None) -> List[dict]:
    """Pose per (query, top-N cutout) from the dense matches
    (ir_top100_NC4D_localization_pnponly.m).  Returns the ImgList and writes
    ``top_<N>_thr..._rthr....mat``; reloads it when it already exists.

    ``config.num_workers > 0`` fans queries out over a spawn-based process
    pool — the Python equivalent of the reference's MATLAB ``parfor`` over
    queries; the per-pair artifact files make retries/collisions safe.

    Per-query fault isolation (round 7): a query whose inputs are broken —
    unreadable matches .mat, missing cutout depth, undecodable query image —
    is retried with backoff and then QUARANTINED into the stage manifest
    (``<pnp_dir>/manifest.json``) with a classified failure record, instead
    of aborting the whole stage as the previous ``pool.map`` did on the
    first worker exception.  A quarantined query is excluded from the
    ImgList; downstream curve scoring already treats a missing query as
    not-localized (``pose_errors`` fills inf), so the run's result stays
    well-defined.

    The RANSAC scores on ``device`` (CUDA unless the caller passes
    another), in the workers too.
    """
    from ncnet_tpu_torch.evaluation.inloc import _as_str, load_shortlist
    from ncnet_tpu_torch.evaluation.resilience import (
        FaultPolicy,
        QuarantineBreaker,
        RunManifest,
        run_isolated,
    )

    device = str(resolve_device(device))
    out_path = os.path.join(config.output_dir, _pnp_matname(config))
    if os.path.exists(out_path):
        return _load_imglist(out_path)

    query_fns, pano_fns = load_shortlist(config.shortlist)
    n_queries = len(query_fns)
    if config.n_queries > 0:
        n_queries = min(n_queries, config.n_queries)
    args = [
        (config, qi, query_fns[qi],
         [_as_str(n) for n in np.asarray(pano_fns[qi]).ravel()], device)
        for qi in range(n_queries)
    ]
    pnp_dir = os.path.join(config.output_dir, _pnp_dirname(config))
    os.makedirs(pnp_dir, exist_ok=True)
    manifest = RunManifest(
        os.path.join(pnp_dir, "manifest.json"),
        meta={"stage": "pnp", "n_queries": n_queries,
              "matches_dir": config.matches_dir},
    )
    policy = FaultPolicy(retries=config.query_retries,
                         backoff_s=config.retry_backoff_s,
                         quarantine=config.quarantine)
    # N consecutive quarantines = systemic (bad matches_dir, dead pool
    # survivor): abort loudly instead of quarantining every query
    breaker = QuarantineBreaker(policy.max_consecutive_quarantines)
    imglist: List[dict] = []
    if config.num_workers > 0:
        with _spawn_pool(config.num_workers) as pool:
            futures = [pool.submit(_pnp_one_query, *a) for a in args]
            try:
                for a, fut in zip(args, futures):
                    first = {"fut": fut}

                    def work(a=a, first=first):
                        f = first["fut"]
                        first["fut"] = None
                        if f is None:  # retry: resubmit to the pool
                            f = pool.submit(_pnp_one_query, *a)
                        # the span is the parent's WAIT on the worker (the
                        # spawned process has no event sink); per-query
                        # compute beyond the first is hidden behind earlier
                        # waits, exactly what the trace should show
                        with span("pnp_query", query=a[2]):
                            return f.result()

                    ok, entry = run_isolated(
                        a[2], work, policy=policy, manifest=manifest,
                        label=f"PnP query {a[2]}",
                    )
                    breaker.note(not ok)
                    if ok:
                        imglist.append(entry)
            except BaseException:
                # abort paths (SystemicEvalError, quarantine=False) must
                # surface NOW: without cancelling, the pool's __exit__
                # would first wait out every pending future's discarded work
                pool.shutdown(wait=False, cancel_futures=True)
                raise
    else:
        for a in args:

            def _one(a=a):
                with span("pnp_query", query=a[2]):
                    return _pnp_one_query(*a)

            ok, entry = run_isolated(
                a[2], _one,
                policy=policy, manifest=manifest,
                label=f"PnP query {a[2]}",
            )
            breaker.note(not ok)
            if ok:
                imglist.append(entry)
    if manifest.quarantined_ids:
        # a degraded ImgList must NOT become the stage's resume artifact —
        # the exists-guard above would pin it forever.  Return this run's
        # partial result, but let the next run retry the quarantined
        # queries; the per-pair artifacts in pnp_dir make the recompute of
        # the completed queries cheap (run_pair_pnp resumes from them).
        log.warning("PnP stage completed with quarantined queries "
                    f"({', '.join(manifest.quarantined_ids)}); the stage "
                    ".mat is NOT written so a rerun retries them (completed "
                    "queries resume from their per-pair artifacts)",
                    kind="quarantine")
        return imglist
    os.makedirs(config.output_dir, exist_ok=True)
    _save_imglist(out_path, imglist)
    return imglist


def _pv_run_items(config: LocalizationConfig, items_ser,
                  prepared_queries=None, progress=None,
                  device=None) -> Dict:
    """Score a batch of PV items (one scan group when pooled) on
    ``device``.  Module-level and plain-data-argumented so spawn workers can
    run it."""
    items = [PVItem(q, d, np.asarray(P)) for q, d, P in items_ser]

    def query_loader(fn: str) -> np.ndarray:
        from ncnet_tpu_torch.data.datasets import load_image

        return load_image(os.path.join(config.query_path, fn))

    return run_pose_verification(
        items,
        query_loader,
        scan_dir=config.scan_path,
        trans_dir=config.transformation_path,
        focal_fn=lambda fn, img: query_focal(config, img.shape[0], img.shape[1]),
        out_dir=os.path.join(config.output_dir, _pv_dirname(config)),
        scan_suffix=config.scan_suffix,
        progress=config.progress if progress is None else progress,
        prepared_queries=prepared_queries,
        device=device,
    )


def run_pv_stage(
    config: LocalizationConfig, imglist: List[dict],
    pin_resume: bool = True, device=None,
) -> List[dict]:
    """Pose-verification rerank of each query's candidates
    (ht_top10_NC4D_PV_localization.m); writes/reloads the densePV ImgList.

    ``config.num_workers > 0`` fans the unique-scan groups out over a spawn
    process pool — the reference's ``parfor`` over scans; per-item .pv.mat
    artifacts keep pooled reruns collision-safe.

    ``pin_resume=False`` (used when the upstream PnP stage ran degraded —
    quarantined queries): neither reload nor write the stage-level resume
    .mat, so a degraded rerank can never be pinned as the experiment's
    final answer; the per-item .pv.mat artifacts still make the eventual
    clean rerun cheap.

    The dense SIFT runs on ``device`` (CUDA unless the caller passes
    another), in the workers too.
    """
    from ncnet_tpu_torch.localization.verification import group_items_by_scan

    device = str(resolve_device(device))
    out_path = os.path.join(config.output_dir, _pv_matname(config))
    if pin_resume and os.path.exists(out_path):
        return _load_imglist(out_path)

    items = [
        PVItem(e["queryname"], db_fn, P)
        for e in imglist
        for db_fn, P in zip(e["topNname"], e["P"])
    ]

    if config.num_workers > 0:
        from ncnet_tpu_torch.data.datasets import load_image
        from ncnet_tpu_torch.localization.verification import downsample_image

        group_map = sorted(group_items_by_scan(items).items())
        groups = [
            [(it.query_fn, it.db_fn, np.asarray(it.P)) for it in group]
            for _, group in group_map
        ]
        # decode + downsample every query ONCE in the parent and ship the
        # small (H/8) arrays to the workers — a query appears in up to topN
        # scan groups, so per-worker caches would redo the full-res decode
        # per group
        prepared: Dict[str, tuple] = {}
        for e in imglist:
            fn = e["queryname"]
            if fn not in prepared:
                img = load_image(os.path.join(config.query_path, fn))
                prepared[fn] = (
                    downsample_image(img),
                    query_focal(config, img.shape[0], img.shape[1]),
                )
        per_group_prepared = [
            {q: prepared[q] for q, _, _ in group} for group in groups
        ]
        scores: Dict = {}
        with _spawn_pool(config.num_workers) as pool:
            results = pool.map(
                _pv_run_items,
                [config] * len(groups),
                groups,
                per_group_prepared,
                [False] * len(groups),  # workers stay quiet; parent reports
                [device] * len(groups),
            )
            for gi, ((key, _), part) in enumerate(zip(group_map, results)):
                scores.update(part)
                if config.progress:
                    log.info(f"ncnetPV: scan {key} ({gi + 1} / "
                             f"{len(groups)}) done.")
    else:
        with span("pv_score", items=len(items)):
            scores = _pv_run_items(
                config, [(it.query_fn, it.db_fn, it.P) for it in items],
                device=device,
            )

    reranked = []
    for e in imglist:
        s = [scores[(e["queryname"], n)] for n in e["topNname"]]
        names, poses, s = rerank_by_scores(e["topNname"], e["P"], s)
        reranked.append(
            {
                "queryname": e["queryname"],
                "topNname": names,
                "topNscore": s,
                "P": poses,
            }
        )
    if pin_resume:
        _save_imglist(out_path, reranked)
    else:
        log.warning("densePV stage ran on a degraded (quarantined) PnP "
                    "result; its stage .mat is NOT written so a rerun "
                    "recomputes from the retried PnP stage",
                    kind="quarantine")
    return reranked


def pnp_stage_degraded(config: LocalizationConfig) -> bool:
    """Whether the PnP stage's manifest records quarantined queries — the
    downstream signal that this run's ImgList is partial and no stage may
    pin a resume artifact built from it."""
    from ncnet_tpu_torch.evaluation.resilience import manifest_has_quarantined

    return manifest_has_quarantined(
        os.path.join(config.output_dir, _pnp_dirname(config), "manifest.json")
    )


def run_localization(config: LocalizationConfig,
                     device=None) -> Dict[str, np.ndarray]:
    """The full L6 pipeline; returns ``{method description: curve}`` and
    writes curves/figures/error txts into ``config.output_dir``.  The
    device stages (the RANSAC's scoring, the dense SIFT) run on ``device``:
    CUDA unless the caller passes another (``"cpu"``); without a GPU the
    default raises."""
    device = str(resolve_device(device))
    imglist = run_pnp_stage(config, device)
    degraded = pnp_stage_degraded(config)
    methods = [
        MethodResult(
            "DensePE + NCNet",
            {e["queryname"]: (e["topNname"][0], e["P"][0]) for e in imglist},
        )
    ]
    if config.do_pose_verification:
        reranked = run_pv_stage(config, imglist, pin_resume=not degraded,
                                device=device)
        methods.append(
            MethodResult(
                "InLoc + NCNet",
                {
                    e["queryname"]: (e["topNname"][0], e["P"][0])
                    for e in reranked
                },
            )
        )
    refposes = load_reference_poses(config.refposes)
    return plot_localization_curves(methods, refposes, config.output_dir)


def _variant_suffix(config: LocalizationConfig) -> str:
    """Result-affecting knobs this port adds over the reference (whose
    artifact names only encode topN/thr/rthr) must key the resume artifacts
    too, or a rerun with different settings silently reloads stale results."""
    s = ""
    if config.n_queries > 0:
        s += f"_nq{config.n_queries}"
    if config.seed != 0:
        s += f"_seed{config.seed}"
    if config.ransac_iters != 10000:
        s += f"_it{config.ransac_iters}"
    if config.max_tentatives:
        s += f"_sub{config.max_tentatives}"
    return s


def _pnp_dirname(config: LocalizationConfig) -> str:
    return (
        f"top_{config.pnp_topN}_PnP_thr{int(config.match_score_thr * 100):03d}"
        f"_rthr{int(config.pnp_inlier_thr_deg * 100):03d}"
        + _variant_suffix(config)
    )


def _pnp_matname(config: LocalizationConfig) -> str:
    return (
        f"top_{config.pnp_topN}_thr{int(config.match_score_thr * 100):03d}"
        f"_rthr{int(config.pnp_inlier_thr_deg * 100):03d}"
        + _variant_suffix(config) + ".mat"
    )


def _pv_dirname(config: LocalizationConfig) -> str:
    return _pnp_matname(config)[:-4] + "_densePV"


def _pv_matname(config: LocalizationConfig) -> str:
    return _pnp_matname(config)[:-4] + "_densePV.mat"
