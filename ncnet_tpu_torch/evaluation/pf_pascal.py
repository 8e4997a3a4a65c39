"""PF-Pascal PCK evaluation, the port of ``ncnet_tpu/evaluation/pf_pascal.py``
(``RESULT_COLUMNS``, ``make_eval_step``, ``run_eval``).

One step per batch: forward → softmax match extraction → keypoint warp →
PCK, with the pair's quality signals beside it, so one fetched ``(B, 6)``
table carries labels and label-free signals together.  Any batch size
works: every PF-Pascal eval image is resized to the same square.

The loop (:func:`run_eval`) mirrors the JAX package's:

  * images come from the dataset in their raw uint8 form (ROADMAP decision
    D1), are resized on the host, and upload as resized uint8 with the
    ImageNet normalization on the card (``device_normalize``), or as
    host-normalized floats (bf16 under ``backbone_bf16``);
  * batch decode overlaps the card through the loader's thread-pool
    prefetch, and dispatch/fetch runs at an adaptive depth
    (``evaluation/pipeline.PipelineDepthController``) on CUDA's
    asynchronous launches: a batch's handle is its step's output tensor on
    the card, and its fetch the ``.cpu()`` of it;
  * per-batch fault isolation (``evaluation/resilience``, ROADMAP decision
    D4): bounded retry of the same program, quarantine into the run
    manifest (the batch's pairs score NaN), the consecutive-quarantine
    breaker, an optional fetch watchdog, and — with
    ``config.journal_dir`` — an append-only journal of the per-batch rows
    from which a killed run resumes to a bit-equal result.  A device
    failure is retried; no tier is ever demoted;
  * a decode / dispatch / fetch wall split (``stats["timing"]``), quality
    digests, an ``eval_summary`` metrics flush and the perf store.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ncnet_tpu_torch.config import EvalPFPascalConfig, ModelConfig
from ncnet_tpu_torch.data.loader import stage_array
from ncnet_tpu_torch.evaluation.pck import pck_metric
from ncnet_tpu_torch.models.ncnet import ncnet_forward
from ncnet_tpu_torch.observability import events as obs_events
from ncnet_tpu_torch.observability.logging import get_logger
from ncnet_tpu_torch.observability.quality import QUALITY_SIGNALS, quality_table
from ncnet_tpu_torch.ops.image import normalize_imagenet, quantize_u8
from ncnet_tpu_torch.ops.matching import corr_to_matches
from ncnet_tpu_torch.utils import faults
from ncnet_tpu_torch.utils.profiling import annotate

log = get_logger("eval.pf_pascal")

# per-batch result columns: per-pair PCK, then the quality signals
RESULT_COLUMNS = ("pck",) + QUALITY_SIGNALS

# the batch keys the step reads
_STEP_KEYS = ("source_image", "target_image", "source_points",
              "target_points", "source_im_size", "target_im_size", "L_pck")


def make_eval_step(net, alpha: float, device_normalize: bool = False):
    """``step(params, batch)`` → the per-sample ``(B, 6)`` float32 table:
    PCK in column 0, the quality signals
    (:data:`~ncnet_tpu_torch.observability.quality.QUALITY_SIGNALS`) in the
    rest, over the same filtered volume the match extraction reads.

    ``net`` is the port's :class:`~ncnet_tpu_torch.models.ncnet.NCNet`;
    ``params`` its ``net.params`` (or another tree of the same shape on its
    device), ``batch`` a dict of tensors on that device (the keys of
    :func:`~ncnet_tpu_torch.evaluation.pck.pck_metric` and
    ``source_image``/``target_image``).  ``device_normalize``: the images
    arrive as resized uint8 and the ImageNet normalization runs on the
    device (cast to bf16 under ``backbone_bf16``); otherwise they are
    normalized floats.  The step runs under ``torch.no_grad`` inside a
    ``pf_pascal_eval_step`` profiler range (``utils/profiling.annotate``),
    and its dispatch passes ``utils/faults.device_error_hook``.  It returns
    without waiting for the card."""
    config = net.config

    @torch.no_grad()
    def forward(params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        src, tgt = batch["source_image"], batch["target_image"]
        if device_normalize:
            src, tgt = normalize_imagenet(src), normalize_imagenet(tgt)
            if config.backbone_bf16:
                src = src.to(torch.bfloat16)
                tgt = tgt.to(torch.bfloat16)
        out = ncnet_forward(config, params, src, tgt)
        matches = corr_to_matches(out.corr, do_softmax=True)
        scores = pck_metric(batch, matches, alpha)
        return torch.cat([scores.to(torch.float32)[:, None],
                          quality_table(out.corr)], dim=1)

    def step(params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        with annotate("pf_pascal_eval_step"):
            faults.device_error_hook("pf_pascal_step")
            return forward(params, batch)

    return step


def upload_batch(batch: Dict[str, np.ndarray], device: torch.device,
                 device_normalize: bool, image_dtype=None
                 ) -> Dict[str, torch.Tensor]:
    """The step's keys of a host batch as tensors on ``device``: resized
    0-255 images as uint8 (``quantize_u8``) when ``device_normalize``,
    else in ``image_dtype`` (the float32 default, or bf16); on CUDA from
    pinned memory without waiting, so the copy queues behind the card's
    work instead of waiting for it."""
    out = {}
    for k in _STEP_KEYS:
        v = np.asarray(batch[k])
        if k.endswith("_image") and device_normalize:
            v = quantize_u8(v)
        t = torch.from_numpy(np.ascontiguousarray(v))
        if k.endswith("_image") and not device_normalize \
                and image_dtype is not None:
            t = t.to(image_dtype)
        out[k] = stage_array(t, device)
    return out


def pad_batch(batch: Dict[str, np.ndarray], batch_size: int
              ) -> Dict[str, np.ndarray]:
    """A trailing partial batch padded up to ``batch_size`` by repeating
    its last sample (every step then runs at one shape; the extra rows are
    cropped after the fetch)."""
    jb = {k: np.asarray(batch[k]) for k in _STEP_KEYS}
    n_real = jb["source_image"].shape[0]
    if n_real < batch_size:
        reps = [1] * n_real
        reps[n_real - 1] = batch_size - n_real + 1
        jb = {k: np.repeat(v, reps, axis=0) for k, v in jb.items()}
    return jb


def run_eval(
    config: EvalPFPascalConfig,
    model_config: Optional[ModelConfig] = None,
    net=None,
    batch_size: int = 1,
    num_workers: int = 4,
    progress: bool = True,
    device_normalize: bool = True,
    pipeline_depth: int = 0,
    device=None,
) -> Dict[str, float]:
    """Evaluate PCK@alpha on the PF-Pascal test split.  See
    :func:`_run_eval_impl` for the contract; this wrapper owns the
    observability scope: with ``config.telemetry_dir`` it opens an event
    log there and binds it as the process-global sink for the run (the
    previous sink is restored on every exit path).

    The run is on CUDA unless ``device`` says otherwise (``"cpu"`` for the
    tests); a given ``net`` runs where it lives, and ``device`` must then
    agree with it or be None."""
    own_sink = prev_sink = None
    if config.telemetry_dir:
        own_sink = obs_events.EventLog(
            os.path.join(config.telemetry_dir, "events.jsonl"),
            run_meta={"eval": "pf_pascal",
                      "checkpoint": config.checkpoint,
                      "image_size": config.image_size,
                      "batch_size": batch_size},
        )
        prev_sink = obs_events.set_global_sink(own_sink)
        own_sink.emit("run_start",
                      envelope=obs_events.run_envelope(own_sink.run_id),
                      eval="pf_pascal")
    try:
        return _run_eval_impl(
            config, model_config, net, batch_size, num_workers, progress,
            device_normalize, pipeline_depth, device,
        )
    finally:
        if own_sink is not None:
            obs_events.set_global_sink(prev_sink)
            own_sink.close()


def _run_eval_impl(
    # defaults live on run_eval (the public wrapper) only
    config: EvalPFPascalConfig,
    model_config: Optional[ModelConfig],
    net,
    batch_size: int,
    num_workers: int,
    progress: bool,
    device_normalize: bool,
    pipeline_depth: int,
    device,
) -> Dict[str, float]:
    """Evaluate PCK@alpha on the PF-Pascal test split.

    Returns ``{"pck": mean over valid pairs, "total": N, "valid": N_valid}``
    (the three numbers the reference prints) plus ``per_pair``, the
    ``quality`` columns, their digests and Spearman correlation with PCK,
    ``quality_tier``, a ``timing`` wall split (decode / dispatch / fetch
    seconds, summed over the loop), and the resilience report
    (``quarantined_batches``: batch indices given up on after retries,
    their pairs scored NaN; ``decode_quarantined``: the raw files of
    undecodable images, whose pairs also score NaN).

    ``pipeline_depth``: 0 = adaptive, >0 pins the dispatch/fetch depth.
    With ``config.journal_dir`` every completed batch's rows are appended
    to ``<journal_dir>/pck_journal.jsonl`` beside a run manifest; a rerun
    with the same settings skips the journaled batches (their batches are
    still decoded, nothing is dispatched) and returns the uninterrupted
    result bit for bit.
    """
    from ncnet_tpu_torch.data import DataLoader, PFPascalDataset
    from ncnet_tpu_torch.evaluation.pipeline import (
        PipelineDepthController,
        call_with_watchdog,
    )
    from ncnet_tpu_torch.evaluation.resilience import (
        EvalJournal,
        FaultPolicy,
        QuarantineBreaker,
        RunManifest,
        classify_failure,
        run_isolated,
    )
    from ncnet_tpu_torch.models.ncnet import NCNet, resolve_device
    from ncnet_tpu_torch.observability import perfstore
    from ncnet_tpu_torch.observability.device import DeviceMonitor
    from ncnet_tpu_torch.observability.memory import (
        LeakSentinel,
        hbm_stats,
        is_oom,
    )
    from ncnet_tpu_torch.observability.metrics import MetricsRegistry
    from ncnet_tpu_torch.observability.quality import (
        DIGEST_BINS,
        SIGNAL_RANGE,
        active_tier,
        emit_quality,
        spearman,
    )
    from ncnet_tpu_torch.observability.tracing import span

    if net is None:
        mc = (model_config or ModelConfig()).replace(
            checkpoint=config.checkpoint)
        if config.sparse_topk:
            # coarse-to-fine matching rides the ModelConfig, so the
            # forward's pipeline chooser sees it; shapes it cannot take run
            # dense inside ncnet_match_volume
            mc = mc.replace(sparse_topk=config.sparse_topk)
        net = NCNet(mc, device=device)
    elif device is not None and resolve_device(device) != net.device:
        raise ValueError(f"device={device!r} but the net lives on "
                         f"{net.device}")
    dev = net.device

    dataset = PFPascalDataset(
        csv_file=os.path.join(config.eval_dataset_path, "image_pairs",
                              "test_pairs.csv"),
        dataset_path=config.eval_dataset_path,
        output_size=(config.image_size, config.image_size),
        pck_procedure=config.pck_procedure,
        decode_retries=config.decode_retries,
        # the uint8-upload path: the dataset emits the resized image
        # unnormalized (0-255 floats) and the loop quantizes it
        normalize=not device_normalize,
    )
    loader = DataLoader(
        dataset, batch_size=batch_size, shuffle=False,
        num_workers=num_workers,
        # one corrupt image must not abort the run: the loader substitutes
        # the next healthy sample (index-deterministic, so reruns and the
        # journal's bit-equal resume are unaffected) and reports it
        on_decode_error="quarantine" if config.quarantine else "raise",
    )
    step = make_eval_step(net, config.pck_alpha,
                          device_normalize=device_normalize)
    policy = FaultPolicy(retries=config.query_retries,
                         backoff_s=config.retry_backoff_s,
                         quarantine=config.quarantine)
    breaker = QuarantineBreaker(policy.max_consecutive_quarantines)
    journal = manifest = None
    if config.journal_dir:
        os.makedirs(config.journal_dir, exist_ok=True)
        header = {
            "image_size": config.image_size,
            "pck_alpha": config.pck_alpha,
            "pck_procedure": config.pck_procedure,
            "checkpoint": config.checkpoint,
            "batch_size": batch_size,
            "device_normalize": bool(device_normalize),
            "n_pairs": len(dataset),
            # records are whole result rows: the layout is part of the
            # fingerprint, and a mismatch starts fresh
            "columns": list(RESULT_COLUMNS),
        }
        journal = EvalJournal(
            os.path.join(config.journal_dir, "pck_journal.jsonl"), header)
        manifest = RunManifest(
            os.path.join(config.journal_dir, "manifest.json"), meta=header)

    registry = MetricsRegistry(scope="pf_pascal_eval")
    # memory at batch boundaries: rate-limited device snapshots and the
    # live-tensor leak sentinel (both silent on the CPU)
    dev_monitor = DeviceMonitor(every_s=30.0)
    leak_sentinel = LeakSentinel(window=4, min_interval_s=1.0,
                                 scope="pf_pascal_eval")
    results = []
    quarantined_batches = []
    n_batches = len(loader)
    # the host-normalized upload: when the trunk runs bf16, its first act
    # is casting the images to bf16, so uploading them as bf16 is exact
    # and halves the bytes
    img_dt = torch.bfloat16 if net.config.backbone_bf16 else None
    timing = {"decode_s": 0.0, "dispatch_s": 0.0, "fetch_s": 0.0}
    fresh_pairs = 0       # pairs dispatched in this run
    replayed_batches = 0  # batches a journal resume skipped
    # the controller's wall caps are per drain; a drain here is one batch,
    # so they scale with the batch (at least one dispatch's round trip)
    scale = max(1.0, batch_size / 2.0)
    depth_ctl = PipelineDepthController(
        pipeline_depth, high_cap=0.7 * scale, low_cap=0.45 * scale)
    in_flight: list = []
    n_cols = len(RESULT_COLUMNS)

    def nan_decode_quarantined(bi, arr) -> np.ndarray:
        """Score NaN the pairs of this batch whose own decode failed: the
        loader substituted the next healthy sample so the run survives, but
        the metric must not count the substitute twice.  Keyed on the
        loader's per-index bad set, and applied before journaling, so a
        resume replays it."""
        bad = loader.bad_indices
        if not bad:
            return arr
        arr = arr.copy()
        for j in range(len(arr)):
            if bi * batch_size + j in bad:
                arr[j] = np.nan
        return arr

    def resolve_batch(bi, jb, n0, handle) -> np.ndarray:
        """Fetch one batch's rows under per-batch fault isolation:
        watchdogged fetch, bounded retry (re-dispatching the same program
        from the kept batch when the handle is poisoned), quarantine (NaN
        rows) when the budget runs out."""
        state = {"handle": handle}

        def work():
            if state["handle"] is None:
                state["handle"] = step(net.params, jb)
            h = state["handle"]
            arr = np.asarray(
                call_with_watchdog(
                    lambda: h.cpu().numpy(),
                    timeout=config.fetch_timeout_s,
                    label=f"pf_pascal batch {bi}",
                ),
                dtype=np.float32,
            )[:n0]
            arr = nan_decode_quarantined(bi, arr)
            if journal is not None:
                # journal BEFORE the manifest's completed transition (which
                # run_isolated applies on return): the journal, the source
                # of truth for resume, is never behind the manifest
                journal.append(bi, arr)
            return arr

        def on_failure(exc, kind):
            state["handle"] = None  # poisoned (or never produced): re-dispatch
            depth_ctl.note_failure()
            if kind == "device":
                obs_events.emit("device_failure", unit=f"batch_{bi}",
                                oom=is_oom(exc), hbm=hbm_stats())

        ok, arr = run_isolated(
            f"batch_{bi}", work, policy=policy, manifest=manifest,
            on_failure=on_failure, label=f"PF-Pascal batch {bi}",
        )
        # N consecutive quarantines = systemic: abort (SystemicEvalError)
        breaker.note(not ok)
        if not ok:
            quarantined_batches.append(bi)
            return np.full((n0, n_cols), np.nan, dtype=np.float32)
        return arr

    def drain_one(sample: bool = True):
        handle, n0, bi, jb = in_flight.pop(0)
        t0 = time.perf_counter()
        with span("fetch", batch=bi):
            arr = resolve_batch(bi, jb, n0, handle)
        results.append(arr)
        fetch_wall = time.perf_counter() - t0
        timing["fetch_s"] += fetch_wall
        registry.timer("fetch_wall").observe(fetch_wall)
        registry.counter("batches").inc()
        registry.gauge("pipeline_depth").set(depth_ctl.depth)
        dev_monitor.maybe_emit(step=bi)
        leak_sentinel.observe(step=bi)
        pck_col = arr[:, 0]
        if obs_events.get_global_sink() is not None:
            good = pck_col[~np.isnan(pck_col)]
            obs_events.emit(
                "eval_batch", batch=bi, n=int(pck_col.size),
                valid=int(good.size),
                pck=float(np.mean(good)) if good.size else None,
                fetch_wall_s=round(fetch_wall, 6),
                pipeline_depth=depth_ctl.depth,
            )
        # per-pair quality signals, tier-tagged, next to the per-pair PCK,
        # and into the registry's fixed-bin digests
        emit_quality(
            "pf_pascal_eval",
            {name: arr[:, i + 1] for i, name in enumerate(QUALITY_SIGNALS)},
            tier=active_tier(net.config.half_precision),
            pck=pck_col, registry=registry, batch=bi, n=int(pck_col.size),
        )
        if sample:
            depth_ctl.note_drain()
        else:
            # end-of-run tail: queued batches fetch back to back with no
            # dispatch between them, not a per-drain wall sample
            depth_ctl.note_gap()

    # an explicit iterator: the decode wall (the loader's __next__) gets
    # its own span per batch
    loader_it = enumerate(loader)
    t_decode = time.perf_counter()
    while True:
        with span("decode"):
            nxt_item = next(loader_it, None)
        if nxt_item is None:
            break
        i, batch = nxt_item
        timing["decode_s"] += time.perf_counter() - t_decode
        if journal is not None and i in journal.entries:
            # resume: this batch's rows are journaled.  Flush the pipeline
            # first so the results keep batch order, then reuse the stored
            # values without dispatching
            while in_flight:
                drain_one(sample=False)
            replayed = journal.entries[i].reshape(-1, n_cols)
            results.append(replayed)
            # replayed pairs feed the quality digests (the per-run
            # aggregate covers every pair) but re-emit no quality event:
            # the killed run's events for this batch are already logged
            for k, name in enumerate(QUALITY_SIGNALS):
                lo, hi = SIGNAL_RANGE[name]
                vals = replayed[:, k + 1]
                registry.histogram(f"q_{name}", lo, hi, DIGEST_BINS).add(
                    vals[np.isfinite(vals)])
            replayed_batches += 1
            if manifest is not None:
                manifest.complete(f"batch_{i}", journaled=True)
            # a replayed unit is a completed unit: reset the breaker streak
            breaker.note(False)
            depth_ctl.note_gap()
            if progress:
                log.info(f"Batch: [{i}/{n_batches}] (journaled, skipped)")
            t_decode = time.perf_counter()
            continue
        t0 = time.perf_counter()
        with span("dispatch", batch=i):
            host = pad_batch(batch, batch_size)
            n_real = np.asarray(batch["source_image"]).shape[0]
            jb = upload_batch(host, dev, device_normalize, img_dt)
            # pipelined dispatch: CUDA's asynchronous launches let batch
            # i+1's upload and forward queue behind batch i's compute, and
            # results are fetched in dispatch order.  A dispatch-time
            # failure is deferred to the drain's isolation path, which
            # re-dispatches the same program under its retry budget
            try:
                handle = step(net.params, jb)
            except Exception as e:
                kind = classify_failure(e)
                log.warning(f"PF-Pascal batch {i}: {kind} failure at "
                            f"dispatch: {type(e).__name__}: {e}", kind=kind)
                depth_ctl.note_failure()
                handle = None
            in_flight.append((handle, n_real, i, jb))
            fresh_pairs += n_real
        timing["dispatch_s"] += time.perf_counter() - t0
        while len(in_flight) >= depth_ctl.depth:
            drain_one()
        if progress:
            log.info(f"Batch: [{i}/{n_batches} "
                     f"({100.0 * i / n_batches:.0f}%)]")
        t_decode = time.perf_counter()
    while in_flight:
        drain_one(sample=False)
    if journal is not None:
        journal.close()

    results = np.concatenate(results)  # (N, 1 + len(QUALITY_SIGNALS))
    per_pair = results[:, 0]
    # NaN PCK = zero valid keypoints, a quarantined batch, or a pair with
    # an undecodable image
    good = np.flatnonzero(~np.isnan(per_pair))
    quality = {name: results[:, i + 1]
               for i, name in enumerate(QUALITY_SIGNALS)}
    # signal-vs-PCK rank correlation: labels exist here, so the label-free
    # signals are validated against them
    quality_pck_spearman = {
        name: spearman(vals, per_pair) for name, vals in quality.items()
    }
    stats = {
        "pck": float(np.mean(per_pair[good])) if good.size else float("nan"),
        "total": int(per_pair.size),
        "valid": int(good.size),
        "per_pair": per_pair,
        "quality": quality,
        "quality_digests": {
            name: registry.histogram(
                f"q_{name}", *SIGNAL_RANGE[name], DIGEST_BINS).snapshot()
            for name in QUALITY_SIGNALS
        },
        "quality_pck_spearman": quality_pck_spearman,
        "quality_tier": active_tier(net.config.half_precision),
        "timing": timing,
        "quarantined_batches": quarantined_batches,
        "decode_quarantined": sorted(loader.quarantined),
    }
    registry.timer("decode_wall").observe(timing["decode_s"])
    registry.timer("dispatch_wall").observe(timing["dispatch_s"])
    registry.counter("quarantined_batches").inc(len(quarantined_batches))
    registry.counter("decode_quarantined").inc(
        len(stats["decode_quarantined"]))
    registry.gauge("pck").set(stats["pck"])
    registry.flush(event="eval_summary", total=stats["total"],
                   valid=stats["valid"], tier=stats["quality_tier"],
                   quality_pck_spearman={
                       k: (None if v != v else round(v, 4))
                       for k, v in quality_pck_spearman.items()})
    # cross-run history: PCK, the quality means and (full runs only) the
    # per-pair wall split land in the perf store (fail-open)
    history = {"pf_pascal_pck": stats["pck"]}
    for name, vals in quality.items():
        finite = vals[np.isfinite(vals)]
        if finite.size:
            history[f"pf_pascal_quality_{name}"] = float(np.mean(finite))
    if fresh_pairs and not replayed_batches:
        for k in ("decode", "dispatch", "fetch"):
            history[f"pf_pascal_{k}_s_per_pair"] = (
                timing[f"{k}_s"] / fresh_pairs)
    perfstore.maybe_record(history, source="pf_pascal_eval")
    return stats
