"""Replay one or more ncnet_tpu event logs into a run report.

The port of the root ``tools/run_report.py``: the same reading of the same
records, with the same text, JSON and exit codes, on the port's own
modules, so an operator of the port needs no JAX.

The event log (``ncnet_tpu_torch/observability/events.py``) is the durable,
machine-readable trace of a run: step/epoch boundaries, checkpoint commits,
NaN-guard skips, tier selections/demotions, retries, quarantines, watchdog
timeouts, metrics flushes.  This tool turns one or more of those JSONL files
(a resumed run appends to the same file; sharded runs write several) into
the report an operator actually wants after a run ends — or dies:

  * run/resume lineage (every run id in the file, with its envelope);
  * step-time percentiles + throughput + the MFU trajectory;
  * the tier timeline (selections and demotions, in order);
  * failure accounting: NaN skips, retries by kind, quarantines, watchdog
    timeouts, preemptions;
  * a divergence postmortem when the run died of TrainDivergedError (the
    last N steps before the fatal streak, with losses and grad norms);
  * checkpoint/resume consistency (commits seen, resume positions).

Usage::

    python -m ncnet_tpu_torch.tools.run_report <events.jsonl> [more.jsonl ...] [--json]

``--json`` emits the raw report dict (one JSON document) instead of text.
Replay is torn-tail tolerant: a log whose writer was SIGKILLed mid-append
still replays in full minus at most the torn trailing line.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Optional

from ncnet_tpu_torch.observability.events import replay_events


def _percentiles(xs: List[float], qs=(50, 90, 99)) -> Dict[str, float]:
    if not xs:
        return {}
    xs = sorted(xs)
    out: Dict[str, float] = {}
    for q in qs:
        # nearest-rank on the sorted walls: no numpy needed, exact enough
        # for a report
        i = min(len(xs) - 1, max(0, round(q / 100 * (len(xs) - 1))))
        out[f"p{q}"] = xs[i]
    out["mean"] = sum(xs) / len(xs)
    out["n"] = len(xs)
    return out


def build_span_breakdown(events: List[dict]) -> Dict[str, Any]:
    """Critical-path accounting over the span events: per span NAME (keyed
    under its parent's name, so `train_step > dispatch` and a root-level
    `dispatch` stay distinct), the count, total wall, and SELF time — total
    minus the time spent inside child spans — which is what actually ranks
    phases on the critical path: a `train_step` span's total wall double-
    counts every phase nested in it, its self time is the unattributed
    remainder.  Unclosed spans (SIGKILL mid-span) are counted, not timed."""
    # pair B/E by (run, span id); resolve each span's parent NAME via the
    # parent id stamped on the B event
    opens: Dict[tuple, dict] = {}
    closed: List[dict] = []
    unclosed = 0
    names: Dict[tuple, str] = {}
    child_time: Dict[tuple, float] = {}
    for e in events:
        if e.get("event") != "span":
            continue
        key = (e.get("run"), e.get("span"))
        if e.get("ph") == "B":
            opens[key] = e
            names[key] = str(e.get("name"))
        elif e.get("ph") == "E":
            b = opens.pop(key, None)
            if b is None:
                continue
            dur = e.get("dur_s")
            if not isinstance(dur, (int, float)):
                continue
            parent_key = (e.get("run"), b.get("parent"))
            child_time[parent_key] = child_time.get(parent_key, 0.0) + dur
            closed.append({"key": key, "name": names[key],
                           "parent": b.get("parent"), "dur": float(dur),
                           "error": e.get("error")})
    unclosed = len(opens)
    groups: Dict[tuple, Dict[str, Any]] = {}
    for s in closed:
        parent_name = (names.get((s["key"][0], s["parent"]), "-")
                       if s["parent"] is not None else "-")
        g = groups.setdefault((parent_name, s["name"]), {
            "parent": parent_name, "name": s["name"], "n": 0,
            "total_s": 0.0, "self_s": 0.0, "errors": 0,
        })
        g["n"] += 1
        g["total_s"] += s["dur"]
        g["self_s"] += s["dur"] - child_time.get(s["key"], 0.0)
        if s["error"]:
            g["errors"] += 1
    out = sorted(groups.values(), key=lambda g: -g["self_s"])
    for g in out:
        g["total_s"] = round(g["total_s"], 6)
        g["self_s"] = round(g["self_s"], 6)
        g["mean_s"] = round(g["total_s"] / g["n"], 6)
    return {"groups": out, "closed": len(closed), "unclosed": unclosed}


def build_quality_section(events: List[dict],
                          device_kind: Optional[str],
                          ref_path: Optional[str] = None) -> Dict[str, Any]:
    """Aggregate the ``quality`` events (observability/quality.py): a
    per-(tier, signal) stats table, the signal-vs-PCK rank correlation where
    labels rode along (the PF-Pascal eval emits them side by side — a
    positive rho validates the signal as a label-free PCK proxy), and —
    when a reference file is given/committed — the PSI drift verdicts the
    standalone ``tools/quality_drift.py`` gate would report."""
    from ncnet_tpu_torch.observability.quality import (
        check_drift,
        digests_from_events,
        load_reference,
        reference_binning,
        signal_pck_correlation,
    )

    # ONE aggregation pass serves both the stats table and the drift
    # verdicts: when a reference exists its binning is applied up front
    # (count/mean are binning-independent; table percentiles are ±bin
    # width either way)
    reference = {}
    bins_like = None
    if ref_path and os.path.exists(ref_path):
        reference = load_reference(ref_path)
        if reference:
            bins_like = reference_binning(reference)
    digests = digests_from_events(events, bins_like=bins_like)
    table = []
    for (tier, signal), h in sorted(digests.items()):
        table.append({
            "tier": tier, "signal": signal, "n": h.count,
            "mean": round(h.mean(), 6) if h.count else None,
            "p50": round(h.percentile(50), 6) if h.count else None,
            "p90": round(h.percentile(90), 6) if h.count else None,
        })
    section: Dict[str, Any] = {
        "table": table,
        "pck_spearman": {
            k: (None if v != v else round(v, 4))
            for k, v in signal_pck_correlation(events).items()
        },
    }
    if reference:
        section["drift"] = check_drift(reference, digests,
                                       device_kind=device_kind)
        section["drift_ref"] = ref_path
    return section


def build_slo_section(events: List[dict]) -> Dict[str, Any]:
    """Recompute the SLO error-budget counters from the event log — the
    replay twin of the live tracker (``ncnet_tpu_torch/serving/slo.py``).

    Classification uses the SAME values the live tracker saw: the latency
    objectives stamped into ``serve_start``, the rounded ``wall_ms`` of
    each ``serve_result``, and the ``admitted`` flags on
    ``serve_deadline``/``serve_shed`` — so a complete log replays to
    counters that match the service's final ``/metrics`` scrape EXACTLY
    (the scrape-vs-replay consistency bar).  ``admitted`` here counts
    terminal outcomes of admitted requests, exactly like the tracker: on a
    clean drain it equals the admission count, after a crash it counts
    what actually terminated."""
    cfg: Optional[Dict[str, Any]] = None
    for e in events:
        if e.get("event") == "serve_start" and isinstance(e.get("slo"),
                                                          dict):
            cfg = e["slo"]  # latest service start wins (resume lineage)
    default_ms = cfg.get("default_ms") if cfg else None
    by_bucket = dict((cfg or {}).get("by_bucket") or {})
    budget_pct = float((cfg or {}).get("budget_pct") or 1.0)

    def objective(bucket: str) -> Optional[float]:
        return by_bucket.get(bucket, default_ms)

    bad = {"deadline": 0, "quarantined": 0, "shed": 0, "latency": 0}
    admitted = ok = 0
    for e in events:
        ev = e.get("event")
        if ev == "serve_result":
            admitted += 1
            obj = objective(str(e.get("bucket")))
            wall = e.get("wall_ms")
            if obj is not None and isinstance(wall, (int, float)) \
                    and wall > obj:
                bad["latency"] += 1
            else:
                ok += 1
        elif ev == "serve_deadline" and e.get("admitted") is not False:
            admitted += 1
            bad["deadline"] += 1
        elif ev == "serve_quarantine":
            admitted += 1
            bad["quarantined"] += 1
        elif ev == "serve_shed" and e.get("admitted") is True:
            admitted += 1
            bad["shed"] += 1
    bad_total = sum(bad.values())
    burn = (round(100.0 * (bad_total / admitted) / (budget_pct / 100.0), 4)
            if admitted else 0.0)
    section: Dict[str, Any] = {
        "objectives": cfg,
        "admitted": admitted,
        "ok": ok,
        "bad": bad,
        "bad_total": bad_total,
        "budget_burn_pct": burn,
    }
    slo_events = [e for e in events if e.get("event") == "slo"]
    if slo_events:
        last = slo_events[-1]
        section["slo_events"] = len(slo_events)
        section["final_event"] = {
            k: last.get(k) for k in
            ("admitted", "ok", "bad", "bad_total", "budget_burn_pct",
             "final") if k in last}
        # the consistency verdict itself: does the replay reproduce the
        # tracker's final counters?  (False on a torn log whose terminal
        # events outlived the final slo event, or vice versa.)
        section["matches_final_event"] = all(
            section.get(k) == last.get(k)
            for k in ("admitted", "ok", "bad", "bad_total",
                      "budget_burn_pct"))
    return section


def build_serving_section(events: List[dict]) -> Dict[str, Any]:
    """The serving postmortem: request-outcome accounting (the outcome-total
    invariant ``admitted == results + deadlines + quarantines +
    admitted_sheds``; a nonzero ``unresolved`` means requests died without
    an outcome — the kill-mid-drain signature), per-bucket AND per-replica
    latency/outcome percentiles (the replica-pool postmortem: batches,
    retries, deaths/resurrections per replica id), the queue-depth
    trajectory (from ``serve_batch`` events), and the health-state timeline
    (replica-tagged entries are replica lifecycle edges)."""
    admits = [e for e in events if e.get("event") == "serve_admit"]
    results = [e for e in events if e.get("event") == "serve_result"]
    deadlines = [e for e in events if e.get("event") == "serve_deadline"
                 and e.get("admitted") is not False]
    quarantines = [e for e in events
                   if e.get("event") == "serve_quarantine"]
    sheds = [e for e in events if e.get("event") == "serve_shed"]
    sheds_admitted = [e for e in sheds if e.get("admitted") is True]
    terminals = (len(results) + len(deadlines) + len(quarantines)
                 + len(sheds_admitted))
    # which admitted requests never reached an outcome (lost mid-drain /
    # in flight at process death) — keyed (run, request): request ids
    # restart at r1 per service process, and a restarted run appending to
    # the same log (the resume-lineage design) must not mask a dead run's
    # losses with its own same-named requests
    def _key(e: dict):
        return (e.get("run"), e.get("request"))

    settled_ids = {_key(e) for e in results + quarantines}
    settled_ids |= {_key(e) for e in deadlines}
    settled_ids |= {_key(e) for e in sheds_admitted}
    lost = [f"{e.get('request')} (run {e.get('run')})" for e in admits
            if _key(e) not in settled_ids]

    lat_all = [e["wall_ms"] for e in results
               if isinstance(e.get("wall_ms"), (int, float))]
    per_bucket: Dict[str, List[float]] = {}
    for e in results:
        if isinstance(e.get("wall_ms"), (int, float)):
            per_bucket.setdefault(str(e.get("bucket")), []).append(
                e["wall_ms"])
    shed_reasons: Dict[str, int] = {}
    for e in sheds:
        r = str(e.get("reason", "unknown"))
        shed_reasons[r] = shed_reasons.get(r, 0) + 1
    deadline_where: Dict[str, int] = {}
    for e in [e for e in events if e.get("event") == "serve_deadline"]:
        w = str(e.get("where", "unknown"))
        deadline_where[w] = deadline_where.get(w, 0) + 1

    batches = [e for e in events if e.get("event") == "serve_batch"]
    # the queue-depth trajectory, downsampled to <= 64 points so a long
    # run's report stays readable
    traj = [{"t": e.get("t"), "queue_depth": e.get("queue_depth"),
             "size": e.get("size")} for e in batches]
    if len(traj) > 64:
        step = len(traj) / 64.0
        traj = [traj[int(i * step)] for i in range(64)]

    # per-replica accounting (the pool postmortem): batches/results/retries
    # per replica id, its latency percentiles, and its death/resurrection
    # count from the replica-tagged serve_health events
    replicas: Dict[str, Dict[str, Any]] = {}

    def _rep(rid) -> Dict[str, Any]:
        return replicas.setdefault(str(rid), {
            "batches": 0, "batch_walls": [], "results": 0, "latencies": [],
            "retries": 0, "deaths": 0, "resurrections": 0, "probes": 0,
        })

    for e in batches:
        if e.get("replica") is not None:
            r = _rep(e["replica"])
            r["batches"] += 1
            if isinstance(e.get("wall_s"), (int, float)):
                r["batch_walls"].append(e["wall_s"])
    for e in results:
        if e.get("replica") is not None:
            r = _rep(e["replica"])
            r["results"] += 1
            if isinstance(e.get("wall_ms"), (int, float)):
                r["latencies"].append(e["wall_ms"])
    for e in events:
        ev, rid = e.get("event"), e.get("replica")
        if rid is None:
            continue
        if ev == "retry" and e.get("scope") == "serving":
            _rep(rid)["retries"] += 1
        elif ev == "serve_health" and e.get("state") == "DEAD":
            _rep(rid)["deaths"] += 1
        elif ev == "serve_health" and e.get("state") == "READY":
            _rep(rid)["resurrections"] += 1
        elif ev == "serve_replica_probe":
            _rep(rid)["probes"] += 1
    replica_table = {}
    for rid, r in sorted(replicas.items()):
        replica_table[rid] = {
            "batches": r["batches"],
            "batch_wall_s": _percentiles(r["batch_walls"]),
            "results": r["results"],
            "latency_ms": _percentiles(r["latencies"]),
            "retries": r["retries"],
            "deaths": r["deaths"],
            "resurrections": r["resurrections"],
            "probes": r["probes"],
        }

    # per-model-version result counts (the rollout stamps every
    # serve_result with the serving replica's model_version): a pod that
    # served under more than one version mid-log renders as mixed-version
    by_version: Dict[str, int] = {}
    for e in results:
        if e.get("model_version") is not None:
            v = str(e["model_version"])
            by_version[v] = by_version.get(v, 0) + 1

    return {
        "outcomes": {
            "admitted": len(admits),
            "results": len(results),
            "deadline_exceeded": len(deadlines),
            "quarantined": len(quarantines),
            "shed_admitted": len(sheds_admitted),
            "shed_at_admission": len(sheds) - len(sheds_admitted),
            "terminals": terminals,
            # clamped: a crash in the admit-emit window can lose an admit
            # record for a settled request, and a negative count must not
            # render as "-1 requests died"
            "unresolved": max(0, len(admits) - terminals),
        },
        "results_by_version": by_version,
        "lost_requests": lost,
        "latency_ms": _percentiles(lat_all),
        "latency_ms_by_bucket": {
            b: _percentiles(v) for b, v in sorted(per_bucket.items())},
        "batches": {
            "n": len(batches),
            "wall_s": _percentiles(
                [e["wall_s"] for e in batches
                 if isinstance(e.get("wall_s"), (int, float))]),
            "mean_size": (sum(e.get("size", 0) for e in batches)
                          / len(batches)) if batches else None,
        },
        "queue_depth_trajectory": traj,
        "shed_reasons": shed_reasons,
        "deadline_where": deadline_where,
        "replicas": replica_table,
        # the unified health document the service recorded as its last act
        # (serving/health.py::build_health_document) — the postmortem's
        # final state-of-the-world, schema-versioned
        "final_health_doc": next(
            (e.get("doc") for e in reversed(events)
             if e.get("event") == "serve_health_doc"
             and isinstance(e.get("doc"), dict)), None),
        "health_timeline": [
            {"t": e.get("t"), "state": e.get("state"),
             "reason": e.get("reason"),
             **({"replica": e["replica"]}
                if e.get("replica") is not None else {})}
            for e in events if e.get("event") == "serve_health"
        ],
        "drains": [
            {k: e.get(k) for k in e
             if k.startswith("n_") or k in ("t", "drained", "leftover")}
            for e in events if e.get("event") == "serve_drain"
        ],
    }


def build_rollout_section(events: List[dict]) -> Dict[str, Any]:
    """The rollout postmortem (ncnet_tpu_torch/serving/rollout.py): the phase
    timeline (STAGING -> CANARY -> PROMOTING -> COMPLETE, or the rollback
    branch), every per-replica weight swap with its warmup verdict, the
    canary judgement (PSI per signal, error rate, latency EWMA for old vs
    new), refusals with their classified reasons, and per-model-version
    request accounting recomputed from the version-tagged ``serve_result``/
    ``serve_failure`` stream — the replayable proof that a rollout (or its
    automatic rollback) lost nothing."""
    phases = [
        {k: e.get(k) for k in ("t", "phase", "reason", "old_version",
                               "new_version") if k in e}
        for e in events if e.get("event") == "rollout_phase"
    ]
    swaps = [
        {k: e.get(k) for k in ("t", "replica", "version", "warmed", "ok",
                               "error") if k in e}
        for e in events if e.get("event") == "rollout_swap"
    ]
    refusals = [
        {k: e.get(k) for k in ("t", "candidate", "reason", "error")
         if k in e}
        for e in events if e.get("event") == "rollout_refused"
    ]
    verdicts = [
        {k: e.get(k) for k in
         ("t", "old_version", "new_version", "breach", "psi",
          "psi_threshold", "error_rate", "latency_ewma_ms", "results")
         if k in e}
        for e in events if e.get("event") == "rollout_canary_verdict"
    ]
    rollbacks = [
        {k: e.get(k) for k in ("t", "reason", "old_version", "new_version",
                               "stuck_replicas") if k in e}
        for e in events if e.get("event") == "rollout_rolled_back"
    ]

    # per-version request accounting from the version-tagged result stream:
    # every serve_result/serve_failure carries the model_version of the
    # replica that served it, so the canary's share and the mixed-version
    # window are auditable after the fact
    versions: Dict[str, Dict[str, Any]] = {}

    def _ver(v) -> Dict[str, Any]:
        return versions.setdefault(str(v), {
            "results": 0, "failures": 0, "latencies": [],
        })

    for e in events:
        ev = e.get("event")
        if ev == "serve_result" and e.get("model_version") is not None:
            v = _ver(e["model_version"])
            v["results"] += 1
            if isinstance(e.get("wall_ms"), (int, float)):
                v["latencies"].append(e["wall_ms"])
        elif ev == "serve_failure" and e.get("model_version") is not None:
            _ver(e["model_version"])["failures"] += 1
    version_table = {}
    for vid, v in sorted(versions.items()):
        version_table[vid] = {
            "results": v["results"],
            "failures": v["failures"],
            "latency_ms": _percentiles(v["latencies"]),
        }

    # the DRAINING edges in the health timeline are the capacity evidence:
    # rolling swaps drain exactly one replica at a time
    draining = [
        {"t": e.get("t"), "replica": e.get("replica"),
         "reason": e.get("reason")}
        for e in events
        if e.get("event") == "serve_health"
        and e.get("state") == "DRAINING" and e.get("replica") is not None
    ]

    terminal = None
    for p in phases:
        if p.get("phase") in ("COMPLETE", "ROLLED_BACK", "IDLE"):
            terminal = p["phase"]
    return {
        "phases": phases,
        "terminal_phase": terminal,
        "swaps": swaps,
        "swaps_failed": sum(1 for s in swaps if not s.get("ok")),
        "refusals": refusals,
        "canary_verdicts": verdicts,
        "rollbacks": rollbacks,
        "versions": version_table,
        "replica_drains": draining,
    }


def build_memory_section(events: List[dict]) -> Dict[str, Any]:
    """The memory postmortem (observability/memory.py), replayed from the
    event log alone: the compiled-program ledger table (latest row per
    (program, shape_class, tier, device_kind) key), the HBM trajectory from
    the ``device_snapshot`` events, the leak sentinel's verdicts, and every
    OOM postmortem with its bundled evidence."""
    ledger: Dict[tuple, dict] = {}
    cached = 0
    for e in events:
        if e.get("event") != "memory_ledger":
            continue
        key = (e.get("program"), e.get("shape_class"), e.get("tier"),
               e.get("device_kind"))
        if e.get("source") == "cache":
            cached += 1
        ledger[key] = {
            "program": e.get("program"), "shape_class": e.get("shape_class"),
            "tier": e.get("tier"), "device_kind": e.get("device_kind"),
            "argument_bytes": e.get("argument_bytes"),
            "output_bytes": e.get("output_bytes"),
            "temp_bytes": e.get("temp_bytes"),
            "generated_code_bytes": e.get("generated_code_bytes"),
            "total_bytes": e.get("total_bytes"),
            "source": e.get("source"),
        }

    # HBM trajectory: one point per device_snapshot entry that carried
    # memory stats, downsampled like the queue-depth trajectory
    traj: List[Dict[str, Any]] = []
    for e in events:
        if e.get("event") != "device_snapshot":
            continue
        for d in e.get("devices") or []:
            if isinstance(d, dict) and d.get("bytes_in_use") is not None:
                traj.append({
                    "t": e.get("t"), "device": d.get("id"),
                    "bytes_in_use": d.get("bytes_in_use"),
                    "peak_bytes_in_use": d.get("peak_bytes_in_use"),
                    "bytes_limit": d.get("bytes_limit"),
                    "bytes_reserved": d.get("bytes_reserved"),
                    "largest_free_block_bytes":
                        d.get("largest_free_block_bytes"),
                })
    if len(traj) > 64:
        step = len(traj) / 64.0
        traj = [traj[int(i * step)] for i in range(64)]

    leaks = [
        {k: e.get(k) for k in ("t", "scope", "step", "window", "suspects",
                               "live_n", "live_bytes") if k in e}
        for e in events if e.get("event") == "memory_leak_suspect"
    ]
    postmortems = [
        {k: e.get(k) for k in
         ("t", "scope", "program", "kind", "error", "replica", "phase",
          "bucket", "snapshot", "ledger", "census") if k in e}
        for e in events if e.get("event") == "memory_postmortem"
    ]
    return {
        "ledger": sorted(
            ledger.values(),
            key=lambda r: (str(r["program"]), str(r["shape_class"]),
                           str(r["tier"]))),
        "ledger_events": sum(
            1 for e in events if e.get("event") == "memory_ledger"),
        "ledger_cached_events": cached,
        "hbm_trajectory": traj,
        "leak_suspects": leaks,
        "postmortems": postmortems,
    }


def build_store_section(events: List[dict]) -> Dict[str, Any]:
    """The feature-store replay (ncnet_tpu_torch/store/): per-scope open/stats
    records, the DEGRADED → recovered health timeline, every quarantined
    (corrupt) entry, evictions, and GC sweeps — reconstructed from the
    event log alone, so a dead run's cache behaviour is auditable without
    the store directory."""
    opens = [
        {k: e.get(k) for k in ("t", "scope", "root", "fingerprint",
                               "entries", "bytes", "budget_bytes", "state")
         if k in e}
        for e in events if e.get("event") == "store_open"
    ]
    timeline = [
        {k: e.get(k) for k in ("t", "scope", "state", "reason") if k in e}
        for e in events if e.get("event") == "store_health"
    ]
    corrupt = [
        {k: e.get(k) for k in ("t", "scope", "digest", "reason",
                               "quarantined_to") if k in e}
        for e in events if e.get("event") == "store_corrupt"
    ]
    evictions = [e for e in events if e.get("event") == "store_evict"]
    gcs = [
        {k: e.get(k) for k in ("t", "scope", "fingerprints", "entries")
         if k in e}
        for e in events if e.get("event") == "store_gc"
    ]
    # the last stats flush per scope is the run's final counter state
    stats: Dict[str, Any] = {}
    for e in events:
        if e.get("event") == "store_stats" and isinstance(
                e.get("store"), dict):
            stats[str(e.get("scope", "store"))] = e["store"]
    return {
        "opens": opens,
        "health_timeline": timeline,
        "degraded_spells": sum(
            1 for e in timeline if e.get("state") == "DEGRADED"),
        "recovered": sum(
            1 for e in timeline if e.get("state") == "OK"),
        "corrupt_quarantined": corrupt,
        "evictions": len(evictions),
        "evicted_bytes": sum(
            e.get("bytes", 0) for e in evictions
            if isinstance(e.get("bytes"), (int, float))),
        "gc_sweeps": gcs,
        "final_stats": stats,
    }


def build_router_section(events: List[dict]) -> Dict[str, Any]:
    """The router-tier postmortem (the multi-host twin of
    :func:`build_serving_section`): the outcome-total identity recomputed
    at the ROUTER level (``route_admit == route_result + admitted
    route_deadline + route_quarantine + admitted route_shed``; nonzero
    ``unresolved`` = edge requests that died without an outcome),
    backend-tagged accounting (requests/results/retries/backpressure/
    latency per backend id, deaths and resurrections from the
    ``route_backend`` lifecycle events), shed/deadline classification, and
    the router health timeline."""
    admits = [e for e in events if e.get("event") == "route_admit"]
    results = [e for e in events if e.get("event") == "route_result"]
    deadlines = [e for e in events if e.get("event") == "route_deadline"
                 and e.get("admitted") is not False]
    quarantines = [e for e in events
                   if e.get("event") == "route_quarantine"]
    sheds = [e for e in events if e.get("event") == "route_shed"]
    sheds_admitted = [e for e in sheds if e.get("admitted") is True]
    terminals = (len(results) + len(deadlines) + len(quarantines)
                 + len(sheds_admitted))

    def _key(e: dict):
        # keyed (run, request) like the serving section: router request
        # ids restart at q1 per process and a restarted router appends to
        # the same log
        return (e.get("run"), e.get("request"))

    settled = {_key(e) for e in results + quarantines}
    settled |= {_key(e) for e in deadlines}
    settled |= {_key(e) for e in sheds_admitted}
    lost = [f"{e.get('request')} (run {e.get('run')})" for e in admits
            if _key(e) not in settled]

    lat_all = [e["wall_ms"] for e in results
               if isinstance(e.get("wall_ms"), (int, float))]
    shed_reasons: Dict[str, int] = {}
    for e in sheds:
        r = str(e.get("reason", "unknown"))
        shed_reasons[r] = shed_reasons.get(r, 0) + 1
    deadline_where: Dict[str, int] = {}
    for e in [e for e in events if e.get("event") == "route_deadline"]:
        w = str(e.get("where", "unknown"))
        deadline_where[w] = deadline_where.get(w, 0) + 1

    # backend-tagged accounting: results/latency per backend, retries and
    # backpressure from the scope="router" retry events, lifecycle from
    # route_backend, probes from route_backend_probe
    backends: Dict[str, Dict[str, Any]] = {}

    def _bk(bid) -> Dict[str, Any]:
        return backends.setdefault(str(bid), {
            "results": 0, "latencies": [], "backend_wall_ms": [],
            "retries": 0, "backpressure": 0, "deaths": 0,
            "resurrections": 0, "draining": 0, "probes": 0,
        })

    for e in results:
        if e.get("backend") is not None:
            b = _bk(e["backend"])
            b["results"] += 1
            if isinstance(e.get("wall_ms"), (int, float)):
                b["latencies"].append(e["wall_ms"])
            if isinstance(e.get("backend_wall_ms"), (int, float)):
                b["backend_wall_ms"].append(e["backend_wall_ms"])
    for e in events:
        ev, bid = e.get("event"), e.get("backend")
        if bid is None:
            continue
        if ev == "retry" and e.get("scope") == "router":
            b = _bk(bid)
            if e.get("via") == "backpressure":
                b["backpressure"] += 1
            else:
                b["retries"] += 1
        elif ev == "route_backend" and e.get("state") == "DEAD":
            _bk(bid)["deaths"] += 1
        elif ev == "route_backend" and e.get("state") == "READY":
            _bk(bid)["resurrections"] += 1
        elif ev == "route_backend" and e.get("state") == "DRAINING":
            _bk(bid)["draining"] += 1
        elif ev == "route_backend_probe":
            _bk(bid)["probes"] += 1
    backend_table = {}
    for bid, b in sorted(backends.items()):
        backend_table[bid] = {
            "results": b["results"],
            "latency_ms": _percentiles(b["latencies"]),
            # the fan-out overhead evidence: edge wall minus the wall the
            # backend itself reported for the same requests
            "backend_wall_ms": _percentiles(b["backend_wall_ms"]),
            "retries": b["retries"],
            "backpressure": b["backpressure"],
            "deaths": b["deaths"],
            "resurrections": b["resurrections"],
            "draining": b["draining"],
            "probes": b["probes"],
        }

    return {
        "outcomes": {
            "admitted": len(admits),
            "results": len(results),
            "deadline_exceeded": len(deadlines),
            "quarantined": len(quarantines),
            "shed_admitted": len(sheds_admitted),
            "shed_at_admission": len(sheds) - len(sheds_admitted),
            "terminals": terminals,
            "unresolved": max(0, len(admits) - terminals),
        },
        "lost_requests": lost,
        "latency_ms": _percentiles(lat_all),
        "shed_reasons": shed_reasons,
        "deadline_where": deadline_where,
        "backends": backend_table,
        "final_health_doc": next(
            (e.get("doc") for e in reversed(events)
             if e.get("event") == "route_health_doc"
             and isinstance(e.get("doc"), dict)), None),
        "health_timeline": [
            {"t": e.get("t"), "state": e.get("state"),
             "reason": e.get("reason"),
             **({"backend": e["backend"]}
                if e.get("backend") is not None else {})}
            for e in events
            if e.get("event") in ("route_health", "route_backend")
        ],
        "drains": [
            {k: e.get(k) for k in e
             if k.startswith("n_") or k in ("t", "drained", "leftover")}
            for e in events if e.get("event") == "route_drain"
        ],
    }


def build_pod_section(events: List[dict]) -> Dict[str, Any]:
    """The POD-scope identity report (``--pod log1 log2 ...``): the
    outcome-total invariant recomputed across EVERY log of a pod at once,
    joined by the wire-propagated trace id (observability/tracing.py).

    What only the merged logs can prove:

      * **edge totality** — every router-admitted request reaches exactly
        one terminal ``route_*`` outcome (same identity as the router
        section, but over all router logs/lineages in the pod);
      * **trail continuity** — every ``route_result`` was BACKED by a
        ``serve_result`` carrying the same trace id in some backend log.
        A trace whose router says "result" but whose backend trail shows
        fewer results has GONE DARK (a backend log lost/torn past its
        settle) and is named, never averaged away;
      * **failover attribution** — each ``retry`` ``scope=router``
        ``via=reroute`` is tied to its trace, with the backend runs that
        admitted the request before and after, so a SIGKILLed backend's
        re-routed requests are individually accounted;
      * **hedge attribution** — ``retrieve_hedge`` events joined by
        trace, the shard tier's duplicate-dispatch accounting;
      * **pod overhead** — per routed result, the edge wall minus the
        wall the backend measured for the SAME trace = wire + routing
        overhead (falls back to the in-band ``backend_wall_ms`` when the
        trace join finds no unique backend twin, e.g. shared stream
        traces).
    """
    def _key(e: dict):
        return (e.get("run"), e.get("request"))

    admits = [e for e in events if e.get("event") == "route_admit"]
    r_results = [e for e in events if e.get("event") == "route_result"]
    r_deadlines = [e for e in events if e.get("event") == "route_deadline"
                   and e.get("admitted") is not False]
    r_quar = [e for e in events if e.get("event") == "route_quarantine"]
    r_sheds = [e for e in events if e.get("event") == "route_shed"
               and e.get("admitted") is True]
    terminals = (len(r_results) + len(r_deadlines) + len(r_quar)
                 + len(r_sheds))
    settled = {_key(e) for e in r_results + r_quar}
    settled |= {_key(e) for e in r_deadlines}
    settled |= {_key(e) for e in r_sheds}
    lost = [f"{e.get('request')} (run {e.get('run')})" for e in admits
            if _key(e) not in settled]

    # --- the trace join across logs -----------------------------------
    s_results = [e for e in events if e.get("event") == "serve_result"
                 and e.get("trace")]
    s_admit_runs: Dict[str, List[Any]] = {}
    for e in events:
        if e.get("event") == "serve_admit" and e.get("trace"):
            runs = s_admit_runs.setdefault(str(e["trace"]), [])
            if e.get("run") not in runs:
                runs.append(e.get("run"))
    serve_by_trace: Dict[str, List[dict]] = {}
    for e in s_results:
        serve_by_trace.setdefault(str(e["trace"]), []).append(e)
    route_by_trace: Dict[str, List[dict]] = {}
    for e in r_results:
        if e.get("trace"):
            route_by_trace.setdefault(str(e["trace"]), []).append(e)

    # trail continuity: a trace the router settled as result must show at
    # least as many backend results across the pod's logs
    dark: List[Dict[str, Any]] = []
    for tr, routed in sorted(route_by_trace.items()):
        served = serve_by_trace.get(tr, [])
        if len(served) < len(routed):
            dark.append({
                "trace": tr,
                "router_requests": sorted(
                    str(e.get("request")) for e in routed),
                "route_results": len(routed),
                "backend_results": len(served),
                "backend_runs": s_admit_runs.get(tr, []),
            })
    # admitted at a backend under a router trace but never settled there:
    # the in-flight-at-SIGKILL population, attributed by trace
    s_settled = {_key(e) for e in events
                 if e.get("event") in ("serve_result", "serve_quarantine")
                 or (e.get("event") == "serve_deadline"
                     and e.get("admitted") is not False)
                 or (e.get("event") == "serve_shed"
                     and e.get("admitted") is True)}
    backend_lost = [
        {"trace": str(e.get("trace")), "request": str(e.get("request")),
         "run": e.get("run")}
        for e in events
        if e.get("event") == "serve_admit" and e.get("trace")
        and _key(e) not in s_settled]

    # failover attribution: every router reroute tied to its trace and
    # the backend runs that saw the request before/after
    failovers = []
    for e in events:
        if e.get("event") == "retry" and e.get("scope") == "router" \
                and e.get("via") == "reroute":
            tr = str(e.get("trace")) if e.get("trace") else None
            failovers.append({
                "request": e.get("unit"), "trace": tr,
                "kind": e.get("kind"), "from_backend": e.get("backend"),
                "backend_runs": (s_admit_runs.get(tr, [])
                                 if tr else []),
                "recovered": bool(tr and route_by_trace.get(tr)),
            })
    hedges = [
        {"request": e.get("request"), "trace": e.get("trace"),
         "shard": e.get("shard"), "panos": e.get("panos")}
        for e in events
        if e.get("event") == "retrieve_hedge" and e.get("trace")]

    # pod overhead: edge wall minus the backend's own wall per request —
    # via the trace join when it is unique, in-band backend_wall_ms else
    overhead: List[float] = []
    joined = 0
    for e in r_results:
        if not isinstance(e.get("wall_ms"), (int, float)):
            continue
        tr = str(e.get("trace")) if e.get("trace") else None
        twins = serve_by_trace.get(tr, []) if tr else []
        if tr and len(twins) == 1 and len(route_by_trace.get(tr, [])) == 1 \
                and isinstance(twins[0].get("wall_ms"), (int, float)):
            overhead.append(float(e["wall_ms"])
                            - float(twins[0]["wall_ms"]))
            joined += 1
        elif isinstance(e.get("backend_wall_ms"), (int, float)):
            overhead.append(float(e["wall_ms"])
                            - float(e["backend_wall_ms"]))

    traced_admits = sum(1 for e in admits if e.get("trace"))
    return {
        "outcomes": {
            "admitted": len(admits),
            "results": len(r_results),
            "deadline_exceeded": len(r_deadlines),
            "quarantined": len(r_quar),
            "shed_admitted": len(r_sheds),
            "terminals": terminals,
            "unresolved": max(0, len(admits) - terminals),
        },
        "lost_requests": lost,
        "traced_admits": traced_admits,
        "traces": {
            "routed": len(route_by_trace),
            "backed": sum(1 for tr in route_by_trace
                          if tr in serve_by_trace),
        },
        "dark_trails": dark,
        "backend_lost": backend_lost,
        "failovers": failovers,
        "hedges": hedges,
        "overhead_ms": _percentiles(overhead),
        "overhead_joined_by_trace": joined,
        "overhead_samples": len(overhead),
    }


def build_retrieval_section(events: List[dict]) -> Dict[str, Any]:
    """The retrieval-tier postmortem (ncnet_tpu_torch/retrieval/): the
    outcome-total identity at the COORDINATOR level (``retrieve_admit ==
    retrieve_result + retrieve_deadline + retrieve_shed``; results split
    into full-coverage and degraded), the coverage distribution with its
    never-silent floor, the hedge rate, per-shard outcome accounting, and
    the shard death/resurrection timeline — all replayed from the log."""
    admits = [e for e in events if e.get("event") == "retrieve_admit"]
    results = [e for e in events if e.get("event") == "retrieve_result"]
    deadlines = [e for e in events
                 if e.get("event") == "retrieve_deadline"]
    sheds = [e for e in events if e.get("event") == "retrieve_shed"]
    hedges = [e for e in events if e.get("event") == "retrieve_hedge"]
    degraded = [e for e in results if e.get("degraded")]
    terminals = len(results) + len(deadlines) + len(sheds)

    def _key(e: dict):
        return (e.get("run"), e.get("request"))

    settled = {_key(e) for e in results + deadlines + sheds}
    lost = [f"{e.get('request')} (run {e.get('run')})" for e in admits
            if _key(e) not in settled]

    covs = [e["coverage"] for e in results
            if isinstance(e.get("coverage"), (int, float))]
    walls = [e["wall_ms"] for e in results
             if isinstance(e.get("wall_ms"), (int, float))]
    hedged_queries = sum(
        1 for e in results if (e.get("hedges") or 0) > 0)

    # per-shard accounting: results/walls from retrieve_shard_result,
    # error kinds from retrieve_shard_error, lifecycle from
    # retrieve_backend, hedges targeted at the shard from retrieve_hedge
    shards: Dict[str, Dict[str, Any]] = {}

    def _sh(sid) -> Dict[str, Any]:
        return shards.setdefault(str(sid), {
            "results": 0, "walls": [], "consulted": 0, "unavailable": 0,
            "errors": {}, "deaths": 0, "resurrections": 0, "draining": 0,
            "hedges": 0,
        })

    for e in events:
        ev, sid = e.get("event"), e.get("shard")
        if sid is None:
            continue
        if ev == "retrieve_shard_result":
            s = _sh(sid)
            s["results"] += 1
            s["consulted"] += e.get("consulted") or 0
            s["unavailable"] += e.get("unavailable") or 0
            if isinstance(e.get("wall_ms"), (int, float)):
                s["walls"].append(e["wall_ms"])
        elif ev == "retrieve_shard_error":
            k = str(e.get("kind", "other"))
            s = _sh(sid)
            s["errors"][k] = s["errors"].get(k, 0) + 1
        elif ev == "retrieve_backend":
            st = e.get("state")
            if st == "DEAD":
                _sh(sid)["deaths"] += 1
            elif st == "READY":
                _sh(sid)["resurrections"] += 1
            elif st == "DRAINING":
                _sh(sid)["draining"] += 1
        elif ev == "retrieve_hedge":
            _sh(sid)["hedges"] += 1
    shard_table = {}
    for sid, s in sorted(shards.items()):
        shard_table[sid] = {
            "results": s["results"],
            "wall_ms": _percentiles(s["walls"]),
            "consulted": s["consulted"],
            "unavailable": s["unavailable"],
            "errors": s["errors"],
            "deaths": s["deaths"],
            "resurrections": s["resurrections"],
            "draining": s["draining"],
            "hedges_absorbed": s["hedges"],
        }

    out: Dict[str, Any] = {
        "outcomes": {
            "admitted": len(admits),
            "results": len(results),
            "results_degraded": len(degraded),
            "deadline_exceeded": len(deadlines),
            "shed": len(sheds),
            "terminals": terminals,
            "unresolved": max(0, len(admits) - terminals),
        },
        "lost_requests": lost,
        "coverage": {
            **_percentiles(covs),
            "min": round(min(covs), 6) if covs else None,
            "below_full": sum(1 for c in covs if c < 1.0),
        },
        "latency_ms": _percentiles(walls),
        "hedging": {
            "hedge_dispatches": len(hedges),
            "hedged_queries": hedged_queries,
            "hedge_rate_pct": round(
                100.0 * hedged_queries / max(1, len(results)), 2),
        },
        "shards": shard_table,
        "timeline": [
            {"t": e.get("t"), "state": e.get("state"),
             "reason": e.get("reason"),
             **({"shard": e["shard"]} if e.get("shard") is not None
                else {})}
            for e in events
            if e.get("event") in ("retrieve_health", "retrieve_backend")
        ],
        "final_health_doc": next(
            (e.get("doc") for e in reversed(events)
             if e.get("event") == "retrieve_health_doc"
             and isinstance(e.get("doc"), dict)), None),
    }
    # the InLoc in-system shortlist's events ride the same section: how
    # often retrieval actually reordered a query vs fell back, and why
    shortlists = [e for e in events
                  if e.get("event") == "retrieval_shortlist"]
    fallbacks = [e for e in events
                 if e.get("event") == "retrieval_fallback"]
    if shortlists or fallbacks:
        reasons: Dict[str, int] = {}
        for e in fallbacks:
            r = str(e.get("reason", "unknown"))
            reasons[r] = reasons.get(r, 0) + 1
        out["inloc_shortlist"] = {
            "reordered": len(shortlists),
            "fallbacks": len(fallbacks),
            "fallback_reasons": reasons,
            "coverage": _percentiles(
                [e["coverage"] for e in shortlists
                 if isinstance(e.get("coverage"), (int, float))]),
        }
    return out


def build_report(paths: List[str],
                 quality_ref: Optional[str] = None) -> Dict[str, Any]:
    """Aggregate one report dict over every given event log."""
    runs: List[Dict[str, Any]] = []
    events: List[dict] = []
    for path in paths:
        header, recs = replay_events(path)
        runs.append({"path": path, "header": header.get("header", {})})
        events.extend(recs)

    steps = [e for e in events if e.get("event") == "step"]
    step_walls = [e["wall_s"] for e in steps if isinstance(
        e.get("wall_s"), (int, float))]
    stage_walls = [e["stage_wall_s"] for e in steps if isinstance(
        e.get("stage_wall_s"), (int, float))]
    mfu = [(e.get("step"), e["mfu_pct"]) for e in steps
           if isinstance(e.get("mfu_pct"), (int, float))]
    pairs_s = [e["pairs_per_s"] for e in steps
               if isinstance(e.get("pairs_per_s"), (int, float))]

    # run/resume lineage: order of first appearance of each run id
    lineage: List[Dict[str, Any]] = []
    seen_runs: Dict[str, int] = {}
    for e in events:
        rid = e.get("run")
        if rid and rid not in seen_runs:
            seen_runs[rid] = len(lineage)
            lineage.append({"run_id": rid, "events": 0})
        if rid:
            lineage[seen_runs[rid]]["events"] += 1
        if e.get("event") == "resume" and rid:
            lineage[seen_runs[rid]]["resumed_from"] = {
                "checkpoint": e.get("checkpoint"),
                "epoch": e.get("epoch"), "batch": e.get("batch"),
                "step": e.get("step"),
            }

    tier_timeline = [
        {k: e.get(k) for k in
         ("t", "event", "tier", "stage", "shape", "demoted") if k in e}
        for e in events if e.get("event") in ("tier_selected", "tier_demoted")
    ]

    retries_by_kind: Dict[str, int] = {}
    for e in events:
        if e.get("event") == "retry":
            k = str(e.get("kind", "other"))
            retries_by_kind[k] = retries_by_kind.get(k, 0) + 1
    quarantines = [
        {"unit": e.get("unit"), "kind": e.get("kind"),
         "attempts": e.get("attempts"), "scope": e.get("scope")}
        for e in events if e.get("event") == "quarantine"
    ]

    checkpoints = [
        {"step": e.get("step"), "epoch": e.get("epoch"),
         "best": e.get("best"), "path": e.get("path")}
        for e in events if e.get("event") == "checkpoint_commit"
    ]
    nan_skips = [e for e in events if e.get("event") == "nan_skip"]
    diverged = [e for e in events if e.get("event") == "diverged"]
    preemptions = [e for e in events if e.get("event") == "preemption"]
    watchdogs = [e for e in events if e.get("event") == "watchdog_timeout"]
    run_ends = [e for e in events if e.get("event") == "run_end"]

    postmortem: Optional[Dict[str, Any]] = None
    if diverged:
        death = diverged[-1]
        tail = [e for e in steps
                if isinstance(e.get("step"), int)
                and e["step"] <= (death.get("step") or 0)][-8:]
        postmortem = {
            "died_at_step": death.get("step"),
            "epoch": death.get("epoch"),
            "streak": death.get("streak"),
            "last_steps": [
                {k: e.get(k) for k in
                 ("step", "loss", "grad_norm", "wall_s") if k in e}
                for e in tail
            ],
        }

    eval_batches = [e for e in events if e.get("event") == "eval_batch"]
    eval_queries = [e for e in events if e.get("event") == "eval_query"]
    eval_summaries = [e for e in events
                      if e.get("event") == "eval_summary"]

    report: Dict[str, Any] = {
        "logs": runs,
        "lineage": lineage,
        "counts": {
            "events": len(events),
            "steps": len(steps),
            "epochs_completed": sum(
                1 for e in events if e.get("event") == "epoch_end"),
            "checkpoint_commits": len(checkpoints),
            "resumes": sum(
                1 for e in events if e.get("event") == "resume"),
            "nan_skips": len(nan_skips),
            "preemptions": len(preemptions),
            "watchdog_timeouts": len(watchdogs),
            "quarantines": len(quarantines),
            "tier_demotions": sum(
                1 for e in events if e.get("event") == "tier_demoted"),
            "run_ends": len(run_ends),
        },
        "step_wall_s": _percentiles(step_walls),
        "stage_wall_s": _percentiles(stage_walls),
        "pairs_per_s": _percentiles(pairs_s),
        "mfu_trajectory": [{"step": s, "mfu_pct": m} for s, m in mfu],
        "tier_timeline": tier_timeline,
        "retries_by_kind": retries_by_kind,
        "quarantines": quarantines,
        "checkpoints": checkpoints,
        "divergence_postmortem": postmortem,
    }
    if any(e.get("event") == "span" for e in events):
        report["spans"] = build_span_breakdown(events)
    if any(str(e.get("event", "")).startswith("serve_") for e in events):
        report["serving"] = build_serving_section(events)
        report["slo"] = build_slo_section(events)
    if any(str(e.get("event", "")).startswith("rollout_") for e in events):
        report["rollout"] = build_rollout_section(events)
    if any(str(e.get("event", "")).startswith("route_") for e in events):
        report["router"] = build_router_section(events)
        report["pod"] = build_pod_section(events)
    if any(str(e.get("event", "")).startswith(("retrieve_", "retrieval_"))
           for e in events):
        report["retrieval"] = build_retrieval_section(events)
    if any(e.get("event") in ("memory_ledger", "memory_leak_suspect",
                              "memory_postmortem", "device_snapshot")
           for e in events):
        report["memory"] = build_memory_section(events)
    if any(str(e.get("event", "")).startswith("store_") for e in events):
        report["store"] = build_store_section(events)
    if any(e.get("event") == "quality" for e in events):
        device_kind = next(
            (r["header"].get("device_kind") for r in runs
             if r["header"].get("device_kind")), None)
        report["quality"] = build_quality_section(
            events, device_kind, ref_path=quality_ref)
    if eval_batches or eval_queries or eval_summaries:
        pcks = [e["pck"] for e in eval_batches
                if isinstance(e.get("pck"), (int, float))]
        report["eval"] = {
            "batches": len(eval_batches),
            "queries": len(eval_queries),
            "queries_ok": sum(1 for e in eval_queries if e.get("ok")),
            "batch_pck": _percentiles(pcks, qs=(50,)),
            "fetch_wall_s": _percentiles(
                [e["fetch_wall_s"] for e in eval_batches
                 if isinstance(e.get("fetch_wall_s"), (int, float))]),
            "summaries": eval_summaries,
        }
    return report


def _fmt_stats(stats: Dict[str, float], unit: str = "s") -> str:
    if not stats:
        return "(no samples)"
    parts = [f"{k}={stats[k]:.4f}{unit}" for k in ("p50", "p90", "p99")
             if k in stats]
    parts.append(f"mean={stats['mean']:.4f}{unit}")
    parts.append(f"n={stats['n']}")
    return "  ".join(parts)


def render_spans(report: Dict[str, Any]) -> str:
    sp = report.get("spans")
    if not sp or not sp["groups"]:
        return "(no span events in the log)"
    lines = ["span breakdown (self-time ranked; parent > name):"]
    width = max(len(f"{g['parent']} > {g['name']}") for g in sp["groups"])
    for g in sp["groups"]:
        label = f"{g['parent']} > {g['name']}"
        err = f"  errors={g['errors']}" if g["errors"] else ""
        lines.append(
            f"  {label:<{width}}  n={g['n']:<6} self={g['self_s']:<10.4f} "
            f"total={g['total_s']:<10.4f} mean={g['mean_s']:.4f}s{err}")
    if sp["unclosed"]:
        lines.append(f"  ({sp['unclosed']} unclosed span(s) — in flight at "
                     "process death)")
    return "\n".join(lines)


def render_quality(report: Dict[str, Any]) -> str:
    q = report.get("quality")
    if not q or not q["table"]:
        return "(no quality events in the log)"
    lines = ["quality signals (per tier):"]
    # a (tier, signal) whose every sample was NaN (all pairs quarantined
    # under that tier) has count 0 and None stats — render, don't crash
    fmt = lambda v: "n/a" if v is None else v  # noqa: E731
    for row in q["table"]:
        lines.append(
            f"  {row['tier']:<12} {row['signal']:<14} n={row['n']:<6} "
            f"mean={fmt(row['mean']):<8} p50={fmt(row['p50']):<8} "
            f"p90={fmt(row['p90'])}")
    rho = q.get("pck_spearman")
    if rho:
        lines.append("signal-vs-PCK rank correlation (Spearman):")
        for name, v in sorted(rho.items()):
            lines.append(f"  {name:<14} rho={'n/a' if v is None else v}")
    drift = q.get("drift")
    if drift is not None:
        lines.append(f"drift vs {q.get('drift_ref')}:")
        for f in drift:
            if f["status"] == "skipped":
                lines.append(f"  [skipped] {f['tier']}/{f['signal']}  "
                             f"({f['reason']})")
            else:
                tag = "DRIFT" if f["status"] == "drift" else "ok"
                lines.append(
                    f"  [{tag}] {f['tier']}/{f['signal']}  "
                    f"psi={f['psi']:.4f} (threshold {f['threshold']})")
    return "\n".join(lines)


def render_serving(report: Dict[str, Any]) -> str:
    sv = report.get("serving")
    if not sv:
        return "(no serving events in the log)"
    lines = ["serving:"]
    o = sv["outcomes"]
    lines.append(
        f"  outcomes: admitted={o['admitted']}  results={o['results']}  "
        f"deadline={o['deadline_exceeded']}  quarantined={o['quarantined']}  "
        f"shed_admitted={o['shed_admitted']}  "
        f"shed_at_admission={o['shed_at_admission']}")
    if o["unresolved"]:
        lines.append(
            f"  UNRESOLVED: {o['unresolved']} admitted request(s) died "
            f"without an outcome (lost mid-drain/crash): "
            f"{', '.join(str(r) for r in sv['lost_requests'][:16])}")
    else:
        lines.append("  outcome-total: every admitted request reached "
                     "exactly one terminal outcome")
    if sv.get("results_by_version"):
        vs = sv["results_by_version"]
        tag = "MIXED-VERSION pod" if len(vs) > 1 else "single version"
        lines.append("  results by model version (" + tag + "): "
                     + ", ".join(f"{k}={v}" for k, v in sorted(vs.items())))
    if sv["latency_ms"]:
        lines.append(f"  latency:  {_fmt_stats(sv['latency_ms'], 'ms')}")
    for b, stats in sv["latency_ms_by_bucket"].items():
        lines.append(f"    {b}: {_fmt_stats(stats, 'ms')}")
    bt = sv["batches"]
    if bt["n"]:
        lines.append(
            f"  batches: n={bt['n']}  mean_size={bt['mean_size']:.2f}  "
            f"wall {_fmt_stats(bt['wall_s'])}")
    if sv["shed_reasons"]:
        lines.append("  shed by reason: " + ", ".join(
            f"{k}={v}" for k, v in sorted(sv["shed_reasons"].items())))
    if sv["deadline_where"]:
        lines.append("  deadlines by checkpoint: " + ", ".join(
            f"{k}={v}" for k, v in sorted(sv["deadline_where"].items())))
    if sv.get("replicas"):
        lines.append("  replicas:")
        for rid, r in sv["replicas"].items():
            chaos = ""
            if r["deaths"] or r["resurrections"]:
                chaos = (f"  deaths={r['deaths']} "
                         f"resurrections={r['resurrections']} "
                         f"probes={r['probes']}")
            lines.append(
                f"    {rid}: batches={r['batches']}  results={r['results']}"
                f"  retries={r['retries']}{chaos}")
            if r["latency_ms"]:
                lines.append(
                    f"      latency {_fmt_stats(r['latency_ms'], 'ms')}")
    if sv["health_timeline"]:
        lines.append("  health timeline:")
        for h in sv["health_timeline"]:
            who = f"[{h['replica']}] " if h.get("replica") else ""
            lines.append(f"    -> {who}{h['state']}"
                         + (f"  ({h['reason']})" if h.get("reason") else ""))
    if sv["queue_depth_trajectory"]:
        depths = [p["queue_depth"] for p in sv["queue_depth_trajectory"]
                  if isinstance(p.get("queue_depth"), (int, float))]
        if depths:
            lines.append(f"  queue depth: first={depths[0]} "
                         f"max={max(depths)} last={depths[-1]} "
                         f"({len(depths)} samples)")
    for d in sv["drains"]:
        lines.append(f"  drain: drained={d.get('drained')} "
                     f"leftover={d.get('leftover')}")
    fh = sv.get("final_health_doc")
    if fh:
        pool = fh.get("pool", {})
        lines.append(
            f"  final health doc (schema {fh.get('schema')}): "
            f"state={fh.get('state')}  pool "
            f"{pool.get('ready')}/{pool.get('total')} ready  "
            f"counters={fh.get('counters')}")
    return "\n".join(lines)


def render_router(report: Dict[str, Any]) -> str:
    rt = report.get("router")
    if not rt:
        return "(no router events in the log)"
    lines = ["router (multi-host tier):"]
    o = rt["outcomes"]
    lines.append(
        f"  outcomes: admitted={o['admitted']}  results={o['results']}  "
        f"deadline={o['deadline_exceeded']}  quarantined={o['quarantined']}"
        f"  shed_admitted={o['shed_admitted']}  "
        f"shed_at_admission={o['shed_at_admission']}")
    if o["unresolved"]:
        lines.append(
            f"  UNRESOLVED: {o['unresolved']} admitted request(s) died "
            f"without an outcome: "
            f"{', '.join(str(r) for r in rt['lost_requests'][:16])}")
    else:
        lines.append("  outcome-total: every admitted request reached "
                     "exactly one terminal outcome")
    if rt["latency_ms"]:
        lines.append(f"  latency:  {_fmt_stats(rt['latency_ms'], 'ms')}")
    if rt["shed_reasons"]:
        lines.append("  shed by reason: " + ", ".join(
            f"{k}={v}" for k, v in sorted(rt["shed_reasons"].items())))
    if rt["deadline_where"]:
        lines.append("  deadlines by checkpoint: " + ", ".join(
            f"{k}={v}" for k, v in sorted(rt["deadline_where"].items())))
    if rt.get("backends"):
        lines.append("  backends:")
        for bid, b in rt["backends"].items():
            chaos = ""
            if b["deaths"] or b["resurrections"] or b["draining"]:
                chaos = (f"  deaths={b['deaths']} "
                         f"resurrections={b['resurrections']} "
                         f"draining={b['draining']} probes={b['probes']}")
            lines.append(
                f"    {bid}: results={b['results']}  retries={b['retries']}"
                f"  backpressure={b['backpressure']}{chaos}")
            if b["latency_ms"]:
                lines.append(
                    f"      edge latency {_fmt_stats(b['latency_ms'], 'ms')}")
            if b["backend_wall_ms"]:
                lines.append(
                    f"      backend wall "
                    f"{_fmt_stats(b['backend_wall_ms'], 'ms')} "
                    "(edge minus this = fan-out overhead)")
    if rt["health_timeline"]:
        lines.append("  health timeline:")
        for h in rt["health_timeline"]:
            who = f"[{h['backend']}] " if h.get("backend") else ""
            lines.append(f"    -> {who}{h['state']}"
                         + (f"  ({h['reason']})" if h.get("reason") else ""))
    for d in rt["drains"]:
        lines.append(f"  drain: drained={d.get('drained')} "
                     f"leftover={d.get('leftover')}")
    fh = rt.get("final_health_doc")
    if fh:
        pod = fh.get("pod", {})
        lines.append(
            f"  final health doc (schema {fh.get('schema')}): "
            f"state={fh.get('state')}  pod "
            f"{pod.get('ready')}/{pod.get('total')} backends ready "
            f"({pod.get('replicas_ready')}/{pod.get('replicas_total')} "
            f"replica units)  counters={fh.get('counters')}")
    return "\n".join(lines)


def render_pod(report: Dict[str, Any]) -> str:
    pod = report.get("pod")
    if not pod:
        return "(no route_* events in the logs — a pod report needs the " \
               "router's log alongside the backend logs)"
    lines = ["pod (trace-joined across all given logs):"]
    o = pod["outcomes"]
    lines.append(
        f"  edge outcomes: admitted={o['admitted']}  "
        f"results={o['results']}  deadline={o['deadline_exceeded']}  "
        f"quarantined={o['quarantined']}  "
        f"shed_admitted={o['shed_admitted']}")
    if o["unresolved"]:
        lines.append(
            f"  EDGE UNRESOLVED: {o['unresolved']} admitted request(s) "
            f"died without an outcome: "
            f"{', '.join(str(r) for r in pod['lost_requests'][:16])}")
    else:
        lines.append("  edge outcome-total: every router-admitted request "
                     "reached exactly one terminal outcome")
    tr = pod["traces"]
    lines.append(
        f"  traces: {pod['traced_admits']}/{o['admitted']} admits traced"
        f"  routed-result traces={tr['routed']}  "
        f"backed-by-backend={tr['backed']}")
    if pod["dark_trails"]:
        lines.append(f"  DARK TRAILS: {len(pod['dark_trails'])} trace(s) "
                     "the router settled as result without a matching "
                     "backend serve_result in ANY log:")
        for d in pod["dark_trails"][:16]:
            lines.append(
                f"    {d['trace'][:16]}…  router req(s) "
                f"{','.join(d['router_requests'])}  "
                f"route_results={d['route_results']} "
                f"backend_results={d['backend_results']}")
    else:
        lines.append("  trail continuity: every routed result is backed "
                     "by a same-trace backend result")
    if pod["backend_lost"]:
        lines.append(f"  backend in-flight at death: "
                     f"{len(pod['backend_lost'])} traced admit(s) never "
                     "settled on their backend:")
        for b in pod["backend_lost"][:16]:
            lines.append(f"    {b['trace'][:16]}…  {b['request']} "
                         f"(run {b['run']})")
    if pod["failovers"]:
        lines.append(f"  failovers: {len(pod['failovers'])} router "
                     "re-route(s), each attributed to its trace:")
        for f in pod["failovers"][:16]:
            t = (f["trace"][:16] + "…") if f.get("trace") else "(untraced)"
            runs = ",".join(str(r) for r in f.get("backend_runs", []))
            lines.append(
                f"    {f['request']}  {t}  kind={f['kind']} "
                f"from={f['from_backend']}  backend runs [{runs}]  "
                + ("recovered" if f.get("recovered") else "NOT recovered"))
    if pod["hedges"]:
        lines.append(f"  hedged shard dispatches: {len(pod['hedges'])} "
                     "(trace-attributed)")
    if pod["overhead_ms"]:
        lines.append(
            f"  wire+routing overhead (edge wall − backend wall): "
            f"{_fmt_stats(pod['overhead_ms'], 'ms')}  "
            f"[{pod['overhead_joined_by_trace']}/"
            f"{pod['overhead_samples']} joined by trace]")
    return "\n".join(lines)


def _fmt_bytes(v) -> str:
    if not isinstance(v, (int, float)):
        return "-"
    if abs(v) >= 2 ** 20:
        return f"{v / 2 ** 20:.1f}MiB"
    if abs(v) >= 2 ** 10:
        return f"{v / 2 ** 10:.1f}KiB"
    return f"{int(v)}B"


def render_memory(report: Dict[str, Any]) -> str:
    m = report.get("memory")
    if not m:
        return "(no memory events in the log)"
    lines = ["memory (observability/memory.py, replayed from the log):"]
    add = lines.append
    if m["ledger"]:
        add(f"  compiled-program ledger ({len(m['ledger'])} program(s); "
            f"{m['ledger_events']} event(s), "
            f"{m['ledger_cached_events']} cache-replayed):")
        width = max(len(str(r["program"])) for r in m["ledger"])
        for r in m["ledger"]:
            add(f"    {str(r['program']):<{width}}  "
                f"args={_fmt_bytes(r['argument_bytes']):>9} "
                f"out={_fmt_bytes(r['output_bytes']):>9} "
                f"temp={_fmt_bytes(r['temp_bytes']):>9} "
                f"total={_fmt_bytes(r['total_bytes']):>9}  "
                f"tier={r['tier']}  [{r['shape_class']}] "
                f"({r['device_kind']})")
    else:
        add("  compiled-program ledger: (no memory_ledger events)")
    traj = m["hbm_trajectory"]
    if traj:
        in_use = [p["bytes_in_use"] for p in traj
                  if isinstance(p.get("bytes_in_use"), (int, float))]
        peaks = [p["peak_bytes_in_use"] for p in traj
                 if isinstance(p.get("peak_bytes_in_use"), (int, float))]
        limit = next((p["bytes_limit"] for p in traj
                      if p.get("bytes_limit")), None)
        add(f"  HBM trajectory ({len(traj)} snapshot(s)): "
            f"first={_fmt_bytes(in_use[0]) if in_use else '-'} "
            f"max={_fmt_bytes(max(in_use)) if in_use else '-'} "
            f"last={_fmt_bytes(in_use[-1]) if in_use else '-'} "
            f"peak={_fmt_bytes(max(peaks)) if peaks else '-'}"
            + (f" limit={_fmt_bytes(limit)}" if limit else ""))
    else:
        add("  HBM trajectory: (no device_snapshot memory stats — CPU "
            "backend, or the monitor never fired)")
    if m["leak_suspects"]:
        add(f"  LEAK SUSPECTS ({len(m['leak_suspects'])} event(s)):")
        for e in m["leak_suspects"]:
            for s in (e.get("suspects") or [])[:8]:
                add(f"    [{e.get('scope')}] {s['shape_class']}: "
                    f"n {s['n_first']} -> {s['n_last']}, "
                    f"+{_fmt_bytes(s['growth_bytes'])} over "
                    f"window {e.get('window')}")
    else:
        add("  leak sentinel: no suspects (green)")
    if m["postmortems"]:
        add(f"  OOM POSTMORTEMS ({len(m['postmortems'])}):")
        for p in m["postmortems"]:
            add(f"    [{p.get('scope')}] program={p.get('program')} "
                + (f"replica={p['replica']} " if p.get("replica") else "")
                + f"error={str(p.get('error'))[:120]}")
            for r in (p.get("ledger") or [])[:4]:
                add(f"      ledger: {r.get('program')} "
                    f"[{r.get('shape_class')}] "
                    f"temp={_fmt_bytes(r.get('temp_bytes'))} "
                    f"total={_fmt_bytes(r.get('total_bytes'))}")
            census = p.get("census")
            if census:
                add(f"      live arrays at death: {census.get('n')} "
                    f"({_fmt_bytes(census.get('bytes'))} across "
                    f"{census.get('classes')} shape class(es))")
            for d in (p.get("snapshot") or [])[:4]:
                if isinstance(d, dict) and d.get("bytes_in_use") is not None:
                    add(f"      device {d.get('id')}: in_use="
                        f"{_fmt_bytes(d['bytes_in_use'])} peak="
                        f"{_fmt_bytes(d.get('peak_bytes_in_use'))} limit="
                        f"{_fmt_bytes(d.get('bytes_limit'))}")
    else:
        add("  OOM postmortems: none")
    return "\n".join(lines)


def render_store(report: Dict[str, Any]) -> str:
    s = report.get("store")
    if not s:
        return "(no store events in the log)"
    lines = ["feature store (ncnet_tpu/store/, replayed from the log):"]
    add = lines.append
    for o in s["opens"]:
        add(f"  open [{o.get('scope')}]: {o.get('entries')} entr(ies), "
            f"{_fmt_bytes(o.get('bytes'))} under {o.get('fingerprint')}"
            + (f", budget {_fmt_bytes(o['budget_bytes'])}"
               if o.get("budget_bytes") else "")
            + f"  ({o.get('state')})")
    for scope, st in sorted(s["final_stats"].items()):
        c = st.get("counters") or {}
        hp = st.get("hit_pct")
        add(f"  final [{scope}]: {st.get('state')}"
            + (f" ({st.get('reason')})" if st.get("reason") else "")
            + f"  hits={c.get('hits', 0)} misses={c.get('misses', 0)}"
            + (f" ({hp:.1f}% hit)" if isinstance(hp, (int, float)) else "")
            + f"  corrupt={c.get('corrupt', 0)} "
            f"evictions={c.get('evictions', 0)} "
            f"degraded_ops={c.get('degraded_ops', 0)}  "
            f"entries={st.get('entries')} "
            f"bytes={_fmt_bytes(st.get('bytes'))}")
    if s["health_timeline"]:
        add(f"  health timeline ({s['degraded_spells']} degraded "
            f"spell(s), {s['recovered']} recover(ies)):")
        for e in s["health_timeline"]:
            add(f"    -> {e.get('state')} [{e.get('scope')}]"
                + (f"  ({e.get('reason')})" if e.get("reason") else ""))
    else:
        add("  health timeline: never degraded (green)")
    if s["corrupt_quarantined"]:
        add(f"  CORRUPT entries quarantined "
            f"({len(s['corrupt_quarantined'])}):")
        for e in s["corrupt_quarantined"]:
            add(f"    {e.get('digest')}  ({e.get('reason')}) -> "
                f"{e.get('quarantined_to')}")
    else:
        add("  corruption: none detected")
    if s["evictions"]:
        add(f"  evictions: {s['evictions']} "
            f"({_fmt_bytes(s['evicted_bytes'])} reclaimed)")
    for g in s["gc_sweeps"]:
        add(f"  GC [{g.get('scope')}]: removed {g.get('entries')} "
            f"entr(ies) of superseded generation(s) {g.get('fingerprints')}")
    return "\n".join(lines)


def render_retrieval(report: Dict[str, Any]) -> str:
    r = report.get("retrieval")
    if not r:
        return "(no retrieval events in the log)"
    lines = ["retrieval tier (replayed from the event log):"]
    o = r["outcomes"]
    ident = "HOLDS" if o["unresolved"] == 0 and not r["lost_requests"] \
        else "VIOLATED"
    lines.append(
        f"  outcomes: admitted={o['admitted']}  results={o['results']} "
        f"(degraded={o['results_degraded']})  "
        f"deadline={o['deadline_exceeded']}  shed={o['shed']}  "
        f"unresolved={o['unresolved']}  [identity {ident}]")
    if r["lost_requests"]:
        lines.append("  LOST requests (admitted, no terminal outcome): "
                     + ", ".join(r["lost_requests"][:10]))
    cov = r["coverage"]
    if cov.get("n"):
        lines.append(
            f"  coverage: p50={cov.get('p50')} p90={cov.get('p90')} "
            f"min={cov.get('min')}  below-full={cov['below_full']} "
            f"of {cov['n']} (degraded or shed, never silent)")
    if r["latency_ms"]:
        lines.append("  sweep wall: "
                     + _fmt_stats(r["latency_ms"], "ms"))
    h = r["hedging"]
    lines.append(
        f"  hedging: {h['hedge_dispatches']} dispatch(es) over "
        f"{h['hedged_queries']} query(ies) "
        f"({h['hedge_rate_pct']}% of results)")
    if r["shards"]:
        lines.append("  per-shard:")
        for sid, s in r["shards"].items():
            err = (" errors=" + ",".join(
                f"{k}:{v}" for k, v in sorted(s["errors"].items()))
                if s["errors"] else "")
            lines.append(
                f"    {sid}: results={s['results']} "
                f"consulted={s['consulted']} "
                f"unavailable={s['unavailable']} deaths={s['deaths']} "
                f"resurrections={s['resurrections']} "
                f"hedges_absorbed={s['hedges_absorbed']}{err}")
    deaths = [t for t in r["timeline"] if t.get("state") == "DEAD"]
    if deaths or any(t.get("state") == "READY" and t.get("shard")
                     for t in r["timeline"]):
        lines.append("  shard lifecycle timeline:")
        for t in r["timeline"]:
            if t.get("shard") is None:
                continue
            lines.append(f"    t={t.get('t')}: {t['shard']} -> "
                         f"{t.get('state')} ({t.get('reason')})")
    il = r.get("inloc_shortlist")
    if il:
        lines.append(
            f"  inloc shortlist: reordered={il['reordered']} "
            f"fallbacks={il['fallbacks']} "
            f"reasons={il['fallback_reasons']}")
    fin = r.get("final_health_doc")
    if fin:
        pod = fin.get("pod", {})
        lines.append(
            f"  final health: {fin.get('state')} "
            f"(shards {pod.get('ready')}/{pod.get('total')})")
    return "\n".join(lines)


def render_rollout(report: Dict[str, Any]) -> str:
    r = report.get("rollout")
    if not r:
        return "(no rollout events in the log)"
    lines = ["rollout (serving/rollout.py, replayed from the event log):"]
    add = lines.append
    if r["phases"]:
        add("  phase timeline:")
        for p in r["phases"]:
            vers = ""
            if p.get("old_version") or p.get("new_version"):
                vers = (f"  [{p.get('old_version')} -> "
                        f"{p.get('new_version')}]")
            add(f"    -> {p.get('phase')}{vers}"
                + (f"  ({p.get('reason')})" if p.get("reason") else ""))
        term = r.get("terminal_phase") or "(none — log ends mid-rollout)"
        add(f"  terminal phase: {term}")
    for f in r["refusals"]:
        add(f"  REFUSED {f.get('candidate')}: {f.get('reason')}"
            + (f"  ({str(f.get('error'))[:120]})" if f.get("error")
               else ""))
    if r["swaps"]:
        add(f"  weight swaps ({len(r['swaps'])}, "
            f"{r['swaps_failed']} failed):")
        for s in r["swaps"]:
            ok = "ok" if s.get("ok") else f"FAILED ({s.get('error')})"
            add(f"    {s.get('replica')} -> {s.get('version')}  "
                f"warmed={s.get('warmed')}  {ok}")
    for v in r["canary_verdicts"]:
        breach = v.get("breach")
        tag = f"BREACH {breach}" if breach else "pass"
        add(f"  canary verdict [{tag}]: {v.get('old_version')} vs "
            f"{v.get('new_version')}  results={v.get('results')}")
        psi = v.get("psi") or {}
        if psi:
            add("    psi: " + ", ".join(
                f"{k}={psi[k]:.4f}" if isinstance(psi[k], (int, float))
                else f"{k}={psi[k]}" for k in sorted(psi))
                + f"  (threshold {v.get('psi_threshold')})")
        if v.get("error_rate"):
            add(f"    error rate: {v['error_rate']}")
        if v.get("latency_ewma_ms"):
            add(f"    latency EWMA (ms): {v['latency_ewma_ms']}")
    for rb in r["rollbacks"]:
        stuck = rb.get("stuck_replicas") or []
        add(f"  ROLLED BACK ({rb.get('reason')}): restored "
            f"{rb.get('old_version')}"
            + (f"  [stuck replicas: {', '.join(map(str, stuck))}]"
               if stuck else ""))
    if r["versions"]:
        add("  per-version accounting (from version-tagged serve "
            "results):")
        for vid, v in r["versions"].items():
            add(f"    {vid}: results={v['results']}  "
                f"failures={v['failures']}"
                + (f"  latency {_fmt_stats(v['latency_ms'], 'ms')}"
                   if v["latency_ms"] else ""))
    if r["replica_drains"]:
        add(f"  replica drains: {len(r['replica_drains'])} "
            "(one at a time is the capacity invariant)")
        for d in r["replica_drains"]:
            add(f"    {d.get('replica')}  ({d.get('reason')})")
    return "\n".join(lines)


def render_slo(report: Dict[str, Any]) -> str:
    s = report.get("slo")
    if not s or not s["admitted"]:
        return "(no admitted serving outcomes in the log)"
    lines = ["SLO / error budget (replayed from the event log):"]
    cfg = s.get("objectives") or {}
    obj = cfg.get("default_ms")
    lines.append(
        f"  objective: {obj if obj is not None else 'none'} ms default"
        + (f", per-bucket {cfg['by_bucket']}" if cfg.get("by_bucket")
           else "")
        + f"; budget {cfg.get('budget_pct', 1.0)}% bad")
    b = s["bad"]
    lines.append(
        f"  outcomes: admitted={s['admitted']}  ok={s['ok']}  "
        f"bad={s['bad_total']} (latency={b['latency']} "
        f"deadline={b['deadline']} quarantined={b['quarantined']} "
        f"shed={b['shed']})")
    lines.append(f"  budget burn: {s['budget_burn_pct']}% "
                 "(100 = budget exactly spent)")
    if "matches_final_event" in s:
        tag = "consistent" if s["matches_final_event"] else "MISMATCH"
        lines.append(
            f"  scrape-vs-replay: {tag} with the service's final slo "
            f"event ({s['slo_events']} slo event(s) in the log)")
        if not s["matches_final_event"]:
            lines.append(f"    final event: {s['final_event']}")
    return "\n".join(lines)


def render_text(report: Dict[str, Any]) -> str:
    lines: List[str] = []
    add = lines.append
    add("=== ncnet_tpu run report ===")
    for lg in report["logs"]:
        h = lg["header"]
        add(f"log: {lg['path']}  (schema {h.get('schema')}, host "
            f"{h.get('host')}, device {h.get('device_kind', 'n/a')})")
    add("")
    add("run lineage:")
    for r in report["lineage"]:
        line = f"  {r['run_id']}  events={r['events']}"
        if "resumed_from" in r:
            rf = r["resumed_from"]
            line += (f"  resumed from step {rf.get('step')} "
                     f"(epoch {rf.get('epoch')}, batch {rf.get('batch')})")
        add(line)
    add("")
    c = report["counts"]
    add(f"steps={c['steps']}  epochs={c['epochs_completed']}  "
        f"checkpoints={c['checkpoint_commits']}  resumes={c['resumes']}")
    add(f"nan_skips={c['nan_skips']}  preemptions={c['preemptions']}  "
        f"quarantines={c['quarantines']}  "
        f"tier_demotions={c['tier_demotions']}  "
        f"watchdog_timeouts={c['watchdog_timeouts']}")
    add("")
    add(f"step wall:   {_fmt_stats(report['step_wall_s'])}")
    add(f"stage wall:  {_fmt_stats(report['stage_wall_s'])}")
    add(f"throughput:  {_fmt_stats(report['pairs_per_s'], ' pairs/s')}")
    traj = report["mfu_trajectory"]
    if traj:
        first, last = traj[0], traj[-1]
        peak = max(traj, key=lambda e: e["mfu_pct"])
        add(f"MFU: first {first['mfu_pct']:.2f}% @ step {first['step']}, "
            f"peak {peak['mfu_pct']:.2f}% @ step {peak['step']}, "
            f"last {last['mfu_pct']:.2f}% @ step {last['step']}")
    if report["tier_timeline"]:
        add("")
        add("tier timeline:")
        for e in report["tier_timeline"]:
            if e["event"] == "tier_demoted":
                add(f"  DEMOTED {e.get('tier')}  "
                    f"(now disabled: {e.get('demoted')})")
            else:
                add(f"  selected {e.get('tier')} for {e.get('stage')} "
                    f"shape {e.get('shape')}")
    if report["retries_by_kind"]:
        add("")
        add("retries by kind: " + ", ".join(
            f"{k}={v}" for k, v in sorted(report["retries_by_kind"].items())))
    if report["quarantines"]:
        add("")
        add("quarantined units:")
        for qn in report["quarantines"]:
            add(f"  {qn['unit']}  kind={qn['kind']} "
                f"attempts={qn.get('attempts')}")
    pm = report["divergence_postmortem"]
    if pm:
        add("")
        add(f"DIVERGED at step {pm['died_at_step']} (epoch {pm['epoch']}, "
            f"streak {pm['streak']}); last steps:")
        for e in pm["last_steps"]:
            add(f"  step {e.get('step')}: loss={e.get('loss')} "
                f"grad_norm={e.get('grad_norm')}")
    ev = report.get("eval")
    if ev:
        add("")
        add(f"eval: batches={ev['batches']} queries={ev['queries']} "
            f"(ok={ev['queries_ok']})")
        if ev["batch_pck"]:
            add(f"  batch PCK: {_fmt_stats(ev['batch_pck'], '')}")
        for s in ev["summaries"]:
            m = s.get("metrics", {})
            add("  summary: " + json.dumps(
                {k: m[k] for k in sorted(m) if not isinstance(m[k], dict)}))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Replay ncnet_tpu event logs into a run report")
    ap.add_argument("logs", nargs="+", help="events.jsonl file(s)")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as one JSON document")
    ap.add_argument("--spans", action="store_true",
                    help="append the span critical-path breakdown "
                         "(self-time vs child-time per phase)")
    ap.add_argument("--quality", action="store_true",
                    help="append the match-quality section: per-tier "
                         "signal table, drift verdicts vs the committed "
                         "reference, signal-vs-PCK rank correlation")
    ap.add_argument("--quality-ref", default=None,
                    help="reference distributions for the drift verdicts "
                         "(default: perf/quality_ref.jsonl)")
    ap.add_argument("--serving", action="store_true",
                    help="append the serving section: request-outcome "
                         "accounting (the outcome-total invariant), "
                         "per-bucket latency, queue-depth trajectory, "
                         "health-state timeline — plus the router section "
                         "(backend-tagged accounting, the outcome-total "
                         "identity recomputed at the router level) when "
                         "the log holds route_* events")
    ap.add_argument("--rollout", action="store_true",
                    help="append the rollout section: phase timeline, "
                         "per-replica weight swaps, canary verdicts (PSI/"
                         "error-rate/latency), rollbacks, refusals, and "
                         "per-model-version request accounting replayed "
                         "from rollout_* and version-tagged serve events")
    ap.add_argument("--memory", action="store_true",
                    help="append the memory section: the compiled-program "
                         "ledger table, the HBM trajectory, leak-sentinel "
                         "verdicts, and OOM postmortems — all replayed "
                         "from the event log alone")
    ap.add_argument("--slo", action="store_true",
                    help="append the SLO section: error-budget counters "
                         "recomputed from the log (objectives from "
                         "serve_start), burn %%, and the consistency "
                         "verdict against the service's final slo event")
    ap.add_argument("--retrieval", action="store_true",
                    help="append the retrieval-tier section: the "
                         "coordinator outcome-total identity, the coverage "
                         "distribution, hedge rate, per-shard outcome "
                         "accounting, and the shard death/resurrection "
                         "timeline replayed from retrieve_* events")
    ap.add_argument("--pod", action="store_true",
                    help="append the pod section: the outcome-total "
                         "identity recomputed ACROSS all given logs at "
                         "once, trace-joined — edge totality, router-to-"
                         "backend trail continuity (dark trails named), "
                         "failover/hedge attribution by trace, and the "
                         "edge-minus-backend wall = wire+routing overhead")
    ap.add_argument("--store", action="store_true",
                    help="append the feature-store section: hit/miss/"
                         "corrupt/evict counters, the DEGRADED->recovered "
                         "health timeline, quarantined entries, and GC "
                         "sweeps replayed from the event log")
    args = ap.parse_args(argv)
    quality_ref = None
    if args.quality or args.quality_ref:
        from ncnet_tpu_torch.observability.quality import default_reference_path

        quality_ref = args.quality_ref or default_reference_path()
    report = build_report(args.logs, quality_ref=quality_ref)
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        print(render_text(report))
        if args.spans:
            print()
            print(render_spans(report))
        if args.quality:
            print()
            print(render_quality(report))
        if args.serving:
            print()
            print(render_serving(report))
            if report.get("router"):
                print()
                print(render_router(report))
        if args.rollout:
            print()
            print(render_rollout(report))
        if args.memory:
            print()
            print(render_memory(report))
        if args.pod:
            print()
            print(render_pod(report))
        if args.retrieval:
            print()
            print(render_retrieval(report))
        if args.slo:
            print()
            print(render_slo(report))
        if args.store:
            print()
            print(render_store(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
