"""Live introspection plane for the resident match service, the port of
``ncnet_tpu/serving/introspect.py`` (host code: the same endpoints, family
names and documents as the JAX package's).

The other observability layers are write-then-replay: the event log, the
perf store, ``run_report`` all explain a run *after* the fact.  A
resident service fronting real traffic needs the READ side live — a
supervisor probes readiness, a router reads per-host capacity, an operator
watches queue depth NOW, not at the postmortem.  This module is that
surface: a stdlib ``http.server`` thread bolted onto a running
:class:`~ncnet_tpu_torch.serving.service.MatchService`, serving three endpoints:

  * ``GET /metrics``  — Prometheus exposition (``observability/export.py``)
    of the serving plane: queue depth, per-bucket and per-replica latency
    histograms (cumulative ``_bucket``/``_sum``/``_count``), the
    outcome-total counters, replica health scores, quality-signal digests,
    and the SLO error-budget counters.  Metric names follow the
    ``ncnet_serve_*`` scheme (README "Live observability"); bucket/replica
    identities ride as labels, never name fragments.
  * ``GET /healthz``  — the unified, schema-versioned health document
    (``serving/health.py::build_health_document``) as JSON: HTTP 200 while
    the service admits (STARTING/READY/DEGRADED), 503 once it drains or
    stops.  This is the exact dict the future multi-host fan-out router
    consumes to route on per-host health/capacity/latency.
  * ``GET /statusz``  — the human page: replica table, bucket ladder,
    queue/active-request counts, SLO burn, recent health timeline.
  * ``POST /match``   — the wire DATA plane (``serving/wire.py``): one
    framed uint8 pair in, the classified terminal outcome (match+quality
    table, or overloaded/deadline/quarantined) out, with the edge's
    deadline budget and client identity propagated into this service's
    admission control.  This is the endpoint the multi-host
    ``serving/router.py::MatchRouter`` fans out to.

Fail-open like every telemetry layer: the server runs on daemon threads, a
handler exception answers 500 instead of propagating, ``start()`` failures
are the caller's to swallow (``MatchService.start`` logs and serves
without the plane), and killing this thread mid-scrape leaves serving
untouched — proven by the kill-mid-scrape test.  The endpoints only
READ service state under its condition lock (an RLock, so the nested
``health()`` call is safe) and never mutate scheduling state.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

from ncnet_tpu_torch.observability.export import Family, render
from ncnet_tpu_torch.observability.metrics import Counter, Histogram

# registry-key prefixes whose identity suffix becomes a label (the curated
# families below); everything else in the registry is either mirrored by a
# curated family or internal
_BUCKET_HIST_PREFIX = "serve_wall_ms_"
_REPLICA_HIST_PREFIX = "replica_wall_ms_"
_QUALITY_HIST_PREFIX = "q_"
_VERSION_HIST_PREFIX = "version_wall_ms_"


def metrics_families(service) -> List[Family]:
    """The curated ``ncnet_serve_*`` family set for one service, built
    under the service lock so counters/histograms and the health document
    are one consistent cut."""
    lat = Family("ncnet_serve_latency_ms", "histogram",
                 "end-to-end request latency per shape bucket")
    rep_hist = Family("ncnet_serve_replica_batch_wall_ms", "histogram",
                      "batch wall per replica")
    quality = Family("ncnet_serve_quality", "histogram",
                     "per-pair match-quality signal digests "
                     "(observability/quality.py)")
    ver_lat = Family("ncnet_serve_version_latency_ms", "histogram",
                     "end-to-end request latency per model version "
                     "(live rollout: canary vs baseline)")
    with service._cond:
        doc = service.health()
        reg_items = dict(service._registry._metrics)
        replica_counters = [
            (name, m.value) for name, m in sorted(reg_items.items())
            if isinstance(m, Counter) and name.startswith("replica_")
        ]
        version_counters = [
            (name, m.value) for name, m in sorted(reg_items.items())
            if isinstance(m, Counter) and name.startswith("version_")
        ]
        stream_cuts = next(
            (m.value for name, m in reg_items.items()
             if name == "stream_cuts" and isinstance(m, Counter)), 0)
        stream_tier = (
            "tracked"
            if getattr(service, "_tracking_capable", False)
            and getattr(getattr(service, "cfg", None),
                        "stream_tracking", False)
            else "full")
        # histogram families render INSIDE the lock: counts and sum must
        # be one cut, or a fetcher landing mid-scrape could put a value in
        # _sum that _count does not yet count — exactly the consistency
        # the scrape tests pin
        for name, h in sorted(reg_items.items()):
            if not isinstance(h, Histogram) or not h.count:
                continue
            if name.startswith(_BUCKET_HIST_PREFIX):
                lat.add_histogram(h, bucket=name[len(_BUCKET_HIST_PREFIX):])
            elif name.startswith(_REPLICA_HIST_PREFIX):
                rep_hist.add_histogram(
                    h, replica=name[len(_REPLICA_HIST_PREFIX):])
            elif name.startswith(_QUALITY_HIST_PREFIX):
                quality.add_histogram(
                    h, signal=name[len(_QUALITY_HIST_PREFIX):])
            elif name.startswith(_VERSION_HIST_PREFIX):
                ver_lat.add_histogram(
                    h, model_version=name[len(_VERSION_HIST_PREFIX):])
    fams: List[Family] = []

    up = Family("ncnet_serve_up", "gauge",
                "1 while the service admits (STARTING/READY/DEGRADED)")
    up.add(1 if doc["state"] in ("STARTING", "READY", "DEGRADED") else 0)
    fams.append(up)
    state = Family("ncnet_serve_state", "gauge",
                   "service health state (1 on the active state's series)")
    state.add(1, state=doc["state"])
    fams.append(state)

    outcomes = Family(
        "ncnet_serve_requests_total", "counter",
        "terminal outcomes of admitted requests (the outcome-total "
        "contract), plus admissions under outcome=\"admitted\"")
    for outcome, n in sorted(doc["counters"].items()):
        outcomes.add(n, outcome=outcome)
    fams.append(outcomes)

    q = doc["queue"]
    fams.append(Family("ncnet_serve_queue_depth", "gauge",
                       "requests queued across shape buckets")
                .add(q["depth"]))
    fams.append(Family("ncnet_serve_effective_max_queue", "gauge",
                       "the elastic queue bound at live capacity")
                .add(q["effective_max_queue"]))
    fams.append(Family("ncnet_serve_inflight_batches", "gauge",
                       "dispatched batches not yet fetched")
                .add(q["inflight_batches"]))
    fams.append(Family("ncnet_serve_pipeline_depth", "gauge",
                       "per-replica in-flight depth target")
                .add(q["pipeline_depth"]))

    pool = doc["pool"]
    fams.append(Family("ncnet_serve_replicas", "gauge",
                       "pool capacity by readiness")
                .add(pool["ready"], status="ready")
                .add(pool["total"], status="total"))
    rep_up = Family("ncnet_serve_replica_up", "gauge",
                    "1 = replica READY, 0 = DEAD awaiting resurrection")
    rep_score = Family("ncnet_serve_replica_health_score", "gauge",
                       "routing cost (lower = preferred)")
    rep_wall = Family("ncnet_serve_replica_wall_ewma_ms", "gauge",
                      "batch-wall EWMA per replica")
    rep_load = Family("ncnet_serve_replica_load", "gauge",
                      "batches owned (queued for fetch + fetching)")
    for r in pool["replicas"]:
        rep_up.add(1 if r["state"] == "READY" else 0, replica=r["id"])
        rep_score.add(r["score"], replica=r["id"])
        if r.get("ewma_wall_ms") is not None:
            rep_wall.add(r["ewma_wall_ms"], replica=r["id"])
        rep_load.add(r["load"], replica=r["id"])
    fams.extend([rep_up, rep_score, rep_wall, rep_load])

    rep_batches = Family("ncnet_serve_replica_batches_total", "counter",
                         "batches completed per replica")
    rep_failures = Family("ncnet_serve_replica_failures_total", "counter",
                          "batch failures per replica")
    for name, value in replica_counters:
        if name.startswith("replica_batches_"):
            rep_batches.add(value,
                            replica=name[len("replica_batches_"):])
        elif name.startswith("replica_failures_"):
            rep_failures.add(value,
                             replica=name[len("replica_failures_"):])
    fams.extend([rep_batches, rep_failures])

    fams.extend([lat, rep_hist, quality])

    # live-rollout version families (serving/rollout.py): the pod's
    # converged identity as an info-style gauge, plus per-version terminal
    # counts and latency digests — the canary judge's evidence, scrapable
    if doc.get("model_version"):
        fams.append(Family(
            "ncnet_serve_model_version", "gauge",
            "1 on the pod's converged model version's series")
            .add(1, model_version=doc["model_version"]))
    ver_req = Family(
        "ncnet_serve_version_requests_total", "counter",
        "terminal outcomes per model version (live rollout)")
    for name, value in version_counters:
        if name.startswith("version_results_"):
            ver_req.add(value, outcome="result",
                        model_version=name[len("version_results_"):])
        elif name.startswith("version_failures_"):
            ver_req.add(value, outcome="failure",
                        model_version=name[len("version_failures_"):])
    if ver_req.samples:
        fams.append(ver_req)
    if ver_lat.samples:
        fams.append(ver_lat)

    slo = doc.get("slo")
    if slo is not None:
        slo_fam = Family(
            "ncnet_serve_slo_requests_total", "counter",
            "SLO classification of admitted terminal outcomes")
        slo_fam.add(slo["ok"], slo_class="ok")
        for cls, n in sorted(slo["bad"].items()):
            slo_fam.add(n, slo_class=cls)
        fams.append(slo_fam)
        fams.append(Family("ncnet_serve_slo_admitted_total", "counter",
                           "admitted requests judged against the SLO")
                    .add(slo["admitted"]))
        fams.append(Family(
            "ncnet_serve_slo_budget_burn_pct", "gauge",
            "cumulative error-budget burn (100 = budget spent)")
            .add(slo["budget_burn_pct"]))
        fams.append(Family(
            "ncnet_serve_slo_window_burn_pct", "gauge",
            "error-budget burn over the sliding window")
            .add(slo["window"]["burn_pct"]))
        obj = Family("ncnet_serve_slo_objective_ms", "gauge",
                     "latency objective per bucket (default under "
                     "bucket=\"default\")")
        if slo["objectives"]["default_ms"] is not None:
            obj.add(slo["objectives"]["default_ms"], bucket="default")
        for b, ms in sorted(slo["objectives"]["by_bucket"].items()):
            obj.add(ms, bucket=b)
        fams.append(obj)

    act = doc.get("activity")
    if act is not None:
        fams.append(Family("ncnet_serve_activity_age_seconds", "gauge",
                           "seconds since the pool last dispatched or "
                           "deliberately idled").add(act["age_s"]))
        fams.append(Family("ncnet_serve_batches_dispatched_total",
                           "counter", "batches dispatched pool-wide")
                    .add(act["batches"]))

    # memory observability (observability/memory.py): the warmed ladder's
    # PREDICTED footprint from the program ledger, and the live
    # per-replica card-memory watermarks sampled at every dispatched batch
    # (the JAX family names are kept: ``hbm``).  A CPU replica simply has
    # no hbm_bytes series — the predicted gauge still renders from the
    # ledger alone.
    mem = doc.get("memory")
    if mem is not None:
        if mem.get("predicted_ladder_bytes") is not None:
            fams.append(Family(
                "ncnet_serve_hbm_predicted_ladder_bytes", "gauge",
                "predicted aggregate footprint of the warmed bucket "
                "ladder (sum of ledger temp+output bytes)")
                .add(mem["predicted_ladder_bytes"]))
        if mem.get("headroom_bytes") is not None:
            fams.append(Family(
                "ncnet_serve_hbm_headroom_bytes", "gauge",
                "bytes_limit minus the predicted ladder footprint "
                "(negative = the ladder cannot all be resident)")
                .add(mem["headroom_bytes"]))
        hbm_bytes = Family("ncnet_serve_hbm_bytes", "gauge",
                           "per-replica card-memory watermarks")
        hbm_fill = Family("ncnet_serve_hbm_fill_pct", "gauge",
                          "bytes_in_use / bytes_limit per replica")
        for rid, s in sorted((mem.get("hbm") or {}).items()):
            for stat in ("bytes_in_use", "peak_bytes_in_use",
                         "bytes_limit", "bytes_reserved",
                         "largest_free_block_bytes"):
                if s.get(stat) is not None:
                    hbm_bytes.add(s[stat], replica=rid, stat=stat)
            if s.get("fill_pct") is not None:
                hbm_fill.add(s["fill_pct"], replica=rid)
        if hbm_bytes.samples:
            fams.append(hbm_bytes)
        if hbm_fill.samples:
            fams.append(hbm_fill)

    # persistent feature store (ncnet_tpu_torch/store/): the ncnet_store_*
    # families — OK/DEGRADED, the hit/miss/corrupt/evict/degraded counters
    # (monotone within one store lifetime), and the footprint gauges.  A
    # DEGRADED store serves on via recompute (fail-open), so ncnet_store_up
    # going 0 is an operator page about the DISK, not about availability.
    # streaming tracked mode (serving/stream.py): monotone frame totals by
    # kind (tracked = coarse pass SKIPPED, fallback = cut-triggered exact
    # re-seed, cold = first/unseeded frame), cut detections, live session
    # gauge, the candidate-recall proxy, and the pipeline tier streaming
    # frames currently dispatch through
    sm = doc.get("streams")
    if sm is not None:
        frames = Family(
            "ncnet_serve_stream_frames_total", "counter",
            "stream frames served by kind (tracked = coarse pass skipped, "
            "fallback = cut re-seed, cold = unseeded)")
        frames.add(sm["tracked_frames"], kind="tracked")
        frames.add(sm["fallback_frames"], kind="fallback")
        frames.add(sm["cold_frames"], kind="cold")
        fams.append(frames)
        fams.append(Family("ncnet_serve_stream_cuts_total", "counter",
                           "detected scene cuts / tracking drifts "
                           "(recall collapse or quality collapse)")
                    .add(stream_cuts))
        fams.append(Family("ncnet_serve_stream_sessions", "gauge",
                           "live stream sessions (bound under "
                           "label=\"max\")")
                    .add(sm["active"], bound="active")
                    .add(sm["max_sessions"], bound="max"))
        fams.append(Family("ncnet_serve_stream_evicted_total", "counter",
                           "stream sessions evicted (idle/cap/drain)")
                    .add(sm["evicted"]))
        if sm.get("recall_mean") is not None:
            fams.append(Family(
                "ncnet_serve_stream_recall", "gauge",
                "mean candidate-recall proxy over live sessions "
                "(fraction of served matches inside the seeded windows)")
                .add(sm["recall_mean"]))
        fams.append(Family(
            "ncnet_serve_stream_pipeline", "gauge",
            "1 on the pipeline tier streaming frames dispatch through "
            "(tracked = temporal-candidate fine pass, full = per-frame "
            "coarse-to-fine)").add(1, tier=stream_tier))

    st = doc.get("store")
    if st is not None:
        fams.append(Family(
            "ncnet_store_up", "gauge",
            "1 = feature store OK, 0 = DEGRADED (failing open to "
            "recompute)").add(1 if st.get("state") == "OK" else 0))
        c = st.get("counters") or {}
        for metric, key, help_text in (
                ("ncnet_store_hits_total", "hits",
                 "verified feature-store read hits"),
                ("ncnet_store_misses_total", "misses",
                 "feature-store misses (recomputed + committed)"),
                ("ncnet_store_corrupt_total", "corrupt",
                 "entries that failed verification and were quarantined"),
                ("ncnet_store_evictions_total", "evictions",
                 "LRU evictions under the size budget"),
                ("ncnet_store_degraded_ops_total", "degraded_ops",
                 "store operations that failed open (I/O errors)")):
            if key in c:
                fams.append(Family(metric, "counter", help_text)
                            .add(c[key]))
        fams.append(Family("ncnet_store_entries", "gauge",
                           "live entries in the current generation")
                    .add(st.get("entries", 0)))
        fams.append(Family("ncnet_store_bytes", "gauge",
                           "bytes used by the current generation")
                    .add(st.get("bytes", 0)))
        if st.get("budget_bytes"):
            fams.append(Family("ncnet_store_budget_bytes", "gauge",
                               "LRU eviction budget (0 = unbounded)")
                        .add(st["budget_bytes"]))
        if st.get("hit_pct") is not None:
            fams.append(Family("ncnet_store_hit_pct", "gauge",
                               "verified-hit percentage over all lookups")
                        .add(st["hit_pct"]))
    return fams


def render_statusz(service) -> str:
    """The human page: one consistent cut of the health document rendered
    as fixed-width text (``/statusz`` convention — glanceable, greppable,
    no JSON tooling needed)."""
    doc = service.health()
    lines: List[str] = []
    add = lines.append
    svc = doc["service"]
    add("ncnet_tpu match service — statusz")
    add(f"state: {doc['state']}  (for {svc['age_s']}s"
        + (f", reason: {svc['reason']}" if svc.get("reason") else "") + ")")
    if doc.get("model_version"):
        line = f"model version: {doc['model_version']}"
        ro = doc.get("rollout")
        if ro is not None and ro.get("phase") not in (None, "IDLE"):
            line += (f"  rollout: {ro['phase']}"
                     + (f" -> {ro['new_version']}"
                        if ro.get("new_version") else ""))
        add(line)
    q = doc["queue"]
    add(f"queue: depth={q['depth']}/{q['effective_max_queue']}  "
        f"inflight_batches={q['inflight_batches']}  "
        f"pipeline_depth={q['pipeline_depth']}")
    c = doc["counters"]
    active = c["admitted"] - (c["results"] + c["deadline"]
                              + c["quarantined"] + c["shed"])
    add(f"requests: admitted={c['admitted']}  results={c['results']}  "
        f"deadline={c['deadline']}  quarantined={c['quarantined']}  "
        f"shed={c['shed']}  active={max(0, active)}")
    add("")
    add(f"bucket ladder: {', '.join(q['buckets']) or '(none registered)'}")
    add("")
    pool = doc["pool"]
    hbm = (doc.get("memory") or {}).get("hbm") or {}
    add(f"replicas ({pool['ready']}/{pool['total']} ready):")
    add(f"  {'id':<8} {'state':<8} {'version':<10} {'score':>10} "
        f"{'ewma_ms':>9} {'load':>4} {'batches':>8} {'failures':>8} "
        f"{'deaths':>6} {'hbm%':>6}")
    for r in pool["replicas"]:
        ewma = r.get("ewma_wall_ms")
        fill = (hbm.get(r["id"]) or {}).get("fill_pct")
        add(f"  {r['id']:<8} {r['state']:<8} "
            f"{(r.get('model_version') or '-'):<10} {r['score']:>10.4f} "
            f"{(f'{ewma:.2f}' if ewma is not None else '-'):>9} "
            f"{r['load']:>4} {r['batches']:>8} {r['failures']:>8} "
            f"{r['deaths']:>6} "
            f"{(f'{fill:.1f}' if fill is not None else '-'):>6}")
    mem = doc.get("memory")
    if mem is not None and (mem.get("predicted_ladder_bytes") is not None
                            or hbm):
        add("")
        pred = mem.get("predicted_ladder_bytes")
        line = (f"memory: predicted ladder "
                f"{pred / 2 ** 20:.1f} MiB over "
                f"{mem.get('ledger_programs')} warmed program(s)"
                if pred is not None else
                "memory: no warmed programs in the ledger")
        head = mem.get("headroom_bytes")
        if head is not None:
            line += f"  headroom vs bytes_limit {head / 2 ** 20:.1f} MiB"
        add(line)
    st = doc.get("store")
    if st is not None:
        add("")
        c = st.get("counters") or {}
        hp = st.get("hit_pct")
        add(f"feature store: {st.get('state')}"
            + (f" ({st.get('reason')})" if st.get("reason") else "")
            + f"  entries={st.get('entries')}"
            f"  bytes={(st.get('bytes') or 0) / 2 ** 20:.1f} MiB"
            + (f"  hit%={hp:.1f}" if hp is not None else "")
            + f"  corrupt={c.get('corrupt', 0)}"
            f"  evictions={c.get('evictions', 0)}")
    sm = doc.get("streams")
    if sm is not None and (sm["active"] or sm["frames"]):
        add("")
        rc = sm.get("recall_mean")
        add(f"streams: active={sm['active']}/{sm['max_sessions']}  "
            f"frames={sm['frames']}  tracked={sm['tracked_frames']}  "
            f"fallback={sm['fallback_frames']}  cold={sm['cold_frames']}  "
            f"evicted={sm['evicted']}"
            + (f"  recall={rc:.3f}" if rc is not None else ""))
    slo = doc.get("slo")
    if slo is not None and slo["admitted"]:
        add("")
        w = slo["window"]
        add(f"SLO: burn={slo['budget_burn_pct']}% of budget "
            f"({slo['bad_total']}/{slo['admitted']} bad, budget "
            f"{slo['objectives']['budget_pct']}%)  window: "
            f"{w['bad']}/{w['n']} bad = {w['burn_pct']}%")
    add("")
    add("recent health timeline:")
    for h in svc.get("history", []):
        add(f"  -> {h['state']}"
            + (f"  ({h['reason']})" if h.get("reason") else ""))
    return "\n".join(lines) + "\n"


def scrape_wall_ms(base_url: str, n: int = 5, timeout: float = 30.0) -> float:
    """Median wall of ``n`` ``/metrics`` scrapes over real HTTP, in ms —
    the scrape-cost methodology of the JAX package's, so both packages'
    scrape walls measure the same thing."""
    import statistics
    import time as _time
    import urllib.request

    url = base_url.rstrip("/") + "/metrics"
    walls = []
    for _ in range(int(n)):
        t0 = _time.perf_counter()
        with urllib.request.urlopen(url, timeout=timeout) as r:
            r.read()
        walls.append(_time.perf_counter() - t0)
    return float(statistics.median(walls)) * 1e3


class _Handler(BaseHTTPRequestHandler):
    server_version = "ncnet-introspect/1"
    protocol_version = "HTTP/1.1"

    # the library logger is the one console sink; per-request access lines
    # are noise there, and the package prints nothing bare
    def log_message(self, format: str, *args: Any) -> None:  # noqa: A002
        pass

    def do_GET(self) -> None:  # noqa: N802 — http.server contract
        intro = getattr(self.server, "introspect", None)
        try:
            path = self.path.split("?", 1)[0].rstrip("/") or "/"
            if intro is None:
                code, ctype, body = 503, "text/plain; charset=utf-8", \
                    "introspection detached\n"
            elif path == "/metrics":
                code = 200
                ctype = "text/plain; version=0.0.4; charset=utf-8"
                body = intro.metrics_text()
            elif path == "/healthz":
                doc = intro.health_doc()
                code = 200 if doc.get("state") in (
                    "STARTING", "READY", "DEGRADED") else 503
                ctype = "application/json; charset=utf-8"
                body = json.dumps(doc, sort_keys=True) + "\n"
            elif path == "/statusz":
                code, ctype = 200, "text/plain; charset=utf-8"
                body = intro.statusz_text()
            elif path == "/rollout":
                code, ctype = 200, "application/json; charset=utf-8"
                body = json.dumps(intro.rollout_doc(),
                                  sort_keys=True) + "\n"
            elif path == "/":
                code, ctype = 200, "text/plain; charset=utf-8"
                body = "endpoints: /metrics /healthz /statusz /rollout " \
                    "(+ POST /match, POST /retrieve, POST /rollout)\n"
            else:
                code, ctype, body = 404, "text/plain; charset=utf-8", \
                    f"no such endpoint {path}; try /metrics /healthz " \
                    "/statusz\n"
        except Exception as e:  # noqa: BLE001 — the plane fails open: a
            # renderer bug answers 500, it never propagates into serving
            code, ctype = 500, "text/plain; charset=utf-8"
            body = f"introspection error: {type(e).__name__}: {e}\n"
        self._respond(code, ctype, body.encode("utf-8"))

    def do_POST(self) -> None:  # noqa: N802 — http.server contract
        """The wire data plane: ``POST /match`` (serving/wire.py) admits
        one framed request against the fronted service/router and blocks
        this connection's thread until its terminal outcome — the
        multi-host twin of a local ``submit(...).result()``.  ``POST
        /retrieve`` (``retrieval/wire.py``) is the same contract for the
        scatter-gather shortlist plane of a shard host or a coordinator; a
        host that fronts no retrieval service answers 404 there, not 500."""
        intro = getattr(self.server, "introspect", None)
        path = self.path.split("?", 1)[0].rstrip("/")
        if intro is None or path not in ("/match", "/retrieve", "/rollout"):
            self._respond(503 if intro is None else 404,
                          "text/plain; charset=utf-8",
                          b"POST accepts only /match, /retrieve and "
                          b"/rollout\n")
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n) if n > 0 else b""
            if path == "/retrieve":
                code, ctype, payload = intro.retrieve_payload(body)
            elif path == "/rollout":
                code, ctype, payload = intro.rollout_payload(body)
            else:
                code, ctype, payload = intro.match_payload(body)
        except Exception as e:  # noqa: BLE001 — same fail-open contract
            # as do_GET: a data-plane handler bug answers 500
            code, ctype = 500, "text/plain; charset=utf-8"
            payload = f"match error: {type(e).__name__}: {e}\n" \
                .encode("utf-8")
        self._respond(code, ctype, payload)

    def _respond(self, code: int, ctype: str, payload: bytes) -> None:
        try:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)
        except OSError:
            pass  # client went away mid-write: its problem, not serving's


class IntrospectionServer:
    """The ``/metrics`` + ``/healthz`` + ``/statusz`` thread for one
    service.  ``port=0`` binds an ephemeral port (tests, multi-service
    hosts); read it back via :attr:`port` / :attr:`url` after
    :meth:`start`.  Binds loopback by default — exposing the plane beyond
    the host is a deployment decision (``ServingConfig.introspect_host``),
    not a default."""

    def __init__(self, service, host: str = "127.0.0.1", port: int = 0):
        self._service = service
        self._host = host
        self._want_port = int(port)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._scrapes = 0

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "IntrospectionServer":
        if self._httpd is not None:
            raise RuntimeError("introspection server already started")
        httpd = ThreadingHTTPServer((self._host, self._want_port), _Handler)
        httpd.daemon_threads = True
        httpd.introspect = self
        self._httpd = httpd
        self._thread = threading.Thread(
            target=httpd.serve_forever, kwargs={"poll_interval": 0.2},
            name="match-introspect", daemon=True)
        self._thread.start()
        return self

    @property
    def port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd else None

    @property
    def url(self) -> Optional[str]:
        return f"http://{self._host}:{self.port}" if self._httpd else None

    def stop(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is None:
            return
        try:
            httpd.shutdown()
            httpd.server_close()
        except Exception:  # noqa: BLE001 — shutdown of a dead socket is
            pass           # not worth more than the attempt
        if self._thread is not None:
            self._thread.join(2.0)
            self._thread = None

    # -- endpoint payloads (also the in-process API the tests drive) --------

    def metrics_text(self) -> str:
        self._scrapes += 1
        fams = metrics_families(self._service)
        fams.append(Family("ncnet_serve_scrapes_total", "counter",
                           "scrapes answered by this introspection server")
                    .add(self._scrapes))
        return render(fams)

    def health_doc(self) -> Dict[str, Any]:
        return self._service.health()

    def statusz_text(self) -> str:
        return render_statusz(self._service)

    def match_payload(self, body: bytes):
        """``POST /match`` body → ``(status, content_type, payload)`` —
        one wire request submitted to the fronted service with the
        propagated deadline budget + client identity
        (``serving/wire.py::serve_match``).  The router's introspection
        plane inherits this unchanged, so a router is itself a valid wire
        backend (tiers chain)."""
        from ncnet_tpu_torch.serving.wire import serve_match

        return serve_match(
            self._service.submit, body,
            stream_submit=getattr(self._service, "stream_submit", None))

    def rollout_doc(self) -> Dict[str, Any]:
        """``GET /rollout``: the live rollout status (phase, versions,
        verdict inputs) — IDLE with the pod's version when no controller
        was ever attached."""
        ctl = getattr(self._service, "_rollout", None)
        if ctl is not None:
            return ctl.status()
        return {"phase": "IDLE",
                "model_version": getattr(self._service, "model_version",
                                         None)}

    def rollout_payload(self, body: bytes):
        """``POST /rollout`` (control plane, ``tools/rollout.py``): JSON
        ``{"checkpoint": ..., knobs...}`` kicks a background rollout on
        the fronted service.  A host that fronts no rollout-capable
        service (a router) answers 404 — same pattern as /retrieve."""
        start = getattr(self._service, "start_rollout", None)
        if not callable(start):
            return (404, "text/plain; charset=utf-8",
                    b"this host serves no rollout control plane\n")
        from ncnet_tpu_torch.serving.rollout import RolloutConfig

        try:
            req = json.loads(body.decode("utf-8") or "{}")
            candidate = req["checkpoint"]
        except (ValueError, KeyError) as e:
            return (400, "text/plain; charset=utf-8",
                    f"bad rollout request: {type(e).__name__}: {e}\n"
                    .encode("utf-8"))
        knobs = {k: req[k] for k in (
            "canary_fraction", "canary_min_results", "canary_timeout_s",
            "drain_timeout_s", "psi_threshold", "error_rate_margin",
            "latency_factor", "min_latency_samples", "state_path",
            "gc_keep_generations") if k in req}
        # additive trace field (pod observability): the control plane's
        # rollout order joins the federated trace like any data request
        from ncnet_tpu_torch.observability import events as obs_events
        from ncnet_tpu_torch.observability.tracing import normalize_trace

        trace = normalize_trace(req.get("trace"))
        obs_events.emit(
            "rollout_control", checkpoint=str(candidate)[:200],
            knobs=sorted(knobs),
            **({"trace": trace} if trace else {}))
        try:
            ctl = start(candidate, RolloutConfig(**knobs))
        except RuntimeError as e:  # a rollout is already in progress
            return (409, "text/plain; charset=utf-8",
                    f"{e}\n".encode("utf-8"))
        payload = json.dumps(ctl.status(), sort_keys=True) + "\n"
        return (202, "application/json; charset=utf-8",
                payload.encode("utf-8"))

    def retrieve_payload(self, body: bytes):
        """``POST /retrieve`` body → ``(status, content_type, payload)``
        — one framed retrieval request against the fronted service
        (``retrieval/wire.py::serve_retrieve``).  Any service exposing a
        ``retrieve(desc, ...)`` data plane (a shard host, the coordinator)
        joins the wire; everything else answers 404."""
        retrieve = getattr(self._service, "retrieve", None)
        if not callable(retrieve):
            return (404, "text/plain; charset=utf-8",
                    b"this host serves no /retrieve\n")
        from ncnet_tpu_torch.retrieval.wire import serve_retrieve

        return serve_retrieve(retrieve, body)
