"""Pod-level match routing: a fronting tier over per-host ``MatchService``s,
the port of ``ncnet_tpu/serving/router.py`` (host code over HTTP that
touches no device: a copy with the port's imports).  Its backends may be
hosts of either package, as the wire is the same.

The replica pool proved the robustness ladder INSIDE one process:
health-scored routing, off-budget failover, quarantine + resurrection,
elastic admission.  This module lifts that ladder one level up, across
process and network boundaries, where the failure modes are harsher — a
SIGKILLed host, a hung socket, a partitioned backend.  The
:class:`MatchRouter` fronts N per-host services (each exposing the
``serving/wire.py`` data plane + the ``/healthz`` probe document)
and gives every admitted request the SAME outcome-total contract the
in-process service gives: exactly one of
``{result, deadline, overloaded, quarantined}``, never a silent drop.

  * **Scoring, one level up.**  Each backend carries the replica pool's formula fed
    by cross-process signals: the per-backend request-wall EWMA (measured
    by the router itself — the only latency number that includes the wire)
    × (1 + in-flight attempts) × 2^consecutive-failures, scaled by the
    backend's OWN ``/healthz`` document — its queue fill and its pool's
    ready fraction — so a host whose replicas are dying is de-prioritized
    before it starts failing the data plane.
  * **Failover, off-budget.**  A transport failure (connection refused or
    reset, a socket hung past ``request_timeout_s``, a wire frame this
    build refuses) re-routes the request to a survivor WITHOUT charging
    its retry budget — the failure was the backend's fault.  Zero lost
    admitted requests, event-log proven (``run_report --serving`` at the
    router level).  ``backend_max_failures`` consecutive failures
    quarantine the BACKEND into DEAD, where periodic ``/healthz`` probes
    are the only way back; a whole-pod-dead router parks admitted work
    off-budget behind the probes and sheds new admissions
    ``Overloaded(reason="no_capacity")`` with the probe period as the
    honest hint.
  * **Backpressure propagation.**  A backend answering ``Overloaded`` is
    NOT a failed backend, and retrying it would be exactly the hammering
    its retry hint asks to prevent: the router records the shed, tries a
    backend that has not shed this request, and — once every live backend
    has — surfaces ``Overloaded(reason="backpressure")`` to the edge with
    the honest AGGREGATE hint (the soonest any backend promised capacity).
  * **Deadline propagation.**  The edge budget rides the wire as REMAINING
    seconds (``serving/wire.py``), is re-checked at router dequeue, bounds
    the socket wait per attempt, and is checked once more when a result
    lands — an expired edge deadline always surfaces as a classified
    ``DeadlineExceeded`` naming the checkpoint that caught it, never as a
    silent backend timeout or a zombie success.
  * **Coordinated drain.**  SIGTERM (or :meth:`request_drain`) closes
    admission, answers 503 on the router's own ``/healthz``, and completes
    every admitted request against the backends before stopping.  The
    reverse direction also holds: a backend whose probe document says
    DRAINING is demoted out of routing — without burning a failure streak —
    before its own drain completes, so pod rollouts drain hosts one at a
    time with zero edge-visible errors.

Elastic admission composes across the tiers (the
``AdmissionController.note_capacity`` capacity-units contract,
``serving/admission.py``): the router feeds the SUM of ready replicas
across live backends — the pod's true drain lanes — so its queue bound
tracks live backend capacity, never the local process's devices.

Telemetry mirrors the service tier with ``route_*`` events (``route_admit``
/ ``route_result`` / ``route_shed`` / ``route_deadline`` /
``route_quarantine`` / ``route_backend`` / ``route_backend_probe`` /
``route_health`` / ``route_drain``; re-routes ride the shared ``retry``
event with ``scope="router"`` and a ``backend`` tag), ``ncnet_route_*``
exposition families on ``/metrics``, and an aggregate activity stamp +
per-backend staleness rows on ``/healthz`` for
``tools/stall_watchdog.py --url`` — one wedged host cannot flag a healthy
pod STALLED.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import socket
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Set

import numpy as np

from ncnet_tpu_torch.observability import MetricsRegistry, events as obs_events
from ncnet_tpu_torch.observability import get_logger
from ncnet_tpu_torch.observability.tracing import TraceContext, adopt_trace
from ncnet_tpu_torch.observability.export import Family, render
from ncnet_tpu_torch.serving.admission import AdmissionController
from ncnet_tpu_torch.serving.health import (
    ADMITTING,
    DEGRADED,
    DRAINING,
    HEALTH_DOC_SCHEMA,
    READY,
    STARTING,
    STOPPED,
    HealthMachine,
)
from ncnet_tpu_torch.serving.introspect import IntrospectionServer
from ncnet_tpu_torch.serving.request import (
    DeadlineExceeded,
    MatchFuture,
    MatchResult,
    Overloaded,
    RequestQuarantined,
    as_pair_image,
)
from ncnet_tpu_torch.serving.wire import MatchClient, WireError

log = get_logger("router")

# router health-document schema: bump when the nesting or field meanings
# change so cross-host consumers (stall_watchdog --url, a higher routing
# tier) can refuse documents they do not understand
ROUTER_DOC_SCHEMA = 1

# backend lifecycle states.  READY <-> DEAD mirrors the replica pool;
# DRAINING is the third, cross-process-only state: the backend ANSWERED its
# probe but is refusing admissions (rollout drain) — demoted out of routing
# without a failure streak, watched until it either re-admits (READY) or
# stops answering (DEAD)
BACKEND_READY = "READY"
BACKEND_DEAD = "DEAD"
BACKEND_DRAINING = "DRAINING"

# routing prior for a backend with no measured wall yet (same rationale as
# the replica prior, scaled for a wire round trip on top of a batch wall)
_PRIOR_WALL_S = 0.1

_EWMA_ALPHA = 0.3  # the shared ~6-sample telemetry memory

# transport-level exceptions that classify as a BACKEND failure (re-route
# off-budget + failure streak); everything the wire decodes into a serving
# outcome class is the REQUEST's terminal state instead
_TRANSPORT_ERRORS = (OSError, socket.timeout, WireError)


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Knobs of the fronting match router (README "Multi-host serving")."""

    # admission / backpressure (AdmissionController capacity-units contract:
    # the queue bound scales with live BACKEND capacity — the sum of ready
    # replicas across live backends — not this process's devices)
    max_queue: int = 256
    max_in_flight_per_client: int = 32
    elastic_admission: bool = True
    # concurrency: in-flight wire attempts per READY backend (the router's
    # pipeline depth — also the worker-thread budget, so a wedged backend
    # can absorb at most this many workers while survivors keep draining)
    per_backend_depth: int = 4
    max_workers: int = 16
    # failure policy
    retries: int = 1                  # budgeted retries per request
    backend_max_failures: int = 3     # consecutive failures -> backend DEAD
    resurrect_after_s: float = 2.0    # /healthz probe period for DEAD backends
    probe_period_s: float = 2.0       # doc-refresh period for live backends
    probe_timeout_s: float = 5.0
    # per-attempt socket ceiling for BUDGET-LESS requests: a hung socket
    # surfaces as a classified retryable failure within this bound.  A
    # budgeted attempt is bounded by its own budget + the wire settle
    # margin instead (never capped below it — see _attempt), so a long
    # edge deadline cannot masquerade as a backend failure.
    request_timeout_s: float = 30.0
    default_deadline_s: Optional[float] = None
    # lifecycle / liveness
    install_sigterm: bool = False
    latency_hist_ms: float = 4000.0
    # the router's own introspection plane (/metrics + /healthz + /statusz
    # + POST /match — the router is itself a wire backend, so tiers chain)
    introspect_port: Optional[int] = None
    introspect_host: str = "127.0.0.1"


class Backend:
    """One per-host ``MatchService`` as the router sees it: the wire
    client pool + cross-process health state.  All mutable fields are
    owned by the router's condition lock; only :meth:`acquire` /
    :meth:`release` (connection pooling) and the actual wire calls run
    outside it."""

    def __init__(self, bid: str, url: str):
        self.id = bid
        self.url = url.rstrip("/")
        self.state = BACKEND_READY  # optimistic: the data plane corrects
        # health signals (the routing-score inputs)
        self.ewma_wall_s: Optional[float] = None
        self.consecutive_failures = 0
        self.inflight = 0            # wire attempts currently out
        # probe-document signals (refreshed every probe_period_s)
        self.doc_state: Optional[str] = None
        self.model_version: Optional[str] = None  # live-rollout visibility
        self.ready_replicas = 1
        self.total_replicas = 1
        self.queue_fill = 0.0        # backend queue depth / its live bound
        self.schema_refused = False  # logged once per backend
        # backpressure memory (never part of the failure streak)
        self.backpressure = 0
        self.retry_after_s: Optional[float] = None
        # counters / timeline
        self.requests = 0
        self.results = 0
        self.failures = 0
        self.deaths = 0
        self.dead_since: Optional[float] = None
        self.last_probe_t: Optional[float] = None
        self.probing = False
        self.last_result_t: Optional[float] = None
        self._clients: List[MatchClient] = []

    # -- connection pool (router-lock free) ---------------------------------

    def acquire(self, timeout_s: float) -> MatchClient:
        try:
            client = self._clients.pop()
            client.timeout_s = timeout_s
            return client
        except IndexError:
            return MatchClient(self.url, timeout_s=timeout_s)

    def release(self, client: MatchClient, *, broken: bool = False) -> None:
        if broken or len(self._clients) >= 8:
            client.close()
        else:
            self._clients.append(client)

    # -- health (router-lock owned) -----------------------------------------

    def health_score(self) -> float:
        """Routing cost, lower = route here — the replica pool's formula
        one level up.  Base cost is the measured per-request wall EWMA
        (wire included), scaled by in-flight attempts (a busy backend
        queues the request behind them), doubled per consecutive failure,
        and scaled by the backend's own probe document: its queue fill
        (a backend near its bound is about to shed) and its pool's
        degraded fraction (a host on 2/4 replicas drains half as fast)."""
        wall = self.ewma_wall_s if self.ewma_wall_s else _PRIOR_WALL_S
        streak = 2.0 ** min(self.consecutive_failures, 4)
        pool_penalty = self.total_replicas / max(1, self.ready_replicas)
        return (wall * (1.0 + self.inflight) * streak
                * (1.0 + self.queue_fill) * pool_penalty)

    def note_success(self, wall_s: float) -> None:
        self.results += 1
        self.consecutive_failures = 0
        w = float(wall_s)
        self.ewma_wall_s = w if self.ewma_wall_s is None else (
            _EWMA_ALPHA * w + (1.0 - _EWMA_ALPHA) * self.ewma_wall_s)
        self.last_result_t = time.monotonic()

    def note_failure(self) -> None:
        self.failures += 1
        self.consecutive_failures += 1

    def ingest_doc(self, doc: Dict[str, Any]) -> None:
        """Fold one accepted ``/healthz`` document into the score inputs.
        Reads BOTH document shapes: a service document's ``pool``
        (replica ready/total) and a sub-ROUTER document's ``pod``
        (replica units across its backends) — tiers chain, so a backend
        may itself be a router fronting a sub-pod."""
        self.doc_state = str(doc.get("state"))
        # which model generation this backend serves (live rollout): the
        # doc refresh every probe_period_s makes a mid-rollout version
        # change visible at the router without any new wire machinery
        mv = doc.get("model_version")
        if isinstance(mv, str) and mv:
            self.model_version = mv
        if doc.get("role") == "router":
            pod = doc.get("pod") or {}
            ready, total = pod.get("replicas_ready"), \
                pod.get("replicas_total")
        else:
            pool = doc.get("pool") or {}
            ready, total = pool.get("ready"), pool.get("total")
        if isinstance(ready, int):
            self.ready_replicas = max(0, ready)
        if isinstance(total, int):
            self.total_replicas = max(1, total)
        q = doc.get("queue") or {}
        depth, bound = q.get("depth"), q.get("effective_max_queue")
        if isinstance(depth, (int, float)) and \
                isinstance(bound, (int, float)) and bound:
            self.queue_fill = max(0.0, float(depth) / float(bound))

    def probe_row(self) -> Dict[str, Any]:
        """This backend's row in the router health document — the
        per-backend staleness breakdown ``stall_watchdog --url`` consumes
        (``last_result_age_s``) plus everything an operator needs to see
        why routing prefers or shuns this host."""
        now = time.monotonic()
        return {
            "id": self.id,
            "url": self.url,
            "state": self.state,
            "model_version": self.model_version,
            "score": round(self.health_score(), 6),
            "ewma_wall_ms": (round(self.ewma_wall_s * 1e3, 3)
                             if self.ewma_wall_s else None),
            "consecutive_failures": self.consecutive_failures,
            "inflight": self.inflight,
            "requests": self.requests,
            "results": self.results,
            "failures": self.failures,
            "backpressure": self.backpressure,
            # the last overload hint this backend gave (operator signal:
            # how far away it said its capacity was)
            "retry_after_s": self.retry_after_s,
            "deaths": self.deaths,
            "replicas_ready": self.ready_replicas,
            "replicas_total": self.total_replicas,
            "queue_fill": round(self.queue_fill, 4),
            "dead_age_s": (round(now - self.dead_since, 3)
                           if self.dead_since is not None else None),
            "last_result_age_s": (round(now - self.last_result_t, 3)
                                  if self.last_result_t is not None
                                  else None),
        }


@dataclasses.dataclass(eq=False)  # identity semantics: requests live in
class _RouterRequest:             # the ownership set, never compared
    """One admitted edge request moving through the router."""

    id: str
    client: str
    src: np.ndarray
    tgt: np.ndarray
    future: MatchFuture
    submitted_t: float
    deadline_t: Optional[float] = None
    attempts: int = 0                     # budgeted failures only
    failed_on: Set[str] = dataclasses.field(default_factory=set)
    shed_by: Set[str] = dataclasses.field(default_factory=set)
    shed_hints: List[float] = dataclasses.field(default_factory=list)
    parked_logged: bool = False           # awaiting_capacity emitted once
    # the pod-wide trace context: stamped (or adopted from the edge
    # caller) at router admission, propagated on every wire attempt, and
    # carried by every route_*/retry event this request produces
    trace: Optional[TraceContext] = None

    @property
    def trace_id(self) -> Optional[str]:
        return self.trace.trace_id if self.trace is not None else None

    def expired(self, now: float) -> bool:
        return self.deadline_t is not None and now >= self.deadline_t

    def remaining_s(self, now: float) -> Optional[float]:
        if self.deadline_t is None:
            return None
        return self.deadline_t - now


def build_router_document(machine: HealthMachine,
                          backends: List[Dict[str, Any]], *,
                          queue: Dict[str, Any],
                          counters: Dict[str, Any],
                          activity: Dict[str, Any]) -> Dict[str, Any]:
    """THE router health document (``ROUTER_DOC_SCHEMA``-versioned): the
    router's ``/healthz`` body, :meth:`MatchRouter.health` return value,
    and the final ``route_health_doc`` event payload.  Shape mirrors the
    service document (``serving/health.py::build_health_document``) with
    ``pod`` in place of ``pool``: backend rows instead of replica rows,
    plus the pod's aggregate replica capacity (the admission units)."""
    ready = sum(1 for b in backends if b.get("state") == BACKEND_READY)
    # the distinct model versions the pod's backends report (live
    # rollout): >1 entry = a mixed-version pod mid-rollout — an operator
    # signal, not an error (the router keeps routing across versions)
    versions = sorted({b["model_version"] for b in backends
                       if b.get("model_version")})
    return {
        "schema": ROUTER_DOC_SCHEMA,
        "role": "router",
        "state": machine.state,
        "service": machine.probe(),
        "pod": {
            "ready": ready,
            "total": len(backends),
            "replicas_ready": sum(
                b.get("replicas_ready") or 0 for b in backends
                if b.get("state") == BACKEND_READY),
            "replicas_total": sum(
                b.get("replicas_total") or 1 for b in backends),
            "model_versions": versions,
            "backends": list(backends),
        },
        "queue": dict(queue),
        "counters": dict(counters),
        "activity": dict(activity),
    }


class MatchRouter:
    """The fronting router over per-host wire backends.

    Usage::

        router = MatchRouter(["http://hostA:8080", "http://hostB:8080"],
                             RouterConfig(...)).start()
        fut = router.submit(src_u8, tgt_u8, deadline_s=0.5, client="cam0")
        result = fut.result(timeout=5.0)   # MatchResult, or classified error
        router.stop()                       # drains admitted work, then stops

    The submit/result surface is the ``MatchService`` surface — callers
    (and the wire's ``serve_match``, so routers chain) cannot tell the
    tiers apart.
    """

    def __init__(self, backends: Sequence[str],
                 routing: RouterConfig = RouterConfig(), *,
                 registry: Optional[MetricsRegistry] = None):
        if not backends:
            raise ValueError("a router needs at least one backend url")
        self.cfg = routing
        self.backends: List[Backend] = [
            Backend(f"b{i}", url) for i, url in enumerate(backends)]
        if len({b.url for b in self.backends}) != len(self.backends):
            raise ValueError(f"duplicate backend urls: {list(backends)}")
        self._registry = registry or MetricsRegistry(scope="router")
        self._admission = AdmissionController(
            max_queue=routing.max_queue,
            max_in_flight_per_client=routing.max_in_flight_per_client,
            # the router's drain unit is one request (backends coalesce
            # batches on their side), so the elastic floor is per-unit
            max_batch=1,
            elastic=routing.elastic_admission,
            dead_retry_after_s=routing.resurrect_after_s,
        )
        self._health = HealthMachine(event="route_health")
        self._cond = threading.Condition()
        self._queue: Deque[_RouterRequest] = deque()
        # requests popped by a worker and not yet settled or requeued: the
        # force-settle set for a shutdown that outlives a wedged attempt
        self._owned: Set[_RouterRequest] = set()
        self._workers: List[threading.Thread] = []
        self._supervisor: Optional[threading.Thread] = None
        self._workers_stop = False
        self._draining = False
        self._drain_requested = False   # set from the signal handler: no lock
        self._stop_now = False
        self._finishing = False
        self._req_seq = 0
        self._old_sigterm = None
        self._activity_t = time.monotonic()
        self._introspect: Optional[IntrospectionServer] = None
        self._n = {"admitted": 0, "results": 0, "deadline": 0,
                   "quarantined": 0, "shed": 0}
        self._note_capacity_locked()

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def start(self) -> "MatchRouter":
        if self._supervisor is not None:
            raise RuntimeError("router already started")
        if self.cfg.introspect_port is not None:
            try:
                self._introspect = _RouterIntrospectionServer(
                    self, host=self.cfg.introspect_host,
                    port=self.cfg.introspect_port).start()
            except Exception as e:  # noqa: BLE001 — same fail-open bar as
                # the service plane: telemetry never kills the data plane
                self._introspect = None
                log.warning(
                    f"router introspection failed to bind "
                    f"{self.cfg.introspect_host}:{self.cfg.introspect_port}"
                    f" ({type(e).__name__}: {e}); routing without "
                    "/metrics + /healthz", kind="io")
        obs_events.emit(
            "route_start",
            backends={b.id: b.url for b in self.backends},
            max_queue=self.cfg.max_queue, retries=self.cfg.retries,
            per_backend_depth=self.cfg.per_backend_depth,
            backend_max_failures=self.cfg.backend_max_failures,
            resurrect_after_s=self.cfg.resurrect_after_s,
            default_deadline_s=self.cfg.default_deadline_s,
            introspect_port=(self._introspect.port
                             if self._introspect is not None else None),
        )
        if self.cfg.install_sigterm and \
                threading.current_thread() is threading.main_thread():
            self._old_sigterm = signal.signal(signal.SIGTERM, self._on_sigterm)
        n_workers = min(self.cfg.max_workers,
                        max(2, self.cfg.per_backend_depth
                            * len(self.backends)))
        for i in range(n_workers):
            t = threading.Thread(target=self._run_worker,
                                 name=f"route-worker-{i}", daemon=True)
            t.start()
            self._workers.append(t)
        self._supervisor = threading.Thread(
            target=self._run, name="route-supervise", daemon=True)
        self._supervisor.start()
        with self._cond:
            if self._health.state == STARTING:
                self._health.to(READY, "routing")
        return self

    def _on_sigterm(self, signum, frame):
        # handler discipline (as the trainer's PreemptionHandler): flip a flag, os.write, act at the
        # supervisor's next loop edge — no locks from a signal handler
        self._drain_requested = True
        os.write(2, b"[router] received SIGTERM; draining admitted work to "
                    b"the backends, admission closed\n")

    def request_drain(self, reason: str = "drain") -> None:
        """Close admission and finish admitted work against the backends
        (the SIGTERM path, callable programmatically).  The router's own
        ``/healthz`` answers 503 from this point — a higher tier demotes
        this router exactly like this router demotes a draining backend."""
        with self._cond:
            if not self._draining:
                self._draining = True
                if self._health.state != STOPPED:
                    self._health.to(DRAINING, reason)
            self._cond.notify_all()

    def stop(self, drain: bool = True,
             timeout: Optional[float] = 30.0) -> None:
        """Stop the router.  ``drain=True`` completes every admitted
        request first; ``drain=False`` aborts — queued work settles
        ``Overloaded(reason="shutdown")`` (classified, never dropped); an
        attempt already on the wire completes or times out at its socket
        bound first."""
        with self._cond:
            if drain:
                if not self._draining:
                    self._draining = True
                    if self._health.state != STOPPED:
                        self._health.to(DRAINING, "stop")
            else:
                self._stop_now = True
            self._cond.notify_all()
        sup = self._supervisor
        if sup is not None and sup is not threading.current_thread():
            sup.join(timeout)
        if self._old_sigterm is not None:
            signal.signal(signal.SIGTERM, self._old_sigterm)
            self._old_sigterm = None

    def __enter__(self) -> "MatchRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def submit(self, src, tgt, *, deadline_s: Optional[float] = None,
               client: str = "default",
               trace: Optional[str] = None) -> MatchFuture:
        """Admit one match query against the pod.  Same contract as
        :meth:`MatchService.submit`: returns a :class:`MatchFuture`,
        raises classified :class:`Overloaded` / :class:`DeadlineExceeded`
        synchronously at the door.  The router is the pod's trace-stamping
        tier: it ADOPTS ``trace`` (a traceparent header an upstream tier
        propagated) or STAMPS a fresh context, and every backend attempt
        carries it — so one edge request is one trace across every log it
        touches."""
        src = as_pair_image(src, "src")
        tgt = as_pair_image(tgt, "tgt")
        now = time.monotonic()
        if deadline_s is None:
            deadline_s = self.cfg.default_deadline_s
        shed: Optional[Overloaded] = None
        expired = False
        req: Optional[_RouterRequest] = None
        with self._cond:
            if self._supervisor is None or self._finishing \
                    or self._stop_now or self._health.state == STOPPED:
                shed = Overloaded("router is not running", reason="stopped")
            elif self._draining or self._drain_requested:
                shed = Overloaded("router is draining", reason="draining")
            elif deadline_s is not None and deadline_s <= 0:
                expired = True
            else:
                depth = len(self._queue)
                try:
                    self._admission.admit(client, depth)
                except Overloaded as e:
                    shed = e
                else:
                    self._req_seq += 1
                    req = _RouterRequest(
                        id=f"q{self._req_seq}", client=client, src=src,
                        tgt=tgt, future=MatchFuture(f"q{self._req_seq}"),
                        submitted_t=now,
                        deadline_t=(now + deadline_s) if deadline_s
                        else None,
                        trace=adopt_trace(trace),
                    )
                    self._admission.note_admit(client)
                    self._n["admitted"] += 1
                    self._registry.counter("admitted").inc()
            if shed is not None:
                self._n["shed"] += 1
                self._registry.counter("shed").inc()
        # event emission outside the lock: the log fsyncs per append, and
        # the disk must not serialize every client's admission
        if expired:
            obs_events.emit("route_deadline", request=None, client=client,
                            where="admission", admitted=False)
            raise DeadlineExceeded(
                f"deadline budget {deadline_s}s already expired at "
                "router admission", where="admission")
        if shed is not None:
            obs_events.emit("route_shed", client=client, reason=shed.reason,
                            retry_after_s=shed.retry_after_s,
                            admitted=False)
            raise shed
        obs_events.emit(
            "route_admit", request=req.id, client=client,
            deadline_s=round(deadline_s, 6) if deadline_s else None,
            trace=req.trace_id)
        # phase 2 (the service's admit discipline): make the admitted
        # request visible to the workers only after its admit event is on
        # disk, settling it ourselves if the router died in the window
        with self._cond:
            dead = self._finishing or self._stop_now \
                or self._health.state == STOPPED
            if not dead:
                self._queue.append(req)
                self._cond.notify_all()
        if dead:
            exc = Overloaded(
                f"router stopped before request {req.id} was queued",
                reason="stopped")
            req.future._settle("overloaded", error=exc)
            with self._cond:
                self._n["shed"] += 1
                self._registry.counter("shed").inc()
                self._admission.note_done(req.client)
            obs_events.emit("route_shed", request=req.id, client=client,
                            reason="stopped", admitted=True,
                            trace=req.trace_id)
            raise exc
        return req.future

    # ------------------------------------------------------------------
    # probes / document ingestion
    # ------------------------------------------------------------------

    def health(self) -> Dict[str, Any]:
        """The unified router health document
        (:func:`build_router_document`)."""
        now = time.monotonic()
        with self._cond:
            return build_router_document(
                self._health,
                [b.probe_row() for b in self.backends],
                queue={
                    "depth": len(self._queue),
                    "inflight": len(self._owned),
                    "effective_max_queue":
                        self._admission.effective_max_queue(),
                },
                counters=dict(self._n),
                activity={
                    "age_s": round(max(0.0, now - self._activity_t), 3),
                    "requests": self._n["results"],
                },
            )

    @property
    def state(self) -> str:
        return self._health.state

    @property
    def introspect_url(self) -> Optional[str]:
        return self._introspect.url if self._introspect is not None else None

    def metrics(self) -> Dict[str, Any]:
        return self._registry.snapshot()

    def _fetch_doc(self, backend: Backend) -> Optional[Dict[str, Any]]:
        """One ``/healthz`` round trip (no router lock held).  Returns the
        parsed document (200 OR 503 — a draining backend answering 503 is
        alive and says so), or None when nothing trustworthy answered."""
        url = backend.url + "/healthz"
        try:
            try:
                with urllib.request.urlopen(
                        url, timeout=self.cfg.probe_timeout_s) as r:
                    doc = json.loads(r.read().decode("utf-8"))
            except urllib.error.HTTPError as e:
                if e.code != 503:
                    raise
                doc = json.loads(e.read().decode("utf-8"))
        except Exception:  # noqa: BLE001 — any transport/parse failure is
            # the same evidence: nothing trustworthy is answering there
            return None
        # accept BOTH document shapes at their own schema constants: a
        # service answers HEALTH_DOC_SCHEMA, a sub-router (tiers chain)
        # answers ROUTER_DOC_SCHEMA with role="router" — each versioned
        # independently, each refused independently when unknown
        known = isinstance(doc, dict) and (
            (doc.get("role") == "router"
             and doc.get("schema") == ROUTER_DOC_SCHEMA)
            or (doc.get("role") != "router"
                and doc.get("schema") == HEALTH_DOC_SCHEMA))
        if not known:
            # refuse a document this build does not understand — but only
            # log the mismatch once per backend, it is a deploy skew, not
            # a flapping condition
            if not backend.schema_refused:
                backend.schema_refused = True
                log.warning(
                    f"backend {backend.id} ({backend.url}) answered a "
                    f"health document with schema "
                    f"{doc.get('schema') if isinstance(doc, dict) else '?'}"
                    f" (role {doc.get('role') if isinstance(doc, dict) else '?'})"
                    f" this build does not understand; refusing it",
                    kind="io")
            return None
        return doc

    def _probe_backend(self, backend: Backend) -> None:
        """One probe thread's body: fetch the document, fold the verdict
        into routing state under the lock.  Resurrection (DEAD/DRAINING →
        READY) requires BOTH an admitting ``/healthz`` document AND a
        successful wire probe (the data-plane twin of the replica pool's
        tiny probe pair) — a backend whose control plane answers while its
        ``/match`` is broken must stay quarantined, or the pod flaps
        DEAD → READY → DEAD forever.  Demotion to DRAINING is probe-only;
        demotion to DEAD is shared with the data plane's failure streak."""
        doc = self._fetch_doc(backend)
        admitting = doc is not None and doc.get("state") in ADMITTING
        data_ok: Optional[bool] = None
        if admitting and backend.state != BACKEND_READY:
            data_ok = self._wire_probe(backend)
        emit: List[Dict[str, Any]] = []
        with self._cond:
            backend.probing = False
            was = backend.state
            if doc is not None:
                backend.ingest_doc(doc)
                # units can change WITHOUT a backend state change (a READY
                # host losing one of its replicas): re-derive admission
                # capacity from every accepted document
                self._note_capacity_locked()
                if admitting and backend.state != BACKEND_READY:
                    if data_ok:
                        self._revive_locked(backend, emit)
                    # else: control plane up, data plane still broken —
                    # stay quarantined until a probe proves the wire
                elif not admitting and backend.state == BACKEND_READY:
                    # coordinated drain: demoted out of routing before the
                    # backend's own drain completes — NOT a failure
                    backend.state = BACKEND_DRAINING
                    emit.append(dict(event="route_backend",
                                     backend=backend.id,
                                     state=BACKEND_DRAINING,
                                     reason=f"backend_{doc.get('state')}"))
                    self._note_capacity_locked()
            else:
                if backend.state == BACKEND_DRAINING:
                    self._kill_locked(backend, "gone_after_drain", emit)
                elif backend.state == BACKEND_READY:
                    backend.note_failure()
                    self._registry.counter(
                        f"backend_failures_{backend.id}").inc()
                    if backend.consecutive_failures >= \
                            self.cfg.backend_max_failures:
                        self._kill_locked(backend, "probe_unreachable", emit)
            resurrection_attempt = was != BACKEND_READY
            self._cond.notify_all()
        if resurrection_attempt or doc is None:
            # resurrection probes and failures are log-worthy; the periodic
            # doc refresh of a live backend is not (event-spam discipline)
            obs_events.emit("route_backend_probe", backend=backend.id,
                            ok=doc is not None,
                            data_ok=data_ok,
                            state=doc.get("state") if doc else None)
        for e in emit:
            obs_events.emit(**e)

    def _wire_probe(self, backend: Backend) -> bool:
        """One tiny zero pair through the REAL data plane.  Any decoded
        wire answer — a result OR a classified serving outcome — proves
        the path; only a transport failure keeps the backend dead (an
        Overloaded answer to the probe is backpressure, not death)."""
        probe = np.zeros((8, 8, 3), np.uint8)
        client = backend.acquire(self.cfg.probe_timeout_s)
        broken, ok = False, True
        try:
            client.match(probe, probe, client="router_probe",
                         budget_s=self.cfg.probe_timeout_s,
                         request_id=f"{backend.id}-probe",
                         timeout_s=self.cfg.probe_timeout_s)
        except (Overloaded, DeadlineExceeded, RequestQuarantined):
            pass  # a classified answer IS a working data plane
        except Exception:  # noqa: BLE001 — transport/wire failure: dead
            broken, ok = True, False
        backend.release(client, broken=broken)
        return ok

    def _revive_locked(self, backend: Backend,
                       emit: List[Dict[str, Any]]) -> None:
        backend.state = BACKEND_READY
        backend.consecutive_failures = 0
        backend.ewma_wall_s = None  # pre-death walls are stale evidence
        backend.dead_since = None
        emit.append(dict(event="route_backend", backend=backend.id,
                         state=BACKEND_READY, reason="probe_ok"))
        self._note_capacity_locked()

    def _kill_locked(self, backend: Backend, reason: str,
                     emit: List[Dict[str, Any]]) -> None:
        if backend.state == BACKEND_DEAD:
            return
        backend.state = BACKEND_DEAD
        backend.deaths += 1
        backend.dead_since = time.monotonic()
        backend.last_probe_t = None
        emit.append(dict(event="route_backend", backend=backend.id,
                         state=BACKEND_DEAD, reason=reason))
        self._note_capacity_locked()

    def _note_capacity_locked(self) -> None:
        """Membership/probe change → elastic admission.  The units are the
        pod's live drain lanes: the SUM of ready replicas across READY
        backends (the capacity-units contract,
        ``AdmissionController.note_capacity``) — NOT this process's
        devices, which serve nothing here."""
        ready_units = sum(max(1, b.ready_replicas) for b in self.backends
                          if b.state == BACKEND_READY)
        total_units = sum(max(1, b.total_replicas) for b in self.backends)
        self._admission.note_capacity(ready_units, total_units)
        self._registry.gauge("ready_backends").set(
            sum(1 for b in self.backends if b.state == BACKEND_READY))
        ready_b = sum(1 for b in self.backends
                      if b.state == BACKEND_READY)
        if self._health.state in (STARTING, READY) \
                and ready_b < len(self.backends):
            self._health.to(
                DEGRADED,
                "no_ready_backends" if ready_b == 0
                else f"backends_ready:{ready_b}/{len(self.backends)}")
        elif self._health.state == DEGRADED \
                and ready_b == len(self.backends):
            self._health.to(READY, "pod_restored")

    # ------------------------------------------------------------------
    # supervisor (probe scheduling, deadline eviction, drain completion)
    # ------------------------------------------------------------------

    def _run(self) -> None:
        crashed: Optional[BaseException] = None
        # first probe round immediately: real documents beat the
        # optimistic READY default as soon as the pod answers
        try:
            while True:
                if self._drain_requested:
                    self.request_drain("sigterm")
                self._schedule_probes()
                self._evict_expired()
                with self._cond:
                    if self._stop_now:
                        break
                    if self._draining and not self._queue \
                            and not self._owned:
                        break
                    if not self._queue and not self._owned:
                        # a deliberately idle router is alive: the
                        # activity stamp advances exactly like the
                        # service's idle beat
                        self._activity_t = time.monotonic()
                    self._cond.wait(0.05)
        except BaseException as e:  # the supervisor must never die silently
            crashed = e
            log.error(f"router supervisor crashed: {type(e).__name__}: {e}",
                      kind="io")
        finally:
            self._finish(crashed)

    def _schedule_probes(self) -> None:
        now = time.monotonic()
        due: List[Backend] = []
        with self._cond:
            for b in self.backends:
                if b.probing:
                    continue
                period = self.cfg.resurrect_after_s \
                    if b.state == BACKEND_DEAD else self.cfg.probe_period_s
                if b.last_probe_t is None or now - b.last_probe_t >= period:
                    b.last_probe_t = now
                    b.probing = True
                    due.append(b)
        for b in due:
            # probes ride their own daemon threads: a host that hangs
            # instead of erroring must not stall eviction or drain
            threading.Thread(target=self._probe_backend, args=(b,),
                             name=f"route-probe-{b.id}",
                             daemon=True).start()

    def _evict_expired(self) -> None:
        now = time.monotonic()
        expired: List[_RouterRequest] = []
        with self._cond:
            if not any(r.expired(now) for r in self._queue):
                return
            keep: Deque[_RouterRequest] = deque()
            for r in self._queue:
                (expired if r.expired(now) else keep).append(r)
            self._queue = keep
        for r in expired:
            self._resolve_deadline(r, "dequeue")

    # ------------------------------------------------------------------
    # workers (route + wire attempt)
    # ------------------------------------------------------------------

    def _route_locked(self, req: _RouterRequest) -> Optional[Backend]:
        """Lowest-score READY backend with spare depth, preferring ones
        this request has neither failed on nor been shed by; falls back to
        a failed-on backend (retrying beats stranding) but NEVER to a
        shed-by one — that is the backpressure contract."""
        best = fallback = None
        best_s = fb_s = float("inf")
        for b in self.backends:
            if b.state != BACKEND_READY \
                    or b.inflight >= self.cfg.per_backend_depth \
                    or b.id in req.shed_by:
                continue
            s = b.health_score()
            if b.id in req.failed_on:
                if s < fb_s:
                    fallback, fb_s = b, s
            elif s < best_s:
                best, best_s = b, s
        return best if best is not None else fallback

    def _run_worker(self) -> None:
        while True:
            req: Optional[_RouterRequest] = None
            backend: Optional[Backend] = None
            overloaded: Optional[Overloaded] = None
            parked_now = False
            with self._cond:
                while True:
                    if self._workers_stop:
                        return
                    if self._queue:
                        head = self._queue[0]
                        ready = [b for b in self.backends
                                 if b.state == BACKEND_READY]
                        if ready and all(b.id in head.shed_by
                                         for b in ready):
                            # every live backend has shed this request:
                            # propagate the backpressure to the edge now
                            req = self._queue.popleft()
                            overloaded = self._aggregate_overload_locked(req)
                            self._owned.add(req)
                            break
                        backend = self._route_locked(head)
                        if backend is not None:
                            req = self._queue.popleft()
                            backend.inflight += 1
                            backend.requests += 1
                            self._owned.add(req)
                            break
                        if not ready and not head.parked_logged:
                            head.parked_logged = True
                            parked_now = True
                            req = head  # only for the event below
                            break
                    self._cond.wait(0.05)
            if parked_now:
                # the whole pod is dead: admitted work parks off-budget
                # behind the resurrection probes — availability degraded,
                # nothing lost (logged once per request, not per tick)
                obs_events.emit("retry", unit=req.id, kind="connection",
                                on_budget=False, scope="router",
                                via="awaiting_capacity",
                                trace=req.trace_id)
                continue
            if overloaded is not None:
                self._settle_overloaded(req, overloaded)
                continue
            self._attempt(req, backend)

    def _aggregate_overload_locked(self,
                                   req: _RouterRequest) -> Overloaded:
        """The honest aggregate backpressure answer: the soonest ANY
        backend promised capacity (min over their hints), falling back to
        the router's own cadence-derived estimate."""
        hints = [h for h in req.shed_hints if h is not None]
        retry = min(hints) if hints \
            else self._admission.retry_after_s(len(self._queue))
        return Overloaded(
            f"every live backend shed request {req.id} "
            f"({sorted(req.shed_by)})",
            reason="backpressure", retry_after_s=retry)

    def _attempt(self, req: _RouterRequest, backend: Backend) -> None:
        """One wire attempt against one backend, plus the failure ladder."""
        now = time.monotonic()
        if req.expired(now):
            self._release(backend)
            self._resolve_deadline(req, "dequeue")
            return
        budget = req.remaining_s(now)
        # the socket ceiling.  A BUDGETED attempt is bounded by its own
        # budget + the wire's settle margin — strictly above the window in
        # which serve_match answers a classified outcome (budget +
        # WIRE_SETTLE_MARGIN_S), and NEVER capped below it by
        # request_timeout_s: the backend's own deadline classification
        # must always outrun this socket timeout, or an in-budget backend
        # would be charged a failure streak for an edge that merely asked
        # for more time than the transport ceiling (the masquerade the
        # margin exists to prevent).  A hung socket therefore occupies a
        # worker for at most the edge's own budget — the edge asked for
        # that wait.  request_timeout_s bounds budget-LESS attempts only.
        from ncnet_tpu_torch.serving.wire import WIRE_SETTLE_MARGIN_S

        timeout = self.cfg.request_timeout_s if budget is None \
            else budget + WIRE_SETTLE_MARGIN_S + 0.5
        client = backend.acquire(timeout)
        attempt_t0 = time.monotonic()
        try:
            result = client.match(
                req.src, req.tgt, client=req.client, budget_s=budget,
                request_id=req.id, timeout_s=timeout,
                trace=(req.trace.to_header()
                       if req.trace is not None else None))
        except Overloaded as e:
            self._release(backend, client)
            self._on_backpressure(req, backend, e)
            return
        except DeadlineExceeded as e:
            # the backend classified it with the propagated budget — the
            # edge deadline expired AS a deadline, never a silent timeout
            self._release(backend, client)
            self._resolve_deadline(req, f"backend_{e.where}")
            return
        except RequestQuarantined as e:
            self._release(backend, client)
            self._quarantine(req, e.kind, e)
            return
        except _TRANSPORT_ERRORS as e:
            self._release(backend, client, broken=True)
            self._on_attempt_failure(req, backend, e)
            return
        except Exception as e:  # noqa: BLE001 — an unclassified client bug
            # is still a backend-attempt failure, never a lost request
            self._release(backend, client, broken=True)
            self._on_attempt_failure(req, backend, e)
            return
        self._release(backend, client)
        now = time.monotonic()
        if req.expired(now):
            # the result landed after the edge budget (late wire, clock
            # margin): the caller has by contract moved on — classified,
            # not a zombie success
            self._resolve_deadline(req, "fetch")
            return
        self._settle_result(req, backend, result, now,
                            attempt_wall_s=now - attempt_t0)

    def _release(self, backend: Backend,
                 client: Optional[MatchClient] = None, *,
                 broken: bool = False) -> None:
        if client is not None:
            backend.release(client, broken=broken)
        with self._cond:
            backend.inflight = max(0, backend.inflight - 1)
            self._cond.notify_all()

    def _requeue_front(self, req: _RouterRequest) -> None:
        with self._cond:
            self._owned.discard(req)
            self._queue.appendleft(req)
            self._cond.notify_all()

    # -- failure ladder -----------------------------------------------------

    def _on_attempt_failure(self, req: _RouterRequest, backend: Backend,
                            exc: Exception) -> None:
        """Transport failure on one backend — the router-level failover
        ladder, mirroring the pool's: (1) a fresh READY survivor →
        re-route off-budget; (2) no READY backend at all → park off-budget
        behind the resurrection probes; (3) failed on every READY backend
        → the bounded retry budget, then quarantine.  An expired edge
        budget wins over all of it: the hang/refusal is classified as the
        DEADLINE it caused, never a silent timeout."""
        kind = "timeout" if isinstance(exc, socket.timeout) else \
            "wire" if isinstance(exc, WireError) else "connection"
        if req.expired(time.monotonic()):
            # the edge budget is already gone: the "failure" is at least
            # partly our own give-up (the per-attempt socket ceiling
            # tracks the budget), so the DEADLINE is the honest outcome
            # and the backend's streak is NOT charged — sustained
            # short-deadline traffic must not quarantine healthy hosts
            # (a genuinely dead host still dies via its health probes)
            self._resolve_deadline(req, "backend_failure")
            return
        with self._cond:
            backend.note_failure()
            self._registry.counter(f"backend_failures_{backend.id}").inc()
            emit: List[Dict[str, Any]] = []
            if backend.state == BACKEND_READY and \
                    backend.consecutive_failures >= \
                    self.cfg.backend_max_failures:
                log.warning(
                    f"backend {backend.id} ({backend.url}) hit "
                    f"{backend.consecutive_failures} consecutive failures "
                    f"({kind}); quarantined DEAD — /healthz probes every "
                    f"{self.cfg.resurrect_after_s}s", kind=kind)
                self._kill_locked(backend, f"{kind}:{type(exc).__name__}",
                                  emit)
            req.failed_on.add(backend.id)
            survivors = [b for b in self.backends
                         if b.state == BACKEND_READY
                         and b.id not in req.failed_on]
            any_ready = any(b.state == BACKEND_READY
                            for b in self.backends)
        for e in emit:
            obs_events.emit(**e)
        if survivors:
            obs_events.emit("retry", unit=req.id, kind=kind,
                            on_budget=False, scope="router",
                            backend=backend.id, via="reroute",
                            trace=req.trace_id)
            self._requeue_front(req)
            return
        if not any_ready:
            if not req.parked_logged:
                req.parked_logged = True
                obs_events.emit("retry", unit=req.id, kind=kind,
                                on_budget=False, scope="router",
                                backend=backend.id, via="awaiting_capacity",
                                trace=req.trace_id)
            self._requeue_front(req)
            return
        req.attempts += 1
        if req.attempts <= self.cfg.retries:
            obs_events.emit("retry", unit=req.id, kind=kind,
                            attempt=req.attempts, on_budget=True,
                            scope="router", backend=backend.id,
                            trace=req.trace_id)
            self._requeue_front(req)
        else:
            self._quarantine(req, kind, exc)

    def _on_backpressure(self, req: _RouterRequest, backend: Backend,
                         exc: Overloaded) -> None:
        """A backend shed the request: record it (NOT a failure streak —
        an overloaded host is healthy), steer the request to a backend
        that has not shed it, and let the worker loop surface the honest
        aggregate once every live backend has."""
        with self._cond:
            backend.backpressure += 1
            backend.retry_after_s = exc.retry_after_s
            self._registry.counter(
                f"backend_backpressure_{backend.id}").inc()
            req.shed_by.add(backend.id)
            if exc.retry_after_s is not None:
                req.shed_hints.append(float(exc.retry_after_s))
        obs_events.emit("retry", unit=req.id, kind="overloaded",
                        on_budget=False, scope="router",
                        backend=backend.id, via="backpressure",
                        reason=exc.reason,
                        retry_after_s=exc.retry_after_s,
                        trace=req.trace_id)
        if req.expired(time.monotonic()):
            self._resolve_deadline(req, "backpressure")
            return
        self._requeue_front(req)

    # -- settle paths (each ends in _terminal; exactly one wins) ------------

    def _settle_result(self, req: _RouterRequest, backend: Backend,
                       result: MatchResult, now: float, *,
                       attempt_wall_s: float) -> None:
        wall = now - req.submitted_t
        edge = MatchResult(request_id=req.id, table=result.table,
                           quality=result.quality, bucket=result.bucket,
                           wall_s=wall)
        if not req.future._try_settle("result", result=edge):
            self._disown(req)  # force-settled during shutdown: the winner
            return             # did the terminal accounting
        with self._cond:
            # the ATTEMPT wall (wire round trip only) feeds the estimators
            # — the backend's EWMA/score and the retry-after cadence both
            # assume a per-drain wall; the submit-to-settle edge wall
            # includes shared router-queue delay and would double-count
            # the queue in retry_after_s (depth × wall already multiplies
            # by the backlog) and loosen the watchdog's staleness
            # thresholds.  The edge wall still rules the latency
            # histogram, the result, and the events — that IS the
            # end-to-end promise.
            backend.note_success(attempt_wall_s)
            self._activity_t = now
            self._n["results"] += 1
            self._registry.counter("results").inc()
            self._registry.counter(f"backend_results_{backend.id}").inc()
            self._admission.note_batch_wall(attempt_wall_s)
            self._registry.histogram(
                "route_wall_ms", 0.0, self.cfg.latency_hist_ms,
            ).add(wall * 1e3)
        obs_events.emit(
            "route_result", request=req.id, client=req.client,
            backend=backend.id, wall_ms=round(wall * 1e3, 3),
            backend_wall_ms=round(result.wall_s * 1e3, 3),
            attempts=req.attempts, trace=req.trace_id)
        self._terminal(req)

    def _resolve_deadline(self, req: _RouterRequest, where: str) -> None:
        if not req.future._try_settle("deadline", error=DeadlineExceeded(
                f"request {req.id} deadline expired at {where}",
                where=where)):
            self._disown(req)
            return
        with self._cond:
            self._n["deadline"] += 1
            self._registry.counter("deadline_exceeded").inc()
        obs_events.emit("route_deadline", request=req.id,
                        client=req.client, where=where, admitted=True,
                        trace=req.trace_id)
        self._terminal(req)

    def _quarantine(self, req: _RouterRequest, kind: str,
                    exc: Exception) -> None:
        msg = (f"request {req.id} gave up after {req.attempts} budgeted "
               f"attempt(s): {type(exc).__name__}: {exc}")
        if not req.future._try_settle("quarantined",
                                      error=RequestQuarantined(
                                          msg, kind=kind,
                                          attempts=max(1, req.attempts))):
            self._disown(req)
            return
        log.warning(f"{msg} — quarantined; the stream continues",
                    kind="quarantine")
        with self._cond:
            self._n["quarantined"] += 1
            self._registry.counter("quarantined").inc()
        obs_events.emit("route_quarantine", request=req.id,
                        client=req.client, kind=kind,
                        attempts=max(1, req.attempts),
                        error=str(exc)[:300], trace=req.trace_id)
        self._terminal(req)

    def _settle_overloaded(self, req: _RouterRequest,
                           exc: Overloaded) -> None:
        if not req.future._try_settle("overloaded", error=exc):
            self._disown(req)
            return
        with self._cond:
            self._n["shed"] += 1
            self._registry.counter("shed").inc()
        obs_events.emit("route_shed", request=req.id, client=req.client,
                        reason=exc.reason,
                        retry_after_s=exc.retry_after_s, admitted=True,
                        trace=req.trace_id)
        self._terminal(req)

    def _terminal(self, req: _RouterRequest) -> None:
        """Close one admitted request's accounting — called exactly once
        per request, by whichever settle path WON the ``_try_settle``
        race; losers call :meth:`_disown` (ownership bookkeeping only)."""
        with self._cond:
            self._owned.discard(req)
            self._admission.note_done(req.client)
            self._activity_t = time.monotonic()
            self._cond.notify_all()

    def _disown(self, req: _RouterRequest) -> None:
        with self._cond:
            self._owned.discard(req)
            self._cond.notify_all()

    # ------------------------------------------------------------------
    # shutdown
    # ------------------------------------------------------------------

    def _finish(self, crashed: Optional[BaseException]) -> None:
        with self._cond:
            self._finishing = True
            self._workers_stop = True
            self._cond.notify_all()
        for t in self._workers:
            # an attempt already on the wire completes (or times out at
            # its socket bound); the join is bounded so a wedged socket
            # cannot wedge shutdown — its request force-settles below and
            # the late completion loses the _try_settle race
            t.join(self.cfg.request_timeout_s + 5.0)
        with self._cond:
            # queued work AND requests a hung worker still owns: both get
            # their classified terminal outcome here, never a silent drop
            leftovers = list(self._queue) + list(self._owned)
            self._queue.clear()
        reason = "crashed" if crashed is not None else "shutdown"
        for req in leftovers:
            if not req.future._try_settle("overloaded", error=Overloaded(
                    f"router stopped before request {req.id} completed",
                    reason=reason)):
                continue
            with self._cond:
                self._n["shed"] += 1
                self._admission.note_done(req.client)
            obs_events.emit("route_shed", request=req.id,
                            client=req.client, reason=reason,
                            admitted=True, trace=req.trace_id)
        obs_events.emit(
            "route_drain", drained=self._draining and crashed is None,
            leftover=len(leftovers),
            **{f"n_{k}": v for k, v in self._n.items()})
        self._registry.flush(scope="router")
        with self._cond:
            if self._health.state != STOPPED:
                self._health.to(
                    STOPPED, "crashed" if crashed is not None else "clean")
            self._cond.notify_all()
        for b in self.backends:
            for c in b._clients:
                c.close()
            b._clients.clear()
        obs_events.emit("route_health_doc", doc=self.health())
        if self._introspect is not None:
            self._introspect.stop()
            self._introspect = None


# ---------------------------------------------------------------------------
# the router's exposition plane (ncnet_route_* families)
# ---------------------------------------------------------------------------


def router_metrics_families(router: MatchRouter) -> List[Family]:
    """The curated ``ncnet_route_*`` family set — the router-tier twin of
    ``serving/introspect.py::metrics_families``, built from one consistent
    health-document cut."""
    doc = router.health()
    with router._cond:
        from ncnet_tpu_torch.observability.metrics import Counter, Histogram

        reg = dict(router._registry._metrics)
        lat = Family("ncnet_route_latency_ms", "histogram",
                     "edge-to-edge request latency through the router")
        for name, h in sorted(reg.items()):
            if isinstance(h, Histogram) and h.count \
                    and name == "route_wall_ms":
                lat.add_histogram(h)
        backend_counters = [
            (name, m.value) for name, m in sorted(reg.items())
            if isinstance(m, Counter) and name.startswith("backend_")
        ]
    fams: List[Family] = []
    up = Family("ncnet_route_up", "gauge",
                "1 while the router admits (STARTING/READY/DEGRADED)")
    up.add(1 if doc["state"] in ADMITTING else 0)
    fams.append(up)
    state = Family("ncnet_route_state", "gauge",
                   "router health state (1 on the active state's series)")
    state.add(1, state=doc["state"])
    fams.append(state)
    outcomes = Family("ncnet_route_requests_total", "counter",
                      "terminal outcomes of admitted requests at the "
                      "router tier (the outcome-total contract)")
    for outcome, n in sorted(doc["counters"].items()):
        outcomes.add(n, outcome=outcome)
    fams.append(outcomes)
    q = doc["queue"]
    fams.append(Family("ncnet_route_queue_depth", "gauge",
                       "requests queued at the router").add(q["depth"]))
    fams.append(Family("ncnet_route_effective_max_queue", "gauge",
                       "the elastic queue bound at live backend capacity")
                .add(q["effective_max_queue"]))
    fams.append(Family("ncnet_route_inflight", "gauge",
                       "requests owned by workers (on the wire or "
                       "settling)").add(q["inflight"]))
    pod = doc["pod"]
    fams.append(Family("ncnet_route_backends", "gauge",
                       "pod capacity by readiness")
                .add(pod["ready"], status="ready")
                .add(pod["total"], status="total"))
    fams.append(Family("ncnet_route_replica_units", "gauge",
                       "pod replica capacity (the admission units)")
                .add(pod["replicas_ready"], status="ready")
                .add(pod["replicas_total"], status="total"))
    b_up = Family("ncnet_route_backend_up", "gauge",
                  "1 = backend READY, 0 = DRAINING or DEAD")
    b_score = Family("ncnet_route_backend_health_score", "gauge",
                     "routing cost (lower = preferred)")
    b_wall = Family("ncnet_route_backend_wall_ewma_ms", "gauge",
                    "request-wall EWMA per backend (wire included)")
    b_inflight = Family("ncnet_route_backend_inflight", "gauge",
                        "wire attempts out per backend")
    for row in pod["backends"]:
        b_up.add(1 if row["state"] == BACKEND_READY else 0,
                 backend=row["id"])
        b_score.add(row["score"], backend=row["id"])
        if row.get("ewma_wall_ms") is not None:
            b_wall.add(row["ewma_wall_ms"], backend=row["id"])
        b_inflight.add(row["inflight"], backend=row["id"])
    fams.extend([b_up, b_score, b_wall, b_inflight])
    b_req = Family("ncnet_route_backend_results_total", "counter",
                   "results served per backend")
    b_fail = Family("ncnet_route_backend_failures_total", "counter",
                    "transport failures per backend")
    b_bp = Family("ncnet_route_backend_backpressure_total", "counter",
                  "Overloaded answers per backend (propagated, never "
                  "retried against the same host)")
    for name, value in backend_counters:
        if name.startswith("backend_results_"):
            b_req.add(value, backend=name[len("backend_results_"):])
        elif name.startswith("backend_failures_"):
            b_fail.add(value, backend=name[len("backend_failures_"):])
        elif name.startswith("backend_backpressure_"):
            b_bp.add(value, backend=name[len("backend_backpressure_"):])
    fams.extend([b_req, b_fail, b_bp, lat])
    fams.append(Family("ncnet_route_activity_age_seconds", "gauge",
                       "seconds since the router last settled a request "
                       "or deliberately idled")
                .add(doc["activity"]["age_s"]))
    return fams


def render_router_statusz(router: MatchRouter) -> str:
    """The router's human page — glanceable, greppable, one document cut."""
    doc = router.health()
    lines: List[str] = []
    add = lines.append
    svc = doc["service"]
    add("ncnet_tpu match router — statusz")
    add(f"state: {doc['state']}  (for {svc['age_s']}s"
        + (f", reason: {svc['reason']}" if svc.get("reason") else "") + ")")
    q = doc["queue"]
    add(f"queue: depth={q['depth']}/{q['effective_max_queue']}  "
        f"inflight={q['inflight']}")
    c = doc["counters"]
    add(f"requests: admitted={c['admitted']}  results={c['results']}  "
        f"deadline={c['deadline']}  quarantined={c['quarantined']}  "
        f"shed={c['shed']}")
    add("")
    pod = doc["pod"]
    add(f"backends ({pod['ready']}/{pod['total']} ready, "
        f"{pod['replicas_ready']}/{pod['replicas_total']} replica units):")
    add(f"  {'id':<6} {'state':<9} {'score':>10} {'ewma_ms':>9} "
        f"{'infl':>4} {'results':>8} {'fail':>5} {'bp':>4} "
        f"{'replicas':>9} {'last_ok':>8}")
    for row in pod["backends"]:
        ewma = row.get("ewma_wall_ms")
        last = row.get("last_result_age_s")
        add(f"  {row['id']:<6} {row['state']:<9} {row['score']:>10.4f} "
            f"{(f'{ewma:.2f}' if ewma is not None else '-'):>9} "
            f"{row['inflight']:>4} {row['results']:>8} "
            f"{row['failures']:>5} {row['backpressure']:>4} "
            f"{row['replicas_ready']}/{row['replicas_total']:>7} "
            f"{(f'{last:.1f}s' if last is not None else '-'):>8}")
    add("")
    add("recent health timeline:")
    for h in svc.get("history", []):
        add(f"  -> {h['state']}"
            + (f"  ({h['reason']})" if h.get("reason") else ""))
    return "\n".join(lines) + "\n"


class _RouterIntrospectionServer(IntrospectionServer):
    """The router's ``/metrics`` + ``/healthz`` + ``/statusz`` +
    ``POST /match`` thread: the base server's handler and lifecycle with
    router-shaped payloads.  ``match_payload`` is inherited unchanged —
    ``MatchRouter.submit`` has the service's submit signature, so a router
    is itself a wire backend and tiers chain."""

    def metrics_text(self) -> str:
        self._scrapes += 1
        fams = router_metrics_families(self._service)
        fams.append(Family("ncnet_route_scrapes_total", "counter",
                           "scrapes answered by this router")
                    .add(self._scrapes))
        return render(fams)

    def statusz_text(self) -> str:
        return render_router_statusz(self._service)
