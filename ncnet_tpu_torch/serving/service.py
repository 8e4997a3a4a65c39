"""The resident match service, the port of ``ncnet_tpu/serving/service.py``:
continuous batching and replicated, fault-tolerant serving around the
warm matcher, in one process.

Pieces:

  * **Continuous batching** — an async request queue coalesces
    variable-resolution queries into padded shape buckets
    (``serving/buckets.py``) and dispatches the next batch while previous
    batches' fetches are still in flight; the per-replica in-flight depth
    follows ``evaluation/pipeline.PipelineDepthController``.  The batch
    dimension is bucketed too: powers of two up to ``max_batch`` (the
    batch ladder).
  * **Replicated serving** — ``serving/replica.py``: a :class:`ReplicaPool`
    of one ``BatchMatchEngine`` per device.  A fetcher thread per replica
    blocks on that replica's fetches, so a wedged card stalls only its own
    lane; the dispatcher routes each batch to the least-loaded READY
    replica by a health score fed by the measured batch-wall EWMA and the
    consecutive-failure streak.
  * **Replica failover** — a replica failing mid-batch requeues that batch
    at the FRONT and re-routes it to a surviving replica OFF-budget;
    ``replica_max_failures`` consecutive failures quarantine the REPLICA
    into a DEAD state with periodic resurrection probes.  Pool membership
    changes flow into admission control.
  * **Admission control + backpressure** — ``serving/admission.py``:
    elastic queue depth, per-client in-flight caps, classified
    ``Overloaded`` rejections with retry-after hints, ``no_capacity``
    shedding when every replica is dead.
  * **Per-request deadlines** — checked at admission, at dequeue and at
    fetch; each fetch rides ``pipeline.call_with_watchdog``.
  * **Failure ladder** — when no surviving replica can take a failed batch
    (a single-replica pool, or a request that failed everywhere), the
    request's retry budget is charged and the same program runs again;
    exhausted requests quarantine into a journaled ``RunManifest``.  The
    JAX service's demote-and-retrace free retry is not ported (ROADMAP
    D4).  SIGTERM stops admission and drains admitted work; the
    STARTING/READY/DEGRADED/DRAINING/STOPPED health machine
    (``serving/health.py``) is exported for probes.
  * **Telemetry** — every lifecycle edge is an event (``serve_admit`` /
    ``serve_shed`` / ``serve_batch`` / ``serve_result`` / ``serve_deadline``
    / ``serve_quarantine`` / ``serve_health`` / ``serve_drain``), latency
    goes into per-bucket and per-replica ``Histogram`` digests, and the
    ``Heartbeat`` is bumped per dispatched batch pool-wide.
  * **Memory** — the warm-up measures each (bucket, batch size) program's
    peak memory on the card into the program ledger
    (``observability/memory.py``, ROADMAP D9); ``health()`` sets the
    ladder's predicted bytes against the card's.

The outcome-total contract (``serving/request.py``): every admitted request
terminates in exactly one of {result, deadline, overloaded, quarantined}.

The network plane sits on top: ``introspect_port`` starts the live
introspection server (``serving/introspect.py``: ``/metrics``,
``/healthz``, ``/statusz``, ``/rollout`` and the ``POST /match`` wire data
plane a ``MatchRouter`` fans out to), fail-open, and the ``rollout_*``
seams let a ``RolloutController`` (``serving/rollout.py``) swap weights
into drained replicas while the rest of the pool serves.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np

from ncnet_tpu_torch.observability import MetricsRegistry, events as obs_events
from ncnet_tpu_torch.observability import get_logger
from ncnet_tpu_torch.observability import memory as obs_memory
from ncnet_tpu_torch.observability.device import DeviceMonitor, Heartbeat
from ncnet_tpu_torch.serving.admission import AdmissionController
from ncnet_tpu_torch.serving.buckets import ShapeBucketer, pad_to_bucket
from ncnet_tpu_torch.serving.health import (
    DEGRADED,
    DRAINING,
    READY,
    STARTING,
    STOPPED,
    HealthMachine,
    build_health_document,
)
from ncnet_tpu_torch.serving.slo import SLOTracker
from ncnet_tpu_torch.serving.replica import (
    REPLICA_READY,
    Replica,
    ReplicaPool,
)
from ncnet_tpu_torch.serving.request import (
    Bucket,
    DeadlineExceeded,
    MatchFuture,
    MatchRequest,
    MatchResult,
    Overloaded,
    RequestQuarantined,
    ServeError,
    as_pair_image,
    bucket_label,
)

log = get_logger("serving")


def _cuda_index(device) -> Optional[int]:
    """The CUDA device index of a replica's device, or None for the CPU and
    for injected engines without a device."""
    if device is None:
        return None
    import torch

    d = torch.device(device)
    if d.type != "cuda":
        return None
    return d.index if d.index is not None else torch.cuda.current_device()


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Knobs of the resident match service (README "Serving")."""

    # admission / backpressure
    max_queue: int = 64                 # total queued requests before shedding
    max_in_flight_per_client: int = 16  # outstanding per client id
    # batching
    max_batch: int = 8                  # requests coalesced per dispatch
    pipeline_depth: int = 0             # 0 = adaptive (2-4); >0 pins it
    # deadlines / hangs
    default_deadline_s: Optional[float] = None  # None = no implicit deadline
    fetch_timeout_s: float = 0.0        # >0: watchdog per batch fetch
    # failure policy
    retries: int = 1                    # budgeted retries per request
    quarantine_dir: Optional[str] = None  # RunManifest home (None = events only)
    # replication (serving/replica.py)
    replicas: int = 1                   # engines in the pool; 0 = one per device
    replica_max_failures: int = 3       # consecutive failures -> replica DEAD
    resurrect_after_s: float = 5.0      # probe period for DEAD replicas
    elastic_admission: bool = True      # queue bound tracks ready/total
    # shape buckets (a bounded set of programs)
    bucket_multiple: int = 64
    max_image_side: int = 1024
    max_buckets: int = 4
    buckets: Optional[Tuple[Tuple[int, int], ...]] = None  # fixed ladder
    warm_buckets: Tuple[Tuple[int, int], ...] = ()  # square pairs run at start
    # liveness / telemetry
    heartbeat_path: Optional[str] = None
    latency_hist_ms: float = 2000.0     # per-bucket latency digest range
    install_sigterm: bool = False       # SIGTERM -> drain (PreemptionHandler style)
    # SLO / error budget (serving/slo.py)
    slo_ms: Optional[float] = None      # default per-request latency objective
    slo_ms_by_bucket: Tuple[Tuple[str, float], ...] = ()  # bucket-label overrides
    slo_budget_pct: float = 1.0         # allowed SLO-bad fraction of admitted (%)
    slo_window: int = 256               # sliding window for the live burn signal
    slo_emit_every: int = 32            # `slo` event cadence (terminal outcomes)
    # live introspection plane (serving/introspect.py): /metrics + /healthz
    # + /statusz + POST /match.  None = off; 0 = ephemeral port (read back
    # via MatchService.introspect_url)
    introspect_port: Optional[int] = None
    introspect_host: str = "127.0.0.1"
    # persistent database-side feature store (ncnet_tpu_torch/store/):
    # source-row backbone features cached on disk,
    # verified on read, shared by every replica's engine.  None = off.
    feature_store_dir: Optional[str] = None
    feature_store_budget_mb: int = 0    # LRU-evict above this (0 = unbounded)
    # streaming tracked mode (serving/stream.py; README "Streaming
    # matching"): per-stream sessions whose steady frames skip the coarse
    # pass by seeding candidates from the previous frame's match table.
    stream_tracking: bool = True        # False = every frame runs the full
                                        # pipeline (sessions still track
                                        # ordering/digests)
    stream_cut_recall: float = 0.35     # tracked frame whose candidate-
                                        # containment proxy falls below this
                                        # → scene cut → exact fallback
    stream_cut_quality_frac: float = 0.5  # ...or whose score/coherence
                                        # falls below this fraction of the
                                        # stream's EMA baseline
    stream_idle_evict_s: float = 30.0   # session GC age (worker tick)
    stream_max_sessions: int = 64       # live-session cap; admission sheds
                                        # `stream_cap` beyond it
    # match extraction
    do_softmax: bool = True
    scale: str = "centered"
    # live rollout (serving/rollout.py): the version label stamped on every
    # replica at construction — serve_result/quality events and /metrics
    # families carry it, and the rollout controller advances it per
    # drained swap
    model_version: str = "v0"


@dataclasses.dataclass
class _InFlight:
    handle: Any
    batch: List[MatchRequest]
    bucket: Bucket
    replica: Replica
    t0: float
    seq: int  # stamped at dispatch: fetchers complete out of order


class MatchService:
    """Resident, fault-tolerant match service around the warm matcher.

    Usage::

        service = MatchService(config, params, ServingConfig(...))
        service.start()
        fut = service.submit(src_u8, tgt_u8, deadline_s=0.5, client="cam0")
        result = fut.result(timeout=5.0)   # MatchResult, or a classified error
        ...
        service.stop()                      # drains admitted work, then stops

    ``engine`` may be injected (anything with ``dispatch``/``fetch``) —
    the chaos suite drives the full lifecycle against a fake device; a
    SEQUENCE of engines builds a multi-replica pool over them (one replica
    per engine, ids ``rep0..``).  Without injection, ``serving.replicas``
    controls the pool: 1 (default) is one engine on the first device, N
    builds N engines over ``devices`` round-robin (0 = one per device).
    ``devices`` defaults to every CUDA device; the CPU tests pass
    ``["cpu"] * n``.
    """

    def __init__(self, model_config=None, params=None,
                 serving: ServingConfig = ServingConfig(), *,
                 engine=None, registry: Optional[MetricsRegistry] = None,
                 store=None, devices=None):
        self.cfg = serving
        # the device the store's fingerprint names (ROADMAP D8); a rollout
        # that changes the trunk fingerprints the new weights the same way
        self._store_device = devices[0] if devices else "cuda"
        # one persistent feature store SHARED across the pool (the store is
        # thread-safe).  Built from the config when a model is given, or
        # injected (chaos tests attach one beside fake engines to exercise
        # the health section).  Its fingerprint names the program that
        # extracts on the pool's device type (ROADMAP D8).
        if store is None and serving.feature_store_dir \
                and model_config is not None and params is not None:
            from ncnet_tpu_torch.store import FeatureStore, backbone_fingerprint

            fp = backbone_fingerprint(
                params, image_size="serve",
                k_size=max(model_config.relocalization_k_size, 1),
                dtype="bf16" if model_config.half_precision else "f32",
                device=self._store_device)
            store = FeatureStore(
                serving.feature_store_dir, fp,
                budget_bytes=serving.feature_store_budget_mb * 2 ** 20,
                scope="serving")
            store.gc_superseded()
        self._store = store
        # live-rollout state (serving/rollout.py): the model identity the
        # pod currently serves, the resident params a rollback swaps back
        # to, and the attached controller (None = no rollout in progress)
        self._model_config = model_config
        self._model_params = params
        self._model_version = serving.model_version
        self._rollout = None
        self._rollout_thread: Optional[threading.Thread] = None
        # test seam: replaces the controller's default checkpoint loader
        self.rollout_loader = None
        if engine is not None:
            engines = list(engine) if isinstance(engine, (list, tuple)) \
                else [engine]
            self._pool = ReplicaPool(
                [Replica(f"rep{i}", e) for i, e in enumerate(engines)],
                on_change=self._on_pool_change,
            )
        else:
            self._pool = ReplicaPool.from_model(
                model_config, params, serving.replicas,
                on_change=self._on_pool_change, devices=devices,
                do_softmax=serving.do_softmax, scale=serving.scale,
                store=self._store,
            )
        for rep in self._pool.replicas:
            rep.model_version = self._model_version
        self._registry = registry or MetricsRegistry(scope="serving")
        self._bucketer = ShapeBucketer(
            multiple=serving.bucket_multiple,
            max_side=serving.max_image_side,
            max_buckets=serving.max_buckets,
            fixed=serving.buckets,
        )
        self._admission = AdmissionController(
            max_queue=serving.max_queue,
            max_in_flight_per_client=serving.max_in_flight_per_client,
            max_batch=serving.max_batch,
            elastic=serving.elastic_admission,
            dead_retry_after_s=serving.resurrect_after_s,
        )
        self._admission.note_capacity(len(self._pool.ready()),
                                      len(self._pool.replicas))
        from ncnet_tpu_torch.evaluation.pipeline import PipelineDepthController

        self._controller = PipelineDepthController(fixed=serving.pipeline_depth)
        self._health = HealthMachine()
        self._heartbeat = None
        if serving.heartbeat_path:
            self._heartbeat = Heartbeat(serving.heartbeat_path)
        self._manifest = None
        if serving.quarantine_dir:
            from ncnet_tpu_torch.evaluation.resilience import RunManifest

            os.makedirs(serving.quarantine_dir, exist_ok=True)
            self._manifest = RunManifest(
                os.path.join(serving.quarantine_dir, "manifest.json"),
                meta={"scope": "serving"},
            )

        self._cond = threading.Condition()
        self._queues: Dict[Bucket, Deque[MatchRequest]] = {}
        self._worker: Optional[threading.Thread] = None
        self._fetchers: List[threading.Thread] = []
        self._fetchers_stop = False
        self._draining = False
        self._drain_requested = False   # set from the signal handler: no lock
        self._stop_now = False
        self._finishing = False         # _finish has begun: admission closed
        self._processing: Optional[List[MatchRequest]] = None
        self._last_idle_beat = 0.0
        self._drain_resolved = 0
        self._req_seq = 0
        self._batch_seq = 0
        self._old_sigterm = None
        # terminal-outcome accounting (the event log is the durable copy;
        # these back the health probe and the drain summary)
        self._n = {"admitted": 0, "results": 0, "deadline": 0,
                   "quarantined": 0, "shed": 0}
        # SLO error-budget tracker: fed under the service lock at every
        # terminal outcome, surfaced on /metrics + /healthz + `slo` events
        self._slo = SLOTracker(
            default_ms=serving.slo_ms,
            by_bucket=serving.slo_ms_by_bucket,
            budget_pct=serving.slo_budget_pct,
            window=serving.slo_window,
            emit_every=serving.slo_emit_every,
            registry=self._registry,
        )
        # monotonic stamp of the pool's last dispatch (or deliberate idle
        # tick): the HTTP-reachable liveness signal /healthz exports for
        # stall_watchdog --url — same semantics as the heartbeat beats
        # (a wedged fetch with nothing else dispatching stops advancing it)
        self._activity_t = time.monotonic()
        self._introspect = None
        # memory observability (observability/memory.py): per-replica card
        # memory watermarks sampled at every dispatched batch (a CPU
        # replica has none — the plane stays silent), a rate-limited
        # device_snapshot emitter on the worker tick, and the live-tensor
        # leak sentinel fed at batch boundaries
        self._hbm: Dict[str, Dict[str, Any]] = {}
        self._dev_monitor = DeviceMonitor(every_s=30.0)
        self._leak = obs_memory.LeakSentinel(
            window=4, min_interval_s=1.0, scope="serving")
        # streaming sessions (serving/stream.py): per-stream FIFO + prior
        # tables, idle-evicted from the worker tick, drained with the
        # service.  Tracked dispatch engages only when EVERY replica's
        # engine exposes the tracked program — a mixed pool would make a
        # stream's path depend on routing
        from ncnet_tpu_torch.serving.stream import StreamTable

        self._streams = StreamTable(
            max_sessions=serving.stream_max_sessions,
            idle_evict_s=serving.stream_idle_evict_s)
        self._tracking_capable = all(
            r.supports_tracking for r in self._pool.replicas)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def start(self) -> "MatchService":
        if self._worker is not None:
            raise RuntimeError("service already started")
        if self.cfg.introspect_port is not None:
            # fail-open: a port clash (or any bind failure) costs the
            # introspection plane, never the serving plane
            from ncnet_tpu_torch.serving.introspect import IntrospectionServer

            try:
                self._introspect = IntrospectionServer(
                    self, host=self.cfg.introspect_host,
                    port=self.cfg.introspect_port).start()
            except Exception as e:  # noqa: BLE001 — telemetry never
                # kills the service it observes
                self._introspect = None
                log.warning(
                    f"introspection endpoint failed to bind "
                    f"{self.cfg.introspect_host}:{self.cfg.introspect_port}"
                    f" ({type(e).__name__}: {e}); serving without "
                    "/metrics + /healthz", kind="io")
        obs_events.emit(
            "serve_start",
            max_queue=self.cfg.max_queue, max_batch=self.cfg.max_batch,
            retries=self.cfg.retries,
            default_deadline_s=self.cfg.default_deadline_s,
            fetch_timeout_s=self.cfg.fetch_timeout_s,
            replicas=[r.id for r in self._pool.replicas],
            # the SLO objectives ride in the log so run_report --slo can
            # replay a dead service with the exact live thresholds
            slo=self._slo.config(),
            introspect_port=(self._introspect.port
                             if self._introspect is not None else None),
        )
        if self.cfg.install_sigterm and \
                threading.current_thread() is threading.main_thread():
            self._old_sigterm = signal.signal(signal.SIGTERM, self._on_sigterm)
        for rep in self._pool.replicas:
            t = threading.Thread(target=self._fetch_loop, args=(rep,),
                                 name=f"match-fetch-{rep.id}", daemon=True)
            t.start()
            self._fetchers.append(t)
        self._worker = threading.Thread(
            target=self._run, name="match-serve", daemon=True)
        self._worker.start()
        # safety net for a process that exits without stop() (an unhandled
        # exception in the caller): settle the outstanding futures and join
        # the worker before interpreter teardown — a daemon thread killed
        # mid-dispatch can otherwise crash the exit
        import atexit

        atexit.register(self._atexit_stop)
        return self

    def _atexit_stop(self) -> None:
        w = self._worker
        if w is not None and w.is_alive():
            self.stop(drain=False, timeout=10.0)

    def _on_sigterm(self, signum, frame):
        # handler discipline (as the trainer's PreemptionHandler): flip a flag, write
        # via os.write (print from a handler can deadlock on the stream
        # lock), let the worker act at its next loop edge.  No lock here —
        # the main thread may hold self._cond inside submit() when the
        # signal lands.
        self._drain_requested = True
        os.write(2, b"[serving] received SIGTERM; draining in-flight "
                    b"requests, admission closed\n")

    def stop(self, drain: bool = True, timeout: Optional[float] = 30.0) -> None:
        """Stop the service.  ``drain=True`` (default) completes every
        admitted request first; ``drain=False`` aborts — queued and
        in-flight requests settle ``Overloaded(reason="shutdown")`` (still a
        classified terminal outcome, never a silent drop).  One caveat on
        the abort: a batch whose blocking device fetch has ALREADY begun
        completes normally first (a blocking fetch cannot be interrupted;
        configure ``fetch_timeout_s`` to bound that wait)."""
        with self._cond:
            if drain:
                self._begin_drain_locked("stop")
            else:
                # NOT _draining: an abort force-settles admitted work, and
                # the serve_drain event's `drained` flag must be able to
                # tell the two apart; admission closes via _stop_now
                self._stop_now = True
            self._cond.notify_all()
        w = self._worker
        if w is not None and w is not threading.current_thread():
            w.join(timeout)
        if self._old_sigterm is not None:
            signal.signal(signal.SIGTERM, self._old_sigterm)
            self._old_sigterm = None
        import atexit

        try:
            # the safety net registered by start() would otherwise hold a
            # strong reference (service + engines + staged params) for the
            # life of the process
            atexit.unregister(self._atexit_stop)
        except Exception:  # noqa: BLE001 — interpreter teardown ordering
            pass

    def request_drain(self, reason: str = "drain") -> None:
        """Close admission and finish admitted work (the SIGTERM path,
        callable programmatically); returns immediately — join via
        :meth:`stop` or poll :meth:`health`."""
        with self._cond:
            self._begin_drain_locked(reason)
            self._cond.notify_all()

    def _begin_drain_locked(self, reason: str) -> None:
        if self._draining:
            return
        self._draining = True
        if self._health.state != STOPPED:
            self._health.to(DRAINING, reason)

    def __enter__(self) -> "MatchService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def submit(self, src, tgt, *, deadline_s: Optional[float] = None,
               client: str = "default", trace: Optional[str] = None,
               _stream_fields: Optional[Dict[str, Any]] = None
               ) -> MatchFuture:
        """Admit one match query (raw uint8 pair).  Returns a
        :class:`MatchFuture`; raises :class:`Overloaded` (shed) or
        :class:`DeadlineExceeded` (budget already gone) synchronously —
        rejections are classified at the door, not discovered by timeout.
        ``trace`` adopts a pod-wide trace (a traceparent header or bare
        trace id — typically the wire's propagated context): every event
        this request touches then carries the trace id.  ``_stream_fields``
        is the private streaming seam (:meth:`stream_submit` passes the
        request's session/prior payload); external callers leave it None.
        """
        from ncnet_tpu_torch.observability.tracing import normalize_trace

        src = as_pair_image(src, "src")
        tgt = as_pair_image(tgt, "tgt")
        trace = normalize_trace(trace)
        now = time.monotonic()
        if deadline_s is None:
            deadline_s = self.cfg.default_deadline_s
        shed: Optional[Overloaded] = None
        expired = False
        req: Optional[MatchRequest] = None
        with self._cond:
            if self._worker is None or self._finishing or self._stop_now \
                    or self._health.state == STOPPED:
                # _finishing closes the submit/_finish race: once _finish
                # has collected the leftover queues, a late submit must
                # shed rather than enqueue work nobody will ever settle
                shed = Overloaded("service is not running", reason="stopped")
            elif self._draining or self._drain_requested:
                shed = Overloaded("service is draining", reason="draining")
            elif deadline_s is not None and deadline_s <= 0:
                expired = True
            else:
                depth = self._queued_locked()
                try:
                    # peek first, COMMIT only after admission passes: a
                    # shed request must not burn a bucket slot
                    bucket = self._bucketer.peek(
                        src.shape[:2], tgt.shape[:2])
                    self._admission.admit(client, depth)
                    self._bucketer.commit(bucket)
                except Overloaded as e:
                    shed = e
                else:
                    # RESERVE only — the request is not visible to the
                    # worker until phase 2 enqueues it, so its serve_admit
                    # event always reaches the log before any terminal
                    # event (negative unresolved counts would otherwise be
                    # possible after a crash in the emit window)
                    self._req_seq += 1
                    req = MatchRequest(
                        id=f"r{self._req_seq}", client=client, src=src,
                        tgt=tgt, bucket=bucket,
                        future=MatchFuture(f"r{self._req_seq}"),
                        submitted_t=now,
                        deadline_t=(now + deadline_s) if deadline_s
                        else None,
                        trace=trace,
                        **(_stream_fields or {}),
                    )
                    self._admission.note_admit(client)
                    self._n["admitted"] += 1
                    self._registry.counter("admitted").inc()
                    self._registry.gauge("queue_depth").set(depth + 1)
            if shed is not None:
                self._n["shed"] += 1
                self._registry.counter("shed").inc()
        # event emission OUTSIDE the lock: EventLog appends flush+fsync,
        # and an fsync held under the service lock would serialize every
        # client's admission (and the worker's queue operations) behind
        # the disk
        if expired:
            obs_events.emit("serve_deadline", request=None, client=client,
                            where="admission", admitted=False)
            raise DeadlineExceeded(
                f"deadline budget {deadline_s}s already expired at "
                "admission", where="admission")
        if shed is not None:
            obs_events.emit(
                "serve_shed", client=client, reason=shed.reason,
                retry_after_s=shed.retry_after_s, admitted=False,
            )
            raise shed
        obs_events.emit(
            "serve_admit", request=req.id, client=client,
            bucket=bucket_label(req.bucket),
            deadline_s=round(deadline_s, 6) if deadline_s else None,
            **({"trace": trace} if trace else {}),
        )
        # phase 2: make the admitted request visible to the worker.  If
        # the service died between the phases, the admitted request still
        # gets its terminal outcome here (nobody else can see it).
        with self._cond:
            dead = self._finishing or self._stop_now \
                or self._health.state == STOPPED
            if not dead:
                self._queues.setdefault(req.bucket, deque()).append(req)
                self._cond.notify_all()
        if dead:
            exc = Overloaded(
                f"service stopped before request {req.id} was queued",
                reason="stopped")
            req.future._settle("overloaded", error=exc)
            with self._cond:
                self._n["shed"] += 1
                self._registry.counter("shed").inc()
            obs_events.emit("serve_shed", request=req.id, client=client,
                            reason="stopped", admitted=True,
                            **({"trace": trace} if trace else {}))
            self._observe_slo(req, "shed")
            self._emit_timeline(req, "overloaded")
            self._terminal(req)
            raise exc
        return req.future

    # ------------------------------------------------------------------
    # streaming (serving/stream.py; README "Streaming matching")
    # ------------------------------------------------------------------

    def stream_submit(self, stream: str, src, tgt, *,
                      deadline_s: Optional[float] = None,
                      client: Optional[str] = None,
                      trace: Optional[str] = None):
        """Serve one frame of a video stream — BLOCKING (unlike
        :meth:`submit`): frame ``t+1``'s candidates are seeded from this
        frame's match table, so the data dependence forces one frame in
        flight per stream; concurrent streams overlap freely, and the
        session's FIFO lock extends the ordering guarantee to
        multi-threaded callers of one stream id.

        The fast path dispatches the engine's TRACKED program — zero
        coarse passes — when the session has a prior, the bucket is
        unchanged, and the shape class is eligible.  Cut/drift detection
        runs on the result (candidate-containment proxy + quality-EMA
        collapse); a detected cut re-runs the SAME frame through the full
        pipeline (``submit`` — the identical executable a cold query uses,
        so the fallback output is bitwise a cold query's), re-seeding the
        tracker.  Returns a :class:`~ncnet_tpu.serving.stream.
        StreamFrameResult`; raises the same classified errors as
        :meth:`submit`."""
        from ncnet_tpu_torch.serving.stream import StreamFrameResult

        client = client or f"stream:{stream}"
        sess = self._streams.acquire(stream)
        with sess.lock:
            try:
                out = self._stream_frame(sess, src, tgt, deadline_s, client,
                                         trace=trace)
            except ServeError:
                with self._cond:
                    sess.errors += 1
                raise
            finally:
                sess.last_activity = time.monotonic()
        self._registry.gauge("active_streams").set(
            self._streams.doc()["active"])
        assert isinstance(out, StreamFrameResult)
        return out

    def _stream_geom(self, bucket: Bucket):
        """(grid_a, grid_b, factor, radius) on the PADDED bucket, or None
        when no model config is attached (injected fake engines): the
        recall proxy and prior inversion are then skipped and the cut
        detector rides quality collapse alone."""
        mc = self._model_config
        if mc is None:
            return None
        from ncnet_tpu_torch.ops.temporal import FEATURE_STRIDE

        ga = tuple(d // FEATURE_STRIDE for d in bucket[0])
        gb = tuple(d // FEATURE_STRIDE for d in bucket[1])
        if min(*ga, *gb) <= 0:
            return None
        return ga, gb, mc.sparse_factor, mc.track_radius

    def _tracking_eligible(self, bucket: Bucket) -> bool:
        if not (self.cfg.stream_tracking and self._tracking_capable):
            return False
        eng = self._pool.replicas[0].engine
        feasible = getattr(eng, "tracking_feasible", None)
        if feasible is None:
            return True  # injected fakes: capability implies eligibility
        return bool(feasible(bucket[0], bucket[1]))

    def _stream_frame(self, sess, src, tgt, deadline_s, client,
                      trace: Optional[str] = None):
        from ncnet_tpu_torch.serving.stream import StreamFrameResult

        src = as_pair_image(src, "src")
        tgt = as_pair_image(tgt, "tgt")
        seq = sess.seq
        sess.seq += 1
        bucket = self._bucketer.peek(src.shape[:2], tgt.shape[:2])
        if sess.bucket is not None and bucket != sess.bucket:
            # resolution change: the prior's grids no longer describe the
            # frames — cold restart for this stream, never a stale gather
            sess.reset_tracking()
        sess.bucket = bucket
        geom = self._stream_geom(bucket)
        digest = None
        if self._tracking_capable:
            digest = sess.src_digest(
                src, bucket,
                lambda: pad_to_bucket([src], bucket[0])[0])
        tracked = (sess.prior_ab is not None
                   and self._tracking_eligible(bucket))
        fallback = False
        recall = None
        if tracked:
            fut = self.submit(
                src, tgt, deadline_s=deadline_s, client=client, trace=trace,
                _stream_fields=dict(
                    stream=sess.id, stream_seq=seq, tracked=True,
                    prior_ab=sess.prior_ab, prior_ba=sess.prior_ba,
                    src_digest=digest))
            res = fut.result()
            if geom is not None:
                from ncnet_tpu_torch.ops.temporal import tracking_recall_proxy

                ga, gb, factor, radius = geom
                recall = tracking_recall_proxy(
                    sess.prior_ab, res.table, ga, gb, factor, radius,
                    scale=self.cfg.scale)
                sess.last_recall = recall
            cut = (recall is not None
                   and recall < self.cfg.stream_cut_recall) \
                or sess.quality_collapsed(
                    res.quality, self.cfg.stream_cut_quality_frac)
            if cut:
                obs_events.emit(
                    "stream_cut", stream=sess.id, seq=seq,
                    recall=(round(recall, 4) if recall is not None
                            else None),
                    quality=res.quality,
                    bucket=bucket_label(bucket))
                self._registry.counter("stream_cuts").inc()
                # exact fallback: the SAME frame through the full
                # pipeline — the identical program a cold query runs, so
                # this output is bitwise a cold coarse-to-fine query's —
                # and the tracker re-seeds from its table below
                sess.reset_tracking()
                fut = self.submit(src, tgt, deadline_s=deadline_s,
                                  client=client, trace=trace,
                                  _stream_fields=dict(
                                      stream=sess.id, stream_seq=seq,
                                      src_digest=digest))
                res = fut.result()
                tracked, fallback = False, True
        else:
            fut = self.submit(src, tgt, deadline_s=deadline_s,
                              client=client, trace=trace,
                              _stream_fields=dict(
                                  stream=sess.id, stream_seq=seq,
                                  src_digest=digest))
            res = fut.result()
        # re-seed / roll the prior from the served table, warm the quality
        # baseline, and account the frame
        if geom is not None:
            from ncnet_tpu_torch.ops.temporal import prior_from_table

            ga, gb, factor, _radius = geom
            try:
                sess.prior_ab, sess.prior_ba = prior_from_table(
                    res.table, ga, gb, factor, scale=self.cfg.scale)
            except ValueError:
                # a table that doesn't invert (foreign engine shape) just
                # means the next frame runs the full pipeline
                sess.reset_tracking()
        sess.note_quality(res.quality)
        kind = "tracked" if tracked else (
            "fallback" if fallback else "cold")
        sess.frames += 1
        if tracked:
            sess.tracked_frames += 1
        elif fallback:
            sess.fallback_frames += 1
        else:
            sess.cold_frames += 1
        self._streams.note_frame(kind)
        self._registry.counter("stream_frames").inc()
        self._registry.counter(f"stream_frames_{kind}").inc()
        if recall is not None:
            self._registry.gauge("stream_recall").set(round(recall, 4))
        from ncnet_tpu_torch.observability.tracing import normalize_trace

        obs_events.emit(
            "stream_frame", stream=sess.id, seq=seq, kind=kind,
            tracked=tracked, fallback=fallback,
            recall=(round(recall, 4) if recall is not None else None),
            wall_ms=round(res.wall_s * 1e3, 3),
            bucket=bucket_label(bucket), client=client,
            **({"trace": normalize_trace(trace)} if trace else {}))
        return StreamFrameResult(result=res, stream=sess.id, seq=seq,
                                 tracked=tracked, fallback=fallback,
                                 recall=recall)

    def _evict_idle_streams(self) -> None:
        for sess in self._streams.evict_idle():
            obs_events.emit("stream_evict", stream=sess.id,
                            frames=sess.frames,
                            tracked=sess.tracked_frames,
                            fallback=sess.fallback_frames, reason="idle")

    # ------------------------------------------------------------------
    # probes
    # ------------------------------------------------------------------

    def health(self) -> Dict[str, Any]:
        """The unified, schema-versioned health document
        (``serving/health.py::build_health_document``): service state +
        transition history, pool capacity + per-replica rows, queue/
        in-flight depth + bucket ladder, outcome counters, the SLO
        error-budget snapshot, and the activity age.  The same dict serves
        ``/healthz``, the chaos tests, and the final ``serve_health_doc``
        event ``run_report --serving`` renders."""
        now = time.monotonic()
        with self._cond:
            return build_health_document(
                self._health,
                [r.probe() for r in self._pool.replicas],
                queue={
                    "depth": self._queued_locked(),
                    "inflight_batches": self._pool.inflight_total(),
                    "pipeline_depth": self._controller.depth,
                    "effective_max_queue":
                        self._admission.effective_max_queue(),
                    "buckets": [bucket_label(b)
                                for b in self._bucketer.buckets],
                },
                counters=dict(self._n),
                slo=self._slo.snapshot(),
                activity={
                    "age_s": round(max(0.0, now - self._activity_t), 3),
                    "batches": self._batch_seq,
                },
                memory=self._memory_doc_locked(),
                store=(self._store.health()
                       if self._store is not None else None),
                model_version=self._model_version,
                rollout=(self._rollout.status()
                         if self._rollout is not None else None),
                streams=self._streams.doc(now),
            )

    def _memory_doc_locked(self) -> Dict[str, Any]:
        """The health document's memory section: the bucket ladder's
        PREDICTED aggregate footprint (sum of ledger temp+output bytes over
        this process's warmed serve programs) set against the live
        ``bytes_limit``, plus the latest per-replica card watermarks — the
        headroom an operator reads BEFORE admitting a new bucket."""
        predicted = obs_memory.predicted_footprint_bytes(
            program=obs_memory.SERVE_PROGRAM)
        doc: Dict[str, Any] = {
            "predicted_ladder_bytes": predicted,
            "ledger_programs": len(obs_memory.ledger_rows(
                program=obs_memory.SERVE_PROGRAM)),
            "hbm": {rid: dict(s) for rid, s in sorted(self._hbm.items())},
        }
        limits = [s.get("bytes_limit") for s in self._hbm.values()
                  if isinstance(s.get("bytes_limit"), int)]
        if limits and predicted is not None:
            doc["headroom_bytes"] = min(limits) - predicted
        return doc

    @property
    def state(self) -> str:
        return self._health.state

    @property
    def introspect_url(self) -> Optional[str]:
        """Base URL of the live introspection plane (None when disabled or
        bind failed) — ``<url>/metrics`` etc."""
        return self._introspect.url if self._introspect is not None else None

    def metrics(self) -> Dict[str, Any]:
        return self._registry.snapshot()

    # ------------------------------------------------------------------
    # pool membership -> admission (the elastic-capacity seam)
    # ------------------------------------------------------------------

    def _on_pool_change(self, ready: int, total: int) -> None:
        """ReplicaPool membership callback (service lock already held —
        mark_dead/resurrect are only called under it).  Queue bounds and
        retry hints re-derive from live capacity; the health machine
        reflects pool strength: below full → DEGRADED, fully restored →
        back to READY (the pool owns that one recovery edge)."""
        self._admission.note_capacity(ready, total)
        self._registry.gauge("ready_replicas").set(ready)
        if self._health.state in (STARTING, READY) and ready < total:
            self._health.to(
                DEGRADED,
                "no_ready_replicas" if ready == 0
                else f"replicas_ready:{ready}/{total}")
        elif self._health.state == DEGRADED and ready == total:
            self._health.to(READY, "pool_restored")

    # ------------------------------------------------------------------
    # worker (dispatcher)
    # ------------------------------------------------------------------

    def _queued_locked(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def _run(self) -> None:
        crashed: Optional[BaseException] = None
        try:
            self._warmup()
            with self._cond:
                if self._health.state == STARTING:
                    self._health.to(READY, "warm")
            while True:
                if self._drain_requested:
                    self.request_drain("sigterm")
                # rate-limited device_snapshot on the worker tick: memory
                # pressure is visible in the event log even while the
                # service idles (before this, only `fit` ever emitted one)
                self._dev_monitor.maybe_emit(step=self._batch_seq)
                self._maybe_resurrect()
                self._evict_expired()
                self._evict_idle_streams()
                self._fill_pipeline()
                with self._cond:
                    if self._stop_now:
                        # an ABORT does not drain in-flight fetches: the
                        # replica backlogs settle Overloaded("shutdown") in
                        # _finish, as stop(drain=False) documents
                        break
                    busy = self._pool.inflight_total() > 0
                    if self._draining and not self._queued_locked() \
                            and not busy:
                        break
                    if not self._queued_locked() and not busy:
                        self._controller.note_gap()
                        # a deliberately idle pool is alive: advance the
                        # /healthz activity stamp exactly where the idle
                        # heartbeat fires (and even when no heartbeat file
                        # is configured), so a wedged fetch — with nothing
                        # else dispatching — stops BOTH liveness signals
                        self._activity_t = time.monotonic()
                        self._idle_beat()
                    # fetcher completions, submits, and stop/drain all
                    # notify; the timeout bounds resurrection-probe and
                    # deadline-eviction latency while idle
                    self._cond.wait(0.05)
        except BaseException as e:  # the worker must never die silently
            crashed = e
            log.error(f"serving worker crashed: {type(e).__name__}: {e}",
                      kind="device")
        finally:
            self._finish(crashed)

    def _idle_beat(self) -> None:
        """Keep the heartbeat fresh while IDLE (rate-limited to ~1/s): a
        quiet service must stay distinguishable from a wedged one — these
        beats fire only when no batch is queued or in flight anywhere in
        the pool, so a wedged fetch (with nothing else dispatching) stops
        the beats exactly when the stall watchdog should fire."""
        if self._heartbeat is None:
            return
        now = time.monotonic()
        if now - self._last_idle_beat >= 1.0:
            self._last_idle_beat = now
            self._heartbeat.beat(step=self._batch_seq,
                                 state=self._health.state, idle=True)

    def _batch_ladder(self) -> List[int]:
        """The padded batch sizes _dispatch can produce: powers of two up
        to (and always including) max_batch."""
        sizes, b = [], 1
        while b < self.cfg.max_batch:
            sizes.append(b)
            b *= 2
        sizes.append(self.cfg.max_batch)
        return sizes

    def _warmup(self) -> None:
        """Run the configured warm buckets (square pairs) at EVERY ladder
        batch size on EVERY replica before admitting traffic counts them as
        latency: the first run builds the kernels and lets cuDNN choose its
        algorithms for that shape on that replica's device.  Each run on a
        CUDA replica also measures the program's memory into the ledger
        (:meth:`_warm_one`).  Fail-open: a failed warm run logs and moves
        on — the first real request in that shape pays it instead."""
        for hw in self.cfg.warm_buckets:
            try:
                bucket = self._bucketer.register(tuple(hw), tuple(hw))
            except Exception as e:  # noqa: BLE001 — warmup is best-effort
                log.warning(f"warm bucket {hw} not registrable "
                            f"({type(e).__name__}: {e})", kind="device")
                continue
            warmed = []
            for rep in self._pool.replicas:
                try:
                    for b in self._batch_ladder():
                        self._warm_one(rep, bucket, b)
                    warmed.append(rep.id)
                except Exception as e:  # noqa: BLE001 — one replica's
                    # failed warm run must not cold-start the others
                    log.warning(f"warmup of bucket {hw} on {rep.id} failed "
                                f"({type(e).__name__}: {e}); its first "
                                "request pays the build", kind="device")
            obs_events.emit("serve_warm", bucket=bucket_label(bucket),
                            batch_sizes=self._batch_ladder(),
                            replicas=warmed)

    def _warm_one(self, rep: Replica, bucket: Bucket, b: int) -> None:
        """One warm run of ``bucket`` at batch ``b`` on ``rep``.  On a CUDA
        replica it records the program's ledger row (ROADMAP D9): the peak
        allocated over the dispatch less what was allocated before it,
        less the result, as the temp bytes; the result's bytes as the
        output; the uploaded pair as the arguments.  The caching allocator
        allocates when work is enqueued, so the peak is read without
        waiting for the card; the warm-up runs one replica at a time, so
        no other dispatch shares the window."""
        src = np.zeros((b, *bucket[0], 3), np.uint8)
        tgt = np.zeros((b, *bucket[1], 3), np.uint8)
        index = _cuda_index(rep.device)
        if index is None:
            rep.fetch(rep.dispatch(src, tgt))
            return
        import torch

        torch.cuda.reset_peak_memory_stats(index)
        before = torch.cuda.memory_allocated(index)
        handle = rep.dispatch(src, tgt)
        peak = torch.cuda.max_memory_allocated(index)
        out = handle.numel() * handle.element_size()
        rep.fetch(handle)
        obs_memory.record_program(
            obs_memory.SERVE_PROGRAM,
            f"{bucket[0][0]}x{bucket[0][1]}-{bucket[1][0]}x{bucket[1][1]}"
            f"xb{b}",
            analysis={"argument_bytes": src.nbytes + tgt.nbytes,
                      "output_bytes": out,
                      "temp_bytes": max(0, peak - before - out)},
            tier=self._active_tier(rep), source="warmup")

    def _evict_expired(self) -> None:
        """Evict deadline-expired QUEUED requests even when no replica can
        take a batch — _fill_pipeline's dequeue check never runs while the
        pool is unroutable (all replicas dead or at depth), and a parked
        request whose budget is gone must still settle the classified
        ``DeadlineExceeded(where="dequeue")``, not hang until resurrection
        or shutdown.  Cheap: a scan per worker tick, a rebuild only when
        something actually expired."""
        now = time.monotonic()
        expired: List[MatchRequest] = []
        with self._cond:
            if not any(req.expired(now)
                       for q in self._queues.values() for req in q):
                return
            for bucket in list(self._queues):
                keep: Deque[MatchRequest] = deque()
                for req in self._queues[bucket]:
                    (expired if req.expired(now) else keep).append(req)
                if keep:
                    self._queues[bucket] = keep
                else:
                    del self._queues[bucket]
        for req in expired:
            self._resolve_deadline(req, "dequeue")

    def _fill_pipeline(self) -> None:
        """Dispatch batches until every READY replica's pipeline is full or
        the queue is empty — dispatching the NEXT batch while previous
        fetches are in flight is the continuous-batching overlap itself,
        and routing picks the least-loaded healthy replica per batch."""
        while True:
            expired: List[MatchRequest] = []
            batch: List[MatchRequest] = []
            bucket: Optional[Bucket] = None
            replica: Optional[Replica] = None
            with self._cond:
                if self._stop_now:
                    return
                if self._drain_requested:
                    # a SIGTERM closes admission at the next batch edge,
                    # not only at the worker's loop edge: a dispatch that
                    # waits on the host (a pinned-buffer allocation, a full
                    # launch queue) can keep this loop filling the
                    # pipeline for the whole backlog, and the health
                    # document must say DRAINING while that backlog drains
                    self._begin_drain_locked("sigterm")
                bucket = self._pick_bucket_locked()
                if bucket is None:
                    return
                q = self._queues[bucket]
                # route BEFORE popping: an unroutable batch (every replica
                # busy or dead) stays queued instead of bouncing.  The
                # head request's failed-on set is the exclusion hint — a
                # requeued failed batch sits contiguously at the front, so
                # the head's history speaks for the batch.
                replica = self._pool.route(
                    max_load=self._controller.depth,
                    exclude=frozenset(q[0].failed_on))
                if replica is None:
                    return
                now = time.monotonic()
                while q and len(batch) < self.cfg.max_batch:
                    # tracked-homogeneous coalescing: a tracked and a plain
                    # request cannot share a program, so peek BEFORE
                    # popping and stop at the first flag flip — the
                    # minority flavor leads the next batch instead of
                    # bouncing
                    if batch and q[0].tracked != batch[0].tracked:
                        break
                    req = q.popleft()
                    # deadline check at DEQUEUE: an expired request is
                    # evicted before it can waste a device slot
                    (expired if req.expired(now) else batch).append(req)
                if not q:
                    del self._queues[bucket]
            for req in expired:
                self._resolve_deadline(req, "dequeue")
            if not batch:
                if expired:
                    continue  # the queue may hold more work behind evictions
                return
            with self._cond:
                self._processing = batch  # crash accounting (see _finish)
            self._dispatch(batch, bucket, replica)
            with self._cond:
                self._processing = None

    def _pick_bucket_locked(self) -> Optional[Bucket]:
        """Oldest-head-first across buckets: global FIFO fairness at batch
        granularity (a hot bucket cannot starve a cold one)."""
        best = None
        for bucket, q in self._queues.items():
            if q and (best is None
                      or q[0].submitted_t < self._queues[best][0].submitted_t):
                best = bucket
        return best

    def _dispatch(self, batch: List[MatchRequest], bucket: Bucket,
                  replica: Replica) -> None:
        # the BATCH dimension is bucketed too (next power of two, capped at
        # max_batch): without it every distinct coalesced size 1..max_batch
        # is a shape of its own per bucket, and the first occurrence of
        # each size pays its kernel builds and cuDNN algorithm search on
        # the live stream — the spike the warm-up exists to prevent.
        # Rows beyond len(batch) are zero padding; _drain_batch indexes
        # results by request position and never reads them.
        b = 1
        while b < len(batch):
            b *= 2
        b = min(b, self.cfg.max_batch)
        npad = b - len(batch)
        tracked = batch[0].tracked
        if tracked:
            # padding REPLICATES row 0 (not zeros): a tracked pad row must
            # carry a valid prior, and repeating the head's image keeps
            # the digest-memoized feature resolve a pure cache hit instead
            # of hashing + extracting a zero image per dispatch
            src = pad_to_bucket(
                [r.src for r in batch] + [batch[0].src] * npad, bucket[0])
            tgt = pad_to_bucket(
                [r.tgt for r in batch] + [batch[0].tgt] * npad, bucket[1])
            prior_ab = np.stack(
                [r.prior_ab for r in batch]
                + [batch[0].prior_ab] * npad).astype(np.int32)
            prior_ba = np.stack(
                [r.prior_ba for r in batch]
                + [batch[0].prior_ba] * npad).astype(np.int32)
            digests = ([r.src_digest for r in batch]
                       + [batch[0].src_digest] * npad)
        else:
            pad = [None] * npad
            src = pad_to_bucket(
                [r.src for r in batch] + pad, bucket[0])
            tgt = pad_to_bucket(
                [r.tgt for r in batch] + pad, bucket[1])
            digests = [r.src_digest for r in batch] + [None] * npad
        try:
            if tracked:
                handle = replica.dispatch_tracked(
                    src, tgt, prior_ab, prior_ba, src_digests=digests)
            elif any(d is not None for d in digests):
                handle = replica.dispatch(src, tgt, src_digests=digests)
            else:
                handle = replica.dispatch(src, tgt)
        except Exception as e:
            self._on_batch_failure(batch, e, phase="dispatch",
                                   replica=replica)
            return
        # trace-timeline stamps: queue phase ends here; a failover
        # re-dispatch re-stamps (the attribution covers the terminating
        # attempt, the queue segment absorbs earlier failed round trips)
        now_dispatch = time.monotonic()
        for req in batch:
            req.dispatched_t = now_dispatch
            req.fetch_begin_t = None
        self._batch_seq += 1
        if self._heartbeat is not None:
            # the liveness contract (tools/stall_watchdog.py): one beat per
            # dispatched batch, POOL-wide — a wedged replica stops the
            # beats only when no survivor is dispatching either
            self._heartbeat.beat(step=self._batch_seq,
                                 state=self._health.state)
        # live card-memory watermark, sampled per dispatched batch (a
        # cheap host call).  A replica without a CUDA device (the CPU, or
        # engine-injection pools) is NOT sampled: defaulting to device 0
        # would attribute one card's watermarks to every lane
        index = _cuda_index(replica.device)
        hbm = obs_memory.hbm_stats(index) if index is not None else None
        with self._cond:
            self._activity_t = now_dispatch  # /healthz liveness signal
            if hbm is not None:
                self._hbm[replica.id] = hbm
                self._registry.gauge(
                    f"hbm_bytes_in_use_{replica.id}").set(
                        hbm.get("bytes_in_use"))
            replica.last_bucket = bucket
            replica.pending.append(
                _InFlight(handle, batch, bucket, replica, time.monotonic(),
                          self._batch_seq))
            self._registry.gauge("queue_depth").set(self._queued_locked())
            self._cond.notify_all()  # wake the replica's fetcher

    # ------------------------------------------------------------------
    # fetchers (one thread per replica)
    # ------------------------------------------------------------------

    def _fetch_loop(self, replica: Replica) -> None:
        """One replica's fetch lane: blocks on that replica's oldest
        in-flight batch, settles its requests, hands failures to the
        shared failover path.  A wedged chip therefore stalls only its own
        lane — survivors keep draining theirs."""
        while True:
            inf: Optional[_InFlight] = None
            with self._cond:
                while not replica.pending and not self._fetchers_stop:
                    self._cond.wait(0.2)
                if self._fetchers_stop:
                    # batches still pending here are dispatched-but-never-
                    # fetched: _finish settles them as classified sheds
                    # (the stop(drain=False) contract)
                    return
                inf = replica.pending.popleft()
                replica.processing = inf.batch
            try:
                self._drain_batch(inf)
            finally:
                with self._cond:
                    replica.processing = None
                    self._cond.notify_all()  # capacity freed: wake dispatcher

    def _drain_batch(self, inf: _InFlight) -> None:
        from ncnet_tpu_torch.evaluation.pipeline import call_with_watchdog

        fetch_begin = time.monotonic()
        for req in inf.batch:
            req.fetch_begin_t = fetch_begin  # device phase ends here
        try:
            table = call_with_watchdog(
                inf.replica.fetch, (inf.handle,),
                timeout=self.cfg.fetch_timeout_s, label="serve_fetch",
            )
        except Exception as e:
            self._on_batch_failure(inf.batch, e, phase="fetch",
                                   replica=inf.replica)
            return
        now = time.monotonic()
        wall = now - inf.t0
        rid = inf.replica.id
        with self._cond:
            self._controller.note_drain()
            self._admission.note_batch_wall(wall)
            inf.replica.note_success(wall)
            qd = self._queued_locked()
            inflight = self._pool.inflight_total()
            self._registry.counter("batches").inc()
            self._registry.counter(f"replica_batches_{rid}").inc()
            self._registry.timer("batch_wall_s").observe(wall)
            self._registry.histogram(
                f"replica_wall_ms_{rid}", 0.0, self.cfg.latency_hist_ms,
            ).add(wall * 1e3)
        obs_events.emit(
            "serve_batch", bucket=bucket_label(inf.bucket),
            size=len(inf.batch), wall_s=round(wall, 6), queue_depth=qd,
            inflight=inflight, seq=inf.seq, replica=rid,
        )
        # leak sentinel census at the batch boundary (rate-limited inside;
        # a growing shape class emits memory_leak_suspect)
        self._leak.observe(step=inf.seq)
        tables, quality = self._split_table(inf.replica, table)
        tier = self._active_tier(inf.replica)
        # which model generation produced this batch — stamped on every
        # result/quality event and per-version metric so the canary judge
        # can split old from new
        ver = inf.replica.model_version
        if quality:
            from ncnet_tpu_torch.utils import faults

            # chaos seam: shift the NEW version's quality signals so the
            # canary judge's PSI gate has a real regression to catch
            quality = faults.canary_quality_shift_hook(ver, quality)
        for i, req in enumerate(inf.batch):
            if req.expired(now):
                # deadline check at FETCH: the caller's budget is gone —
                # the computed result is discarded, the outcome classified
                self._resolve_deadline(req, "fetch")
                continue
            req_wall = now - req.submitted_t
            result = MatchResult(
                request_id=req.id, table=np.array(tables[i]),
                quality=quality[i] if quality else None,
                bucket=inf.bucket, wall_s=req_wall,
            )
            if not req.future._try_settle("result", result=result):
                continue  # settled elsewhere (abandoned-fetch abort path)
            with self._cond:
                self._n["results"] += 1
                self._registry.counter("results").inc()
                self._registry.counter(f"version_results_{ver}").inc()
                self._registry.histogram(
                    f"serve_wall_ms_{bucket_label(inf.bucket)}",
                    0.0, self.cfg.latency_hist_ms,
                ).add(req_wall * 1e3)
                self._registry.histogram(
                    f"version_wall_ms_{ver}",
                    0.0, self.cfg.latency_hist_ms,
                ).add(req_wall * 1e3)
            wall_ms = round(req_wall * 1e3, 3)
            obs_events.emit(
                "serve_result", request=req.id, client=req.client,
                bucket=bucket_label(inf.bucket),
                wall_ms=wall_ms, batch_size=len(inf.batch),
                replica=rid, model_version=ver,
                **({"trace": req.trace} if req.trace else {}),
            )
            # SLO judged on the SAME rounded wall the event records, so
            # run_report --slo replaying the log reclassifies identically
            self._observe_slo(req, "result", wall_ms=wall_ms)
            self._emit_timeline(req, "result", replica=rid)
            if quality:
                from ncnet_tpu_torch.observability.quality import emit_quality

                emit_quality("serving", quality[i], tier=tier,
                             registry=self._registry, request=req.id,
                             replica=rid, model_version=ver)
            rollout = self._rollout
            if rollout is not None:
                # feed the canary judge (controller takes its OWN lock;
                # never called under self._cond — see rollout.py)
                rollout.observe_result(
                    ver, wall_ms, quality[i] if quality else None)
            self._terminal(req)

    @staticmethod
    def _split_table(replica: Replica, table) -> Tuple[Any, Any]:
        split = getattr(replica.engine, "split", None)
        if split is not None:
            return split(np.asarray(table))
        from ncnet_tpu_torch.serving.engine import BatchMatchEngine

        return BatchMatchEngine.split(np.asarray(table))

    def _active_tier(self, replica: Replica) -> str:
        from ncnet_tpu_torch.observability.quality import active_tier

        return active_tier(getattr(replica.engine, "half_precision", False))

    # ------------------------------------------------------------------
    # failure handling (failover ladder)
    # ------------------------------------------------------------------

    def _on_batch_failure(self, batch: List[MatchRequest],
                          exc: Exception, phase: str,
                          replica: Replica) -> None:
        """One failed batch on one replica (dispatch raised, fetch raised,
        or the fetch watchdog fired).  The failover ladder, per request:

          1. a surviving READY replica this request has NOT failed on →
             requeue at the FRONT, re-routed OFF-budget (the failure is the
             replica's fault; zero lost requests);
          2. no READY replica at all (the pool is dead) → requeue
             off-budget and WAIT — resurrection probes are the recovery,
             and new admissions shed ``no_capacity`` meanwhile;
          3. otherwise (single-replica pool, or failed everywhere) the
             request's bounded budget is charged and the same program runs
             again; exhausted requests quarantine.  The JAX service first
             tries a demote-and-retrace that retries free; the port has no
             such step (ROADMAP D4).

        Repeated failures quarantine the REPLICA: ``replica_max_failures``
        consecutive failures move it to DEAD (router stops sending traffic,
        admission capacity shrinks, resurrection probes begin)."""
        from ncnet_tpu_torch.evaluation.resilience import classify_failure

        kind = classify_failure(exc)
        # an out-of-memory batch failure is a MEMORY failure: bundle the
        # device snapshot, the failed program's ledger rows, and the
        # live-tensor census into ONE memory_postmortem (idempotent: a
        # failover re-dispatch may see the same exception again)
        obs_memory.report_oom(
            exc, program=obs_memory.SERVE_PROGRAM, scope="serving",
            replica=replica.id, phase=phase,
            bucket=bucket_label(batch[0].bucket) if batch else None)
        with self._cond:
            self._controller.note_failure()
            replica.note_failure()
            self._registry.counter(f"replica_failures_{replica.id}").inc()
            self._registry.counter(
                f"version_failures_{replica.model_version}").inc()
            if replica.state == REPLICA_READY and \
                    replica.consecutive_failures >= \
                    self.cfg.replica_max_failures:
                log.warning(
                    f"replica {replica.id} hit "
                    f"{replica.consecutive_failures} consecutive failures "
                    f"({kind}); quarantined DEAD — resurrection probes "
                    f"every {self.cfg.resurrect_after_s}s", kind=kind)
                self._pool.mark_dead(replica, f"{kind}:{type(exc).__name__}")
            pending = [r for r in batch if not r.future.done()]
            for req in pending:
                req.failed_on.add(replica.id)
            survivors = [r for r in self._pool.ready() if r is not replica]
            any_ready = bool(self._pool.ready())
        rollout = self._rollout
        if rollout is not None:
            rollout.observe_failure(replica.model_version)
        requeue: List[MatchRequest] = []
        quarantine: List[MatchRequest] = []
        for req in pending:
            fresh = any(r.id not in req.failed_on for r in survivors)
            if fresh:
                obs_events.emit("retry", unit=req.id, kind=kind,
                                on_budget=False, scope="serving",
                                replica=replica.id, via="reroute")
                requeue.append(req)
                continue
            if not any_ready:
                # the whole pool is dead: park the work off-budget behind
                # the resurrection probes — availability degraded, nothing
                # lost
                obs_events.emit("retry", unit=req.id, kind=kind,
                                on_budget=False, scope="serving",
                                replica=replica.id,
                                via="awaiting_capacity")
                requeue.append(req)
                continue
            req.attempts += 1
            if req.attempts <= self.cfg.retries:
                obs_events.emit("retry", unit=req.id, kind=kind,
                                attempt=req.attempts, on_budget=True,
                                scope="serving", replica=replica.id)
                requeue.append(req)
            else:
                quarantine.append(req)
        if requeue:
            for req in requeue:
                # the failed attempt's timeline stamps are dead evidence: a
                # requeued request is QUEUED again (re-stamped at its next
                # dispatch), and one that terminates while parked — e.g. a
                # deadline eviction behind an all-dead pool — must
                # attribute the wait to the queue phase, not to a fetch
                # that never completed
                req.dispatched_t = None
                req.fetch_begin_t = None
            routes = {r.id for r in survivors} or {"(awaiting capacity)"}
            log.warning(
                f"serving batch {phase} failed on {replica.id} ({kind}: "
                f"{type(exc).__name__}: {exc}); {len(requeue)} request(s) "
                f"requeued at the front (candidates: {sorted(routes)})",
                kind=kind)
            with self._cond:
                q = self._queues.setdefault(requeue[0].bucket, deque())
                q.extendleft(reversed(requeue))
                self._cond.notify_all()
        for req in quarantine:
            self._quarantine(req, kind, exc)

    def _quarantine(self, req: MatchRequest, kind: str,
                    exc: Exception) -> None:
        msg = (f"request {req.id} gave up after {req.attempts} attempt(s): "
               f"{type(exc).__name__}: {exc}")
        if not req.future._try_settle("quarantined", error=RequestQuarantined(
                msg, kind=kind, attempts=req.attempts)):
            return
        log.warning(f"{msg} — quarantined; the stream continues",
                    kind="quarantine")
        with self._cond:
            self._n["quarantined"] += 1
            self._registry.counter("quarantined").inc()
        obs_events.emit("serve_quarantine", request=req.id,
                        client=req.client, kind=kind,
                        attempts=req.attempts, error=str(exc)[:300],
                        **({"trace": req.trace} if req.trace else {}))
        self._observe_slo(req, "quarantined")
        self._emit_timeline(req, "quarantined")
        if self._manifest is not None:
            self._manifest.quarantine(req.id, kind, str(exc), req.attempts)
        self._terminal(req)

    def _resolve_deadline(self, req: MatchRequest, where: str) -> None:
        if not req.future._try_settle("deadline", error=DeadlineExceeded(
                f"request {req.id} deadline expired at {where}",
                where=where)):
            return
        with self._cond:
            self._n["deadline"] += 1
            self._registry.counter("deadline_exceeded").inc()
        obs_events.emit("serve_deadline", request=req.id, client=req.client,
                        where=where, admitted=True,
                        **({"trace": req.trace} if req.trace else {}))
        self._observe_slo(req, "deadline")
        self._emit_timeline(req, "deadline", where=where)
        self._terminal(req)

    # ------------------------------------------------------------------
    # SLO accounting + per-request trace timelines (every settle path
    # passes through these right after its terminal event)
    # ------------------------------------------------------------------

    def _observe_slo(self, req: MatchRequest, outcome: str,
                     wall_ms: Optional[float] = None) -> None:
        """Feed one admitted terminal outcome to the error-budget tracker
        (under the service lock, like every counter) and emit the periodic
        ``slo`` event OUTSIDE it — the fsync must not serialize admission."""
        with self._cond:
            due = self._slo.observe(
                outcome, bucket=bucket_label(req.bucket), wall_ms=wall_ms)
            snap = self._slo.snapshot() if due else None
        if snap is not None:
            obs_events.emit("slo", **snap)

    def _emit_timeline(self, req: MatchRequest, outcome: str, *,
                       replica: Optional[str] = None,
                       where: Optional[str] = None) -> None:
        """One ``request_timeline`` event per terminal outcome: the
        queue/device/fetch attribution (``MatchRequest.timeline_ms`` — the
        segments SUM to ``total_ms`` by construction) plus the wall-clock
        submission instant ``t0``, so ``tools/trace_export.py`` can lay the
        request out as Perfetto async slices keyed by its id."""
        now_m = time.monotonic()
        # t0 reconstructs the wall-clock submission instant from the
        # monotonic age — through wall_now(), so an injected clock skew
        # shifts the timeline exactly like every other stamp this process
        # publishes (the federation's skew correction must see ONE clock)
        fields: Dict[str, Any] = dict(
            request=req.id, client=req.client,
            bucket=bucket_label(req.bucket), outcome=outcome,
            attempts=req.attempts,
            t0=round(obs_events.wall_now() - (now_m - req.submitted_t), 6),
        )
        if req.trace:
            fields["trace"] = req.trace
        if replica is not None:
            fields["replica"] = replica
        if where is not None:
            fields["where"] = where
        # every caller settled the request first; the timeline ends at that
        # settle, not here: the terminal event and its fsync come between,
        # and by then the caller may hold its reply
        fields.update(req.timeline_ms(req.future.settled_t))
        obs_events.emit("request_timeline", **fields)

    def _terminal(self, req: MatchRequest) -> None:
        """Close one admitted request's accounting (every settle path ends
        here — the exactly-one-outcome bar)."""
        with self._cond:
            self._admission.note_done(req.client)
        if self._draining:
            with self._cond:
                self._drain_resolved += 1
                n = self._drain_resolved
            from ncnet_tpu_torch.utils import faults

            # chaos seam: SIGKILL after the Nth terminal outcome of the
            # drain phase (tests prove the event log still accounts for
            # everything that had no outcome yet)
            faults.serve_drain_kill_hook(n)

    # ------------------------------------------------------------------
    # live rollout seam (serving/rollout.py drives these; each method
    # takes the service lock itself — the controller NEVER holds its own
    # lock while calling in, and the service never calls controller
    # methods under self._cond except status()/observe_* which take only
    # the controller's lock: one consistent lock order, no deadlock)
    # ------------------------------------------------------------------

    def attach_rollout(self, controller) -> None:
        self._rollout = controller

    def detach_rollout(self) -> None:
        self._rollout = None

    def start_rollout(self, candidate: str, config=None):
        """Kick a rollout to ``candidate`` (a checkpoint dir or versioned
        root) on a background thread — the POST /rollout entry point.
        Returns the attached controller; raises if one is already live."""
        from ncnet_tpu_torch.serving.rollout import (RolloutConfig,
                                                     RolloutController)

        with self._cond:
            if self._rollout_thread is not None \
                    and self._rollout_thread.is_alive():
                raise RuntimeError("a rollout is already in progress")
        ctl = RolloutController(self, config or RolloutConfig(),
                                loader=self.rollout_loader)
        t = threading.Thread(target=ctl.run, args=(candidate,),
                             name="match-rollout", daemon=True)
        self._rollout_thread = t
        t.start()
        return ctl

    def rollout_pick_canary(self) -> Replica:
        """The replica staging borrows: READY with the lowest load.  A
        pool with fewer than two READY replicas refuses — draining the
        sole survivor would trade a model update for an outage."""
        with self._cond:
            ready = self._pool.ready()
            if len(ready) < 2:
                raise RuntimeError(
                    f"rollout needs >= 2 READY replicas to keep serving "
                    f"during the swap (have {len(ready)})")
            return min(ready, key=lambda r: r.load)

    def rollout_drain(self, rep: Replica, timeout_s: float) -> bool:
        """DRAINING + wait for the replica's in-flight batches to finish.
        Returns False on timeout (the replica is left DRAINING for the
        caller to re-admit or roll back)."""
        with self._cond:
            self._pool.drain_for_swap(rep, "rollout_swap")
            self._cond.notify_all()
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while rep.load > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(min(0.2, remaining))
        return True

    def rollout_swap(self, rep: Replica, params, version: str, *,
                     detach_store: bool = False) -> None:
        """Swap one DRAINED replica's weights and warm it off the dispatch
        path: ``engine.swap_params`` stages the new tree on the replica's
        device, then the registered bucket ladder runs at every batch size
        on this thread, re-recording each program's memory-ledger row on a
        card as the start-up warm-up does (:meth:`_warm_one`).  The
        ``kill_at_weight_swap`` chaos seam fires between the staging and
        the version stamp: a SIGKILL there leaves the pod restartable on
        the OLD version (the state file's pointer only advances at
        COMPLETE).  A failed swap or warm run raises into the rollout's
        rollback; nothing carries on on another device."""
        from ncnet_tpu_torch.utils import faults

        engine = rep.engine
        swap = getattr(engine, "swap_params", None)
        if swap is None:
            raise RuntimeError(
                f"replica {rep.id} engine cannot swap params")
        fast0 = getattr(engine, "swap_fastpath_hits", 0)
        t0 = time.perf_counter()
        swap(params)
        # host wall of the staging (the copies themselves finish on the
        # device's stream, ahead of the warm-up's first dispatch)
        swap_ms = round((time.perf_counter() - t0) * 1e3, 3)
        fastpath = getattr(engine, "swap_fastpath_hits", 0) > fast0
        faults.weight_swap_kill_hook()
        if detach_store and hasattr(engine, "attach_store"):
            # new weights must not commit features into the old
            # fingerprint's generation (cache poisoning); recompute-only
            # until the pod converges and the store generation advances
            engine.attach_store(None)
        with self._cond:
            rep.model_version = version
            buckets = list(self._bucketer.buckets)
        warmed = []
        t0 = time.perf_counter()
        # swap_ms and warm_ms are the port's additive fields of the event
        try:
            for bucket in buckets:
                for b in self._batch_ladder():
                    self._warm_one(rep, bucket, b)
                warmed.append(bucket_label(bucket))
        except Exception:
            obs_events.emit("rollout_swap", replica=rep.id, version=version,
                            warmed=warmed, fastpath=fastpath, ok=False,
                            swap_ms=swap_ms)
            raise
        obs_events.emit("rollout_swap", replica=rep.id, version=version,
                        warmed=warmed, fastpath=fastpath, ok=True,
                        swap_ms=swap_ms,
                        warm_ms=round((time.perf_counter() - t0) * 1e3, 3))

    def rollout_readmit(self, rep: Replica, reason: str) -> None:
        with self._cond:
            self._pool.resurrect(rep, reason=reason)
            self._cond.notify_all()

    def rollout_set_canary(self, rep: Replica, fraction: float) -> None:
        with self._cond:
            self._pool.set_canary(rep, fraction)
            self._cond.notify_all()

    def rollout_clear_canary(self) -> None:
        with self._cond:
            self._pool.clear_canary()
            self._cond.notify_all()

    def rollout_replicas(self) -> List[Replica]:
        with self._cond:
            return list(self._pool.replicas)

    def rollout_set_version(self, version: str, params) -> None:
        """The pod's converged identity: health docs and future replicas
        report ``version``; ``params`` become what a later rollback (or
        the next rollout's old side) swaps back to."""
        with self._cond:
            self._model_version = version
            self._model_params = params

    def rollout_switch_store(self, params) -> None:
        """Advance the shared feature store to the new weights' fingerprint
        generation (the port's, naming the device's program: ROADMAP D8)
        and re-attach it to every engine (promotion committed), GC'ing
        superseded generations with the configured grace so the rollback
        target's cache survives.  No store configured = no-op."""
        old = self._store
        if old is None:
            return
        from ncnet_tpu_torch.store import FeatureStore, backbone_fingerprint

        mc = self._model_config
        fp = backbone_fingerprint(
            params, image_size="serve",
            k_size=max(mc.relocalization_k_size, 1) if mc is not None else 1,
            dtype="bf16" if mc is not None and mc.half_precision else "f32",
            device=self._store_device)
        if fp == old.fingerprint:
            # same backbone (an NC-filter-only fine-tune): the generation
            # is still valid everywhere — just re-attach where detached
            new = old
        else:
            new = FeatureStore(old.root, fp, budget_bytes=old.budget_bytes,
                               scope="serving")
        with self._cond:
            self._store = new
            for rep in self._pool.replicas:
                if hasattr(rep.engine, "attach_store"):
                    rep.engine.attach_store(new)
        if new is not old:
            old.flush_stats()
            old.close()

    def rollout_reattach_store(self) -> None:
        """Rollback path: the store generation never advanced — re-attach
        the existing store to any engine the canary swap detached."""
        if self._store is None:
            return
        with self._cond:
            for rep in self._pool.replicas:
                if hasattr(rep.engine, "attach_store"):
                    rep.engine.attach_store(self._store)

    def rollout_gc_store(self, keep_generations: int) -> None:
        if self._store is not None:
            self._store.gc_superseded(keep_generations=keep_generations)

    @property
    def model_version(self) -> str:
        return self._model_version

    # ------------------------------------------------------------------
    # resurrection probes
    # ------------------------------------------------------------------

    def _maybe_resurrect(self) -> None:
        """Schedule resurrection probes for DEAD replicas whose period has
        elapsed.  Each probe (a tiny zero pair at the replica's last, or
        smallest known, bucket) runs on its OWN daemon thread — a probe at
        a replica that hangs instead of erroring must not stall the
        dispatcher, which would wedge every healthy lane behind a dead
        chip's silence.  Success returns the replica to READY and its
        capacity to admission; failure leaves it DEAD until the next
        period.  Probes run during DRAINING too — a drain stuck behind a
        dead pool NEEDS the resurrection to finish its admitted work."""
        if self._stop_now:
            return
        now = time.monotonic()
        with self._cond:
            due = self._pool.due_probes(now, self.cfg.resurrect_after_s)
            buckets = self._bucketer.buckets
        for rep in due:
            bucket = rep.last_bucket or (buckets[0] if buckets else None)
            if bucket is None:
                m = self.cfg.bucket_multiple
                bucket = ((m, m), (m, m))
            threading.Thread(
                target=self._probe_replica, args=(rep, bucket),
                name=f"match-probe-{rep.id}", daemon=True,
            ).start()

    def _probe_replica(self, rep: Replica, bucket: Bucket) -> None:
        ok, err = True, None
        try:
            from ncnet_tpu_torch.evaluation.pipeline import call_with_watchdog

            src = np.zeros((1, *bucket[0], 3), np.uint8)
            tgt = np.zeros((1, *bucket[1], 3), np.uint8)
            handle = rep.dispatch(src, tgt)
            call_with_watchdog(rep.fetch, (handle,),
                               timeout=self.cfg.fetch_timeout_s,
                               label="resurrect_probe")
        except Exception as e:  # noqa: BLE001 — a failed probe only
            # means the replica stays dead until the next period
            ok, err = False, f"{type(e).__name__}: {e}"
        obs_events.emit("serve_replica_probe", replica=rep.id, ok=ok,
                        error=err and err[:200],
                        bucket=bucket_label(bucket))
        with self._cond:
            rep.probing = False
            if ok:
                self._pool.resurrect(rep)
            self._cond.notify_all()
        if ok:
            log.info(f"replica {rep.id} resurrected (probe ok); "
                     "rejoining the pool", kind="device")

    # ------------------------------------------------------------------
    # shutdown
    # ------------------------------------------------------------------

    def _finish(self, crashed: Optional[BaseException]) -> None:
        with self._cond:
            self._finishing = True  # admission closed before collection
            self._fetchers_stop = True
            self._cond.notify_all()
        for t in self._fetchers:
            # a fetch that already began completes normally (a blocking
            # fetch cannot be interrupted); the join is bounded so a hung
            # fetch without a watchdog cannot wedge shutdown — its batch is
            # then force-settled below and the late fetch result discarded
            # (the done() guards in _drain_batch)
            t.join(10.0)
        with self._cond:
            leftovers: List[MatchRequest] = []
            for q in self._queues.values():
                leftovers.extend(q)
            self._queues.clear()
            for rep in self._pool.replicas:
                for inf in rep.pending:
                    leftovers.extend(inf.batch)
                rep.pending.clear()
                if rep.processing:
                    # the batch a hung (or crashed) fetcher still holds
                    leftovers.extend(rep.processing)
                    rep.processing = None
            if self._processing:
                # the batch the worker held when it crashed — in no queue
                # and no replica's backlog
                leftovers.extend(self._processing)
                self._processing = None
        reason = "crashed" if crashed is not None else "shutdown"
        for req in leftovers:
            # an aborted shutdown (or a worker crash) still settles every
            # admitted request with a classified outcome; _try_settle keeps
            # this atomic against a hung fetcher that outlived the bounded
            # join and is only now landing its results
            if not req.future._try_settle("overloaded", error=Overloaded(
                    f"service stopped before request {req.id} completed",
                    reason=reason)):
                continue  # settled before the crash interrupted its batch
            self._n["shed"] += 1
            obs_events.emit("serve_shed", request=req.id, client=req.client,
                            reason=reason, admitted=True,
                            **({"trace": req.trace} if req.trace else {}))
            self._observe_slo(req, "shed")
            self._emit_timeline(req, "overloaded")
            self._terminal(req)
        for sess in self._streams.evict_all():
            obs_events.emit("stream_evict", stream=sess.id,
                            frames=sess.frames,
                            tracked=sess.tracked_frames,
                            fallback=sess.fallback_frames, reason="drain")
        obs_events.emit(
            "serve_drain", drained=self._draining and crashed is None,
            leftover=len(leftovers), **{f"n_{k}": v
                                        for k, v in self._n.items()},
        )
        # the FINAL slo event: the cumulative budget counters every replay
        # consumer (run_report --slo) must reproduce exactly from the
        # terminal events above it in this same log
        obs_events.emit("slo", final=True, **self._slo.snapshot())
        if self._store is not None:
            # the durable per-run store stats (run_report --store replays
            # them); the journal handle closes with the service
            self._store.flush_stats()
            self._store.close()
        self._registry.flush(scope="serving")
        with self._cond:
            if self._health.state != STOPPED:
                self._health.to(
                    STOPPED, "crashed" if crashed is not None else "clean")
            self._cond.notify_all()
        # last act of the worker: durably record the unified health
        # document (run_report --serving renders it), then take the
        # introspection plane down with the service it describes
        obs_events.emit("serve_health_doc", doc=self.health())
        if self._introspect is not None:
            self._introspect.stop()
            self._introspect = None
