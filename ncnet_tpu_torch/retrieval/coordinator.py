"""Scatter-gather retrieval coordinator: partial-failure-tolerant sweeps,
the port of ``ncnet_tpu/retrieval/coordinator.py`` (a coordinator of
either package fronts shards of either).

One query in, a global top-k pano shortlist out — assembled by fanning the
query's pooled descriptor to every shard that owns an un-consulted pano,
gathering scored answers, and walking each pano's rendezvous replica
ranking (``assignment.py``) when a shard fails.  The coordinator is the
retrieval tier's twin of ``serving/router.py``: the same READY/DEAD shard
lifecycle, transport-failure streaks, ``/healthz`` probe loops with
wire-probe resurrection, EWMA latency accounting, and outcome-total
bookkeeping — re-derived here over PANOS instead of requests, because the
unit that must never be lost is a database entry's chance to be scored.

The honesty contract (what the chaos suite pins):

  * every answer carries ``coverage`` — the fraction of the requested
    database actually consulted.  Coverage below ``min_coverage`` makes
    the answer DEGRADED (or, at zero, a classified shed/deadline) — a
    shortlist is never silently truncated by a dead shard;
  * with replication R ≥ 2, one shard's death (SIGKILL, injected
    ``dead_shard_urls``, corrupt response) costs CAPACITY, not COVERAGE:
    its panos re-dispatch down their replica rankings and the sweep still
    reports coverage 1.0;
  * a straggling shard is HEDGED: after ``hedge_after_s`` with no answer,
    its un-consulted panos are re-dispatched to replicas while the
    original attempt keeps running — first answer per pano wins, and the
    straggler is never punished as dead.
"""

from __future__ import annotations

import concurrent.futures
import http.client
import json
import socket
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ncnet_tpu_torch.observability import events as obs_events
from ncnet_tpu_torch.observability.export import Family, render
from ncnet_tpu_torch.observability.logging import get_logger
from ncnet_tpu_torch.observability.metrics import Histogram
from ncnet_tpu_torch.retrieval.assignment import replica_shards
from ncnet_tpu_torch.retrieval.scoring import top_k
from ncnet_tpu_torch.retrieval.shard import RETRIEVAL_DOC_SCHEMA
from ncnet_tpu_torch.retrieval.wire import SETTLE_MARGIN_S, RetrieveClient
from ncnet_tpu_torch.serving.health import (
    ADMITTING,
    DEGRADED,
    READY,
    STOPPED,
    HealthMachine,
)
from ncnet_tpu_torch.serving.introspect import IntrospectionServer
from ncnet_tpu_torch.serving.request import DeadlineExceeded, Overloaded
from ncnet_tpu_torch.serving.wire import WireError

log = get_logger("retrieval")

# shard lifecycle states (the router's backend states, minus DRAINING-as-
# routing-target: a DRAINING shard is simply not planned to)
SHARD_READY = "READY"
SHARD_DRAINING = "DRAINING"
SHARD_DEAD = "DEAD"

_EWMA_ALPHA = 0.3
_TRANSPORT_ERRORS = (OSError, socket.timeout, http.client.HTTPException,
                     WireError)
_CLIENT_POOL_CAP = 8

__all__ = [
    "RetrievalConfig",
    "RetrievalCoordinator",
    "ShardBackend",
    "build_retrieval_document",
    "retrieval_metrics_families",
]


@dataclass(frozen=True)
class RetrievalConfig:
    """Coordinator knobs.  Defaults are the 4-shard CPU chaos pod's."""

    topk: int = 10
    replication: int = 2
    # coverage below this makes an answer DEGRADED (1.0 = full sweep
    # required; an InLoc caller may accept 0.9 and say so explicitly)
    min_coverage: float = 1.0
    # per-query budget when the caller sends none (None = unbounded)
    default_budget_s: Optional[float] = None
    # outstanding shard attempt older than this with un-consulted panos
    # gets hedged to replicas (0 disables hedging)
    hedge_after_s: float = 0.25
    # socket-level bound per shard attempt — the hung-peer backstop
    shard_timeout_s: float = 10.0
    probe_period_s: float = 1.0
    resurrect_after_s: float = 1.0
    probe_timeout_s: float = 5.0
    # consecutive transport failures before a shard is marked DEAD
    max_failures: int = 2
    # scatter worker threads shared by all in-flight queries
    max_workers: int = 16
    introspect_host: str = "127.0.0.1"
    introspect_port: Optional[int] = None


class ShardBackend:
    """One shard host as the coordinator sees it: client pool, failure
    streak, EWMA, lifecycle state.  The row shape mirrors the router's
    ``Backend.probe_row`` (``last_result_age_s`` / ``ewma_wall_ms``) so
    ``stall_watchdog --url`` reads a retrieval document unchanged."""

    def __init__(self, shard_id: str, url: str, *, timeout_s: float):
        self.id = str(shard_id)
        self.url = str(url)
        self.timeout_s = float(timeout_s)
        self.state = SHARD_READY
        self.consecutive_failures = 0
        self.inflight = 0
        self.requests = 0
        self.results = 0
        self.failures = 0
        self.deaths = 0
        self.hedges_absorbed = 0
        self.dead_since: Optional[float] = None
        self.last_result_t: Optional[float] = None
        self.ewma_wall_s: Optional[float] = None
        self._clients: List[RetrieveClient] = []

    # pool discipline copied from the router: pop/append under the owner's
    # lock, capped so a burst cannot hoard sockets
    def acquire(self) -> RetrieveClient:
        if self._clients:
            return self._clients.pop()
        return RetrieveClient(self.url, timeout_s=self.timeout_s)

    def release(self, client: RetrieveClient) -> None:
        if len(self._clients) < _CLIENT_POOL_CAP:
            self._clients.append(client)
        else:
            client.close()

    def close_clients(self) -> None:
        clients, self._clients = self._clients, []
        for c in clients:
            c.close()

    def note_success(self, wall_s: float) -> None:
        self.results += 1
        self.consecutive_failures = 0
        self.last_result_t = time.monotonic()
        self.ewma_wall_s = wall_s if self.ewma_wall_s is None else (
            _EWMA_ALPHA * wall_s + (1.0 - _EWMA_ALPHA) * self.ewma_wall_s)

    def note_failure(self) -> None:
        self.failures += 1
        self.consecutive_failures += 1

    def probe_row(self) -> Dict[str, Any]:
        now = time.monotonic()
        return {
            "id": self.id,
            "url": self.url,
            "state": self.state,
            "ewma_wall_ms": (round(self.ewma_wall_s * 1e3, 3)
                             if self.ewma_wall_s else None),
            "consecutive_failures": self.consecutive_failures,
            "inflight": self.inflight,
            "requests": self.requests,
            "results": self.results,
            "failures": self.failures,
            "deaths": self.deaths,
            "hedges_absorbed": self.hedges_absorbed,
            "dead_age_s": (round(now - self.dead_since, 3)
                           if self.dead_since is not None else None),
            "last_result_age_s": (round(now - self.last_result_t, 3)
                                  if self.last_result_t is not None
                                  else None),
        }


@dataclass
class _Attempt:
    """One in-flight shard dispatch inside a query's scatter plan."""

    shard_id: str
    panos: List[str]
    dispatched_t: float
    hedge: bool = False
    hedged: bool = False  # set once this attempt has spawned its hedge


class RetrievalCoordinator:
    """The scatter-gather front of a shard pod (see module docstring).

    ``shards`` maps shard id → base url of a running shard host (a
    ``ShardService`` behind its introspection server, usually a
    ``ncnet_tpu_torch.tools.serve_shard`` process); ``pano_ids`` is the full indexed
    database (usually ``index["panos"].keys()``)."""

    def __init__(self, shards: Dict[str, str], pano_ids: Sequence[str],
                 cfg: RetrievalConfig = RetrievalConfig()):
        if not shards:
            raise ValueError("a retrieval pod needs at least one shard")
        self.cfg = cfg
        self.shard_ids: Tuple[str, ...] = tuple(
            sorted(str(s) for s in shards))
        self.pano_ids: List[str] = [str(p) for p in pano_ids]
        self._pano_set = set(self.pano_ids)
        self._backends: Dict[str, ShardBackend] = {
            str(sid): ShardBackend(str(sid), url,
                                   timeout_s=cfg.shard_timeout_s)
            for sid, url in shards.items()}
        self._lock = threading.Lock()
        self._health = HealthMachine(event="retrieve_health")
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._probe_threads: List[threading.Thread] = []
        self._stopping = threading.Event()
        self._introspect: Optional[_RetrievalIntrospectionServer] = None
        self._n = {"admitted": 0, "results": 0, "degraded": 0,
                   "deadline": 0, "shed": 0, "hedges": 0, "probes": 0}
        self._coverage_hist = Histogram(0.0, 1.0, bins=20)
        self._wall_hist = Histogram(0.0, 2000.0, bins=40)  # ms
        self._last_result_t: Optional[float] = None
        self._started_t = time.monotonic()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "RetrievalCoordinator":
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(2, int(self.cfg.max_workers)),
            thread_name_prefix="retrieve-scatter")
        if self.cfg.introspect_port is not None:
            self._introspect = _RetrievalIntrospectionServer(
                self, self.cfg.introspect_host, self.cfg.introspect_port)
            try:
                self._introspect.start()
            except OSError as e:
                self._introspect = None
                self._health.to(STOPPED, f"bind_failed:{e}")
                return self
        self._health.to(READY, "pod_up")
        obs_events.emit("retrieve_start", shards=len(self.shard_ids),
                        panos=len(self.pano_ids),
                        replication=self.cfg.replication,
                        topk=self.cfg.topk,
                        min_coverage=self.cfg.min_coverage)
        for sid in self.shard_ids:
            t = threading.Thread(target=self._probe_loop, args=(sid,),
                                 name=f"retrieve-probe-{sid}", daemon=True)
            t.start()
            self._probe_threads.append(t)
        return self

    def stop(self) -> None:
        self._stopping.set()
        with self._lock:
            if self._health.state != STOPPED:
                self._health.to(STOPPED, "clean")
            doc = build_retrieval_document(self)
        obs_events.emit("retrieve_health_doc", doc=doc)
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)
        for t in self._probe_threads:
            t.join(0.5)
        self._probe_threads = []
        with self._lock:
            for b in self._backends.values():
                b.close_clients()
        if self._introspect is not None:
            self._introspect.stop()
            self._introspect = None

    @property
    def state(self) -> str:
        return self._health.state

    @property
    def introspect_url(self) -> Optional[str]:
        return self._introspect.url if self._introspect else None

    def __enter__(self) -> "RetrievalCoordinator":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- shard lifecycle (the router's kill/revive machinery over shards) ---

    def _kill_locked(self, b: ShardBackend, reason: str) -> None:
        if b.state == SHARD_DEAD:
            return
        b.state = SHARD_DEAD
        b.deaths += 1
        b.dead_since = time.monotonic()
        b.close_clients()
        log.warning(f"retrieval shard {b.id} DEAD ({reason})", kind="pod")
        obs_events.emit("retrieve_backend", shard=b.id, state=SHARD_DEAD,
                        reason=reason, deaths=b.deaths)
        self._note_capacity_locked()

    def _revive_locked(self, b: ShardBackend, reason: str) -> None:
        if b.state == SHARD_READY:
            return
        b.state = SHARD_READY
        b.consecutive_failures = 0
        b.dead_since = None
        b.ewma_wall_s = None  # stale latency must not bias planning
        log.info(f"retrieval shard {b.id} READY ({reason})")
        obs_events.emit("retrieve_backend", shard=b.id, state=SHARD_READY,
                        reason=reason, deaths=b.deaths)
        self._note_capacity_locked()

    def _note_capacity_locked(self) -> None:
        ready = sum(1 for b in self._backends.values()
                    if b.state == SHARD_READY)
        total = len(self._backends)
        if ready < total and self._health.state == READY:
            self._health.to(DEGRADED, f"shards:{ready}/{total}")
        elif ready == total and self._health.state == DEGRADED:
            self._health.to(READY, "capacity_restored")

    # -- probing ------------------------------------------------------------

    def _probe_loop(self, sid: str) -> None:
        while not self._stopping.is_set():
            with self._lock:
                b = self._backends[sid]
                dead = b.state == SHARD_DEAD
            period = (self.cfg.resurrect_after_s if dead
                      else self.cfg.probe_period_s)
            if self._stopping.wait(max(0.05, period)):
                return
            try:
                self._probe_shard(sid)
            except Exception as e:  # noqa: BLE001 — a probe bug must
                # never kill the probe loop
                log.warning(f"shard probe {sid} error: "
                            f"{type(e).__name__}: {e}", kind="pod")

    def _fetch_healthz(self, url: str) -> Optional[Dict[str, Any]]:
        """The shard's ``/healthz`` document, accepting 200 OR 503 bodies
        (a DRAINING shard answers 503 with a valid document — that IS the
        signal).  None when the host is unreachable."""
        try:
            with urllib.request.urlopen(
                    f"{url}/healthz",
                    timeout=self.cfg.probe_timeout_s) as resp:
                raw = resp.read()
        except urllib.error.HTTPError as e:
            if e.code != 503:
                return None
            raw = e.read()
        except (OSError, socket.timeout):
            return None
        try:
            doc = json.loads(raw.decode("utf-8"))
        except (UnicodeDecodeError, ValueError):
            return None
        return doc if isinstance(doc, dict) else None

    def _wire_probe(self, b: ShardBackend) -> bool:
        """Resurrection requires the DATA plane, not just a pretty
        document: one probe-marked request through the real wire."""
        client = RetrieveClient(b.url, timeout_s=self.cfg.probe_timeout_s)
        try:
            client.retrieve(np.zeros(1, np.float32), probe=True,
                            client="probe",
                            timeout_s=self.cfg.probe_timeout_s)
            return True
        except _TRANSPORT_ERRORS:
            return False
        except Exception:  # noqa: BLE001 — a CLASSIFIED outcome proves
            # the wire works; only transport failure keeps a shard dead
            return True
        finally:
            client.close()

    def _probe_shard(self, sid: str) -> None:
        with self._lock:
            b = self._backends[sid]
            state = b.state
        doc = self._fetch_healthz(b.url)
        admitting = (isinstance(doc, dict)
                     and doc.get("schema") == RETRIEVAL_DOC_SCHEMA
                     and doc.get("role") == "retrieval_shard"
                     and doc.get("state") in ADMITTING)
        with self._lock:
            self._n["probes"] += 1
        if state == SHARD_DEAD:
            if admitting and self._wire_probe(b):
                with self._lock:
                    self._revive_locked(b, "probe_ok")
            return
        if doc is None:
            with self._lock:
                b.consecutive_failures += 1
                if b.consecutive_failures >= self.cfg.max_failures:
                    self._kill_locked(b, "probe_unreachable")
            return
        if not admitting:
            # a valid document in a non-admitting state: coordinated
            # drain/stop — demote immediately, probe-only (no streak)
            with self._lock:
                if b.state == SHARD_READY:
                    b.state = SHARD_DRAINING
                    obs_events.emit("retrieve_backend", shard=b.id,
                                    state=SHARD_DRAINING,
                                    reason=str(doc.get("state")))
                    self._note_capacity_locked()
            return
        with self._lock:
            if b.state == SHARD_DRAINING:
                b.state = SHARD_READY
                obs_events.emit("retrieve_backend", shard=b.id,
                                state=SHARD_READY, reason="probe_ok")
                self._note_capacity_locked()
            # NOTE: an admitting document does NOT reset the data-plane
            # failure streak — only a real result does (note_success).  A
            # shard whose wire is dead but whose control plane still
            # answers must still cross the kill threshold.

    # -- the scatter-gather data plane --------------------------------------

    def _attempt(self, desc: np.ndarray, sid: str, panos: List[str],
                 topk: int, budget_s: Optional[float], request_id: str,
                 trace: Optional[str] = None
                 ) -> Tuple[str, str, Any, float]:
        """One shard dispatch, fully self-accounting (acquire/release,
        success/failure notes) so an ABANDONED straggler still settles its
        backend's books after the query has answered without it.  Returns
        ``(kind, shard_id, answer_or_exc, wall_s)`` with kind one of
        ``ok`` / ``classified`` / ``transport``."""
        with self._lock:
            b = self._backends[sid]
            client = b.acquire()
            b.inflight += 1
            b.requests += 1
        t0 = time.monotonic()
        try:
            timeout = self.cfg.shard_timeout_s
            if budget_s is not None:
                timeout = min(timeout, max(0.05,
                                           budget_s + SETTLE_MARGIN_S))
            answer = client.retrieve(
                desc, panos=panos, topk=topk, client="coordinator",
                budget_s=budget_s, request_id=request_id,
                timeout_s=timeout, trace=trace)
            wall = time.monotonic() - t0
            with self._lock:
                b.note_success(wall)
                self._last_result_t = time.monotonic()
            return ("ok", sid, answer, wall)
        except (Overloaded, DeadlineExceeded) as e:
            # a CLASSIFIED outcome: the shard is alive and honest — no
            # failure streak, but these panos retry on replicas
            wall = time.monotonic() - t0
            return ("classified", sid, e, wall)
        except _TRANSPORT_ERRORS as e:
            wall = time.monotonic() - t0
            with self._lock:
                b.note_failure()
                if b.consecutive_failures >= self.cfg.max_failures:
                    self._kill_locked(
                        b, f"transport:{type(e).__name__}")
            return ("transport", sid, e, wall)
        except Exception as e:  # noqa: BLE001 — outcome-total: anything
            # else is treated as a transport-grade shard failure
            wall = time.monotonic() - t0
            with self._lock:
                b.note_failure()
                if b.consecutive_failures >= self.cfg.max_failures:
                    self._kill_locked(b, f"error:{type(e).__name__}")
            return ("transport", sid, e, wall)
        finally:
            with self._lock:
                b.inflight -= 1
                b.release(client)

    def retrieve(self, desc: np.ndarray, *,
                 panos: Optional[Sequence[str]] = None,
                 topk: Optional[int] = None,
                 budget_s: Optional[float] = None,
                 client: str = "local", request_id: str = "",
                 probe: bool = False,
                 trace: Optional[str] = None) -> Dict[str, Any]:
        """One scatter-gather sweep → the coverage-honest answer document
        (see module docstring).  Raises classified ``Overloaded`` /
        ``DeadlineExceeded`` only at coverage ZERO — partial coverage is
        an answered, DEGRADED result, never an exception."""
        from ncnet_tpu_torch.observability.tracing import normalize_trace

        trace = normalize_trace(trace)
        t0 = time.monotonic()
        with self._lock:
            if self._health.state not in ADMITTING:
                self._n["shed"] += 1
                raise Overloaded(
                    f"retrieval pod is {self._health.state}",
                    reason="draining")
            if not probe:
                self._n["admitted"] += 1
        if probe:
            return {"schema": RETRIEVAL_DOC_SCHEMA, "probe": True,
                    "scores": [], "coverage": 0.0, "consulted": 0,
                    "total": 0}
        k = int(topk) if topk else self.cfg.topk
        budget = (float(budget_s) if budget_s is not None
                  else self.cfg.default_budget_s)
        deadline_t = t0 + budget if budget is not None else None
        if panos is None:
            targets = list(self.pano_ids)
            unknown: List[str] = []
        else:
            targets = [str(p) for p in panos if str(p) in self._pano_set]
            unknown = [str(p) for p in panos
                       if str(p) not in self._pano_set]
        obs_events.emit("retrieve_admit", request=request_id,
                        client=client, panos=len(targets),
                        budget_s=budget,
                        **({"trace": trace} if trace else {}))
        desc = np.ascontiguousarray(np.asarray(desc, np.float32).ravel())
        return self._sweep(desc, targets, unknown, k, deadline_t, t0,
                           client, request_id, trace)

    def _plan_locked(self, uncovered: List[str],
                     tried: Dict[str, Set[str]]) -> Dict[str, List[str]]:
        """Group un-consulted panos by their best UNTRIED, READY replica
        shard (walking each pano's rendezvous ranking) — the scatter
        plan's single step.  Pure bookkeeping; caller holds the lock."""
        groups: Dict[str, List[str]] = {}
        for p in uncovered:
            for sid in replica_shards(p, self.shard_ids,
                                      self.cfg.replication):
                if sid in tried[p]:
                    continue
                if self._backends[sid].state != SHARD_READY:
                    continue
                groups.setdefault(sid, []).append(p)
                break
        return groups

    def _sweep(self, desc: np.ndarray, targets: List[str],
               unknown: List[str], k: int, deadline_t: Optional[float],
               t0: float, client: str, request_id: str,
               trace: Optional[str] = None) -> Dict[str, Any]:
        pool = self._pool
        if pool is None:
            raise Overloaded("coordinator not started", reason="draining")
        # conditional event stamp: untraced sweeps keep their event shape
        tr = {"trace": trace} if trace else {}
        tried: Dict[str, Set[str]] = {p: set() for p in targets}
        scores: Dict[str, float] = {}
        consulted: Set[str] = set()
        pending: Dict[concurrent.futures.Future, _Attempt] = {}
        hedges = attempts = 0

        def dispatch(groups: Dict[str, List[str]], *,
                     hedge: bool) -> None:
            nonlocal hedges, attempts
            for sid, group in groups.items():
                for p in group:
                    tried[p].add(sid)
                remaining = (max(0.01, deadline_t - time.monotonic())
                             if deadline_t is not None else None)
                fut = pool.submit(self._attempt, desc, sid, group, k,
                                  remaining, request_id, trace)
                pending[fut] = _Attempt(sid, group, time.monotonic(),
                                        hedge=hedge)
                attempts += 1
                if hedge:
                    hedges += 1
                    with self._lock:
                        self._n["hedges"] += 1
                        self._backends[sid].hedges_absorbed += 1
                    obs_events.emit("retrieve_hedge", request=request_id,
                                    shard=sid, panos=len(group), **tr)

        while True:
            now = time.monotonic()
            if deadline_t is not None and now >= deadline_t:
                break
            uncovered = [p for p in targets if p not in consulted]
            if not uncovered:
                break
            in_flight: Set[str] = set()
            for att in pending.values():
                in_flight.update(p for p in att.panos
                                 if p not in consulted)
            with self._lock:
                groups = self._plan_locked(
                    [p for p in uncovered if p not in in_flight], tried)
            dispatch(groups, hedge=False)
            # hedging: an outstanding attempt past hedge_after_s with
            # un-consulted panos gets those panos re-dispatched down
            # their replica rankings — first answer per pano wins
            if self.cfg.hedge_after_s > 0:
                for att in list(pending.values()):
                    if att.hedged or att.hedge:
                        continue
                    if now - att.dispatched_t < self.cfg.hedge_after_s:
                        continue
                    att.hedged = True
                    stale = [p for p in att.panos if p not in consulted]
                    if not stale:
                        continue
                    with self._lock:
                        hgroups = self._plan_locked(stale, tried)
                    dispatch(hgroups, hedge=True)
            if not pending:
                break  # nothing in flight and nothing plannable
            wait_t = 0.05
            if deadline_t is not None:
                wait_t = min(wait_t, max(0.001, deadline_t - now))
            done, _ = concurrent.futures.wait(
                list(pending), timeout=wait_t,
                return_when=concurrent.futures.FIRST_COMPLETED)
            for fut in done:
                att = pending.pop(fut)
                kind, sid, payload, wall = fut.result()
                if kind == "ok":
                    for p, s in payload.get("scores") or []:
                        p = str(p)
                        s = float(s)
                        if p not in scores or s > scores[p]:
                            scores[p] = s
                    consulted.update(
                        str(p) for p in payload.get("consulted") or [])
                else:
                    obs_events.emit(
                        "retrieve_shard_error", request=request_id,
                        shard=sid, kind=kind,
                        error=f"{type(payload).__name__}: {payload}"[:200],
                        panos=len(att.panos), **tr)
        # stragglers still in flight are ABANDONED (their _attempt settles
        # the backend's books when it lands); the query answers now
        total = len(targets)
        coverage = round(len(consulted) / total, 6) if total else 1.0
        wall_ms = round((time.monotonic() - t0) * 1e3, 3)
        uncoverable = sorted(p for p in targets if p not in consulted)
        if not consulted and total:
            expired = (deadline_t is not None
                       and time.monotonic() >= deadline_t)
            with self._lock:
                self._n["deadline" if expired else "shed"] += 1
            if expired:
                obs_events.emit("retrieve_deadline", request=request_id,
                                coverage=coverage, wall_ms=wall_ms, **tr)
                raise DeadlineExceeded(
                    "budget expired before any shard answered",
                    where="scatter")
            obs_events.emit("retrieve_shed", request=request_id,
                            reason="no_capacity", wall_ms=wall_ms, **tr)
            raise Overloaded("no shard could answer the sweep",
                             reason="no_capacity")
        degraded = coverage < self.cfg.min_coverage
        with self._lock:
            self._n["degraded" if degraded else "results"] += 1
            self._coverage_hist.add(coverage)
            self._wall_hist.add(wall_ms)
            self._last_result_t = time.monotonic()
        obs_events.emit("retrieve_result", request=request_id,
                        client=client, coverage=coverage,
                        degraded=degraded, hedges=hedges,
                        attempts=attempts, consulted=len(consulted),
                        total=total, wall_ms=wall_ms, **tr)
        return {
            "schema": RETRIEVAL_DOC_SCHEMA,
            "request": request_id,
            "scores": [[p, s] for p, s in top_k(scores, k)],
            "coverage": coverage,
            "consulted": len(consulted),
            "total": total,
            "degraded": degraded,
            "hedges": hedges,
            "attempts": attempts,
            "unavailable": uncoverable,
            "unknown": unknown,
            "wall_ms": wall_ms,
        }

    # -- health -------------------------------------------------------------

    def health(self) -> Dict[str, Any]:
        with self._lock:
            return build_retrieval_document(self)

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._n)


def build_retrieval_document(coord: RetrievalCoordinator
                             ) -> Dict[str, Any]:
    """The coordinator's health document (caller holds no invariants — the
    coordinator's :meth:`health` wraps this under its lock).  ``pod``
    carries one ``probe_row`` per shard in the router-document shape, so
    ``stall_watchdog``'s per-backend staleness backstop applies
    unchanged."""
    now = time.monotonic()
    backends = [coord._backends[sid].probe_row()
                for sid in coord.shard_ids]
    ready = sum(1 for b in backends if b["state"] == SHARD_READY)
    last = coord._last_result_t
    cov = coord._coverage_hist
    return {
        "schema": RETRIEVAL_DOC_SCHEMA,
        "role": "retrieval",
        "state": coord._health.state,
        "service": coord._health.probe(),
        "pod": {"ready": ready, "total": len(backends),
                "backends": backends},
        "retrieval": {
            "panos": len(coord.pano_ids),
            "replication": coord.cfg.replication,
            "topk": coord.cfg.topk,
            "min_coverage": coord.cfg.min_coverage,
            "coverage_p50": cov.percentile(0.5) if cov.count else None,
            "coverage_min": cov.min,
        },
        "counters": dict(coord._n),
        "activity": {
            "age_s": round(now - (last if last is not None
                                  else coord._started_t), 3),
            "requests": coord._n["results"] + coord._n["degraded"],
        },
    }


def retrieval_metrics_families(coord: RetrievalCoordinator
                               ) -> List[Family]:
    """The curated ``ncnet_retrieve_*`` exposition families — the
    coordinator-tier cut every scrape and ``serve_top`` reads."""
    doc = coord.health()
    with coord._lock:
        cov_hist = coord._coverage_hist
        wall_hist = coord._wall_hist
    fams: List[Family] = []
    fams.append(Family("ncnet_retrieve_up", "gauge",
                       "1 while the coordinator admits sweeps")
                .add(1 if doc["state"] in ADMITTING else 0))
    state = Family("ncnet_retrieve_state", "gauge",
                   "coordinator health state (1 on the active series)")
    state.add(1, state=doc["state"])
    fams.append(state)
    outcomes = Family("ncnet_retrieve_requests_total", "counter",
                      "sweep outcomes (admitted and terminals)")
    for outcome, n in sorted(doc["counters"].items()):
        outcomes.add(n, outcome=outcome)
    fams.append(outcomes)
    fams.append(Family("ncnet_retrieve_shards", "gauge",
                       "shard capacity: ready vs total")
                .add(doc["pod"]["ready"], status="ready")
                .add(doc["pod"]["total"], status="total"))
    up = Family("ncnet_retrieve_shard_up", "gauge",
                "1 while this shard takes scatter traffic")
    deaths = Family("ncnet_retrieve_shard_deaths_total", "counter",
                    "times this shard was declared DEAD")
    ewma = Family("ncnet_retrieve_shard_wall_ewma_ms", "gauge",
                  "per-shard attempt wall EWMA")
    for row in doc["pod"]["backends"]:
        up.add(1 if row["state"] == SHARD_READY else 0, shard=row["id"])
        deaths.add(row["deaths"], shard=row["id"])
        if row.get("ewma_wall_ms") is not None:
            ewma.add(row["ewma_wall_ms"], shard=row["id"])
    fams.extend([up, deaths, ewma])
    fams.append(Family("ncnet_retrieve_coverage", "histogram",
                       "per-answer coverage (fraction of the database "
                       "consulted)").add_histogram(cov_hist))
    fams.append(Family("ncnet_retrieve_wall_ms", "histogram",
                       "per-answer sweep wall time")
                .add_histogram(wall_hist))
    return fams


def _render_retrieval_statusz(coord: RetrievalCoordinator) -> str:
    doc = coord.health()
    c = doc["counters"]
    r = doc["retrieval"]
    svc = doc["service"]
    lines = [
        "ncnet_tpu retrieval coordinator — statusz",
        f"state: {doc['state']}  (for {svc['age_s']}s"
        + (f", reason: {svc['reason']}" if svc.get("reason") else "") + ")",
        f"pod: {doc['pod']['ready']}/{doc['pod']['total']} shards ready  "
        f"(R={r['replication']}, {r['panos']} panos, "
        f"topk={r['topk']}, min_coverage={r['min_coverage']})",
        f"sweeps: admitted={c['admitted']}  results={c['results']}  "
        f"degraded={c['degraded']}  deadline={c['deadline']}  "
        f"shed={c['shed']}  hedges={c['hedges']}",
        f"coverage: p50={r['coverage_p50']}  min={r['coverage_min']}",
        "", "shards:",
    ]
    for row in doc["pod"]["backends"]:
        lines.append(
            f"  {row['id']:<12} {row['state']:<9} "
            f"results={row['results']:<6} failures={row['failures']:<4} "
            f"deaths={row['deaths']:<3} "
            f"ewma={row['ewma_wall_ms'] or '-'} ms "
            f"last_result_age={row['last_result_age_s'] or '-'} s")
    return "\n".join(lines) + "\n"


class _RetrievalIntrospectionServer(IntrospectionServer):
    """Coordinator control plane: base lifecycle/handler, retrieval-shaped
    payloads.  ``retrieve_payload`` dispatches to the coordinator's data
    plane via the base class; ``/match`` is refused."""

    def metrics_text(self) -> str:
        self._scrapes += 1
        fams = retrieval_metrics_families(self._service)
        fams.append(Family("ncnet_retrieve_scrapes_total", "counter",
                           "scrapes answered by the coordinator")
                    .add(self._scrapes))
        return render(fams)

    def statusz_text(self) -> str:
        return _render_retrieval_statusz(self._service)

    def match_payload(self, body: bytes):
        return (404, "text/plain; charset=utf-8",
                b"this host serves /retrieve, not /match\n")
