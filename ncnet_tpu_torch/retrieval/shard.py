"""One retrieval shard host: rendezvous-assigned coarse volumes + scoring,
the port of ``ncnet_tpu/retrieval/shard.py``.  A shard does no device
work (its scoring is numpy, as in the JAX package), so a shard process
never creates a CUDA context.

A ``ShardService`` is the per-host unit the coordinator fans out to: it
derives its assigned pano set from the SAME rendezvous assignment every
other tier computes (``assignment.py`` — no placement service, no config
drift), reads each pano's coarse volume through the feature store's
verified-read / quarantine / recompute ladder, and answers one scoring
sweep per ``/retrieve`` request: requested ∩ assigned panos scored against
the query descriptor, deterministic top-k back.

Honesty contract (what the coordinator's coverage accounting builds on):
the answer lists exactly which panos were CONSULTED and which were
UNAVAILABLE (store miss, quarantined entry with no recompute path) — a
shard never pads, never silently skips.  A corrupt entry therefore costs
this shard one pano (quarantined on read) while the coordinator re-routes
that pano to a replica shard; with a ``compute`` callback the store
recomputes it transparently instead and the shortlist is identical to an
uncorrupted run.

Fronted by :class:`ShardIntrospectionServer`: the standard ``/healthz`` /
``/metrics`` / ``/statusz`` control plane plus ``POST /retrieve`` on the
versioned NCMW wire (``retrieval/wire.py``); ``python -m
ncnet_tpu_torch.tools.serve_shard`` is the process wrapper.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ncnet_tpu_torch.observability import events as obs_events
from ncnet_tpu_torch.observability.export import Family, render
from ncnet_tpu_torch.observability.logging import get_logger
from ncnet_tpu_torch.retrieval.assignment import replica_shards
from ncnet_tpu_torch.retrieval.scoring import score_coarse_volume, top_k
from ncnet_tpu_torch.serving.health import (
    ADMITTING,
    DEGRADED,
    DRAINING,
    READY,
    STOPPED,
    HealthMachine,
)
from ncnet_tpu_torch.serving.introspect import IntrospectionServer
from ncnet_tpu_torch.serving.request import DeadlineExceeded, Overloaded
from ncnet_tpu_torch.store.feature_store import STORE_DEGRADED

log = get_logger("retrieval")

# retrieval health-document schema (shard AND coordinator documents): the
# version gate a coordinator applies before trusting a shard's document,
# exactly like ROUTER_DOC_SCHEMA one tier down
RETRIEVAL_DOC_SCHEMA = 1

_EWMA_ALPHA = 0.3

__all__ = [
    "RETRIEVAL_DOC_SCHEMA",
    "ShardIntrospectionServer",
    "ShardService",
    "shard_metrics_families",
]


class ShardService:
    """One shard host's retrieval service (see module docstring).

    ``index`` is a loaded/merged manifest from
    :func:`ncnet_tpu_torch.retrieval.index.load_index_manifests`; ``store`` a
    :class:`~ncnet_tpu_torch.store.FeatureStore` opened under the index's coarse
    fingerprint.  ``compute`` (optional) maps a pano name to a freshly
    computed coarse volume — the transparent-recompute path for corrupted
    entries; without it an unreadable pano is honestly UNAVAILABLE."""

    def __init__(self, shard_id: str, shard_ids: Sequence[str],
                 index: Dict[str, Any], store, *,
                 replication: int = 2, default_topk: int = 10,
                 compute: Optional[Callable[[str], np.ndarray]] = None,
                 introspect_host: str = "127.0.0.1",
                 introspect_port: Optional[int] = None):
        self.shard_id = str(shard_id)
        self.shard_ids = tuple(str(s) for s in shard_ids)
        if self.shard_id not in self.shard_ids:
            raise ValueError(f"shard id {shard_id!r} not in the shard set "
                             f"{self.shard_ids}")
        self.index = index
        self.store = store
        self.replication = max(1, int(replication))
        self.default_topk = max(1, int(default_topk))
        self._compute = compute
        self._introspect_host = introspect_host
        self._introspect_port = introspect_port
        self._introspect: Optional[ShardIntrospectionServer] = None
        # the rendezvous-assigned subset this host serves (order preserved
        # from the index manifest: deterministic sweeps)
        self.assigned: List[str] = [
            name for name in index["panos"]
            if self.shard_id in replica_shards(name, self.shard_ids,
                                               self.replication)]
        self._assigned_set = set(self.assigned)
        self._cache: Dict[str, np.ndarray] = {}
        self._unavailable: set = set()
        self._lock = threading.Lock()
        self._health = HealthMachine(event="retrieve_shard_health")
        self._inflight = 0
        self._activity_t = time.monotonic()
        self._last_result_t: Optional[float] = None
        self._ewma_wall_s: Optional[float] = None
        self._n = {"requests": 0, "results": 0, "deadline": 0, "shed": 0,
                   "errors": 0, "probes": 0}

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "ShardService":
        if self._introspect_port is not None:
            self._introspect = ShardIntrospectionServer(
                self, self._introspect_host, self._introspect_port)
            try:
                self._introspect.start()
            except OSError as e:
                self._introspect = None
                self._health.to(STOPPED, f"bind_failed:{e}")
                return self
        self._health.to(READY, "shard_loaded")
        obs_events.emit("retrieve_shard_start", shard=self.shard_id,
                        shards=len(self.shard_ids),
                        replication=self.replication,
                        assigned=len(self.assigned),
                        indexed=len(self.index["panos"]))
        return self

    def request_drain(self, reason: str = "drain") -> None:
        """Coordinated drain: ``/healthz`` answers 503 from here on, so
        the coordinator demotes this host BEFORE it stops answering."""
        with self._lock:
            if self._health.state in ADMITTING:
                self._health.to(DRAINING, reason)

    def stop(self) -> None:
        with self._lock:
            if self._health.state != STOPPED:
                self._health.to(STOPPED, "clean")
        if self._introspect is not None:
            self._introspect.stop()
            self._introspect = None

    @property
    def state(self) -> str:
        return self._health.state

    @property
    def introspect_url(self) -> Optional[str]:
        return self._introspect.url if self._introspect else None

    def __enter__(self) -> "ShardService":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- entries ------------------------------------------------------------

    def _entry(self, name: str) -> Optional[np.ndarray]:
        """One pano's coarse volume through the store ladder: cached in
        memory after the first verified read (coarse volumes are tiny —
        1/factor^4 of dense features — so a whole shard stays resident).
        Returns None when the pano is honestly unavailable."""
        with self._lock:
            hit = self._cache.get(name)
        if hit is not None:
            return hit
        digest = self.index["panos"][name]
        try:
            if self._compute is not None:
                vol, _status = self.store.resolve(
                    digest, lambda name=name: self._compute(name))
            else:
                vol = self.store.get(digest)
        except Exception as e:  # noqa: BLE001 — a store/compute failure
            # costs this shard one pano, never the whole sweep
            log.warning(f"shard {self.shard_id}: pano {name} unreadable "
                        f"({type(e).__name__}: {e})", kind="io")
            vol = None
        with self._lock:
            if vol is None:
                self._unavailable.add(name)
            else:
                self._unavailable.discard(name)
                self._cache[name] = vol
        return vol

    # -- the data plane -----------------------------------------------------

    def retrieve(self, desc: np.ndarray, *,
                 panos: Optional[Sequence[str]] = None,
                 topk: Optional[int] = None,
                 budget_s: Optional[float] = None,
                 client: str = "wire", request_id: str = "",
                 probe: bool = False,
                 trace: Optional[str] = None) -> Dict[str, Any]:
        """One scoring sweep: requested ∩ assigned panos scored, top-k +
        the consulted/unavailable accounting back.  Raises the classified
        ``serving/request.py`` outcomes (Overloaded when not admitting,
        DeadlineExceeded when the budget expires mid-sweep) — the wire
        maps them onto HTTP, a local caller sees them directly."""
        from ncnet_tpu_torch.observability.tracing import normalize_trace

        trace = normalize_trace(trace)
        t0 = time.monotonic()
        with self._lock:
            if self._health.state not in ADMITTING:
                self._n["shed"] += 1
                raise Overloaded(
                    f"shard {self.shard_id} is {self._health.state}",
                    reason="draining")
            self._n["probes" if probe else "requests"] += 1
            self._inflight += 1
        try:
            if probe:
                return {"shard": self.shard_id, "probe": True,
                        "scores": [], "consulted": [], "unavailable": [],
                        "assigned": len(self.assigned)}
            deadline_t = (t0 + float(budget_s)
                          if budget_s is not None else None)
            if panos is None:
                targets = list(self.assigned)
                unknown: List[str] = []
            else:
                targets = [str(p) for p in panos
                           if str(p) in self._assigned_set]
                unknown = [str(p) for p in panos
                           if str(p) not in self._assigned_set]
            scores: Dict[str, float] = {}
            unavailable: List[str] = []
            for name in targets:
                if deadline_t is not None \
                        and time.monotonic() >= deadline_t:
                    with self._lock:
                        self._n["deadline"] += 1
                    raise DeadlineExceeded(
                        f"budget expired after {len(scores)}/"
                        f"{len(targets)} panos", where="shard_score")
                vol = self._entry(name)
                if vol is None:
                    unavailable.append(name)
                    continue
                scores[name] = score_coarse_volume(desc, vol)
            wall = time.monotonic() - t0
            with self._lock:
                self._n["results"] += 1
                self._last_result_t = time.monotonic()
                self._ewma_wall_s = wall if self._ewma_wall_s is None else (
                    _EWMA_ALPHA * wall
                    + (1.0 - _EWMA_ALPHA) * self._ewma_wall_s)
                degraded = (self.store.health().get("state")
                            == STORE_DEGRADED) or bool(self._unavailable)
                if degraded and self._health.state == READY:
                    self._health.to(DEGRADED,
                                    "store_degraded" if not
                                    self._unavailable else
                                    f"unavailable:{len(self._unavailable)}")
                elif not degraded and self._health.state == DEGRADED:
                    self._health.to(READY, "restored")
            obs_events.emit(
                "retrieve_shard_result", shard=self.shard_id,
                request=request_id, client=client,
                consulted=len(scores), unavailable=len(unavailable),
                requested=len(targets), wall_ms=round(wall * 1e3, 3),
                **({"trace": trace} if trace else {}))
            return {
                "shard": self.shard_id,
                "scores": [[p, s] for p, s in
                           top_k(scores, topk or self.default_topk)],
                "consulted": sorted(scores),
                "unavailable": unavailable,
                "unknown": unknown,
                "assigned": len(self.assigned),
                "wall_ms": round(wall * 1e3, 3),
            }
        except (Overloaded, DeadlineExceeded):
            raise
        except Exception:
            with self._lock:
                self._n["errors"] += 1
            raise
        finally:
            with self._lock:
                self._inflight -= 1

    # -- health -------------------------------------------------------------

    def health(self) -> Dict[str, Any]:
        now = time.monotonic()
        with self._lock:
            if self._inflight == 0 and self._last_result_t is None:
                # a deliberately idle shard is alive (the router's idle-
                # beat rule): the activity stamp advances until work lands
                self._activity_t = now
            last = self._last_result_t
            age = now - (last if last is not None else self._activity_t)
            return {
                "schema": RETRIEVAL_DOC_SCHEMA,
                "role": "retrieval_shard",
                "state": self._health.state,
                "service": self._health.probe(),
                "shard": {
                    "id": self.shard_id,
                    "shards": len(self.shard_ids),
                    "replication": self.replication,
                    "assigned": len(self.assigned),
                    "loaded": len(self._cache),
                    "unavailable": sorted(self._unavailable),
                    "ewma_wall_ms": (round(self._ewma_wall_s * 1e3, 3)
                                     if self._ewma_wall_s else None),
                    "inflight": self._inflight,
                },
                "counters": dict(self._n),
                "activity": {"age_s": round(max(0.0, age), 3),
                             "requests": self._n["results"]},
                "store": self.store.health(),
            }


def shard_metrics_families(shard: ShardService) -> List[Family]:
    """The curated ``ncnet_retrieve_shard_*`` family set, one consistent
    health-document cut (the shard-tier twin of ``metrics_families``)."""
    doc = shard.health()
    fams: List[Family] = []
    fams.append(Family("ncnet_retrieve_shard_up", "gauge",
                       "1 while the shard admits "
                       "(STARTING/READY/DEGRADED)")
                .add(1 if doc["state"] in ADMITTING else 0,
                     shard=doc["shard"]["id"]))
    state = Family("ncnet_retrieve_shard_state", "gauge",
                   "shard health state (1 on the active state's series)")
    state.add(1, state=doc["state"], shard=doc["shard"]["id"])
    fams.append(state)
    outcomes = Family("ncnet_retrieve_shard_requests_total", "counter",
                      "terminal outcomes of shard scoring sweeps")
    for outcome, n in sorted(doc["counters"].items()):
        outcomes.add(n, outcome=outcome, shard=doc["shard"]["id"])
    fams.append(outcomes)
    sh = doc["shard"]
    fams.append(Family("ncnet_retrieve_shard_panos", "gauge",
                       "pano accounting on this shard")
                .add(sh["assigned"], status="assigned")
                .add(sh["loaded"], status="loaded")
                .add(len(sh["unavailable"]), status="unavailable"))
    if sh.get("ewma_wall_ms") is not None:
        fams.append(Family("ncnet_retrieve_shard_wall_ewma_ms", "gauge",
                           "scoring-sweep wall EWMA")
                    .add(sh["ewma_wall_ms"], shard=sh["id"]))
    return fams


def _render_shard_statusz(shard: ShardService) -> str:
    doc = shard.health()
    sh, c = doc["shard"], doc["counters"]
    svc = doc["service"]
    lines = [
        "ncnet_tpu retrieval shard — statusz",
        f"shard: {sh['id']}  ({sh['assigned']} assigned of a "
        f"{len(shard.index['panos'])}-pano index, R={sh['replication']} "
        f"over {sh['shards']} shards)",
        f"state: {doc['state']}  (for {svc['age_s']}s"
        + (f", reason: {svc['reason']}" if svc.get("reason") else "") + ")",
        f"requests: results={c['results']}  deadline={c['deadline']}  "
        f"shed={c['shed']}  errors={c['errors']}  probes={c['probes']}",
        f"entries: loaded={sh['loaded']}  "
        f"unavailable={len(sh['unavailable'])}"
        + (f" ({', '.join(sh['unavailable'][:5])}"
           + ("…" if len(sh["unavailable"]) > 5 else "") + ")"
           if sh["unavailable"] else ""),
        f"store: {doc['store'].get('state')}"
        + (f" ({doc['store'].get('reason')})"
           if doc["store"].get("reason") else ""),
    ]
    return "\n".join(lines) + "\n"


class ShardIntrospectionServer(IntrospectionServer):
    """The shard's control + data plane: base lifecycle and handler with
    shard-shaped payloads.  ``retrieve_payload`` is inherited from the
    base server (it dispatches to ``ShardService.retrieve``);
    ``POST /match`` is refused — a retrieval shard serves no match wire."""

    def metrics_text(self) -> str:
        self._scrapes += 1
        fams = shard_metrics_families(self._service)
        fams.append(Family("ncnet_retrieve_shard_scrapes_total", "counter",
                           "scrapes answered by this shard")
                    .add(self._scrapes))
        return render(fams)

    def statusz_text(self) -> str:
        return _render_shard_statusz(self._service)

    def match_payload(self, body: bytes):
        return (404, "text/plain; charset=utf-8",
                b"this host serves /retrieve, not /match\n")
