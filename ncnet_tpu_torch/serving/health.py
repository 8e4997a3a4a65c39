"""Serving health state machine — the probe surface external supervisors see.

States and their meaning for a load balancer / readiness probe:

  * ``STARTING``  — the worker is up but warming (compiling warm buckets).
    Admission IS open (requests queue behind the warmup) but probes should
    not route fresh traffic yet.
  * ``READY``     — serving normally on the preferred tier ladder.
  * ``DEGRADED``  — the replica pool is below full strength (a replica
    is DEAD awaiting resurrection — capacity degraded, availability
    intact); the service is still serving — with zero lost requests — but
    an operator should look.  It recovers to READY once every replica is
    resurrected (the one DEGRADED → READY edge).  The JAX package also
    enters it, sticky, when a device failure demotes a kernel tier; the
    port has no demotion (ROADMAP D4).
  * ``DRAINING``  — SIGTERM (or ``stop()``): admission is closed, admitted
    work is completing.  Probes must stop routing here.
  * ``STOPPED``   — terminal; the worker has exited.

Transitions are monotone along STARTING → READY → DEGRADED and any
non-terminal state may enter DRAINING → STOPPED; anything else is a service
bug and raises.  Every transition is emitted as a ``serve_health`` event so
``tools/run_report.py --serving`` can reconstruct the health timeline of a
dead service from its event log alone.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from ncnet_tpu_torch.observability import events as obs_events

# schema version of the UNIFIED health document (build_health_document):
# bump when the nesting or field meanings change, so the multi-host router
# / watchdog / chaos tests scraping /healthz can refuse documents they do
# not understand instead of silently misreading them
HEALTH_DOC_SCHEMA = 1

STARTING = "STARTING"
READY = "READY"
DEGRADED = "DEGRADED"
DRAINING = "DRAINING"
STOPPED = "STOPPED"

_ALLOWED = {
    STARTING: (READY, DEGRADED, DRAINING, STOPPED),
    READY: (DEGRADED, DRAINING, STOPPED),
    # DEGRADED -> READY is the replica-pool recovery edge ONLY: every dead
    # replica resurrected (the service checks it before requesting it)
    DEGRADED: (READY, DRAINING, STOPPED),
    DRAINING: (STOPPED,),
    STOPPED: (),
}

# states whose admission door is open
ADMITTING = (STARTING, READY, DEGRADED)


class HealthMachine:
    """The service's state cell; mutated only under the service lock.
    ``event`` names the transition event emitted into the log —
    ``serve_health`` for a ``MatchService``, ``route_health`` for the
    multi-host ``MatchRouter`` (same machine, same transition rules, so
    ``run_report`` reconstructs either tier's timeline the same way)."""

    def __init__(self, event: str = "serve_health"):
        self.event = event
        self.state = STARTING
        self.since = time.time()
        self.reason: Optional[str] = None
        self.history: List[Dict[str, Any]] = [
            {"state": STARTING, "t": self.since, "reason": "init"}
        ]

    def to(self, state: str, reason: str = "") -> bool:
        """Transition (emitting the machine's transition event); returns
        False when the machine is already there (idempotent re-entry is not
        an error — DEGRADED may be requested per failed batch)."""
        if state == self.state:
            return False
        if state not in _ALLOWED[self.state]:
            raise RuntimeError(
                f"illegal health transition {self.state} -> {state}"
            )
        self.state = state
        self.since = time.time()
        self.reason = reason or None
        self.history.append(
            {"state": state, "t": self.since, "reason": reason or None})
        obs_events.emit(self.event, state=state, reason=reason or None)
        return True

    @property
    def admitting(self) -> bool:
        return self.state in ADMITTING

    def probe(self, history: int = 8) -> Dict[str, Any]:
        """This machine's section of the unified health document: current
        state + how long it has held + why + the recent transition
        timeline (newest last, bounded so the document stays a probe, not
        a log)."""
        return {
            "state": self.state,
            "since": self.since,
            "age_s": round(max(0.0, time.time() - self.since), 3),
            "reason": self.reason,
            "history": [dict(h) for h in self.history[-history:]],
        }


def build_health_document(machine: HealthMachine,
                          replicas: List[Dict[str, Any]], *,
                          queue: Dict[str, Any],
                          counters: Dict[str, Any],
                          slo: Optional[Dict[str, Any]] = None,
                          activity: Optional[Dict[str, Any]] = None,
                          memory: Optional[Dict[str, Any]] = None,
                          store: Optional[Dict[str, Any]] = None,
                          model_version: Optional[str] = None,
                          rollout: Optional[Dict[str, Any]] = None,
                          streams: Optional[Dict[str, Any]] = None,
                          ) -> Dict[str, Any]:
    """THE one health document (``HEALTH_DOC_SCHEMA``-versioned) — the
    ``/healthz`` body, ``MatchService.health()`` return value, the final
    ``serve_health_doc`` event payload that ``run_report --serving``
    renders, and the dict the future multi-host router will route on.

    Before this function the service-level probe (``HealthMachine.probe``)
    and the per-replica rows (``Replica.probe``) were merged ad hoc at each
    consumer and drifted independently; now every consumer reads the same
    nesting:

      * ``state`` — the service state, mirrored top-level (the one field a
        load balancer needs without parsing the rest);
      * ``service`` — the health machine's probe (state/age/reason/recent
        transition history);
      * ``pool`` — ``ready``/``total`` capacity + every replica's row
        (``Replica.probe()``: id, state, score, EWMA wall, load, counters);
      * ``queue`` — depth, in-flight batches, pipeline depth, the elastic
        queue bound, and the registered bucket ladder;
      * ``counters`` — the terminal-outcome accounting;
      * ``slo`` — the error-budget tracker's snapshot (when configured);
      * ``activity`` — seconds since the pool last dispatched (or idled
        deliberately): the HTTP-reachable liveness signal
        ``stall_watchdog --url`` judges instead of a heartbeat mtime.
      * ``memory`` — the memory observability section (when the service
        tracks one): the warmed ladder's predicted footprint from the
        compiled-program ledger, per-replica HBM watermarks, and the
        headroom against ``bytes_limit``.
      * ``store`` — the persistent feature store's health
        (``FeatureStore.health()``, when one is attached): OK/DEGRADED
        state + hit/miss/corrupt/evict counters + footprint.  A DEGRADED
        store is an operator signal, NOT a serving outage — the store
        fails open to recompute, so ``stall_watchdog --url`` must (and
        does) treat store-DEGRADED as degraded-but-serving, never stalled.
      * ``model_version`` — the pod's converged model identity (live
        rollout, serving/rollout.py); per-replica versions live in the
        pool rows, so a mid-rollout mixed pod is visible to the router.
      * ``rollout`` — the rollout controller's status while one is
        attached (phase, versions, canary verdict inputs).
      * ``streams`` — the streaming session table (``StreamTable.doc()``,
        serving/stream.py): active/tracked/fallback/cold frame totals,
        mean candidate recall, and per-session rows — the tracked-mode
        counterpart of the request counters.

    ``model_version``/``rollout``/``streams`` are ADDITIVE optional
    fields — schema 1 consumers that predate them simply never read the
    keys.
    """
    ready = sum(1 for r in replicas if r.get("state") == "READY")
    doc: Dict[str, Any] = {
        "schema": HEALTH_DOC_SCHEMA,
        "state": machine.state,
        "service": machine.probe(),
        "pool": {"ready": ready, "total": len(replicas),
                 "replicas": list(replicas)},
        "queue": dict(queue),
        "counters": dict(counters),
    }
    if slo is not None:
        doc["slo"] = slo
    if activity is not None:
        doc["activity"] = activity
    if memory is not None:
        doc["memory"] = memory
    if store is not None:
        doc["store"] = store
    if model_version is not None:
        doc["model_version"] = model_version
    if rollout is not None:
        doc["rollout"] = rollout
    if streams is not None:
        doc["streams"] = streams
    return doc
