"""Replicated serving, the port of ``ncnet_tpu/serving/replica.py``: a pool
of match engines with health-scored routing, replica quarantine, and
resurrection probes.  Losing a device degrades capacity instead of
availability.

  * **One engine per device.**  :meth:`ReplicaPool.from_model` builds one
    :class:`BatchMatchEngine` per CUDA device (params staged on it, so its
    work runs there); more replicas than devices take them round-robin, and
    the caller may name the devices (the CPU tests pass ``["cpu"] * n``).
  * **Health-scored routing.**  The service routes each coalesced batch to
    the READY replica with the lowest :meth:`Replica.health_score`: an
    EWMA of its measured batch walls scaled by its current load and its
    consecutive-failure streak.  A slow or flaky replica is de-prioritized
    continuously, not only after it dies.
  * **Replica quarantine, not request quarantine.**  A batch failure
    requeues the batch and re-routes it to a surviving replica off-budget;
    ``replica_max_failures`` consecutive failures move the replica itself
    to DEAD, where the router never sends it traffic.
  * **Resurrection probes.**  Every ``resurrect_after_s`` the service
    dispatches a tiny probe pair at a DEAD replica; success returns it to
    READY and its capacity flows back into admission control.
  * **Elastic admission.**  Membership changes call back into the service
    (``on_change``) so the queue bound and ``retry_after_s`` hints track
    live capacity; an all-dead pool sheds ``reason="no_capacity"``.

Replica state is mutated only under the owning service's condition lock
(the pool holds no lock of its own); the chaos seams live in
``utils/faults.py`` (``dead_replica_ids`` / ``slow_replica_ids``), called
from :meth:`Replica.dispatch`/:meth:`Replica.fetch`.  The live rollout
(``serving/rollout.py``) adds DRAINING and canary routing: a replica
drained for a weight swap gets no traffic and no resurrection probe, and a
canary takes a set share of routing decisions.
"""

from __future__ import annotations

import time
from collections import deque
from typing import (Any, Callable, Deque, Dict, FrozenSet, List, Optional,
                    Sequence)

from ncnet_tpu_torch.observability import events as obs_events
from ncnet_tpu_torch.serving.request import Bucket

# replica lifecycle states (distinct from the service-level health machine:
# replicas cycle READY <-> DEAD, the service machine is monotone).
# DRAINING is the live-rollout holding state: the router treats it like
# DEAD (no new traffic) but resurrection probes leave it alone — the
# rollout controller owns the replica until it re-admits it via
# ``resurrect``.
REPLICA_READY = "READY"
REPLICA_DEAD = "DEAD"
REPLICA_DRAINING = "DRAINING"

# routing prior for a replica with no measured wall yet (fresh or just
# resurrected): small enough that an idle unknown replica wins against a
# busy known one, large enough that a known-fast idle replica still wins
_PRIOR_WALL_S = 0.05

_EWMA_ALPHA = 0.3  # same ~6-sample memory as the admission batch-wall EWMA


class Replica:
    """One engine in the pool: the engine + its scheduling/health state.

    All mutable fields are owned by the service's condition lock; the only
    methods safe to call without it are :meth:`dispatch`/:meth:`fetch`
    (which touch the device, not the scheduling state).
    """

    def __init__(self, rid: str, engine: Any, device: Any = None):
        self.id = rid
        self.engine = engine
        self.device = device
        self.state = REPLICA_READY
        # scheduling (service-lock owned)
        self.pending: Deque[Any] = deque()   # dispatched, fetch not started
        self.processing: Any = None          # the batch its fetcher holds
        # health signals (the routing score inputs)
        self.ewma_wall_s: Optional[float] = None
        self.consecutive_failures = 0
        # counters / timeline
        self.batches = 0
        self.failures = 0
        self.deaths = 0
        self.dead_since: Optional[float] = None
        self.last_probe_t: Optional[float] = None
        self.probing = False   # a probe thread is out on this replica
        self.last_bucket: Optional[Bucket] = None
        # which model generation this replica's engine is serving; stamped
        # by the service at construction and advanced by the rollout
        # controller at each drained swap (version-tags results + /metrics)
        self.model_version: str = ""

    # -- device-facing (no service lock; the chaos seams live here) ---------

    def dispatch(self, src_u8, tgt_u8, src_digests=None):
        from ncnet_tpu_torch.utils import faults

        faults.replica_fault_hook(self.id, "dispatch")
        if src_digests is not None:
            # only engines that understand digest memoization get the
            # keyword (injected fakes keep their two-arg signature)
            return self.engine.dispatch(src_u8, tgt_u8,
                                        src_digests=src_digests)
        return self.engine.dispatch(src_u8, tgt_u8)

    def dispatch_tracked(self, src_u8, tgt_u8, prior_ab, prior_ba,
                         src_digests=None):
        """The streaming batch: same fault seam as :meth:`dispatch` (an
        injected replica death kills tracked frames identically), routed
        to the engine's coarse-pass-free tracked program."""
        from ncnet_tpu_torch.utils import faults

        faults.replica_fault_hook(self.id, "dispatch")
        return self.engine.dispatch_tracked(
            src_u8, tgt_u8, prior_ab, prior_ba, src_digests=src_digests)

    @property
    def supports_tracking(self) -> bool:
        return hasattr(self.engine, "dispatch_tracked")

    def fetch(self, handle):
        from ncnet_tpu_torch.utils import faults

        faults.replica_fault_hook(self.id, "fetch")
        return self.engine.fetch(handle)

    # -- scheduling/health state (service-lock owned) -----------------------

    @property
    def load(self) -> int:
        """Batches this replica currently owns (queued for fetch + the one
        its fetcher holds)."""
        return len(self.pending) + (1 if self.processing is not None else 0)

    def health_score(self) -> float:
        """Routing cost, lower = route here.  Base cost is the measured
        batch-wall EWMA (a slow replica is expensive), scaled by current
        load (a busy replica queues the batch behind its backlog), and
        doubled per consecutive failure (a flaky replica is probably about
        to cost a full failover round trip).  The JAX score's tier-demotion
        factor is 1 here: the port demotes no tier (ROADMAP D4)."""
        wall = self.ewma_wall_s if self.ewma_wall_s else _PRIOR_WALL_S
        streak = 2.0 ** min(self.consecutive_failures, 4)
        return wall * (1.0 + self.load) * streak

    def note_success(self, wall_s: float) -> None:
        self.batches += 1
        self.consecutive_failures = 0
        w = float(wall_s)
        self.ewma_wall_s = w if self.ewma_wall_s is None else (
            _EWMA_ALPHA * w + (1.0 - _EWMA_ALPHA) * self.ewma_wall_s)

    def note_failure(self) -> None:
        self.failures += 1
        self.consecutive_failures += 1

    def probe(self) -> Dict[str, Any]:
        """One replica's row in the UNIFIED health document
        (``serving/health.py::build_health_document`` nests these under
        ``pool.replicas`` — the one place this shape is consumed, so the
        row and the service-level probe can no longer drift apart)."""
        return {
            "id": self.id,
            "state": self.state,
            "model_version": self.model_version or None,
            "device": str(self.device) if self.device is not None else None,
            "score": round(self.health_score(), 6),
            "ewma_wall_ms": (round(self.ewma_wall_s * 1e3, 3)
                             if self.ewma_wall_s else None),
            "consecutive_failures": self.consecutive_failures,
            "load": self.load,
            "batches": self.batches,
            "failures": self.failures,
            "deaths": self.deaths,
            # the JAX row's tier-demotion count, always 0 here (the port
            # demotes no tier, ROADMAP D4): a pod's /healthz documents keep
            # one key set whichever package a host runs
            "demotions": 0,
            # how long it has been dead (None while READY): the /statusz
            # operator signal for "is resurrection overdue"
            "dead_age_s": (round(time.monotonic() - self.dead_since, 3)
                           if self.dead_since is not None else None),
        }


class ReplicaPool:
    """The replica set + routing.  Owned by one ``MatchService``; every
    method that reads or writes replica state must be called under the
    service's condition lock.  ``on_change(ready, total)`` fires on every
    membership change (death, resurrection) — the service wires it into
    admission control so queue bounds and retry hints track live capacity.
    """

    def __init__(self, replicas: List[Replica],
                 on_change: Optional[Callable[[int, int], None]] = None):
        if not replicas:
            raise ValueError("a replica pool needs at least one replica")
        self.replicas = list(replicas)
        ids = [r.id for r in self.replicas]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate replica ids: {ids}")
        self.on_change = on_change
        # canary routing (rollout-controller owned, service-lock guarded):
        # while set, ``canary_id`` receives ``canary_fraction`` of routing
        # decisions via a deterministic credit accumulator and is excluded
        # from the general health-scored scan
        self.canary_id: Optional[str] = None
        self.canary_fraction: float = 0.0
        self._canary_credit: float = 0.0

    @classmethod
    def from_model(cls, model_config, params, n_replicas: int = 0,
                   on_change: Optional[Callable[[int, int], None]] = None,
                   devices: Optional[Sequence[Any]] = None,
                   **engine_kw) -> "ReplicaPool":
        """One :class:`BatchMatchEngine` per device.  ``devices`` defaults
        to every CUDA device (``cuda:0`` .. ``cuda:N-1``; none raises, as
        ``resolve_device`` does); ``n_replicas == 0`` uses every device and
        ``n > len(devices)`` assigns them round-robin (the capacity numbers
        only mean something at one replica per device)."""
        import torch

        from ncnet_tpu_torch.models.ncnet import resolve_device
        from ncnet_tpu_torch.serving.engine import BatchMatchEngine

        if devices is None:
            devices = [resolve_device(f"cuda:{i}")
                       for i in range(max(torch.cuda.device_count(), 1))]
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError("a replica pool needs at least one device")
        n = len(devices) if n_replicas <= 0 else int(n_replicas)
        replicas = []
        for i in range(n):
            dev = devices[i % len(devices)]
            engine = BatchMatchEngine(model_config, params, device=dev,
                                      **engine_kw)
            replicas.append(Replica(f"rep{i}", engine, device=dev))
        return cls(replicas, on_change=on_change)

    # -- membership ---------------------------------------------------------

    def ready(self) -> List[Replica]:
        return [r for r in self.replicas if r.state == REPLICA_READY]

    def dead(self) -> List[Replica]:
        return [r for r in self.replicas if r.state == REPLICA_DEAD]

    def inflight_total(self) -> int:
        return sum(r.load for r in self.replicas)

    def get(self, rid: str) -> Optional[Replica]:
        for r in self.replicas:
            if r.id == rid:
                return r
        return None

    def _notify_change(self) -> None:
        if self.on_change is not None:
            self.on_change(len(self.ready()), len(self.replicas))

    def mark_dead(self, replica: Replica, reason: str) -> None:
        """Quarantine the REPLICA (not any request): the router stops
        sending it traffic until a resurrection probe succeeds.  Emits a
        ``serve_health`` event tagged with the replica id — the service-
        level machine stays wherever it is; replica state is orthogonal."""
        if replica.state == REPLICA_DEAD:
            return
        replica.state = REPLICA_DEAD
        replica.deaths += 1
        replica.dead_since = time.monotonic()
        replica.last_probe_t = None
        obs_events.emit("serve_health", replica=replica.id,
                        state=REPLICA_DEAD, reason=reason)
        self._notify_change()

    def resurrect(self, replica: Replica, reason: str = "probe_ok") -> None:
        """A probe succeeded: back to READY with a clean failure streak and
        a reset wall estimate (the pre-death EWMA is stale evidence)."""
        if replica.state == REPLICA_READY:
            return
        replica.state = REPLICA_READY
        replica.consecutive_failures = 0
        replica.ewma_wall_s = None
        replica.dead_since = None
        obs_events.emit("serve_health", replica=replica.id,
                        state=REPLICA_READY, reason=reason)
        self._notify_change()

    def drain_for_swap(self, replica: Replica, reason: str) -> None:
        """Pull a READY replica out of rotation for a live weight swap:
        DRAINING gets no new traffic (routing only considers READY) but —
        unlike DEAD — resurrection probes skip it, so the rollout
        controller alone decides when it rejoins (via :meth:`resurrect`).
        In-flight batches it already owns finish normally; the caller
        waits for ``load == 0`` before touching the engine."""
        if replica.state != REPLICA_READY:
            return
        replica.state = REPLICA_DRAINING
        obs_events.emit("serve_health", replica=replica.id,
                        state=REPLICA_DRAINING, reason=reason)
        self._notify_change()

    # -- canary routing (rollout controller seam) ---------------------------

    def set_canary(self, replica: Replica, fraction: float) -> None:
        """Route ``fraction`` of decisions to ``replica`` (the freshly
        swapped version) and everything else away from it."""
        self.canary_id = replica.id
        self.canary_fraction = max(0.0, min(1.0, float(fraction)))
        self._canary_credit = 0.0

    def clear_canary(self) -> None:
        self.canary_id = None
        self.canary_fraction = 0.0
        self._canary_credit = 0.0

    def due_probes(self, now: float, period_s: float) -> List[Replica]:
        """DEAD replicas whose next resurrection probe is due (and whose
        backlog has fully failed over — probing a replica that still owns
        batches would race its fetcher).  Stamps ``last_probe_t`` and the
        ``probing`` flag so the caller can probe OFF-thread without
        double-scheduling; a probe that never returns (the chip is wedged,
        not erroring) leaves ``probing`` set and the replica is simply
        never probed again — a wedge cannot be resurrected, and the leaked
        daemon thread is bounded at one per wedged replica."""
        due = []
        for r in self.replicas:
            if r.state != REPLICA_DEAD or r.load or r.probing:
                continue
            since = r.last_probe_t if r.last_probe_t is not None \
                else r.dead_since
            if since is None or now - since >= period_s:
                r.last_probe_t = now
                r.probing = True
                due.append(r)
        return due

    # -- routing ------------------------------------------------------------

    def route(self, max_load: int,
              exclude: FrozenSet[str] = frozenset()) -> Optional[Replica]:
        """The READY replica with the lowest health score and spare depth,
        preferring replicas the batch has NOT already failed on
        (``exclude``); when every candidate is excluded the least-cost
        READY one is returned anyway — retrying a replica beats stranding
        the batch.  None = no READY replica has spare depth.

        While a canary is set, it is carved OUT of the general scan and
        receives exactly ``canary_fraction`` of decisions through a
        deterministic credit accumulator (no RNG: every ``1/fraction``-th
        routable decision goes to the canary) — except when the rest of
        the pool has no spare depth, where the canary takes the batch
        anyway: availability beats holding the fraction exact."""
        canary = self.get(self.canary_id) if self.canary_id else None
        canary_ok = (canary is not None
                     and canary.state == REPLICA_READY
                     and canary.load < max_load)
        if canary_ok and canary.id not in exclude:
            self._canary_credit += self.canary_fraction
            if self._canary_credit >= 1.0:
                self._canary_credit -= 1.0
                return canary
        best = fallback = None
        best_s = fb_s = float("inf")
        for r in self.replicas:
            if r.state != REPLICA_READY or r.load >= max_load:
                continue
            if r is canary:
                continue
            s = r.health_score()
            if r.id in exclude:
                if s < fb_s:
                    fallback, fb_s = r, s
            elif s < best_s:
                best, best_s = r, s
        chosen = best if best is not None else fallback
        if chosen is None and canary_ok:
            return canary
        return chosen
