"""Admission control + backpressure for the match service.

Load shedding at the door is the difference between a service that degrades
(rejects the overflow with a classified error and a retry hint, keeps its
admitted work inside deadline) and one that collapses (admits everything,
queues grow without bound, EVERY request deadline-blows).  The controller
enforces four independent bounds, checked in one place under the service
lock:

  * **queue depth** — total queued requests across buckets may not exceed
    the EFFECTIVE queue bound; the overflow sheds with
    ``reason="queue_full"`` and a ``retry_after_s`` hint derived from
    actual aggregate throughput, so well-behaved clients back off
    proportionally to real load.  With a replica pool the bound is
    elastic: ``max_queue`` scaled by the live ready/total replica fraction
    (floored at one batch), so a 4-replica pool running on 2 survivors
    advertises half the queue instead of buffering work it can no longer
    drain in time.
  * **per-client in-flight cap** — one misbehaving client (a runaway retry
    loop, a fan-out bug) may not occupy the whole queue; beyond
    ``max_in_flight_per_client`` outstanding (queued or dispatched)
    requests, that client's submissions shed with ``reason="client_cap"``
    while other clients keep being admitted.
  * **pool capacity** — zero READY replicas admits nothing
    (``reason="no_capacity"``): queueing behind a dead pool would turn
    every admission into a deadline blow; the retry hint is the
    resurrection-probe period, the soonest capacity could return.
  * **lifecycle** — a draining or stopped service admits nothing
    (``reason="draining"`` / ``"stopped"``), so SIGTERM can complete the
    admitted work without the queue refilling behind it.

The ``retry_after_s`` hint derives from the AGGREGATE pool cadence: the
pool drains ``ready_replicas`` batches per measured batch wall, so the
estimate is ``batches_ahead x batch_wall / ready_replicas`` — it stays
honest as replicas die (fewer drains per wall → longer hints) and
resurrect (hints shrink back), which is what keeps shed clients from
hammering a half-dead pool at full-pool cadence.

**The capacity-units contract** (:meth:`AdmissionController.note_capacity`).
One controller serves two tiers, so the ``ready``/``total`` feed is defined
once: they are **drain-lane units**, not processes and not devices.  A
single-process ``MatchService`` feeds its READY/total REPLICA counts (one
lane per engine); the multi-host ``MatchRouter`` feeds the SUM of ready
replicas across its live backends over the pod's provisioned total — the
pod's true drain lanes, which is what its queue bound must track (a router
admitting against its *local* device count would buffer a dead pod's worth
of work, and one admitting per *backend process* would halve its bound
when a 4-replica host loses one chip).  Both tiers' elastic bounds then
compose: each backend sheds at its own live-replica bound, the router
sheds at the pod's, and the same ``units``-scaled cadence maths keeps both
tiers' ``retry_after_s`` hints honest.

The controller holds no lock of its own: the service serializes every call
under its condition lock, and the throughput EWMA is a single float write.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

from ncnet_tpu_torch.serving.request import Overloaded


class AdmissionController:
    """Bounds + the retry-after estimator (see module docstring)."""

    _ALPHA = 0.3  # batch-wall EWMA: ~6-sample memory, enough to track load

    def __init__(self, max_queue: int = 64,
                 max_in_flight_per_client: int = 16,
                 max_batch: int = 8, *, elastic: bool = True,
                 dead_retry_after_s: float = 5.0):
        if max_queue < 1 or max_in_flight_per_client < 1 or max_batch < 1:
            raise ValueError(
                f"bad admission knobs: max_queue={max_queue} "
                f"per_client={max_in_flight_per_client} max_batch={max_batch}"
            )
        self.max_queue = int(max_queue)
        self.max_in_flight_per_client = int(max_in_flight_per_client)
        self.max_batch = int(max_batch)
        self.elastic = bool(elastic)
        self.dead_retry_after_s = float(dead_retry_after_s)
        self._per_client: Dict[str, int] = {}
        self._batch_wall_ewma: Optional[float] = None
        # live pool capacity (single-engine services never call
        # note_capacity and keep the 1/1 default — the single-engine semantics)
        self._ready = 1
        self._total = 1

    # -- accounting (service-lock serialized) -------------------------------

    def note_admit(self, client: str) -> None:
        self._per_client[client] = self._per_client.get(client, 0) + 1

    def note_done(self, client: str) -> None:
        """Called on EVERY terminal outcome of an admitted request — the
        cap tracks outstanding work, so a leak here would slowly choke the
        client out (the chaos suite pins the pairing)."""
        n = self._per_client.get(client, 0) - 1
        if n <= 0:
            self._per_client.pop(client, None)
        else:
            self._per_client[client] = n

    def note_batch_wall(self, seconds: float) -> None:
        s = float(seconds)
        self._batch_wall_ewma = s if self._batch_wall_ewma is None else (
            self._ALPHA * s + (1.0 - self._ALPHA) * self._batch_wall_ewma
        )

    def note_capacity(self, ready: int, total: int) -> None:
        """Live capacity changed.  ``ready``/``total`` are DRAIN-LANE
        UNITS (the module-docstring contract): READY/total replicas for a
        pool-backed service, the pod-wide sum of ready replicas across
        live backends for a router — never the local process's device
        count.  The elastic queue bound and the retry-after cadence both
        re-derive from the live unit count."""
        self._ready = max(0, int(ready))
        self._total = max(1, int(total))

    def outstanding(self, client: str) -> int:
        return self._per_client.get(client, 0)

    # -- the decision -------------------------------------------------------

    def effective_max_queue(self) -> int:
        """The live queue bound: ``max_queue`` scaled by the ready/total
        unit fraction (elastic pools only), floored at one batch so a
        single surviving drain lane still coalesces full batches (the
        router's drain unit is one request — ``max_batch=1`` — so its
        floor is one)."""
        if not self.elastic or self._total <= 1:
            return self.max_queue
        share = self.max_queue * self._ready / self._total
        return max(self.max_batch, int(math.ceil(share)))

    def retry_after_s(self, queue_depth: int) -> float:
        """When a shed client should retry: the time to drain the current
        queue at the recent AGGREGATE pool cadence (``ready`` replicas
        drain in parallel, so batches-ahead x wall / ready), floored at
        50 ms (an empty estimate must not invite an instant hammer-retry).
        With zero ready replicas the honest hint is the resurrection-probe
        period — the soonest any capacity can come back."""
        if self._ready == 0:
            return round(self.dead_retry_after_s, 3)
        wall = self._batch_wall_ewma if self._batch_wall_ewma else 0.1
        batches_ahead = max(1.0, queue_depth / self.max_batch)
        return max(0.05, round(batches_ahead * wall / self._ready, 3))

    def admit(self, client: str, queue_depth: int) -> None:
        """Raise :class:`Overloaded` when the request must shed; returns
        None when admissible.  The caller (service.submit, under its lock)
        then enqueues and calls :meth:`note_admit` — check and commit are
        one critical section."""
        if self._ready == 0:
            raise Overloaded(
                f"no ready replicas ({self._total} in pool, all dead; "
                "resurrection probes pending)",
                reason="no_capacity",
                retry_after_s=self.retry_after_s(queue_depth),
            )
        bound = self.effective_max_queue()
        if queue_depth >= bound:
            raise Overloaded(
                f"queue full ({queue_depth}/{bound}"
                + (f", {self._ready}/{self._total} replicas ready"
                   if self._total > 1 else "") + ")",
                reason="queue_full",
                retry_after_s=self.retry_after_s(queue_depth),
            )
        if self.outstanding(client) >= self.max_in_flight_per_client:
            raise Overloaded(
                f"client {client!r} has "
                f"{self.outstanding(client)} requests in flight "
                f"(cap {self.max_in_flight_per_client})",
                reason="client_cap",
                retry_after_s=self.retry_after_s(queue_depth),
            )
