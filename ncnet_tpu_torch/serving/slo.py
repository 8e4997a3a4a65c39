"""SLO accounting for the match service: latency objectives + error budget.

The serving stack's availability story so far is *mechanical* (outcome-total
settlement, failover, drains); this module adds the *contractual* one: a
per-bucket latency objective and an error budget, tracked live so the
``/metrics`` plane, the ``slo`` event stream, ``run_report --slo`` and the
perf-store gate all answer the operator question "are we inside our SLO,
and how fast are we burning the budget?"

Definitions (pinned here so every consumer agrees):

  * An admitted request is **SLO-bad** when it terminates as
    ``deadline`` / ``quarantined`` / an admitted ``shed`` (an aborted
    shutdown or crash rejected it), or as a ``result`` whose end-to-end
    wall exceeds its bucket's latency objective (``slo_ms`` /
    ``slo_ms_by_bucket``; no objective configured ⇒ results are always
    good).  Rejections at the door (never admitted) are capacity policy,
    not SLO violations — they are counted separately by admission metrics.
  * **Budget burn** is the bad fraction measured against the allowed bad
    fraction: ``burn_pct = 100 · (bad/admitted) / (slo_budget_pct/100)``.
    100 means the budget is exactly spent; >100 means the SLO is blown.
  * The **window burn** is the same ratio over the last ``slo_window``
    terminated requests — the live "are we burning NOW" signal that a
    long healthy history cannot dilute.

Exact-replay contract: the tracker classifies from the SAME values the
event log records (the rounded ``wall_ms`` of ``serve_result``, the
``admitted`` flags of ``serve_deadline``/``serve_shed``), so
``tools/run_report.py --slo`` replaying a dead service's log recomputes
counters that match the final ``/metrics`` scrape EXACTLY — the
scrape-vs-replay consistency bar in the tier-1 acceptance chain.

The tracker holds no lock: the service serializes ``observe`` under its
condition lock exactly like the admission controller, and ``snapshot`` is
called from the introspection thread under the same lock.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Deque, Dict, Optional, Tuple

# the SLO-bad classes (latency misses are the fourth, implicit class)
BAD_OUTCOMES = ("deadline", "quarantined", "shed")


class SLOTracker:
    """Sliding-window error-budget accounting (see module docstring).

    ``registry`` (optional) receives mirror counters/gauges so the
    ``/metrics`` exposition and the in-process snapshot can never drift:
    ``slo_admitted``, ``slo_ok``, ``slo_miss_<class>``,
    ``slo_budget_burn_pct``, ``slo_window_burn_pct``.
    """

    def __init__(self, *, default_ms: Optional[float] = None,
                 by_bucket: Tuple[Tuple[str, float], ...] = (),
                 budget_pct: float = 1.0, window: int = 256,
                 emit_every: int = 32, registry=None):
        if budget_pct <= 0 or budget_pct > 100:
            raise ValueError(f"slo_budget_pct must be in (0, 100], "
                             f"got {budget_pct}")
        if window < 1 or emit_every < 1:
            raise ValueError(
                f"bad SLO knobs: window={window} emit_every={emit_every}")
        self.default_ms = float(default_ms) if default_ms else None
        self.by_bucket: Dict[str, float] = {
            str(k): float(v) for k, v in by_bucket}
        self.budget_pct = float(budget_pct)
        self.emit_every = int(emit_every)
        self.admitted = 0
        self.ok = 0
        self.bad: Dict[str, int] = {k: 0 for k in BAD_OUTCOMES}
        self.bad["latency"] = 0
        self._window: Deque[bool] = deque(maxlen=int(window))
        self._registry = registry
        self._since_emit = 0

    # -- objectives ---------------------------------------------------------

    def objective_ms(self, bucket: Optional[str]) -> Optional[float]:
        """The latency objective for one bucket label (per-bucket override
        first, then the default; None = no latency objective)."""
        if bucket is not None and bucket in self.by_bucket:
            return self.by_bucket[bucket]
        return self.default_ms

    def config(self) -> Dict[str, Any]:
        """The objectives document stamped into ``serve_start`` and every
        ``slo`` event — what lets ``run_report --slo`` replay a log with
        the exact thresholds the live tracker used."""
        return {
            "default_ms": self.default_ms,
            "by_bucket": dict(self.by_bucket),
            "budget_pct": self.budget_pct,
            "window": self._window.maxlen,
        }

    # -- accounting (service-lock serialized) -------------------------------

    def observe(self, outcome: str, *, bucket: Optional[str] = None,
                wall_ms: Optional[float] = None) -> bool:
        """Record one admitted request's terminal outcome; returns True when
        an ``slo`` event is due (the CALLER emits it outside the lock, with
        :meth:`snapshot` as the payload — events under the service lock
        would serialize admission behind the fsync)."""
        self.admitted += 1
        miss: Optional[str] = None
        if outcome == "result":
            obj = self.objective_ms(bucket)
            if obj is not None and wall_ms is not None and wall_ms > obj:
                miss = "latency"
        elif outcome in BAD_OUTCOMES:
            miss = outcome
        elif outcome != "result":
            raise ValueError(f"unknown SLO outcome {outcome!r}")
        if miss is None:
            self.ok += 1
        else:
            self.bad[miss] += 1
        self._window.append(miss is not None)
        if self._registry is not None:
            self._registry.counter("slo_admitted").inc()
            if miss is None:
                self._registry.counter("slo_ok").inc()
            else:
                self._registry.counter(f"slo_miss_{miss}").inc()
            self._registry.gauge("slo_budget_burn_pct").set(
                self.budget_burn_pct())
            self._registry.gauge("slo_window_burn_pct").set(
                self.window_burn_pct())
        self._since_emit += 1
        if self._since_emit >= self.emit_every:
            self._since_emit = 0
            return True
        return False

    # -- derived ------------------------------------------------------------

    def bad_total(self) -> int:
        return sum(self.bad.values())

    def _burn(self, bad: int, n: int) -> float:
        if not n:
            return 0.0
        return round(100.0 * (bad / n) / (self.budget_pct / 100.0), 4)

    def budget_burn_pct(self) -> float:
        """Cumulative burn: 100 = budget exactly spent, >100 = SLO blown."""
        return self._burn(self.bad_total(), self.admitted)

    def window_burn_pct(self) -> float:
        return self._burn(sum(self._window), len(self._window))

    def snapshot(self) -> Dict[str, Any]:
        """The ``slo`` event payload / health-document section — plain data,
        byte-for-byte reproducible from the event log by
        ``run_report --slo``."""
        return {
            "objectives": self.config(),
            "admitted": self.admitted,
            "ok": self.ok,
            "bad": dict(self.bad),
            "bad_total": self.bad_total(),
            "budget_burn_pct": self.budget_burn_pct(),
            "window": {
                "n": len(self._window),
                "bad": int(sum(self._window)),
                "burn_pct": self.window_burn_pct(),
            },
        }
