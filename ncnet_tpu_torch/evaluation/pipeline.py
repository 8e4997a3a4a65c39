"""The eval loops' dispatch/fetch pipeline machinery, the port of
``ncnet_tpu/evaluation/pipeline.py`` (``PipelineDepthController``,
``FetchTimeoutError``, ``call_with_watchdog``).

The eval loop dispatches batch i+1 before fetching batch i, so the
host's decode, upload and launch overhead hides behind the card's compute
(CUDA launches are asynchronous; a fetch is the ``.cpu()`` of the step's
output).  The controller adapts the queue depth to the measured
drain-to-drain wall; :meth:`PipelineDepthController.note_failure` keeps an
aborted drain out of its statistics, and :func:`call_with_watchdog` turns a
hung fetch into a retryable :class:`FetchTimeoutError` instead of an
eternal stall.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional


class PipelineDepthController:
    """Adaptive dispatch/fetch pipeline depth for an eval loop.

    The JAX package measured depth 2 best when dispatch latency is low
    and deeper queues (3-4) best when it is high; the port keeps its
    controller and constants unchanged (no card measurement has tuned them
    yet).  It watches a 4-sample-memory EWMA of the drain-to-drain wall:
    above ``high`` s/drain it deepens one step up to 4; below ``low`` it
    returns to 2.  The thresholds default to ratios of the best (minimum)
    wall in a 16-sample window — a drain can never complete faster than one
    unit's device compute, so the windowed minimum IS a measured
    device-compute estimate, and ``2.0×best`` / ``1.3×best`` mark the
    latency-dominated and recovered regimes — capped at
    ``high_cap``/``low_cap`` (defaults 0.7/0.45 s a drain; callers whose
    drain unit is a batch scale them up): the caps rescue a run that
    cold-starts in a high-latency regime (where every wall is inflated and
    a pure ratio of the minimum would never trigger), and the window bounds
    the damage of a single anomalously short wall to ~1.5 queries instead
    of the rest of the run.  Explicit ``high``/``low`` seconds override the
    derived thresholds.

    Wall statistics alone cannot distinguish latency-dominated from
    compute-bound slowness (in both, EWMA ≈ best), so every deepen is a
    SPECULATIVE PROBE: the pre-deepen EWMA is remembered, and if the next
    window's EWMA has not improved by ≥15% the step is reverted and
    further deepens are blocked until the EWMA leaves that regime (>1.3×
    the failed probe's wall, or a recovery below ``low``).  A genuinely
    compute-bound rig therefore pays one brief probe (two extra in-flight
    buffers for ~4 drains) instead of being pinned at depth 4 for the
    run, and a miscalibrated threshold self-corrects.

    A depth change resets the EWMA window AND the interval anchor (the
    min-wall window deliberately survives — it estimates device compute,
    which a depth change does not alter): the first post-change interval
    spans the queue refill (two dispatches, no drain between) and would
    otherwise read as ~2× the true wall, re-triggering a spurious deepen.  Inter-query gaps (preprocess + IO) are excluded via
    :meth:`note_gap`; depth and the device-compute estimate persist across
    queries, so each query seeds from the regime the previous one
    measured.

    ``fixed>0`` pins the depth verbatim and bypasses the 2–4 adaptive band
    entirely (a pinned 1 or 6 is honored); negative values are rejected.
    """

    _ALPHA = 0.4    # EWMA weight: ~4-sample effective memory (2/α − 1)
    _WINDOW = 16    # min-wall window: an outlier washes out in ~1.5 queries

    def __init__(self, fixed: int = 0, high: Optional[float] = None,
                 low: Optional[float] = None, high_cap: float = 0.7,
                 low_cap: float = 0.45):
        if fixed < 0:
            raise ValueError(
                f"pipeline_depth={fixed}: use 0 (adaptive) or a positive "
                "pinned depth"
            )
        self.depth = fixed if fixed > 0 else 2
        self._fixed = fixed > 0
        self._high, self._low = high, low
        self._high_cap, self._low_cap = high_cap, low_cap
        self._t_last: Optional[float] = None
        self._ewma: Optional[float] = None
        self._n = 0                       # samples since the last depth change
        self._walls: deque = deque(maxlen=self._WINDOW)
        self._probe: Optional[float] = None  # pre-deepen EWMA, judged next window
        self._block: Optional[float] = None  # EWMA regime where a deepen failed

    @property
    def best(self) -> Optional[float]:
        """Windowed-minimum wall ≈ device-compute estimate."""
        return min(self._walls) if self._walls else None

    def note_drain(self) -> None:
        now = time.perf_counter()
        if self._t_last is None:
            self._t_last = now
            return
        dt = now - self._t_last
        self._t_last = now
        self._walls.append(dt)
        self._ewma = dt if self._ewma is None else (
            self._ALPHA * dt + (1.0 - self._ALPHA) * self._ewma
        )
        self._n += 1
        if self._fixed or self._n < 4:
            return
        if self._block is not None and self._ewma > 1.3 * self._block:
            self._block = None  # clearly a new, worse regime: probe again
        if self._probe is not None:
            # judge the speculative deepen against the wall it tried to cut
            if self._ewma > 0.85 * self._probe:
                # no improvement: the slowness is compute, not latency
                self._change_depth(self.depth - 1, "probe_reverted")
                self._block = self._probe
                self._probe = None
                self._reset_ewma()
                return
            self._probe = None  # improvement confirmed; keep the depth
        best = min(self._walls)
        high = (self._high if self._high is not None
                else min(2.0 * best, self._high_cap))
        low = (self._low if self._low is not None
               else min(1.3 * best, self._low_cap))
        if self._ewma > high and self.depth < 4 and self._block is None:
            self._probe = self._ewma
            self._change_depth(self.depth + 1, "deepen_probe")
            self._reset_ewma()
        elif self._ewma < low:
            # regime recovered: lift any failed-probe block even at depth 2,
            # or a later genuine latency regime could never deepen
            self._block = None
            if self.depth > 2:
                self._change_depth(2, "recovered")
                self._probe = None
                self._reset_ewma()

    def _change_depth(self, new: int, reason: str) -> None:
        old, self.depth = self.depth, new
        from ncnet_tpu_torch.observability import events as obs_events

        obs_events.emit("pipeline_depth", depth=new, prev=old, reason=reason)

    def _reset_ewma(self) -> None:
        # resets the decision window + anchor only, NOT the min-wall window:
        # device compute does not change when the depth does
        self._ewma = None
        self._n = 0
        self._t_last = None  # next interval spans the refill — don't record it

    def note_gap(self) -> None:
        self._t_last = None

    def note_failure(self) -> None:
        """An aborted drain (exception or watchdog timeout mid-fetch): the
        dispatch/drain cadence is broken, and the retried query's first
        interval would span the retry's backoff + queue refill — the same
        refill-spanning wall a depth change produces — so clear
        the anchor AND the EWMA decision window.  A pending speculative
        probe is dropped unjudged (its judgment window was torn; the kept
        depth re-judges itself against fresh walls).  The min-wall window
        deliberately survives: device compute is unchanged by a failed
        query, and it is the device-compute estimate the thresholds derive
        from."""
        self._probe = None
        self._reset_ewma()


class FetchTimeoutError(RuntimeError):
    """A dispatch/fetch exceeded its watchdog budget — a hung fetch or
    wedged device surfaced as a *retryable* per-query failure (classified
    'timeout' by evaluation/resilience.classify_failure) instead of stalling
    the eval loop forever."""


def call_with_watchdog(fn, args=(), timeout: float = 0.0, label: str = ""):
    """Run blocking ``fn(*args)`` under a wall-clock watchdog.

    ``timeout <= 0`` disables the watchdog (direct call — the default, since
    a healthy rig should not pay a thread handoff per fetch).  Otherwise the
    call runs in a daemon worker thread; if it has not returned within
    ``timeout`` seconds a :class:`FetchTimeoutError` is raised.  The stuck
    worker thread cannot be killed — it is abandoned (daemonized, so process
    exit is not blocked); the leak is bounded by the caller's retry budget,
    and an actually-hung device leaves the process within a few retries via
    quarantine anyway.

    The injected-hang hook (``faults.hang_fetch_hook``) runs inside the
    worker, so a test-armed hang exercises the REAL timeout path rather than
    a simulated exception.
    """
    from ncnet_tpu_torch.observability.tracing import span
    from ncnet_tpu_torch.utils import faults

    if timeout <= 0:
        with span("watched_call", label=label or "fetch"):
            return fn(*args)
    result = {}
    done = threading.Event()

    def target():
        try:
            faults.hang_fetch_hook(label)
            result["value"] = fn(*args)
        except BaseException as e:  # re-raised in the caller below
            result["error"] = e
        finally:
            done.set()

    worker = threading.Thread(
        target=target, daemon=True,
        name=f"watchdog-{label or 'fetch'}",
    )
    # the span lives on the CALLER's thread (the worker has its own span
    # stack), so a timeout closes it with error=FetchTimeoutError and the
    # trace shows the watchdog budget as the span's wall
    with span("watched_call", label=label or "fetch",
              timeout_s=float(timeout)):
        worker.start()
        if not done.wait(timeout):
            from ncnet_tpu_torch.observability import events as obs_events

            obs_events.emit("watchdog_timeout", label=label or "fetch",
                            timeout_s=float(timeout))
            raise FetchTimeoutError(
                f"{label or 'fetch'} exceeded its {timeout:.1f}s watchdog "
                "(hung fetch or wedged device?)"
            )
        if "error" in result:
            raise result["error"]
        return result["value"]
