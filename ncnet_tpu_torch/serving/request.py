"""Request lifecycle types for the resident match service.

The serving contract (ncnet_tpu_torch/serving/service.py) is outcome-total: every
request presented to :meth:`MatchService.submit` terminates in EXACTLY ONE of
four classified outcomes —

  * ``result``      — the match table (plus per-pair quality signals) came
    back within budget; the future resolves with a :class:`MatchResult`.
  * ``deadline``    — the request's deadline expired (at admission, at
    dequeue before dispatch, or by the time its batch's fetch landed); the
    future raises :class:`DeadlineExceeded` naming where the budget died.
  * ``overloaded``  — admission shed the request (queue full, per-client
    cap, bucket capacity, draining) with a ``retry_after_s`` hint, or an
    aborted shutdown rejected admitted-but-unfinished work; the caller gets
    :class:`Overloaded` with a machine-readable ``reason``.
  * ``quarantined`` — the request failed repeatedly after every recovery
    (replica failover, budgeted retries) was exhausted; :class:`RequestQuarantined`
    carries the classified failure kind, and the request lands in the
    service's quarantine manifest (the eval loops' ``RunManifest``).

Nothing is ever silently dropped: the chaos suite (tests/test_serving.py)
proves the accounting identity ``admitted == results + deadlines +
quarantines + admitted_sheds`` over the event log, and ``tools/run_report.py
--serving`` recomputes it for any run.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

# the four terminal outcomes; `outcome` on a settled MatchFuture is one of
# these, and the event-log accounting in run_report --serving sums them
TERMINAL_OUTCOMES = ("result", "deadline", "overloaded", "quarantined")

# bucket key: ((src_h, src_w), (tgt_h, tgt_w)) padded shapes — one compiled
# program per key (the bounded jit cache unit)
Bucket = Tuple[Tuple[int, int], Tuple[int, int]]


def bucket_label(bucket: Bucket) -> str:
    """Stable human/metric label for a shape bucket: ``64x64-96x64``."""
    (sh, sw), (th, tw) = bucket
    return f"{sh}x{sw}-{th}x{tw}"


class ServeError(RuntimeError):
    """Base of the classified terminal rejections."""

    outcome: str = "overloaded"


class Overloaded(ServeError):
    """Admission shed the request (or an aborted shutdown rejected it).

    ``reason`` is machine-readable: ``queue_full`` / ``client_cap`` /
    ``bucket_capacity`` / ``unservable_shape`` / ``no_capacity`` (every
    pool replica is DEAD; retry after the resurrection-probe period) /
    ``draining`` / ``stopped`` / ``shutdown`` / ``crashed``.  ``retry_after_s`` (when not None) is the
    service's estimate of when a retry could be admitted — derived from the
    current queue depth and the recent batch wall, so a well-behaved client
    backs off proportionally to actual load instead of hammering.
    """

    outcome = "overloaded"

    def __init__(self, message: str, *, reason: str,
                 retry_after_s: Optional[float] = None):
        super().__init__(message)
        self.reason = reason
        self.retry_after_s = retry_after_s


class DeadlineExceeded(ServeError):
    """The request's deadline budget expired.  ``where`` names the check
    that caught it: ``admission`` (already expired when submitted — never
    admitted), ``dequeue`` (evicted from its batch before dispatch), or
    ``fetch`` (the result landed after the caller's budget — discarded, the
    caller has by contract moved on)."""

    outcome = "deadline"

    def __init__(self, message: str, *, where: str):
        super().__init__(message)
        self.where = where


class RequestQuarantined(ServeError):
    """Retries and program-changing recoveries were exhausted for this
    request; the service gave up on it (and recorded it in the quarantine
    manifest) rather than let it wedge the stream."""

    outcome = "quarantined"

    def __init__(self, message: str, *, kind: str, attempts: int):
        super().__init__(message)
        self.kind = kind
        self.attempts = attempts


@dataclasses.dataclass
class MatchResult:
    """One served pair: the match table rows plus the in-graph quality
    signals that rode back in the same device→host pull.

    ``matches`` is the raw ``(5, N)`` float32 table (xA, yA, xB, yB, score —
    the :class:`~ncnet_tpu_torch.ops.matching.Matches` row order; coordinates are
    normalized over the PADDED bucket grid, see the README "Serving"
    section).  ``quality`` maps each
    :data:`~ncnet_tpu_torch.observability.quality.QUALITY_SIGNALS` name to its
    per-pair value (None when the table was too narrow to carry the row).
    """

    request_id: str
    table: np.ndarray
    quality: Optional[Dict[str, float]]
    bucket: Bucket
    wall_s: float

    @property
    def matches(self):
        from ncnet_tpu_torch.ops.matching import Matches

        return Matches(*(self.table[i] for i in range(5)))


class MatchFuture:
    """Thread-safe one-shot result slot for a submitted request.

    ``result(timeout)`` blocks until the request reaches its terminal
    outcome, then returns the :class:`MatchResult` or raises the classified
    terminal error.  ``outcome`` is None until settled, then one of
    :data:`TERMINAL_OUTCOMES`.  Settling twice is a programming error in
    the service and raises — the outcome-total contract means exactly one.
    ``settled_t`` is the ``time.monotonic`` instant of the settle, taken
    before any waiter can wake: the request's timeline ends there, so a
    backend's slice never outlasts the reply its caller reads.
    """

    def __init__(self, request_id: str):
        self.request_id = request_id
        self.outcome: Optional[str] = None
        self.settled_t: Optional[float] = None
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._result: Optional[MatchResult] = None
        self._error: Optional[BaseException] = None

    def _settle(self, outcome: str, *, result: Optional[MatchResult] = None,
                error: Optional[BaseException] = None) -> None:
        if not self._try_settle(outcome, result=result, error=error):
            raise RuntimeError(
                f"request {self.request_id} settled twice "
                f"({self.outcome} then {outcome})"
            )

    def _try_settle(self, outcome: str, *,
                    result: Optional[MatchResult] = None,
                    error: Optional[BaseException] = None) -> bool:
        """Atomically settle if still pending; False when another path won
        the race.  The check-and-set is one critical section because the
        pool's settle paths genuinely race: a bounded-join shutdown
        force-settles a hung fetcher's batch while the late fetch may be
        landing its results — exactly one side must win, and the loser must
        skip its accounting rather than crash."""
        assert outcome in TERMINAL_OUTCOMES
        with self._lock:
            if self.outcome is not None:
                return False
            self._result, self._error = result, error
            self.outcome = outcome
            self.settled_t = time.monotonic()
        self._event.set()
        return True

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> MatchResult:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not settled within {timeout}s"
            )
        if self._error is not None:
            raise self._error
        assert self._result is not None
        return self._result


@dataclasses.dataclass
class MatchRequest:
    """One admitted request moving through the queue/batch/fetch pipeline.
    ``deadline_t`` is an absolute ``time.monotonic`` instant (None = no
    deadline); ``attempts`` counts BUDGETED failures only — a failover to
    another replica retries free (the port has no demote-and-retrace,
    ROADMAP D4), the
    :func:`~ncnet_tpu_torch.evaluation.resilience.run_isolated` discipline."""

    id: str
    client: str
    src: np.ndarray
    tgt: np.ndarray
    bucket: Bucket
    future: MatchFuture
    submitted_t: float
    deadline_t: Optional[float] = None
    attempts: int = 0
    # replica ids this request's batch has already failed on: the router
    # prefers replicas NOT in this set, and a re-route to a fresh replica
    # is off-budget (the failure was the replica's, not the request's);
    # once no fresh READY replica remains, failures charge the budget
    failed_on: set = dataclasses.field(default_factory=set)
    # trace-timeline stamps (time.monotonic, like submitted_t/deadline_t):
    # the service stamps dispatch and fetch-begin so every terminal outcome
    # can attribute its end-to-end wall to queue vs device vs fetch time
    # (a request re-dispatched by failover keeps its LAST stamps — the
    # attribution covers the attempt that terminated it, and the queue
    # segment absorbs the earlier failed round trips)
    dispatched_t: Optional[float] = None
    fetch_begin_t: Optional[float] = None
    # streaming tracked mode (serving/stream.py): requests carrying a
    # session's temporal priors dispatch through the engine's coarse-pass-
    # free tracked program.  The dispatcher keeps batches tracked-
    # homogeneous (a tracked and a plain request cannot share a program),
    # and ``src_digest`` lets the engine skip re-hashing a stream's
    # unchanged reference image.  All None/False for ordinary requests —
    # the plain path is untouched.
    stream: Optional[str] = None
    stream_seq: int = 0
    tracked: bool = False
    prior_ab: Optional[np.ndarray] = None
    prior_ba: Optional[np.ndarray] = None
    src_digest: Optional[str] = None
    # pod-wide trace id (observability/tracing.py::TraceContext) adopted
    # from the wire or the submitting caller: every event this request
    # touches carries it, so the federated pod trace and the pod identity
    # report can join this process's slice of the request to the rest.
    # None for an untraced request — the plain path is untouched.
    trace: Optional[str] = None

    def expired(self, now: float) -> bool:
        return self.deadline_t is not None and now >= self.deadline_t

    def remaining_s(self, now: float) -> Optional[float]:
        if self.deadline_t is None:
            return None
        return self.deadline_t - now

    def timeline_ms(self, settled_t: float) -> Dict[str, float]:
        """Phase attribution of this request's life, in milliseconds:
        ``queue_ms`` (admission → dispatch: queueing + bucket coalescing),
        ``device_ms`` (dispatch → fetch-begin: in flight on the replica,
        the async device execution overlapping the fetch lane's backlog),
        ``fetch_ms`` (fetch-begin → settle: the blocking device→host pull
        and settlement).  Phases the request never reached are absent
        (a dequeue-evicted deadline has only ``queue_ms``), and
        ``total_ms`` is the SUM of the rendered segments — the identity
        the Perfetto timeline export and the tier-1 chain rely on."""
        segs: Dict[str, float] = {}
        queue_end = self.dispatched_t if self.dispatched_t is not None \
            else settled_t
        segs["queue_ms"] = round(
            max(0.0, queue_end - self.submitted_t) * 1e3, 3)
        if self.dispatched_t is not None:
            dev_end = self.fetch_begin_t \
                if self.fetch_begin_t is not None else settled_t
            segs["device_ms"] = round(
                max(0.0, dev_end - self.dispatched_t) * 1e3, 3)
            if self.fetch_begin_t is not None:
                segs["fetch_ms"] = round(
                    max(0.0, settled_t - self.fetch_begin_t) * 1e3, 3)
        segs["total_ms"] = round(sum(segs.values()), 3)
        return segs


def as_pair_image(x: Any, name: str) -> np.ndarray:
    """Validate/normalize one side of a pair to ``(H, W, 3)`` uint8 — the
    serving wire shape.  A leading batch-1 axis (the demo/matcher shape
    ``(1, H, W, 3)``) is squeezed; anything else is a caller error, rejected
    synchronously at submit rather than poisoning a batch."""
    arr = np.asarray(x)
    if arr.ndim == 4 and arr.shape[0] == 1:
        arr = arr[0]
    if arr.ndim != 3 or arr.shape[-1] != 3:
        raise ValueError(
            f"{name} must be (H, W, 3) or (1, H, W, 3) uint8, got "
            f"{arr.shape}"
        )
    if arr.dtype != np.uint8:
        raise ValueError(f"{name} must be uint8 (raw image bytes; the "
                         f"service normalizes on device), got {arr.dtype}")
    return arr
