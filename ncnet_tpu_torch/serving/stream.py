"""Stream sessions for tracked (coarse-pass-skipping) video matching, the
port of ``ncnet_tpu/serving/stream.py``.

One :class:`StreamSession` per live video stream: the session owns the
temporal prior pair frame ``t`` seeds its candidates from (inverted from
frame ``t-1``'s served match table, ``ops/temporal.prior_from_table``), the
memoized content digest of the stream's reference image, the quality-EMA
baseline the cut detector compares against, and the per-stream FIFO lock
that serializes the stream's frames through admission and batching (frame
``t`` cannot be built before frame ``t-1``'s table exists — the data
dependence IS the ordering guarantee, and the lock extends it to
multi-threaded callers of one stream id).

:class:`StreamTable` is the service-side registry: bounded, idle-evicted
from the worker tick, drained with the service, and summarized into the
health document's ``streams`` section.

:func:`run_stream_load` is the open-loop load generator (the chaos tests; the JAX
package's bench and ``tools/stream_probe.py``): per-stream arrival
schedules with jitter and bursts, frames submitted at their scheduled
instants whatever the completions (backpressure shows up as lateness),
one outcome record a frame.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ncnet_tpu_torch.serving.request import Bucket, MatchResult

# EMA memory of the per-stream quality baseline (~6 frames, the admission
# batch-wall constant): long enough to ride out one noisy frame, short
# enough that a re-seeded tracker re-baselines within a burst
_QUALITY_EWMA_ALPHA = 0.3


@dataclasses.dataclass
class StreamFrameResult:
    """What :meth:`MatchService.stream_submit` returns for one frame: the
    ordinary :class:`MatchResult` plus the streaming-plane facts the
    open-loop load generator and the tests assert on."""

    result: MatchResult
    stream: str
    seq: int
    tracked: bool      # served by the coarse-pass-free tracked program
    fallback: bool     # a cut/drift fallback re-ran the full pipeline
    recall: Optional[float]  # candidate-containment proxy (tracked frames)

    @property
    def table(self) -> np.ndarray:
        return self.result.table


class StreamSession:
    """Per-stream state (see module docstring).  ``lock`` is the stream's
    FIFO: the service holds it for the whole frame round trip, so one
    stream's frames admit, batch, and settle strictly in ``seq`` order
    while other streams proceed concurrently."""

    def __init__(self, stream_id: str):
        self.id = stream_id
        self.lock = threading.Lock()
        self.created_t = time.monotonic()
        self.last_activity = self.created_t
        self.seq = 0
        # temporal prior pair over the session's bucket's coarse grids;
        # None until the first full-pipeline frame seeds the tracker
        self.bucket: Optional[Bucket] = None
        self.prior_ab: Optional[np.ndarray] = None
        self.prior_ba: Optional[np.ndarray] = None
        # memoized reference-image digest (of the PADDED bucket row — the
        # exact bytes the engine's store path would hash), keyed by object
        # identity: a steady stream passes the same reference array every
        # frame, so identity is the zero-cost "unchanged" witness.  A new
        # array object re-hashes (mutating an array in place between
        # frames is a caller error the identity check cannot see).
        self._digest: Optional[str] = None
        self._digest_src_id: Optional[int] = None
        self._digest_bucket: Optional[Bucket] = None
        # quality-EMA baseline for the cut detector
        self.score_ema: Optional[float] = None
        self.coherence_ema: Optional[float] = None
        self.last_recall: Optional[float] = None
        # counters (health/metrics rows)
        self.frames = 0
        self.tracked_frames = 0
        self.fallback_frames = 0
        self.cold_frames = 0
        self.errors = 0

    def src_digest(self, src: np.ndarray, bucket: Bucket,
                   padded_row: Callable[[], np.ndarray]) -> str:
        """The reference image's content digest, hashed at most once per
        (array object, bucket) — the satellite fix for the per-request
        sha256 the store-backed pair path used to pay."""
        if (self._digest is not None and self._digest_src_id == id(src)
                and self._digest_bucket == bucket):
            return self._digest
        from ncnet_tpu_torch.store import content_digest

        self._digest = content_digest(np.ascontiguousarray(padded_row()))
        self._digest_src_id = id(src)
        self._digest_bucket = bucket
        return self._digest

    def note_quality(self, quality: Optional[Dict[str, float]]) -> None:
        if not quality:
            return
        a = _QUALITY_EWMA_ALPHA
        s = quality.get("score")
        if s is not None:
            self.score_ema = s if self.score_ema is None \
                else a * s + (1 - a) * self.score_ema
        c = quality.get("coherence")
        if c is not None:
            self.coherence_ema = c if self.coherence_ema is None \
                else a * c + (1 - a) * self.coherence_ema

    def quality_collapsed(self, quality: Optional[Dict[str, float]],
                          frac: float) -> bool:
        """The quality-collapse half of the cut detector: a tracked
        frame whose score OR coherence fell below ``frac`` of the stream's
        EMA baseline stopped matching the scene the tracker believes in.
        No baseline yet (first frames) → never collapsed by this test."""
        if not quality:
            return False
        s, c = quality.get("score"), quality.get("coherence")
        if s is not None and self.score_ema is not None \
                and s < frac * self.score_ema:
            return True
        if c is not None and self.coherence_ema is not None \
                and c < frac * self.coherence_ema:
            return True
        return False

    def reset_tracking(self) -> None:
        """Drop the prior pair (bucket change, eviction re-entry): the next
        frame runs the full pipeline and re-seeds."""
        self.prior_ab = None
        self.prior_ba = None
        self.score_ema = None
        self.coherence_ema = None
        self.last_recall = None

    def row(self, now: float) -> Dict[str, Any]:
        """This session's row in the health document."""
        return {
            "stream": self.id,
            "frames": self.frames,
            "tracked": self.tracked_frames,
            "fallback": self.fallback_frames,
            "cold": self.cold_frames,
            "errors": self.errors,
            "seeded": self.prior_ab is not None,
            "recall": (round(self.last_recall, 4)
                       if self.last_recall is not None else None),
            "idle_s": round(max(0.0, now - self.last_activity), 3),
        }


class StreamTable:
    """Bounded registry of live stream sessions.  Thread-safe; the service
    worker evicts idle sessions on its tick and drains the table at stop.
    Aggregate counters survive their sessions — the Prometheus families
    (``ncnet_serve_stream_*``) are monotone across evictions."""

    def __init__(self, *, max_sessions: int = 64,
                 idle_evict_s: float = 30.0):
        self.max_sessions = max_sessions
        self.idle_evict_s = idle_evict_s
        self._lock = threading.Lock()
        self._sessions: Dict[str, StreamSession] = {}
        # monotone totals (evicted sessions fold in here)
        self.total_frames = 0
        self.total_tracked = 0
        self.total_fallback = 0
        self.total_cold = 0
        self.total_evicted = 0

    def acquire(self, stream_id: str) -> StreamSession:
        """Get-or-create; raises ``Overloaded(reason="stream_cap")`` when
        the table is full and no idle session can make room (an ACTIVE
        session is never evicted to admit a new stream)."""
        from ncnet_tpu_torch.serving.request import Overloaded

        now = time.monotonic()
        with self._lock:
            sess = self._sessions.get(stream_id)
            if sess is not None:
                sess.last_activity = now
                return sess
            if len(self._sessions) >= self.max_sessions:
                victim = self._evict_lru_locked(now)
                if victim is None:
                    raise Overloaded(
                        f"stream table full ({self.max_sessions} live "
                        f"sessions, none idle)", reason="stream_cap")
            sess = StreamSession(stream_id)
            self._sessions[stream_id] = sess
            return sess

    def _fold_locked(self, sess: StreamSession) -> None:
        self.total_evicted += 1

    def _evict_lru_locked(self, now: float) -> Optional[StreamSession]:
        idle = [s for s in self._sessions.values() if not s.lock.locked()]
        if not idle:
            return None
        victim = min(idle, key=lambda s: s.last_activity)
        del self._sessions[victim.id]
        self._fold_locked(victim)
        return victim

    def note_frame(self, kind: str) -> None:
        """Aggregate a terminal frame outcome (``tracked`` / ``fallback`` /
        ``cold``) into the monotone totals."""
        with self._lock:
            self.total_frames += 1
            if kind == "tracked":
                self.total_tracked += 1
            elif kind == "fallback":
                self.total_fallback += 1
            else:
                self.total_cold += 1

    def evict_idle(self, now: Optional[float] = None
                   ) -> List[StreamSession]:
        """Evict sessions idle past the threshold (skipping any whose FIFO
        lock is held — a frame in flight is activity the stamp just hasn't
        recorded yet).  Returns the evicted sessions for event emission."""
        now = time.monotonic() if now is None else now
        out: List[StreamSession] = []
        with self._lock:
            for sid in list(self._sessions):
                s = self._sessions[sid]
                if s.lock.locked():
                    continue
                if now - s.last_activity >= self.idle_evict_s:
                    del self._sessions[sid]
                    self._fold_locked(s)
                    out.append(s)
        return out

    def evict_all(self) -> List[StreamSession]:
        with self._lock:
            out = list(self._sessions.values())
            for s in out:
                self._fold_locked(s)
            self._sessions.clear()
        return out

    def doc(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The health document's ``streams`` section."""
        now = time.monotonic() if now is None else now
        with self._lock:
            rows = [s.row(now) for s in self._sessions.values()]
            recalls = [r["recall"] for r in rows if r["recall"] is not None]
            return {
                "active": len(rows),
                "max_sessions": self.max_sessions,
                "idle_evict_s": self.idle_evict_s,
                "frames": self.total_frames,
                "tracked_frames": self.total_tracked,
                "fallback_frames": self.total_fallback,
                "cold_frames": self.total_cold,
                "evicted": self.total_evicted,
                "recall_mean": (round(float(np.mean(recalls)), 4)
                                if recalls else None),
                "sessions": sorted(rows, key=lambda r: r["stream"]),
            }


# ---------------------------------------------------------------------------
# the open-loop streaming load generator
# ---------------------------------------------------------------------------


def stream_schedule(frames: int, rate_hz: float, *, jitter: float = 0.3,
                    burst_every: int = 4, seed: int = 0) -> List[float]:
    """Open-loop arrival offsets (seconds from stream start): a jittered
    base period with every ``burst_every``-th gap collapsed to zero —
    bursty arrivals that stress admission and coalescing the way a real
    camera's frame pacing (vsync drift + transport hiccups) does."""
    rng = np.random.RandomState(seed)
    period = 1.0 / max(rate_hz, 1e-6)
    t, out = 0.0, []
    for i in range(frames):
        out.append(t)
        gap = period * (1.0 + jitter * float(rng.uniform(-1.0, 1.0)))
        if burst_every > 0 and (i + 1) % burst_every == 0:
            gap = 0.0
        t += max(0.0, gap)
    return out


def run_stream_load(
    service, frame_fn: Callable[[int, int], Tuple[np.ndarray, np.ndarray]],
    *, streams: int = 2, frames: int = 8, rate_hz: float = 20.0,
    jitter: float = 0.3, burst_every: int = 4,
    deadline_s: Optional[float] = None, seed: int = 0,
    stream_prefix: str = "cam",
) -> List[Dict[str, Any]]:
    """Drive ``streams`` concurrent open-loop streams of ``frames`` frames
    each through ``service.stream_submit``.

    ``frame_fn(stream_idx, frame_idx)`` supplies each frame's (reference,
    frame) uint8 pair — cut injection is the caller's choice of content.
    Per-stream ordering is structural (each stream thread blocks on its
    frame before the next), and the OPEN loop is preserved across frames
    by scheduling: a frame whose arrival instant has passed while the
    previous frame was in flight submits immediately, and its lateness is
    recorded (``late_ms``) instead of silently re-pacing the client.

    Returns one record per frame: stream, seq, outcome ("result" or the
    classified error name), tracked/fallback flags, recall, wall_ms,
    late_ms — everything the bench extras and the SLO replay assert on.
    """
    from ncnet_tpu_torch.serving.request import ServeError

    records: List[List[Dict[str, Any]]] = [[] for _ in range(streams)]

    def one_stream(si: int) -> None:
        from ncnet_tpu_torch.observability.tracing import new_trace

        sched = stream_schedule(frames, rate_hz, jitter=jitter,
                                burst_every=burst_every, seed=seed + si)
        sid = f"{stream_prefix}{si}"
        # one pod trace per stream: every frame of a session shares the
        # trace id, so the federated view groups a camera's whole life
        trace = new_trace().trace_id
        t0 = time.monotonic()
        for fi in range(frames):
            due = t0 + sched[fi]
            now = time.monotonic()
            if due > now:
                time.sleep(due - now)
            late_ms = round(max(0.0, time.monotonic() - due) * 1e3, 3)
            src, tgt = frame_fn(si, fi)
            t1 = time.monotonic()
            rec: Dict[str, Any] = {"stream": sid, "seq": fi,
                                   "late_ms": late_ms}
            try:
                fr = service.stream_submit(
                    sid, src, tgt, deadline_s=deadline_s,
                    client=f"{stream_prefix}{si}", trace=trace)
                rec.update(outcome="result", tracked=fr.tracked,
                           fallback=fr.fallback, recall=fr.recall,
                           wall_ms=round((time.monotonic() - t1) * 1e3, 3))
            except ServeError as e:
                rec.update(outcome=e.outcome, tracked=False, fallback=False,
                           recall=None,
                           wall_ms=round((time.monotonic() - t1) * 1e3, 3))
            records[si].append(rec)

    threads = [threading.Thread(target=one_stream, args=(i,),
                                name=f"stream-load-{i}", daemon=True)
               for i in range(streams)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    flat = [r for per in records for r in per]
    # the per-stream ordering invariant, asserted where the records are
    # born: each stream's results appended strictly in seq order
    for per in records:
        seqs = [r["seq"] for r in per]
        assert seqs == sorted(seqs), f"stream records out of order: {seqs}"
    return flat
