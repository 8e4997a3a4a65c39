"""Zero-downtime model rollout: canaried, quality-gated live weight swap
with automatic rollback; the port of ``ncnet_tpu/serving/rollout.py``,
whose candidates load through the port's native checkpoints
(``models/checkpoint.py``).

The serving plane survives dead cards (replica quarantine + resurrection),
dead hosts (the multi-host router), corrupt stores (verified reads), and
overload (elastic admission) — but without this module, a *model update*
requires killing the pod and cold-restarting every replica, warm-up and
all.  :class:`RolloutController` ships new weights while the
pod serves, judges the new version against the old with the SAME label-
free quality signals + PSI drift gate the accuracy sentinel uses
(observability/quality.py), and rolls back automatically when the canary
regresses — zero lost requests in either direction.

State machine (``rollout_phase`` events record every edge)::

    IDLE -> STAGING -> CANARY -> PROMOTING -> COMPLETE
              |           |          |
              +-----------+----------+--> ROLLING_BACK -> ROLLED_BACK
              |
              +--> IDLE   (refused: bad checksum/shape, too few replicas)

  * **STAGING** — resolve the candidate via the versioned-checkpoint
    loader (newest complete ``step_<N>``), refuse it on payload-sha256 or
    architecture mismatch BEFORE touching any replica, then borrow ONE
    replica: drain it (in-flight batches finish; the rest of the pool
    keeps serving at N-1 capacity), swap its weights, and re-warm the
    bucket ladder off the dispatch path (fresh memory-ledger rows on a card).
  * **CANARY** — re-admit the swapped replica and route a configured
    traffic fraction to it (``ReplicaPool.set_canary`` — a deterministic
    credit accumulator, no RNG).  Every ``serve_result``/``quality`` event
    and per-version metric family carries ``model_version``, so the judge
    splits new from old by construction.  Once both versions have enough
    results, new-vs-old is judged on three axes: PSI over the per-signal
    quality digests (``psi`` > threshold = drift), error-rate delta, and
    the latency EWMA ratio.
  * **PROMOTING** — the remaining replicas swap one drained ladder step at
    a time: capacity degrades by exactly one replica at any instant,
    availability never.  Only after the last swap does the pod identity
    (health-doc ``model_version``) advance and the feature store move to
    the new weights' fingerprint generation (superseded generations GC
    with a grace — the rollback target's cache survives, satellite of
    ``FeatureStore.gc_superseded``).
  * **ROLLBACK** — the same ladder in reverse, triggered automatically by
    a canary breach or a failed swap.  The old params are still resident
    (captured at staging), so rollback is another drained swap, not a
    restart.

**Crash consistency.**  The durable pointer (``state_path``) is two-phase:
the candidate is recorded at staging, but ``current`` only advances at
COMPLETE — so a SIGKILL at ANY phase (the ``kill_at_weight_swap`` chaos
seam fires inside the swap window) restarts on exactly one consistent
version: the old one before COMPLETE, the new one after.
:func:`resolve_serving_checkpoint` is the restart-side half.

Locking: the controller's ``_lock`` guards only its own stats/phase.  The
service calls ``observe_result``/``observe_failure``/``status`` (controller
lock only, sometimes while holding the service lock); the controller calls
``service.rollout_*`` seams (service lock only) — never while holding its
own lock.  One consistent lock order, no deadlock.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ncnet_tpu_torch.observability import events as obs_events
from ncnet_tpu_torch.observability import get_logger
from ncnet_tpu_torch.observability.metrics import Histogram
from ncnet_tpu_torch.observability.quality import (
    DEFAULT_PSI_THRESHOLD,
    DIGEST_BINS,
    QUALITY_SIGNALS,
    SIGNAL_RANGE,
    psi,
)

log = get_logger("rollout")

# rollout phases (the ``rollout_phase`` event vocabulary)
ROLLOUT_IDLE = "IDLE"
ROLLOUT_STAGING = "STAGING"
ROLLOUT_CANARY = "CANARY"
ROLLOUT_PROMOTING = "PROMOTING"
ROLLOUT_COMPLETE = "COMPLETE"
ROLLOUT_ROLLING_BACK = "ROLLING_BACK"
ROLLOUT_ROLLED_BACK = "ROLLED_BACK"

_ALLOWED = {
    ROLLOUT_IDLE: (ROLLOUT_STAGING,),
    # STAGING -> IDLE is the refusal edge: nothing was touched
    ROLLOUT_STAGING: (ROLLOUT_CANARY, ROLLOUT_IDLE, ROLLOUT_ROLLING_BACK),
    ROLLOUT_CANARY: (ROLLOUT_PROMOTING, ROLLOUT_ROLLING_BACK),
    ROLLOUT_PROMOTING: (ROLLOUT_COMPLETE, ROLLOUT_ROLLING_BACK),
    ROLLOUT_ROLLING_BACK: (ROLLOUT_ROLLED_BACK,),
    ROLLOUT_COMPLETE: (),
    ROLLOUT_ROLLED_BACK: (),
}

_EWMA_ALPHA = 0.3  # same memory as the admission/replica wall EWMAs

ROLLOUT_STATE_SCHEMA = 1


@dataclasses.dataclass(frozen=True)
class RolloutConfig:
    """Knobs of one live rollout (README "Live rollout")."""

    # canary routing + judging
    canary_fraction: float = 0.25      # share of decisions the canary gets
    canary_min_results: int = 16       # per-version results before judging
                                       # (0 = skip judging: promote blind)
    canary_timeout_s: float = 60.0     # starved canary -> rollback
    drain_timeout_s: float = 30.0      # per-replica drain bound
    # judge gates (breach any one -> rollback)
    psi_threshold: float = DEFAULT_PSI_THRESHOLD
    judge_signals: Tuple[str, ...] = QUALITY_SIGNALS
    error_rate_margin: float = 0.10    # new error rate may exceed old by this
    latency_factor: float = 3.0        # new EWMA > factor * old EWMA = breach
    min_latency_samples: int = 8       # EWMAs compared only past this
    # durability + store grace
    state_path: Optional[str] = None   # two-phase version pointer (None = off)
    gc_keep_generations: int = 1       # superseded store generations kept


# ---------------------------------------------------------------------------
# durable version pointer (two-phase: candidate at staging, current at
# COMPLETE) — the SIGKILL-consistency contract
# ---------------------------------------------------------------------------


def write_rollout_state(path: str, state: Dict[str, Any]) -> None:
    """Atomic tmp+rename+fsync, like every durable artifact here."""
    doc = {"schema": ROLLOUT_STATE_SCHEMA, **state}
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_rollout_state(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def resolve_serving_checkpoint(state_path: Optional[str],
                               default: Optional[str]) -> Optional[str]:
    """Which checkpoint a restarting pod should serve: the state file's
    ``current`` pointer when one was ever committed (i.e. a rollout
    COMPLETEd), else ``default`` (the operator's configured checkpoint).
    A SIGKILL mid-swap left ``current`` un-advanced, so the restart lands
    on the OLD version — one consistent version, never a mix."""
    if state_path:
        state = read_rollout_state(state_path)
        if state and state.get("current"):
            return state["current"]
    return default


# ---------------------------------------------------------------------------
# per-version live stats (the judge's evidence)
# ---------------------------------------------------------------------------


class _VersionStats:
    """One model version's canary-window evidence: result/failure counts,
    a wall EWMA, and per-signal quality digests binned EXACTLY like the
    drift sentinel's (SIGNAL_RANGE x DIGEST_BINS — ``psi`` requires
    identical binning)."""

    def __init__(self):
        self.results = 0
        self.failures = 0
        self.ewma_wall_ms: Optional[float] = None
        self.digests: Dict[str, Histogram] = {}

    def note_result(self, wall_ms: float,
                    quality: Optional[Dict[str, float]]) -> None:
        self.results += 1
        w = float(wall_ms)
        self.ewma_wall_ms = w if self.ewma_wall_ms is None else (
            _EWMA_ALPHA * w + (1.0 - _EWMA_ALPHA) * self.ewma_wall_ms)
        if quality:
            for name, v in quality.items():
                h = self.digests.get(name)
                if h is None:
                    lo, hi = SIGNAL_RANGE.get(name, (0.0, 1.0))
                    h = self.digests[name] = Histogram(lo, hi, DIGEST_BINS)
                h.add(float(v))

    def error_rate(self) -> Optional[float]:
        n = self.results + self.failures
        return (self.failures / n) if n else None

    def snapshot(self) -> Dict[str, Any]:
        return {
            "results": self.results,
            "failures": self.failures,
            "ewma_wall_ms": (round(self.ewma_wall_ms, 3)
                             if self.ewma_wall_ms is not None else None),
        }


class RolloutRefused(RuntimeError):
    """The candidate never touched a replica: payload/arch mismatch, same
    version, or the pool cannot spare a canary."""

    def __init__(self, msg: str, reason: str):
        super().__init__(msg)
        self.reason = reason


class RolloutController:
    """One live rollout, driven through a ``MatchService``'s ``rollout_*``
    seams.  Construct, then :meth:`run` (or let
    ``MatchService.start_rollout`` run it on a background thread)::

        ctl = RolloutController(service, RolloutConfig(state_path=...))
        outcome = ctl.run("/ckpts")          # COMPLETE | ROLLED_BACK | IDLE

    ``loader`` (or ``service.rollout_loader`` — the test seam) replaces
    the default checkpoint loader; it takes the candidate string and
    returns ``(resolved_path, version, model_config_or_None, params)``.
    """

    def __init__(self, service, config: RolloutConfig = RolloutConfig(), *,
                 loader: Optional[Callable[[str], Tuple]] = None):
        self.service = service
        self.cfg = config
        self._loader = loader
        self._lock = threading.Lock()
        self.phase = ROLLOUT_IDLE
        self.reason: Optional[str] = None
        self.old_version: Optional[str] = None
        self.new_version: Optional[str] = None
        self.candidate_path: Optional[str] = None
        self._old_params = None
        self._new_params = None
        self._stats: Dict[str, _VersionStats] = {}
        self._verdict: Optional[Dict[str, Any]] = None
        # baseline (old-version) evidence starts accumulating at attach
        service.attach_rollout(self)

    # -- service-facing (controller lock ONLY; may be called under the
    #    service lock) --------------------------------------------------

    def observe_result(self, version: str, wall_ms: float,
                       quality: Optional[Dict[str, float]]) -> None:
        with self._lock:
            self._stats.setdefault(
                version, _VersionStats()).note_result(wall_ms, quality)

    def observe_failure(self, version: str) -> None:
        with self._lock:
            self._stats.setdefault(version, _VersionStats()).failures += 1

    def status(self) -> Dict[str, Any]:
        """The health document's ``rollout`` section (and GET /rollout)."""
        with self._lock:
            return {
                "phase": self.phase,
                "reason": self.reason,
                "old_version": self.old_version,
                "new_version": self.new_version,
                "candidate": self.candidate_path,
                "canary_fraction": self.cfg.canary_fraction,
                "versions": {v: s.snapshot()
                             for v, s in sorted(self._stats.items())},
                "verdict": self._verdict,
            }

    # -- internals -------------------------------------------------------

    def _to(self, phase: str, reason: str = "") -> None:
        with self._lock:
            if phase not in _ALLOWED[self.phase]:
                raise RuntimeError(
                    f"illegal rollout transition {self.phase} -> {phase}")
            self.phase = phase
            self.reason = reason or None
        obs_events.emit("rollout_phase", phase=phase, reason=reason or None,
                        old_version=self.old_version,
                        new_version=self.new_version)

    def _persist(self, current: Optional[str]) -> None:
        if not self.cfg.state_path:
            return
        prior = read_rollout_state(self.cfg.state_path) or {}
        write_rollout_state(self.cfg.state_path, {
            "current": current if current is not None
            else prior.get("current"),
            "candidate": self.candidate_path,
            "candidate_version": self.new_version,
            "old_version": self.old_version,
            "phase": self.phase,
            "t": time.time(),
        })

    def _load_candidate(self, candidate: str):
        """Resolve + verify the candidate BEFORE any replica is touched.
        Raises :class:`RolloutRefused` with a classified reason."""
        from ncnet_tpu_torch.models.checkpoint import CheckpointPayloadError

        loader = self._loader or self._default_loader
        try:
            resolved, version, config, params = loader(candidate)
        except RolloutRefused:
            raise
        except CheckpointPayloadError as e:
            raise RolloutRefused(str(e), reason="payload_sha_mismatch")
        except Exception as e:  # noqa: BLE001 — any load failure refuses,
            # never crashes the serving process driving the rollout
            raise RolloutRefused(
                f"candidate {candidate!r} failed to load: "
                f"{type(e).__name__}: {e}", reason="load_failed")
        if version == self.service.model_version:
            raise RolloutRefused(
                f"candidate resolves to the live version {version!r}",
                reason="same_version")
        base = getattr(self.service, "_model_config", None)
        if base is not None and config is not None:
            from ncnet_tpu_torch.models.checkpoint import _ARCH_FIELDS

            bad = [k for k in _ARCH_FIELDS
                   if getattr(config, k) != getattr(base, k)]
            if bad:
                raise RolloutRefused(
                    f"candidate architecture differs on {bad} — a rollout "
                    "swaps weights, not architectures", reason="arch_mismatch")
        return resolved, version, params

    def _default_loader(self, candidate: str):
        """The newest-complete version resolution + the payload-sha gate + the
        ``corrupt_candidate_checkpoint`` chaos seam (bit-flips the loaded
        tree so the sha gate has real corruption to catch)."""
        from ncnet_tpu_torch.models.checkpoint import (
            load_params,
            resolve_checkpoint_dir,
            verify_checkpoint_payload,
        )
        from ncnet_tpu_torch.utils import faults

        resolved = resolve_checkpoint_dir(candidate)
        base = getattr(self.service, "_model_config", None)
        if base is not None:
            config, params = load_params(resolved, base)
        else:
            config, params = load_params(resolved)
        params = faults.corrupt_candidate_hook(resolved, params)
        verify_checkpoint_payload(resolved, params)
        version = os.path.basename(os.path.normpath(resolved))
        return resolved, version, config, params

    # -- the rollout itself ----------------------------------------------

    def run(self, candidate: str) -> str:
        """Drive the full state machine; returns the terminal phase
        (COMPLETE / ROLLED_BACK / IDLE-on-refusal).  Never raises for
        operational failures — a rollout is a maintenance action on a
        LIVE service, and its failure modes all end in a consistent,
        serving pod."""
        svc = self.service
        with self._lock:
            self.old_version = svc.model_version
            self._old_params = getattr(svc, "_model_params", None)
        self._to(ROLLOUT_STAGING)
        try:
            resolved, version, params = self._load_candidate(candidate)
        except RolloutRefused as e:
            obs_events.emit("rollout_refused", candidate=candidate,
                            reason=e.reason, error=str(e)[:300])
            log.warning(f"rollout refused ({e.reason}): {e}", kind="io")
            self._to(ROLLOUT_IDLE, f"refused:{e.reason}")
            return ROLLOUT_IDLE
        with self._lock:
            self.candidate_path = resolved
            self.new_version = version
            self._new_params = params
        self._persist(current=None)  # phase 1: candidate recorded only

        # detach the store from swapped replicas when the backbone weights
        # actually changed (committing new-weight features into the old
        # generation would poison the cache); an NC-filter-only fine-tune
        # keeps the same generation and stays attached
        detach = False
        if getattr(svc, "_store", None) is not None:
            try:
                from ncnet_tpu_torch.store import weights_digest

                detach = (self._old_params is None
                          or weights_digest(params)
                          != weights_digest(self._old_params))
            except Exception:  # noqa: BLE001 — unknown trees: stay safe
                detach = True

        # stage on ONE drained replica while the rest of the pool serves
        try:
            canary = svc.rollout_pick_canary()
        except RuntimeError as e:
            obs_events.emit("rollout_refused", candidate=candidate,
                            reason="no_spare_replica", error=str(e)[:300])
            self._to(ROLLOUT_IDLE, "refused:no_spare_replica")
            return ROLLOUT_IDLE
        if not svc.rollout_drain(canary, self.cfg.drain_timeout_s):
            svc.rollout_readmit(canary, reason="rollout_drain_timeout")
            obs_events.emit("rollout_refused", candidate=candidate,
                            reason="drain_timeout", error=None)
            self._to(ROLLOUT_IDLE, "refused:drain_timeout")
            return ROLLOUT_IDLE
        try:
            svc.rollout_swap(canary, params, version, detach_store=detach)
        except Exception as e:  # noqa: BLE001 — a failed swap rolls back
            log.error(f"canary swap failed ({type(e).__name__}: {e}); "
                      "rolling back", kind="device")
            return self._rollback("canary_swap_failed", [canary])

        # CANARY: re-admit + route the fraction; judge once fed
        self._to(ROLLOUT_CANARY)
        with self._lock:
            self._stats = {}  # the judge window starts here, both versions
        svc.rollout_readmit(canary, reason="canary")
        svc.rollout_set_canary(canary, self.cfg.canary_fraction)
        breach = None
        if self.cfg.canary_min_results > 0:
            breach = self._canary_wait_and_judge()
        if breach is not None:
            svc.rollout_clear_canary()
            return self._rollback(breach, [canary])

        # PROMOTING: the remaining replicas, one drained swap at a time
        self._to(ROLLOUT_PROMOTING)
        svc.rollout_clear_canary()
        for rep in svc.rollout_replicas():
            if rep.model_version == version:
                continue
            if not svc.rollout_drain(rep, self.cfg.drain_timeout_s):
                svc.rollout_readmit(rep, reason="rollout_drain_timeout")
                return self._rollback("promote_drain_timeout",
                                      self._swapped_replicas())
            try:
                svc.rollout_swap(rep, params, version, detach_store=detach)
            except Exception as e:  # noqa: BLE001
                log.error(f"promotion swap on {rep.id} failed "
                          f"({type(e).__name__}: {e}); rolling back",
                          kind="device")
                return self._rollback("promote_swap_failed",
                                      self._swapped_replicas())
            svc.rollout_readmit(rep, reason="promoted")

        # COMPLETE: advance the pod identity, THEN the durable pointer,
        # THEN let the store GC superseded generations (with grace)
        svc.rollout_set_version(version, params)
        self._to(ROLLOUT_COMPLETE)
        self._persist(current=resolved)  # phase 2: the pointer advances
        svc.rollout_switch_store(params)
        svc.rollout_gc_store(self.cfg.gc_keep_generations)
        log.info(f"rollout complete: {self.old_version} -> {version}",
                 kind="io")
        return ROLLOUT_COMPLETE

    def _swapped_replicas(self) -> List[Any]:
        return [r for r in self.service.rollout_replicas()
                if r.model_version == self.new_version]

    def _canary_wait_and_judge(self) -> Optional[str]:
        """Wait until both versions have ``canary_min_results`` results
        (or the window times out), then judge.  Returns the breach reason
        (→ rollback) or None (→ promote)."""
        deadline = time.monotonic() + self.cfg.canary_timeout_s
        need = self.cfg.canary_min_results
        while True:
            with self._lock:
                new = self._stats.get(self.new_version)
                old = self._stats.get(self.old_version)
                fed = (new is not None and new.results >= need
                       and old is not None and old.results >= need)
            if fed:
                break
            if time.monotonic() >= deadline:
                # a canary that cannot even absorb its fraction is its own
                # verdict — the stream may have stopped, but promoting on
                # zero evidence is how silent regressions ship
                return "canary_starved"
            time.sleep(0.02)
        return self._judge()

    def _judge(self) -> Optional[str]:
        """New-vs-old on three axes; ANY breach rolls back.  Emits ONE
        ``rollout_canary_verdict`` event carrying every input — the replay
        (``run_report --rollout``) re-reads the decision, not a summary."""
        with self._lock:
            new = self._stats.get(self.new_version) or _VersionStats()
            old = self._stats.get(self.old_version) or _VersionStats()
            psi_by_signal: Dict[str, float] = {}
            for name in self.cfg.judge_signals:
                ho, hn = old.digests.get(name), new.digests.get(name)
                if ho is None or hn is None or not ho.count or not hn.count:
                    continue
                psi_by_signal[name] = round(psi(ho, hn), 4)
            new_err, old_err = new.error_rate(), old.error_rate()
            new_ms, old_ms = new.ewma_wall_ms, old.ewma_wall_ms
            enough_latency = (new.results >= self.cfg.min_latency_samples
                              and old.results >= self.cfg.min_latency_samples)
        breach = None
        drifted = [n for n, v in psi_by_signal.items()
                   if v > self.cfg.psi_threshold]
        if drifted:
            breach = f"quality_drift:{','.join(sorted(drifted))}"
        elif (new_err is not None and old_err is not None
              and new_err - old_err > self.cfg.error_rate_margin):
            breach = "error_rate"
        elif (enough_latency and new_ms is not None and old_ms
              and new_ms > self.cfg.latency_factor * old_ms):
            breach = "latency"
        verdict = {
            "breach": breach,
            "psi": psi_by_signal,
            "psi_threshold": self.cfg.psi_threshold,
            "error_rate": {"old": old_err, "new": new_err,
                           "margin": self.cfg.error_rate_margin},
            "latency_ewma_ms": {"old": old_ms, "new": new_ms,
                                "factor": self.cfg.latency_factor},
            "results": {"old": old.results, "new": new.results},
        }
        with self._lock:
            self._verdict = verdict
        obs_events.emit("rollout_canary_verdict",
                        old_version=self.old_version,
                        new_version=self.new_version, **verdict)
        return breach

    def _rollback(self, reason: str, replicas: List[Any]) -> str:
        """The ladder in reverse: every replica on the new version swaps
        back to the still-resident old params, one drained step at a
        time.  The durable pointer never advanced, so even a crash DURING
        rollback restarts on the old version."""
        svc = self.service
        self._to(ROLLOUT_ROLLING_BACK, reason)
        svc.rollout_clear_canary()
        stuck: List[str] = []
        for rep in replicas:
            if not svc.rollout_drain(rep, self.cfg.drain_timeout_s):
                # a replica that cannot drain cannot be safely swapped;
                # it stays DRAINING (no traffic) as an operator signal —
                # the rest of the pod still converges on the old version
                stuck.append(rep.id)
                log.error(f"rollback: {rep.id} failed to drain; left out "
                          "of rotation", kind="device")
                continue
            try:
                svc.rollout_swap(rep, self._old_params, self.old_version)
            except Exception as e:  # noqa: BLE001 — a replica that cannot
                # swap back stays out of rotation; availability degrades,
                # correctness does not
                stuck.append(rep.id)
                log.error(f"rollback swap on {rep.id} failed "
                          f"({type(e).__name__}: {e}); left out of "
                          "rotation", kind="device")
                continue
            svc.rollout_readmit(rep, reason="rolled_back")
        svc.rollout_set_version(self.old_version, self._old_params)
        svc.rollout_reattach_store()
        self._to(ROLLOUT_ROLLED_BACK, reason)
        self._persist(current=None)
        obs_events.emit("rollout_rolled_back", reason=reason,
                        old_version=self.old_version,
                        new_version=self.new_version,
                        stuck_replicas=stuck or None)
        log.warning(f"rollout rolled back ({reason}): pod back on "
                    f"{self.old_version}", kind="device")
        return ROLLOUT_ROLLED_BACK
