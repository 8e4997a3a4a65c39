"""Deterministic fault injection for the fault tolerance of the training,
eval, serving, feature-store and retrieval paths, the part of
``ncnet_tpu/utils/faults.py`` that the port's data, training, eval,
``utils/io``, ``observability/events``, ``serving/``, ``store/`` and
``retrieval/`` paths call.

Claims about crash paths rot unless they are executed, so the production
code carries tiny hook call sites and this module arms them
deterministically from tests:

  * ``decode_hook(path)``        — ``data/datasets.load_image``: raises
    :class:`InjectedFault` (an OSError) for matching image paths, optionally
    only for the first k attempts per path (exercises decode retry).
  * ``corrupt_batch_hook(b, s)`` — ``training/train.process_epoch``:
    NaN-fills the source images of selected global train steps, so the NaN
    flows through the real loss, gradients and update and the NaN guard
    must keep it out of the Adam state.
  * ``kill_mid_save_hook(n)``    — ``training/train.save_train_checkpoint``:
    SIGKILLs the process between the ``params`` and ``opt`` writes of
    version ``step_<n>`` (a ``.tmp`` carcass, no commit).
  * ``sigterm_hook(step)``       — ``fit``'s step loop: delivers SIGTERM to
    the process after a given global step (the preemption handler end to
    end, its boundary checkpoint included).
  * ``savemat_hook(path)``       — ``utils/io.atomic_savemat``: raises
    :class:`InjectedFault` for matching artifact paths (optionally only the
    first k attempts per path).
  * ``savemat_kill_hook(path)``  — ``utils/io.atomic_savemat``: SIGKILLs
    the process between the temp-file write and the commit rename (a
    ``.tmp`` carcass, no final file).
  * ``device_error_hook(label)`` — the eval step's dispatch
    (``evaluation/pf_pascal.make_eval_step``): raises
    :class:`InjectedDeviceError` on selected dispatch-call ordinals (a
    process-global counter), standing in for a mid-run CUDA error.
  * ``hang_fetch_hook(label)``   — ``evaluation/pipeline.call_with_watchdog``:
    sleeps on selected watchdog-call ordinals, standing in for a hung fetch
    that the watchdog must turn into a retryable timeout.
  * ``journal_kill_hook(n, w)``  — ``evaluation/resilience.EvalJournal``:
    SIGKILLs mid-append of the Nth journal record, after flushing a torn
    prefix of the line via ``w()``.
  * ``event_kill_hook(n, w)``    — ``observability/events.EventLog``: the
    same torn-append kill for the Nth event record of a log.
  * ``serve_drain_kill_hook(n)`` — ``serving/service.MatchService``:
    SIGKILLs the process after the Nth terminal request outcome of a drain.
  * ``replica_fault_hook(id, phase)`` — ``serving/replica.py`` dispatch and
    fetch: kills (``dead_replica_ids``: InjectedDeviceError until cleared)
    or slows (``slow_replica_ids``: a sleep a fetch) single replicas.
  * ``queue_overflow_burst`` / ``paced_burst`` — not hooks but the chaos
    traffic: N submissions back to back or paced, returning the admitted
    futures and the classified sheds.
  * ``store_io_hook(op, path)``, ``store_commit_kill_hook(path)``,
    ``store_bitflip_hook(path)`` — ``store/feature_store.py``: an ENOSPC on
    an armed store operation, a SIGKILL between an entry's payload write
    and its commit rename, and one payload bit flipped after a commit.
  * ``backend_fault_hook(url, phase)`` — ``serving/wire.MatchClient.match``:
    kills (``dead_backend_urls``: ConnectionError) or stalls
    (``hang_backend_urls``: a sleep before the send) a backend host, the
    router's failover seam without a process to kill.
  * ``shard_fault_hook(url, phase)``, ``shard_payload_hook(url, data)`` —
    ``retrieval/wire.RetrieveClient.retrieve``: kills
    (``dead_shard_urls``), stalls then kills (``hang_shard_urls``) or slows
    (``slow_shard_urls``) a shard host, and flips a bit of its response
    (``shard_bitflip_urls``), the coordinator's failover, hedging and
    checksum seams.
  * ``weight_swap_kill_hook()``, ``corrupt_candidate_hook(path, params)``,
    ``canary_quality_shift_hook(version, quality)`` — the live rollout
    (``serving/rollout.py``, ``MatchService.rollout_swap``): a SIGKILL in
    the Nth weight swap, one bit flipped in a loaded candidate, and a
    shifted quality signal for a canary version.

Arming: :func:`install`/:func:`clear` (or the :func:`injected` context
manager) in-process, or the ``NCNET_TPU_FAULTS`` environment variable (a
JSON object of :class:`FaultPlan` fields, the JAX package's variable) for a
subprocess that is meant to die.  A field this module does not know raises:
a plan the port cannot honour must not pass as armed.  Every hook returns
after one ``is None`` check when nothing is armed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import signal
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

FAULTS_ENV = "NCNET_TPU_FAULTS"


class InjectedFault(OSError):
    """An injected I/O failure.  Subclasses OSError so production retry and
    quarantine paths treat it exactly like a real decode error."""


class InjectedDeviceError(RuntimeError):
    """An injected runtime device failure (the stand-in for a mid-run CUDA
    error or out-of-memory); ``evaluation/resilience.classify_failure``
    files it as ``"device"``."""


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """What to break, and when.  All fields default to 'never'."""

    # global train steps (1-based, = TrainState.step after the batch) whose
    # input batch is NaN-corrupted before the step runs
    nan_loss_steps: Tuple[int, ...] = ()
    # image paths containing this substring raise InjectedFault on decode
    decode_fail_substring: str = ""
    # -1: every decode attempt fails; k >= 0: only the first k attempts per
    # path fail (a transient error that retry should absorb)
    decode_fail_times: int = -1
    # SIGKILL self mid-save of checkpoint version step_<N> (between the
    # params and opt writes: .tmp exists, the commit rename never happens)
    kill_at_version: int = -1
    # SIGTERM self after this global train step (1-based)
    sigterm_at_step: int = -1
    # artifact paths containing this substring raise InjectedFault inside
    # atomic_savemat (before any bytes are written)
    savemat_fail_substring: str = ""
    # -1: every matching savemat fails; k >= 0: only the first k attempts
    savemat_fail_times: int = -1
    # SIGKILL self inside atomic_savemat for matching paths, between the
    # temp-file write and the commit rename
    kill_in_savemat_substring: str = ""
    # dispatch-call ordinals (1-based, process-global) that raise
    # InjectedDeviceError
    device_fail_calls: Tuple[int, ...] = ()
    # watchdog-call ordinals (1-based, process-global) whose wrapped call
    # sleeps hang_fetch_seconds
    hang_fetch_calls: Tuple[int, ...] = ()
    hang_fetch_seconds: float = 30.0
    # SIGKILL self mid-append of the Nth EvalJournal record (1-based),
    # flushing a torn prefix of the line first
    kill_at_journal_append: int = -1
    # SIGKILL self mid-append of the Nth EventLog record (1-based, per
    # EventLog instance), flushing a torn prefix first
    kill_at_event_append: int = -1
    # SIGKILL self after the Nth terminal request outcome of a service
    # drain (1-based)
    kill_at_drain_result: int = -1
    # these replica ids fail every armed-phase call with
    # InjectedDeviceError until the plan is cleared
    dead_replica_ids: Tuple[str, ...] = ()
    # which calls die: "fetch" (the dispatch succeeded, the in-flight batch
    # must fail over), "dispatch" or "both"
    dead_replica_phase: str = "fetch"
    # these replica ids sleep slow_replica_seconds inside every fetch
    slow_replica_ids: Tuple[str, ...] = ()
    slow_replica_seconds: float = 0.25
    # store entry paths containing any of these substrings get one payload
    # bit flipped right after their commit rename
    store_bitflip_paths: Tuple[str, ...] = ()
    # store operations ("read", "write", "evict", "journal") that raise
    # OSError(ENOSPC) at their hook site
    store_io_error_ops: Tuple[str, ...] = ()
    # SIGKILL self during the Nth store entry commit (1-based, process-
    # global), between the payload write and the rename
    kill_at_store_commit: int = -1
    # backend base-url substrings whose wire sends raise ConnectionError
    # (a dead host: the router must fail over off-budget, quarantine the
    # backend and resurrect it by probe once the plan clears)
    dead_backend_urls: Tuple[str, ...] = ()
    # backend base-url substrings whose wire sends sleep
    # hang_backend_seconds before the request leaves (a stalled peer)
    hang_backend_urls: Tuple[str, ...] = ()
    hang_backend_seconds: float = 0.5
    # shard base-url substrings whose retrieval wire sends raise
    # ConnectionError (a dead shard: the coordinator must fail the pano
    # group over to replica shards, keep coverage and resurrect the shard
    # by probe once the plan clears)
    dead_shard_urls: Tuple[str, ...] = ()
    # shard base-url substrings whose retrieval wire sends sleep
    # hang_shard_seconds and then die (the stalled-then-lost peer)
    hang_shard_urls: Tuple[str, ...] = ()
    hang_shard_seconds: float = 0.5
    # shard base-url substrings whose retrieval wire sends sleep
    # slow_shard_seconds and then proceed (the straggler the coordinator
    # hedges around without marking it dead)
    slow_shard_urls: Tuple[str, ...] = ()
    slow_shard_seconds: float = 0.25
    # shard base-url substrings whose retrieval wire responses get one bit
    # flipped before decode: the response checksum must refuse them
    shard_bitflip_urls: Tuple[str, ...] = ()
    # SIGKILL self during the Nth rollout weight swap (1-based, process-
    # global), after the new params are staged on the drained replica and
    # before its warm-up and readmission: the restart must come back on
    # the old version
    kill_at_weight_swap: int = -1
    # candidate checkpoint paths containing this substring get one param
    # leaf bit-flipped after a successful load: the payload sha256 must
    # refuse the candidate before any replica is touched
    corrupt_candidate_checkpoint: str = ""
    # additive shift of every quality signal of batches served by replicas
    # whose model_version contains canary_shift_version: the rollout's PSI
    # gate must breach and roll back.  0.0 = disarmed.
    canary_quality_shift: float = 0.0
    canary_shift_version: str = ""


_plan: Optional[FaultPlan] = None
_env_read = False
_decode_attempts: Dict[str, int] = {}
_savemat_attempts: Dict[str, int] = {}
_device_calls = 0
_watchdog_calls = 0
_store_commits = 0
_weight_swaps = 0
_lock = threading.Lock()


def _reset_counters_locked() -> None:
    global _device_calls, _watchdog_calls, _store_commits, _weight_swaps
    _decode_attempts.clear()
    _savemat_attempts.clear()
    _device_calls = 0
    _watchdog_calls = 0
    _store_commits = 0
    _weight_swaps = 0


def install(plan: FaultPlan) -> None:
    """Arm ``plan`` for this process (replaces any prior plan)."""
    global _plan
    with _lock:
        _plan = plan
        _reset_counters_locked()


def clear() -> None:
    """Disarm all faults (tests pair install with clear)."""
    global _plan, _env_read
    with _lock:
        _plan = None
        _env_read = True  # an explicit clear also wins over the env var
        _reset_counters_locked()


@contextlib.contextmanager
def injected(plan: FaultPlan):
    """``with injected(FaultPlan(...)):`` — armed inside, disarmed after."""
    install(plan)
    try:
        yield plan
    finally:
        clear()


def _active() -> Optional[FaultPlan]:
    global _plan, _env_read
    if _plan is None and not _env_read:
        with _lock:
            if _plan is None and not _env_read:
                _env_read = True
                env = os.environ.get(FAULTS_ENV, "")
                if env:
                    fields = {k: tuple(v) if isinstance(v, list) else v
                              for k, v in json.loads(env).items()}
                    known = {f.name for f in dataclasses.fields(FaultPlan)}
                    if set(fields) - known:
                        raise ValueError(
                            f"{FAULTS_ENV} arms {sorted(set(fields) - known)},"
                            " which ncnet_tpu_torch has no hook for")
                    _plan = FaultPlan(**fields)
    return _plan


def _attempt_fails(attempts: Dict[str, int], path: str, times: int) -> bool:
    """Whether this attempt on ``path`` fails: every one when ``times`` < 0,
    else only the first ``times`` per path."""
    if times < 0:
        return True
    with _lock:
        n = attempts.get(path, 0)
        attempts[path] = n + 1
    return n < times


def decode_hook(path: str) -> None:
    """Raise :class:`InjectedFault` when ``path`` is scheduled to fail."""
    p = _active()
    if p is None or not p.decode_fail_substring \
            or p.decode_fail_substring not in path:
        return
    if _attempt_fails(_decode_attempts, path, p.decode_fail_times):
        raise InjectedFault(f"injected decode failure for {path!r}")


def corrupt_batch_hook(batch: dict, step: int) -> dict:
    """NaN-fill the source images of the host batch feeding global
    ``step`` (if armed)."""
    p = _active()
    if p is None or step not in p.nan_loss_steps:
        return batch
    out = dict(batch)
    src = np.asarray(out["source_image"], dtype=np.float32)
    out["source_image"] = np.full_like(src, np.nan)
    return out


def kill_mid_save_hook(version: int) -> None:
    """SIGKILL self mid-save of checkpoint version ``version`` (if armed)."""
    p = _active()
    if p is None or p.kill_at_version < 0 or version != p.kill_at_version:
        return
    os.kill(os.getpid(), signal.SIGKILL)


def sigterm_hook(step: int) -> None:
    """Deliver SIGTERM to self after global train step ``step`` (if
    armed)."""
    p = _active()
    if p is None or p.sigterm_at_step < 0 or step != p.sigterm_at_step:
        return
    os.kill(os.getpid(), signal.SIGTERM)


def savemat_hook(path: str) -> None:
    """Raise :class:`InjectedFault` when ``path``'s savemat is scheduled to
    fail (before any bytes reach disk, so no carcass is left)."""
    p = _active()
    if p is None or not p.savemat_fail_substring \
            or p.savemat_fail_substring not in path:
        return
    if _attempt_fails(_savemat_attempts, path, p.savemat_fail_times):
        raise InjectedFault(f"injected savemat failure for {path!r}")


def savemat_kill_hook(path: str) -> None:
    """SIGKILL self between the temp write and the commit rename of a
    matching atomic_savemat (if armed)."""
    p = _active()
    if p is None or not p.kill_in_savemat_substring:
        return
    if p.kill_in_savemat_substring in path:
        os.kill(os.getpid(), signal.SIGKILL)


def device_error_hook(label: str = "") -> None:
    """Raise :class:`InjectedDeviceError` on armed dispatch-call ordinals."""
    p = _active()
    if p is None or not p.device_fail_calls:
        return
    global _device_calls
    with _lock:
        _device_calls += 1
        n = _device_calls
    if n in p.device_fail_calls:
        raise InjectedDeviceError(
            f"injected runtime device failure (dispatch call {n}"
            + (f", {label}" if label else "") + ")")


def hang_fetch_hook(label: str = "") -> None:
    """Sleep ``hang_fetch_seconds`` on armed watchdog-call ordinals: the
    wrapped fetch then overruns its watchdog timeout."""
    p = _active()
    if p is None or not p.hang_fetch_calls:
        return
    global _watchdog_calls
    with _lock:
        _watchdog_calls += 1
        n = _watchdog_calls
    if n in p.hang_fetch_calls:
        time.sleep(p.hang_fetch_seconds)


def journal_kill_hook(n_append: int, write_partial: Callable[[], None]) -> None:
    """SIGKILL self mid-append of journal record ``n_append`` (if armed),
    flushing a torn prefix of the record via ``write_partial`` first."""
    p = _active()
    if p is None or p.kill_at_journal_append < 0 \
            or n_append != p.kill_at_journal_append:
        return
    write_partial()
    os.kill(os.getpid(), signal.SIGKILL)


def event_kill_hook(n_append: int, write_partial: Callable[[], None]) -> None:
    """SIGKILL self mid-append of event record ``n_append`` (if armed),
    flushing a torn prefix via ``write_partial`` first."""
    p = _active()
    if p is None or p.kill_at_event_append < 0 \
            or n_append != p.kill_at_event_append:
        return
    write_partial()
    os.kill(os.getpid(), signal.SIGKILL)


def serve_drain_kill_hook(n_resolved: int) -> None:
    """SIGKILL self after the ``n_resolved``-th terminal request outcome of
    a serving drain (if armed): the event log must still account for every
    admitted request."""
    p = _active()
    if p is None or p.kill_at_drain_result < 0 \
            or n_resolved != p.kill_at_drain_result:
        return
    os.kill(os.getpid(), signal.SIGKILL)


def replica_fault_hook(replica_id: str, phase: str) -> None:
    """The replica-pool chaos seam: ``slow_replica_ids`` sleep on fetch,
    ``dead_replica_ids`` raise :class:`InjectedDeviceError` on the armed
    phase(s), a replica-local death the service must fail over."""
    p = _active()
    if p is None:
        return
    if phase == "fetch" and replica_id in p.slow_replica_ids:
        time.sleep(p.slow_replica_seconds)
    if replica_id in p.dead_replica_ids and \
            p.dead_replica_phase in (phase, "both"):
        raise InjectedDeviceError(
            f"injected replica death ({replica_id}, {phase})")


def queue_overflow_burst(submit: Callable[[], object], n: int):
    """``n`` back-to-back submissions: ``(futures, sheds)``, the admitted
    futures and the classified ``Overloaded`` rejections in submission
    order.  Any other exception propagates."""
    return paced_burst(submit, rate_qps=0.0, n=n)


def paced_burst(submit: Callable[[], object], rate_qps: float, n: int):
    """Open-loop paced traffic: one submission every ``1/rate_qps`` seconds
    whatever the completions (``rate_qps <= 0``: back to back).  Returns
    ``(futures, sheds)`` like :func:`queue_overflow_burst`."""
    from ncnet_tpu_torch.serving.request import Overloaded

    futures, sheds = [], []
    t0 = time.perf_counter()
    for i in range(int(n)):
        if rate_qps > 0:
            dt = t0 + i / rate_qps - time.perf_counter()
            if dt > 0:
                time.sleep(dt)
        try:
            futures.append(submit())
        except Overloaded as e:
            sheds.append(e)
    return futures, sheds


def store_io_hook(op: str, path: str = "") -> None:
    """Raise ``OSError(ENOSPC)`` when store operation ``op`` ("read",
    "write", "evict", "journal") is armed: the store must answer through a
    recompute and go DEGRADED."""
    p = _active()
    if p is None or not p.store_io_error_ops:
        return
    if op in p.store_io_error_ops:
        import errno

        raise OSError(errno.ENOSPC,
                      f"injected store {op} failure (no space left)", path)


def store_commit_kill_hook(path: str) -> None:
    """SIGKILL self between the payload write and the commit rename of the
    Nth store entry commit (1-based, if armed)."""
    p = _active()
    if p is None or p.kill_at_store_commit < 0:
        return
    global _store_commits
    with _lock:
        _store_commits += 1
        n = _store_commits
    if n == p.kill_at_store_commit:
        os.kill(os.getpid(), signal.SIGKILL)


def store_bitflip_hook(path: str) -> None:
    """Flip one bit of a committed store entry's payload (the file's last
    byte) for matching paths: the next verified read must fail the
    checksum, quarantine the entry and recompute."""
    p = _active()
    if p is None or not p.store_bitflip_paths:
        return
    if not any(s and s in path for s in p.store_bitflip_paths):
        return
    with open(path, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        byte = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([byte[0] ^ 0x01]))


def backend_fault_hook(base_url: str, phase: str) -> None:
    """The multi-host chaos seam (``serving/wire.MatchClient.match``):
    ``hang_backend_urls`` sleep before the request leaves (the stalled
    peer whose late result the router's post-flight deadline check must
    classify); ``dead_backend_urls`` raise ``ConnectionError`` (a dead host:
    the router must re-route off-budget, quarantine the backend after its
    failure streak and resurrect it by a ``/healthz`` probe once the plan
    clears)."""
    p = _active()
    if p is None:
        return
    if any(s and s in base_url for s in p.hang_backend_urls):
        time.sleep(p.hang_backend_seconds)
    if any(s and s in base_url for s in p.dead_backend_urls):
        raise ConnectionError(
            f"injected backend death ({base_url}, {phase})")


def shard_fault_hook(base_url: str, phase: str) -> None:
    """The retrieval tier's chaos seam (``retrieval/wire.py``
    ``RetrieveClient.retrieve``): ``slow_shard_urls`` sleep then proceed
    (the straggler the coordinator hedges around; its late answer still
    counts), ``hang_shard_urls`` sleep then raise ``ConnectionError`` (the
    stalled-then-lost peer), ``dead_shard_urls`` raise ``ConnectionError``
    (shard death without a process: the coordinator re-routes the pano
    group to replicas and a probe resurrects the shard once the plan
    clears)."""
    p = _active()
    if p is None:
        return
    if any(s and s in base_url for s in p.slow_shard_urls):
        time.sleep(p.slow_shard_seconds)
    if any(s and s in base_url for s in p.hang_shard_urls):
        time.sleep(p.hang_shard_seconds)
        raise ConnectionError(
            f"injected shard hang-death ({base_url}, {phase})")
    if any(s and s in base_url for s in p.dead_shard_urls):
        raise ConnectionError(
            f"injected shard death ({base_url}, {phase})")


def shard_payload_hook(base_url: str, data: bytes) -> bytes:
    """Flip the last bit of a retrieval wire response for matching shard
    urls (corruption in flight): the client's checksum must refuse it and
    the coordinator re-cover the pano group from replicas.  Returns
    ``data`` unchanged when the fault is not armed."""
    p = _active()
    if p is None or not p.shard_bitflip_urls:
        return data
    if not any(s and s in base_url for s in p.shard_bitflip_urls) \
            or not data:
        return data
    flipped = bytearray(data)
    flipped[-1] ^= 0x01
    return bytes(flipped)


def weight_swap_kill_hook() -> None:
    """SIGKILL self during the Nth rollout weight swap (1-based, if armed),
    after the candidate params are staged on the drained replica and
    before its warm-up and readmission: the serving-version pointer only
    advances at COMPLETE, so the restart must serve the old version."""
    p = _active()
    if p is None or p.kill_at_weight_swap < 0:
        return
    global _weight_swaps
    with _lock:
        _weight_swaps += 1
        n = _weight_swaps
    if n == p.kill_at_weight_swap:
        os.kill(os.getpid(), signal.SIGKILL)


def corrupt_candidate_hook(path: str, params):
    """Flip one bit of the first non-empty param leaf of a just-loaded
    rollout candidate whose path matches: the bit-rotted checkpoint that
    loading alone does not catch, so the payload sha256 must refuse it
    before any replica is touched.  Other trees come back unchanged."""
    p = _active()
    if p is None or not p.corrupt_candidate_checkpoint:
        return params
    if p.corrupt_candidate_checkpoint not in path:
        return params
    import torch

    flipped = [False]

    def flip(leaf):
        if not torch.is_tensor(leaf):
            return leaf
        t = leaf.detach().clone()
        if not flipped[0] and t.numel():
            raw = t.view(-1).view(torch.uint8)
            raw[0] ^= 0x01
            flipped[0] = True
        return t

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return flip(tree)

    return walk(params)


def canary_quality_shift_hook(model_version: str, quality):
    """Add ``canary_quality_shift`` to every quality signal of a batch
    served by a matching ``model_version``, clipped to [0, 1]: the injected
    canary regression the rollout's PSI gate must catch.  ``quality`` is
    the per-pair signal-dict list of ``BatchMatchEngine.split`` (or None
    for narrow grids); returned unchanged when not armed or not matching."""
    p = _active()
    if p is None or not p.canary_quality_shift or not quality:
        return quality
    if not p.canary_shift_version \
            or p.canary_shift_version not in (model_version or ""):
        return quality
    return [
        {k: min(1.0, max(0.0, float(v) + p.canary_quality_shift))
         for k, v in row.items()} if row else row
        for row in quality
    ]
