"""Deterministic fault injection for the training and eval paths' fault
tolerance, the part of ``ncnet_tpu/utils/faults.py`` that the port's data,
training, eval and ``utils/io`` paths call.

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


_plan: Optional[FaultPlan] = None
_env_read = False
_decode_attempts: Dict[str, int] = {}
_savemat_attempts: Dict[str, int] = {}
_device_calls = 0
_watchdog_calls = 0
_lock = threading.Lock()


def _reset_counters_locked() -> None:
    global _device_calls, _watchdog_calls
    _decode_attempts.clear()
    _savemat_attempts.clear()
    _device_calls = 0
    _watchdog_calls = 0


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
