"""Profiling hooks, the port of ``ncnet_tpu/utils/profiling.py`` on
``torch.profiler``:

  * :func:`annotate` — a named range (``torch.profiler.record_function``)
    around the train/eval steps, checkpoint commits and device snapshots;
    the names match the observability event types, so a trace and a
    replayed event log name the same phases alike.
  * :func:`maybe_trace` — a profiler capture of a whole block when a
    directory is given (or ``NCNET_TPU_PROFILE_DIR`` is set); a no-op
    otherwise.
  * :class:`StepWindowTracer` — ``NCNET_TPU_PROFILE_STEPS=<a>:<b>`` bounds
    the capture to global train steps ``[a, b)``: the training loop feeds
    it every step number.  When the window is set, ``fit`` hands the
    capture to the tracer and ``maybe_trace`` stands down (one profiler
    session at a time).

A capture records the host and, where CUDA is available, the card's
kernels (CUPTI), and is written into the directory as a Chrome trace
(``chrome://tracing`` or Perfetto open it).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional, Tuple

import torch

PROFILE_DIR_ENV = "NCNET_TPU_PROFILE_DIR"
PROFILE_STEPS_ENV = "NCNET_TPU_PROFILE_STEPS"


def annotate(name: str):
    """Named range in the profiler's trace (cheap; always on): a
    ``torch.profiler.record_function`` context."""
    return torch.profiler.record_function(name)


def profile_step_window() -> Optional[Tuple[int, int]]:
    """``NCNET_TPU_PROFILE_STEPS=<a>:<b>`` as ``(a, b)``: capture global
    train steps ``[a, b)``.  Unset or empty: None; a malformed value raises
    (a silently ignored profiling request wastes the run it was meant to
    measure)."""
    raw = os.environ.get(PROFILE_STEPS_ENV, "").strip()
    if not raw:
        return None
    try:
        a_s, b_s = raw.split(":")
        a, b = int(a_s), int(b_s)
    except ValueError:
        raise ValueError(
            f"{PROFILE_STEPS_ENV}={raw!r}: expected '<a>:<b>' "
            "(capture steps [a, b), 1-based)") from None
    if a < 1 or b <= a:
        raise ValueError(f"{PROFILE_STEPS_ENV}={raw!r}: need 1 <= a < b")
    return a, b


def _start(log_dir: str) -> torch.profiler.profile:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def _stop(prof: torch.profiler.profile, path: str) -> str:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    prof.export_chrome_trace(path)
    return path


class StepWindowTracer:
    """Start and stop the profiler around global train steps ``[a, b)``.

    Inactive (every call a cheap no-op) unless both a log dir (argument or
    ``$NCNET_TPU_PROFILE_DIR``) and a window (argument or
    ``$NCNET_TPU_PROFILE_STEPS``) are present.  ``at_step(g)`` is called
    with each global step number just before that step dispatches;
    ``close()`` (always call it: the window may outlive the run) stops a
    capture left open by an early exit.  The trace lands in
    ``<log_dir>/trace_steps_<a>-<b>.json`` (:attr:`trace_path`)."""

    def __init__(self, log_dir: Optional[str] = None,
                 window: Optional[Tuple[int, int]] = None):
        self.log_dir = log_dir or os.environ.get(PROFILE_DIR_ENV) or None
        self.window = window if window is not None else profile_step_window()
        self.trace_path: Optional[str] = None
        self._prof: Optional[torch.profiler.profile] = None
        self._done = False

    @property
    def enabled(self) -> bool:
        return bool(self.log_dir and self.window and not self._done)

    def at_step(self, global_step: int) -> None:
        """Called before global step ``global_step`` dispatches."""
        if not self.enabled:
            return
        a, b = self.window
        if self._prof is None and a <= global_step < b:
            self._prof = _start(self.log_dir)
        elif self._prof is not None and global_step >= b:
            self.close()

    def close(self) -> None:
        if self._prof is not None:
            a, b = self.window
            self.trace_path = _stop(self._prof, os.path.join(
                self.log_dir, f"trace_steps_{a}-{b}.json"))
            self._prof = None
        self._done = True


@contextlib.contextmanager
def maybe_trace(log_dir: Optional[str] = None,
                enabled: bool = True) -> Iterator[bool]:
    """Capture a profiler trace into ``log_dir`` (or
    ``$NCNET_TPU_PROFILE_DIR``) for the block, as
    ``trace_<unix time>_<pid>.json``; yields whether it traces.
    ``enabled=False`` forces a no-op (callers bound the capture to one
    phase, or stand down for a :class:`StepWindowTracer`)."""
    log_dir = log_dir or os.environ.get(PROFILE_DIR_ENV) or None
    if not log_dir or not enabled:
        yield False
        return
    prof = _start(log_dir)
    try:
        yield True
    finally:
        _stop(prof, os.path.join(
            log_dir, f"trace_{int(time.time())}_{os.getpid()}.json"))
