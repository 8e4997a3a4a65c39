"""Per-unit fault isolation for the eval path, the port of
``ncnet_tpu/evaluation/resilience.py`` under ROADMAP decision D4: it keeps
the fault isolation and drops tier demotion.

An eval run processes hundreds of independent work units (batches), and
one bad unit — a corrupt image, a mid-run CUDA error, a hung fetch — must
not abort it.  Every recovery path is executed by deterministic fault
injection (``utils/faults.py``), not merely written.

  * :func:`run_isolated` — bounded retry with exponential backoff around
    one work unit, with :func:`classify_failure` naming the failure kind
    and an ``on_failure`` callback as the recovery seam.  A device failure
    re-runs the same program under the retry budget; the port never
    demotes a tier at run time (its route is a static decision, ROADMAP
    rule 2).  Exhausted retries quarantine the unit into the run manifest
    instead of aborting; :class:`QuarantineBreaker` aborts a run whose
    quarantines come back to back (:class:`SystemicEvalError`).
  * :class:`RunManifest` — a journaled per-experiment ``manifest.json``
    (completed / quarantined / in-flight), committed atomically via
    ``utils/io.atomic_write_json`` on every transition.
  * :class:`EvalJournal` — an append-only JSONL journal of per-batch result
    rows.  Records carry the raw little-endian float bytes (base64), so a
    resumed run reproduces the uninterrupted result bit for bit; each
    append is flushed and fsynced, and a torn trailing line (a kill
    mid-append) is dropped on load.

The file formats are the JAX package's, so either package resumes the
other's journal.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from ncnet_tpu_torch.observability import events as obs_events
from ncnet_tpu_torch.observability import get_logger
from ncnet_tpu_torch.utils.io import atomic_write_json

log = get_logger("resilience")


# the messages of the RuntimeErrors that a CUDA launch, the CUDA runtime or a
# CUDA library raises (PyTorch's "CUDA error: ...", the port's kernel
# wrappers' "... launch failed: ...", cuBLAS / cuDNN / cuFFT status errors)
_DEVICE_ERROR_MARKERS = ("cuda error", "cudaerror", "launch failed",
                         "cublas_status", "cudnn_status", "cufft_",
                         "out of memory")


def classify_failure(exc: BaseException) -> str:
    """Map an exception from a work unit to a failure kind.

    ``'timeout'``  — watchdog-expired dispatch/fetch (hung fetch);
    ``'device'``   — runtime device error: ``torch.cuda.OutOfMemoryError``,
    :class:`~ncnet_tpu_torch.utils.faults.InjectedDeviceError`, or a
    ``RuntimeError`` raised by a CUDA launch, the CUDA runtime or a CUDA
    library;
    ``'decode'``   — undecodable input image;
    ``'io'``       — other filesystem/OS errors;
    ``'other'``    — everything else (a bug, most likely).

    Every kind is retried on the same program under the budget and ends in
    quarantine, never in aborting the run.
    """
    import torch

    from ncnet_tpu_torch.data.datasets import SampleDecodeError
    from ncnet_tpu_torch.evaluation.pipeline import FetchTimeoutError
    from ncnet_tpu_torch.utils.faults import InjectedDeviceError

    if isinstance(exc, FetchTimeoutError):
        return "timeout"
    if isinstance(exc, SampleDecodeError):  # a RuntimeError: test it first
        return "decode"
    if isinstance(exc, (torch.cuda.OutOfMemoryError, InjectedDeviceError)) or (
            isinstance(exc, RuntimeError)
            and any(m in str(exc).lower() for m in _DEVICE_ERROR_MARKERS)):
        return "device"
    if isinstance(exc, OSError):
        # an injected decode fault (InjectedFault) is an OSError too.  Match
        # the decode PHRASES, not bare words like "image" — a
        # FileNotFoundError whose PATH contains 'images/' is an io failure
        msg = str(exc).lower()
        if "decode" in msg or "truncated" in msg or "cannot identify" in msg:
            return "decode"
        return "io"
    return "other"


@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """How hard to fight for one work unit before giving up on it."""

    retries: int = 2          # retry attempts after the first failure
    backoff_s: float = 0.5    # sleep before retry k is backoff_s * 2**(k-1)
    quarantine: bool = True   # exhausted retries: quarantine (True) or raise
    # consecutive quarantines before the run aborts as SYSTEMIC (see
    # QuarantineBreaker); <= 0 disables the breaker
    max_consecutive_quarantines: int = 5


class SystemicEvalError(RuntimeError):
    """Too many CONSECUTIVE quarantines: the failure is systemic (dead
    device, unreachable dataset root, incompatible checkpoint), not
    per-query — aborting loudly beats quarantining an entire run one unit
    at a time and exiting 'successfully' with an empty result."""


class QuarantineBreaker:
    """Consecutive-quarantine circuit breaker — the eval twin of
    ``DataLoader._MAX_FRESH_FAILURES`` (the loader's systemic-decode
    guard).  Any
    completed unit resets the streak; ``limit <= 0`` disables."""

    def __init__(self, limit: int):
        self.limit = limit
        self._streak = 0

    def note(self, quarantined: bool) -> None:
        if not quarantined:
            self._streak = 0
            return
        self._streak += 1
        if self.limit > 0 and self._streak >= self.limit:
            raise SystemicEvalError(
                f"{self._streak} consecutive work units quarantined — "
                "treating the failure as systemic, not per-query"
            )


class RunManifest:
    """Journaled run manifest: ``manifest.json`` per experiment directory.

    ``data`` layout::

        {"meta":        {... run settings fingerprint ...},
         "completed":   {unit_id: {optional info}},
         "quarantined": {unit_id: {"kind", "error", "attempts"}},
         "in_flight":   [unit_id, ...]}

    Every transition commits atomically (temp + rename), so after ANY crash
    the manifest is readable and at most one unit is listed in-flight per
    worker.  A unit re-run to completion leaves quarantine; re-running a
    completed unit is harmless (idempotent transitions).
    """

    def __init__(self, path: str, meta: Optional[dict] = None):
        self.path = path
        # normalize through one json round trip (as EvalJournal does) so
        # tuple-vs-list / int-vs-float representation cannot fail the match
        meta = (json.loads(json.dumps(meta, sort_keys=True))
                if meta is not None else None)
        self.data = {
            "meta": meta or {},
            "completed": {},
            "quarantined": {},
            "in_flight": [],
        }
        if os.path.exists(path):
            try:
                with open(path) as f:
                    loaded = json.load(f)
            except (OSError, ValueError):
                # atomic writes should make this impossible; a foreign or
                # hand-edited file starts the manifest fresh rather than
                # crashing the run it exists to protect
                log.warning(f"unreadable run manifest {path}; starting fresh",
                            kind="validation")
                loaded = None
            if loaded and meta is not None and loaded.get("meta") != meta:
                # the manifest belongs to a DIFFERENT configuration (same
                # guard as EvalJournal's header): adopting its completed /
                # quarantined maps would report another experiment's units
                # as this run's
                log.warning(f"run manifest {path} belongs to a different "
                            "run configuration; starting fresh",
                            kind="validation")
                loaded = None
            if loaded:
                for key in ("completed", "quarantined", "in_flight"):
                    if isinstance(loaded.get(key), type(self.data[key])):
                        self.data[key] = loaded[key]
                if meta is None:
                    self.data["meta"] = loaded.get("meta", {})

    def save(self) -> None:
        atomic_write_json(self.path, self.data)

    def begin(self, unit_id: str) -> None:
        """Mark a unit in-flight (an attempt is starting)."""
        unit_id = str(unit_id)
        if unit_id not in self.data["in_flight"]:
            self.data["in_flight"].append(unit_id)
        self.save()

    def complete(self, unit_id: str, **info) -> None:
        unit_id = str(unit_id)
        if unit_id in self.data["in_flight"]:
            self.data["in_flight"].remove(unit_id)
        self.data["quarantined"].pop(unit_id, None)
        self.data["completed"][unit_id] = info
        self.save()

    def quarantine(self, unit_id: str, kind: str, message: str,
                   attempts: int) -> None:
        unit_id = str(unit_id)
        if unit_id in self.data["in_flight"]:
            self.data["in_flight"].remove(unit_id)
        self.data["quarantined"][unit_id] = {
            "kind": kind,
            "error": message[:500],
            "attempts": attempts,
        }
        self.save()

    def is_completed(self, unit_id: str) -> bool:
        return str(unit_id) in self.data["completed"]

    @property
    def quarantined_ids(self) -> Tuple[str, ...]:
        return tuple(self.data["quarantined"])


def run_isolated(
    unit_id: str,
    work: Callable[[], object],
    *,
    policy: FaultPolicy,
    manifest: Optional[RunManifest] = None,
    on_failure: Optional[Callable[[BaseException, str], None]] = None,
    label: str = "",
) -> Tuple[bool, object]:
    """Run one work unit under per-query fault isolation.

    ``work`` is called up to ``1 + policy.retries`` times.  On each failure
    the exception is classified (:func:`classify_failure`) and
    ``on_failure(exc, kind)`` runs first: the recovery seam (drop a
    poisoned handle, the pipeline controller's ``note_failure``).  Every
    retry re-runs the same program and counts against the budget; no
    recovery changes the program (ROADMAP decision D4).

    Returns ``(True, result)`` on success.  On an exhausted budget:
    quarantines into ``manifest`` and returns ``(False, None)`` when
    ``policy.quarantine``, else re-raises the last exception (the
    fail-fast policy for callers that prefer the old abort behavior).
    ``BaseException``s that are not ``Exception`` (KeyboardInterrupt,
    SystemExit, injected SIGKILL/SIGTERM) always propagate — preemption is
    handled at a different layer, not retried.
    """
    from concurrent.futures import BrokenExecutor

    name = label or str(unit_id)
    attempts = 0
    while True:
        if manifest is not None:
            manifest.begin(unit_id)
        try:
            result = work()
        except BrokenExecutor:
            # a dead worker pool fails EVERY remaining unit instantly;
            # retrying/quarantining would convert one systemic failure into
            # silent mass loss — abort loudly
            raise
        except Exception as e:
            kind = classify_failure(e)
            if on_failure is not None:
                on_failure(e, kind)
            attempts += 1
            log.warning(f"{name}: {kind} failure "
                        f"(attempt {attempts}): {type(e).__name__}: {e}",
                        kind=kind)
            if attempts <= policy.retries:
                obs_events.emit("retry", unit=str(unit_id), kind=kind,
                                attempt=attempts, on_budget=True)
                time.sleep(policy.backoff_s * 2 ** (attempts - 1))
                continue
            if policy.quarantine:
                log.warning(f"{name}: quarantined after {attempts} "
                            f"attempt(s) — the run continues without it",
                            kind="quarantine")
                obs_events.emit("quarantine", unit=str(unit_id), kind=kind,
                                attempts=attempts, error=str(e)[:300])
                if manifest is not None:
                    manifest.quarantine(unit_id, kind, str(e), attempts)
                return False, None
            raise
        else:
            if manifest is not None:
                manifest.complete(unit_id)
            return True, result


def manifest_has_quarantined(path: str) -> bool:
    """Whether a run manifest at ``path`` records quarantined units — THE
    degraded-run check, shared by every consumer (CLI exit codes) so the
    schema read lives in one place.  Missing/unreadable manifests read as not-degraded."""
    try:
        with open(path) as f:
            return bool(json.load(f).get("quarantined"))
    except (OSError, ValueError):
        return False


def _encode_f32(arr: np.ndarray) -> str:
    return base64.b64encode(
        np.ascontiguousarray(arr, dtype="<f4").tobytes()
    ).decode("ascii")


def _decode_f32(s: str) -> np.ndarray:
    return np.frombuffer(base64.b64decode(s), dtype="<f4").astype(
        np.float32, copy=True
    )


class EvalJournal:
    """Append-only journal of per-batch eval contributions (JSONL).

    Line 1 is a header fingerprinting the run settings; each later line is
    one batch's contribution ``{"batch": i, "pck": <base64 f32 bytes>}``.
    Floats travel as raw little-endian bytes, so a resumed run concatenates
    EXACTLY the values the killed run computed — the bitwise-resume bar the
    training checkpoints already meet.  Appends flush+fsync (a journal that
    loses its tail on power cut would silently recompute, which is correct
    but wasteful; a torn TAIL, however, must be tolerated: a process can
    die mid-``write``).  A header mismatch — the journal belongs to a
    different configuration — discards the journal and starts fresh rather
    than poisoning the result.
    """

    def __init__(self, path: str, header: dict):
        self.path = path
        # normalize through one json round trip so tuple-vs-list and
        # int-vs-float representation differences cannot fail the match
        self.header = json.loads(json.dumps(header, sort_keys=True))
        self.entries: Dict[int, np.ndarray] = {}
        self._appends = 0
        good_bytes = self._load()
        if good_bytes is None:
            if os.path.exists(self.path) and os.path.getsize(self.path):
                # never destroy another run's journal at construction time:
                # a mismatched --journal_dir may be an operator mistake, and
                # the displaced run's accumulated results should survive it
                stale = self.path + ".stale"
                os.replace(self.path, stale)
                log.warning(f"set the non-resumable journal aside as "
                            f"{stale}", kind="validation")
            self._f = open(self.path, "w")
            self._write_raw(json.dumps({"header": self.header},
                                       sort_keys=True) + "\n")
        else:
            # truncate the torn tail BEFORE appending: the next record must
            # start on a fresh line, not be concatenated onto the partial
            # one (which would corrupt it and cost every later batch on the
            # next resume)
            with open(self.path, "rb+") as f:
                f.truncate(good_bytes)
            self._f = open(self.path, "a")

    def _load(self) -> Optional[int]:
        """Parse an existing journal.  Returns the byte offset of the end of
        the last GOOD line when the journal is resumable (header matches),
        else None.  A torn trailing line is dropped; torn or foreign content
        earlier in the file discards everything from that point (those
        batches simply recompute)."""
        if not os.path.exists(self.path):
            return None
        with open(self.path, "rb") as f:
            lines = f.read().split(b"\n")
        if len(lines) < 2 or not lines[0]:
            # no newline at all: even the header line is torn — fresh start
            return None
        try:
            head = json.loads(lines[0])
        except ValueError:
            head = None
        if not isinstance(head, dict) or head.get("header") != self.header:
            log.warning(f"eval journal {self.path} belongs to a different "
                        "run configuration; starting fresh",
                        kind="validation")
            return None
        good_bytes = len(lines[0]) + 1
        # every element except the LAST was newline-terminated; the last is
        # b"" for a cleanly-terminated file, else a newline-less tail.  A
        # newline-less record is dropped (truncated) EVEN IF it parses:
        # accepting it would either make good_bytes overshoot the file size
        # (truncate would zero-extend) or let the next append fuse onto it —
        # one recomputed batch is the cheap, correct outcome.  A torn but
        # TERMINATED line mid-file (a failed write repaired by the next
        # append's newline) is merely skipped: records are independent and
        # keyed by batch index, so later lines stay valid.
        for i, line in enumerate(lines[1:], start=2):
            if i == len(lines):
                break  # the unterminated tail (or the clean-file b"")
            good_bytes += len(line) + 1
            if not line:
                continue  # a sealing newline after a repaired torn write
            try:
                rec = json.loads(line)
                self.entries[int(rec["batch"])] = _decode_f32(rec["pck"])
            except (ValueError, KeyError, TypeError):
                log.warning(f"eval journal {self.path}: skipping "
                            f"undecodable line {i} (its batch will "
                            "recompute)", kind="validation")
        return good_bytes

    def _write_raw(self, text: str) -> None:
        # _dirty spans the write: a failure part-way (ENOSPC, EIO) may have
        # landed a torn prefix on disk, and the NEXT append must start on a
        # fresh line or it would fuse onto it (losing that record AND its
        # retry at the next resume)
        self._dirty = True
        self._f.write(text)
        self._f.flush()
        os.fsync(self._f.fileno())
        self._dirty = text[-1:] != "\n"

    def append(self, batch_index: int, pck: np.ndarray) -> None:
        from ncnet_tpu_torch.utils import faults

        if getattr(self, "_dirty", False):
            self._write_raw("\n")  # seal a torn previous write
        line = json.dumps(
            {"batch": int(batch_index), "pck": _encode_f32(pck)},
            sort_keys=True,
        )
        self._appends += 1
        # injected SIGKILL mid-append: a torn prefix is flushed first, so the
        # resumed run must prove partial-trailing-line tolerance
        faults.journal_kill_hook(
            self._appends,
            lambda: self._write_raw(line[: max(1, len(line) // 2)]),
        )
        self._write_raw(line + "\n")
        self.entries[int(batch_index)] = np.asarray(pck, dtype=np.float32)

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()
