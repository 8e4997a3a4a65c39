"""Structured event log, the port of ``ncnet_tpu/observability/events.py``.

  * :class:`EventLog`: append-only JSONL.  Line 1 is a schema-versioned
    header carrying the run envelope (run id, host, pid, device kind);
    every later line is one typed event ``{"t", "run", "seq", "event",
    **fields}``.  Appends are flushed and fsynced; a process killed
    mid-append leaves at worst a torn trailing line, which
    :func:`replay_events` drops.  The format is the JAX package's, byte for
    byte in its keys, so either package's replay reads the other's logs.
  * Resume lineage: reopening a compatible log appends under a fresh run
    id; a foreign or newer-schema file is set aside as ``<path>.stale``.
  * A process-global sink (:func:`set_global_sink`, :func:`emit`,
    :func:`bound`): deep layers emit without a log handle, and ``emit`` is
    one ``is None`` check when nothing is bound.

Telemetry never kills the run it observes: a failing global-sink append
unbinds the sink and reports on stderr.  The device fields come from
``torch.cuda``, read only where the process already uses the card, so
building an envelope never opens a CUDA context.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

SCHEMA_VERSION = 1
_LOG_KIND = "ncnet_tpu_events"

# injected wall-clock skew (seconds), read once at import: every wall stamp
# this process publishes goes through wall_now, so NCNET_TPU_CLOCK_SKEW_S
# makes the process behave as a host whose clock is off by that much
try:
    _WALL_SKEW_S = float(os.environ.get("NCNET_TPU_CLOCK_SKEW_S", "") or 0.0)
except ValueError:
    _WALL_SKEW_S = 0.0


def wall_now() -> float:
    """This process's wall clock as published in telemetry: ``time.time()``
    plus the injected test skew (``NCNET_TPU_CLOCK_SKEW_S``, normally 0).
    Every stamp that another process compares goes through it."""
    return time.time() + _WALL_SKEW_S


def make_run_id() -> str:
    """Run id: seconds + pid + a random suffix (readable, and unique across
    hosts restarting in the same second)."""
    import secrets

    return f"{int(time.time()):x}-{os.getpid():x}-{secrets.token_hex(3)}"


def _cuda_device_names() -> Optional[List[str]]:
    """The CUDA device names, or None when the process has not initialized
    CUDA (nothing here initializes it) or cannot read them."""
    try:
        import torch

        if not torch.cuda.is_initialized():
            return None
        return [torch.cuda.get_device_name(i)
                for i in range(torch.cuda.device_count())]
    except Exception:  # noqa: BLE001 — no device = no kind, never a crash
        return None


def run_envelope(run_id: Optional[str] = None) -> Dict[str, Any]:
    """The who/where envelope stamped into headers and ``run_start``
    events: schema version, run id, host, pid, time, and the CUDA device
    kind and count with process index 0 where the process uses the card
    (absent otherwise: the envelope must build in tools that never touch
    an accelerator)."""
    env: Dict[str, Any] = {
        "schema": SCHEMA_VERSION,
        "run_id": run_id or make_run_id(),
        "host": socket.gethostname(),
        "pid": os.getpid(),
        "time": time.time(),
    }
    names = _cuda_device_names()
    if names:
        env["device_kind"] = names[0]
        env["device_count"] = len(names)
        env["process_index"] = 0
    return env


def local_device_kind() -> Optional[str]:
    """The local CUDA device's name, or None (no card in use): the one
    fail-open probe the envelope and the perf store key device entries by."""
    names = _cuda_device_names()
    return names[0] if names else None


def git_revision(repo_dir: Optional[str] = None) -> Optional[str]:
    """Short git revision of ``repo_dir`` (default: this package's repo),
    or None outside a work tree."""
    import subprocess

    if repo_dir is None:
        repo_dir = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
    try:
        out = subprocess.run(
            ["git", "-C", repo_dir, "rev-parse", "--short", "HEAD"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True, timeout=10,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    rev = out.stdout.strip()
    return rev if out.returncode == 0 and rev else None


def _parse_lines(raw: bytes) -> Tuple[Optional[dict], List[dict], int]:
    """Tail-tolerant JSONL parse: ``(header, records, good_bytes)``.

    ``header`` is None when line 1 is missing, torn or foreign;
    ``good_bytes`` is the end of the last newline-terminated line (the
    truncation point for an appender: an unterminated tail is dropped even
    if it parses).  Undecodable terminated lines are skipped: records are
    independent."""
    lines = raw.split(b"\n")
    if len(lines) < 2 or not lines[0]:
        return None, [], 0
    try:
        head = json.loads(lines[0])
    except ValueError:
        head = None
    if not isinstance(head, dict) or head.get("kind") != _LOG_KIND:
        return None, [], 0
    good_bytes = len(lines[0]) + 1
    records: List[dict] = []
    for i, line in enumerate(lines[1:], start=2):
        if i == len(lines):
            break  # the unterminated tail (or the clean file's b"")
        good_bytes += len(line) + 1
        if not line:
            continue  # a sealing newline after a repaired torn write
        try:
            rec = json.loads(line)
        except ValueError:
            continue  # torn but terminated: skip it, keep later records
        if isinstance(rec, dict):
            records.append(rec)
    return head, records, good_bytes


def replay_events(path: str) -> Tuple[Dict[str, Any], List[dict]]:
    """Replay an event log: ``(header, events)``, torn tail dropped.
    Raises ``FileNotFoundError`` for a missing file and ``ValueError`` for
    one that is not an event log or has a newer schema."""
    with open(path, "rb") as f:
        raw = f.read()
    head, records, _ = _parse_lines(raw)
    if head is None:
        raise ValueError(f"{path} is not an ncnet_tpu event log")
    if head.get("schema", 0) > SCHEMA_VERSION:
        raise ValueError(
            f"{path} has schema {head.get('schema')}, newer than this "
            f"reader ({SCHEMA_VERSION})")
    return head, records


class EventLog:
    """Append-only, schema-versioned, crash-safe event log (JSONL).

    Opening a path that holds a compatible log appends under a new run id
    (after truncating a torn tail); a foreign or newer-schema file is set
    aside as ``<path>.stale`` and a fresh log started.  Every append is
    flushed and fsynced, and seals a torn previous write with a newline
    first."""

    def __init__(self, path: str, run_meta: Optional[dict] = None,
                 run_id: Optional[str] = None):
        self.path = path
        self.run_id = run_id or make_run_id()
        self._seq = 0
        self._appends = 0
        self._dirty = False
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        good_bytes = 0
        if os.path.exists(path) and os.path.getsize(path):
            with open(path, "rb") as f:
                raw = f.read()
            head, _, good_bytes = _parse_lines(raw)
            if head is None or head.get("schema", 0) > SCHEMA_VERSION:
                # never destroy what may be another run's data
                stale = path + ".stale"
                os.replace(path, stale)
                _warn_stderr(f"event log {path} is foreign or "
                             f"newer-schema; set aside as {stale}")
                good_bytes = 0
        if good_bytes:
            with open(path, "rb+") as f:
                f.truncate(good_bytes)
            self._f = open(path, "a")
        else:
            self._f = open(path, "w")
            header = {
                "kind": _LOG_KIND,
                "header": {**run_envelope(self.run_id),
                           **({"meta": run_meta} if run_meta else {})},
            }
            self._write_raw(json.dumps(header, sort_keys=True) + "\n")

    def _write_raw(self, text: str) -> None:
        # _dirty spans the write: a failure part-way may leave a torn
        # prefix, and the next append must start on a fresh line
        self._dirty = True
        self._f.write(text)
        self._f.flush()
        os.fsync(self._f.fileno())
        self._dirty = text[-1:] != "\n"

    def emit(self, event: str, **fields) -> None:
        """Append one typed event: fully on disk (fsynced), or detectably
        torn on replay."""
        from ncnet_tpu_torch.utils import faults

        rec = {"t": wall_now(), "run": self.run_id, "seq": self._seq,
               "event": str(event)}
        for k, v in fields.items():
            rec[k] = _jsonable(v)
        line = json.dumps(rec, sort_keys=True)
        with self._lock:
            if self._dirty:
                self._write_raw("\n")  # seal a torn previous write
            self._seq += 1
            self._appends += 1
            # an injected SIGKILL mid-append flushes a torn prefix first
            faults.event_kill_hook(
                self._appends,
                lambda: self._write_raw(line[: max(1, len(line) // 2)]))
            self._write_raw(line + "\n")

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()

    def __enter__(self) -> "EventLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _jsonable(v):
    """One field as a JSON value: numpy and torch scalars and arrays
    degrade to numbers and lists, anything else to its ``repr``; a NaN
    becomes ``"nan"`` (strict JSON has none)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        if isinstance(v, float) and v != v:
            return "nan"
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    tolist = getattr(v, "tolist", None)  # numpy and torch values
    if callable(tolist):
        try:
            return _jsonable(tolist())
        except (TypeError, ValueError, RuntimeError):
            pass
    try:
        return _jsonable(float(v))
    except (TypeError, ValueError):
        return repr(v)


# ---------------------------------------------------------------------------
# the process-global sink
# ---------------------------------------------------------------------------

_sink: Optional[EventLog] = None


def set_global_sink(log: Optional[EventLog]) -> Optional[EventLog]:
    """Bind ``log`` as the process-global sink; returns the previous one."""
    global _sink
    prev = _sink
    _sink = log
    return prev


def get_global_sink() -> Optional[EventLog]:
    return _sink


def _warn_stderr(msg: str) -> None:
    import sys

    sys.stderr.write(f"[telemetry] {msg}\n")


def emit(event: str, **fields) -> None:
    """Emit to the global sink, if bound.  A failing append (disk full, a
    closed file) unbinds the sink and reports on stderr."""
    global _sink
    if _sink is None:
        return
    try:
        _sink.emit(event, **fields)
    except (OSError, ValueError) as e:
        _sink = None
        _warn_stderr(f"event sink failed ({e}); telemetry disabled for the "
                     "rest of the process")


@contextlib.contextmanager
def bound(log: Optional[EventLog]) -> Iterator[Optional[EventLog]]:
    """``with bound(log):`` the global sink bound inside, restored after."""
    prev = set_global_sink(log)
    try:
        yield log
    finally:
        set_global_sink(prev)
