"""Memory observability, the port of ``ncnet_tpu/observability/memory.py``
on ``torch.cuda``: the program ledger, live memory pressure
(:func:`hbm_stats`), the live-tensor census and the leak sentinel
(:func:`live_tensor_census`, :class:`LeakSentinel`), and the OOM
postmortem (:func:`is_oom`, :func:`report_oom`).

  * The program ledger keeps one row for each ``(program, shape_class,
    tier, device_kind)``: argument, output and temp bytes.  The JAX package
    fills a row from XLA's compiled memory analysis; PyTorch compiles no
    program, so the serving warm-up measures one on the card (ROADMAP D9):
    the peak allocated over one run of a bucket at a batch size less what
    was allocated before it as the temp bytes, the result's bytes as the
    output.  Rows are emitted as ``memory_ledger`` events and persisted in
    the JAX package's ledger file (``~/.cache/ncnet_tpu/memory_ledger.json``,
    knob ``NCNET_TPU_MEMORY_LEDGER``: a path, or ``0``/``off``).  On the CPU
    no row is measured.
  * :func:`hbm_stats` reads one CUDA device's caching-allocator watermarks
    (bytes in use, peak, reserved; the card's memory as the limit; fill %).
  * :class:`LeakSentinel` takes a census of the live CUDA tensors (count
    and bytes by shape class) at batch boundaries; a shape class whose
    count grows strictly across the whole trailing window is named in a
    ``memory_leak_suspect`` event.

Like the JAX module on a backend without memory stats, everything here is
silent where this process has not initialized CUDA (the CPU), and
fail-open.
"""

from __future__ import annotations

import gc
import os
import re
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional

from ncnet_tpu_torch.observability import events as _events

SCHEMA_VERSION = 1
LEDGER_ENV = "NCNET_TPU_MEMORY_LEDGER"

# the serving engine's program label: the serving plane sums this program's
# rows into its predicted-footprint gauge
SERVE_PROGRAM = "serve_batch"

_lock = threading.Lock()
# rows recorded (or replayed from the file) in this process, by ledger key:
# the "warmed programs" the predicted-footprint gauge sums
_runtime_rows: Dict[str, Dict[str, Any]] = {}
# the on-disk mirror, loaded once per resolved path
_state: Dict[str, object] = {"loaded": False, "path": None, "doc": None}


# ---------------------------------------------------------------------------
# the program ledger
# ---------------------------------------------------------------------------


def ledger_path() -> Optional[str]:
    """The ledger file, or None when the env knob turns it off."""
    raw = os.environ.get(LEDGER_ENV)
    if raw is not None:
        raw = raw.strip()
        if raw.lower() in ("", "0", "off", "none"):
            return None
        return raw
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return os.path.join(base, "ncnet_tpu", "memory_ledger.json")


def _device_kind() -> str:
    return _events.local_device_kind() or "unknown"


def ledger_key(program: str, shape_class: str, tier: Optional[str],
               device_kind: str) -> str:
    """The key of one row: ``program|shape_class|tier|device_kind``."""
    return f"{program}|{shape_class}|{tier or 'xla'}|{device_kind}"


def _empty_doc() -> dict:
    return {"kind": "ncnet_tpu_memory_ledger", "schema": SCHEMA_VERSION,
            "rows": {}}


def _load_locked() -> dict:
    """The parsed file (cached in-process); a missing, corrupt, foreign or
    newer-schema file reads as empty and is overwritten on the next
    record."""
    path = ledger_path()
    if _state["loaded"] and path == _state["path"]:
        return _state["doc"]  # type: ignore[return-value]
    doc = _empty_doc()
    if path is not None:
        try:
            import json

            with open(path) as f:
                cand = json.load(f)
            if (isinstance(cand, dict)
                    and cand.get("kind") == "ncnet_tpu_memory_ledger"
                    and cand.get("schema") == SCHEMA_VERSION
                    and isinstance(cand.get("rows"), dict)):
                doc = cand
        except (OSError, ValueError):
            pass
    _state.update(loaded=True, path=path, doc=doc)
    return doc


def _save_locked(doc: dict) -> None:
    path = ledger_path()
    if path is None:
        return
    try:
        from ncnet_tpu_torch.utils.io import atomic_write_json

        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        atomic_write_json(path, doc)
    except (OSError, ValueError):
        pass  # fail-open: events alone are still a ledger


def _reset_state() -> None:
    """Tests: forget the in-process mirror and rows (a fresh process)."""
    with _lock:
        _state.update(loaded=False, path=None, doc=None)
        _runtime_rows.clear()


_ANALYSIS_FIELDS = ("argument_bytes", "output_bytes", "temp_bytes",
                    "alias_bytes", "generated_code_bytes")


def analysis_dict(analysis: Any) -> Optional[Dict[str, int]]:
    """A plain dict of byte fields reduced to the ones the ledger stores,
    plus ``total_bytes`` (arguments + outputs + temps - aliased); None when
    it holds none."""
    if not isinstance(analysis, dict):
        return None
    out = {k: int(analysis[k]) for k in _ANALYSIS_FIELDS
           if isinstance(analysis.get(k), (int, float))
           and not isinstance(analysis.get(k), bool)}
    if not out:
        return None
    out["total_bytes"] = (out.get("argument_bytes", 0)
                          + out.get("output_bytes", 0)
                          + out.get("temp_bytes", 0)
                          - out.get("alias_bytes", 0))
    return out


def _evict_stale_tiers_locked(row: Dict[str, Any]) -> None:
    """Drop in-process rows of the same (program, shape_class,
    device_kind) under another tier, so a shape is counted once in
    :func:`predicted_footprint_bytes` (the file keeps every tier's row)."""
    for key, old in list(_runtime_rows.items()):
        if (old["program"] == row["program"]
                and old["shape_class"] == row["shape_class"]
                and old["device_kind"] == row["device_kind"]
                and old["tier"] != row["tier"]):
            del _runtime_rows[key]


def record_program(program: str, shape_cls: str, *,
                   analysis: Any = None, tier: Optional[str] = None,
                   device_kind: Optional[str] = None,
                   source: str = "probe") -> Optional[Dict[str, Any]]:
    """Record one program's memory: build the row, register it in-process,
    persist it and emit the ``memory_ledger`` event.  ``analysis`` is a
    dict of byte fields.  Returns the row (None without one); fail-open."""
    try:
        fields = analysis_dict(analysis)
        if fields is None:
            return None
        kind = device_kind or _device_kind()
        row: Dict[str, Any] = {
            "schema": SCHEMA_VERSION, "program": str(program),
            "shape_class": str(shape_cls), "tier": tier or "xla",
            "device_kind": kind, **fields,
        }
        key = ledger_key(program, shape_cls, tier, kind)
        with _lock:
            _evict_stale_tiers_locked(row)
            _runtime_rows[key] = row
            if ledger_path() is not None:
                doc = _load_locked()
                if doc["rows"].get(key) != row:
                    doc["rows"][key] = dict(row)
                    _save_locked(doc)
        _events.emit("memory_ledger", source=source, **row)
        return row
    except Exception:  # noqa: BLE001 — the ledger never kills the caller
        return None


def ensure_program(program: str, shape_cls: str, *,
                   analyze: Callable[[], Any],
                   tier: Optional[str] = None,
                   device_kind: Optional[str] = None
                   ) -> Optional[Dict[str, Any]]:
    """The row of this key, measuring (``analyze()``) only on a miss; a hit,
    in-process or from the file, still emits ``memory_ledger`` with
    ``source="cache"``."""
    try:
        kind = device_kind or _device_kind()
        key = ledger_key(program, shape_cls, tier, kind)
        with _lock:
            row = _runtime_rows.get(key)
            if row is None and ledger_path() is not None:
                cand = _load_locked()["rows"].get(key)
                if isinstance(cand, dict) and cand.get(
                        "schema") == SCHEMA_VERSION:
                    row = dict(cand)
                    _evict_stale_tiers_locked(row)
                    _runtime_rows[key] = row
        if row is not None:
            _events.emit("memory_ledger", source="cache", **row)
            return row
        return record_program(program, shape_cls, analysis=analyze(),
                              tier=tier, device_kind=kind)
    except Exception:  # noqa: BLE001
        return None


def ledger_rows(program: Optional[str] = None,
                device_kind: Optional[str] = None) -> List[Dict[str, Any]]:
    """The rows this process knows, optionally filtered."""
    with _lock:
        rows = [dict(r) for r in _runtime_rows.values()]
    return [r for r in rows
            if (program is None or r["program"] == program)
            and (device_kind is None or r["device_kind"] == device_kind)]


def predicted_footprint_bytes(program: Optional[str] = None,
                              device_kind: Optional[str] = None
                              ) -> Optional[int]:
    """The sum of temp + output bytes over this process's rows; None when
    nothing is warmed."""
    rows = ledger_rows(program=program, device_kind=device_kind)
    if not rows:
        return None
    return sum(int(r.get("temp_bytes", 0)) + int(r.get("output_bytes", 0))
               for r in rows)


def hbm_stats(device: Optional[int] = None) -> Optional[Dict[str, Any]]:
    """One CUDA device's watermarks (``bytes_in_use``,
    ``peak_bytes_in_use``, ``bytes_reserved``, ``bytes_limit``,
    ``bytes_free``) and ``fill_pct``, or None where CUDA is not
    initialized (the CPU): the plane stays silent, it never errors."""
    try:
        import torch

        from ncnet_tpu_torch.observability.device import cuda_memory

        if not torch.cuda.is_initialized():
            return None
        index = torch.cuda.current_device() if device is None else int(device)
        mem = cuda_memory(index)
        if mem is None:
            return None
        out: Dict[str, Any] = {"device": index, **mem}
        if mem["bytes_limit"]:
            out["fill_pct"] = round(
                100.0 * mem["bytes_in_use"] / mem["bytes_limit"], 2)
        return out
    except Exception:  # noqa: BLE001 — optional per-device API
        return None


# ---------------------------------------------------------------------------
# leak sentinel
# ---------------------------------------------------------------------------


def live_tensor_census(max_classes: int = 64) -> Optional[Dict[str, Any]]:
    """The live CUDA tensors the garbage collector tracks, grouped by shape
    class (``dtype[dims]``): total count/bytes plus the per-class breakdown
    (largest ``max_classes`` classes by bytes).  None where CUDA is not
    initialized, or when the census cannot be taken."""
    try:
        import torch

        if not torch.cuda.is_initialized():
            return None
        by: Dict[str, Dict[str, int]] = {}
        n_total = 0
        b_total = 0
        for obj in gc.get_objects():
            try:
                # type(), not isinstance(): a deprecated module object
                # warns when its attributes (__class__) are read
                if not (issubclass(type(obj), torch.Tensor) and obj.is_cuda):
                    continue
                cls = (f"{str(obj.dtype).replace('torch.', '')}"
                       f"[{'x'.join(str(d) for d in obj.shape)}]")
                nb = obj.numel() * obj.element_size()
            except Exception:  # noqa: BLE001 — exotic objects: skip
                continue
            d = by.setdefault(cls, {"n": 0, "bytes": 0})
            d["n"] += 1
            d["bytes"] += nb
            n_total += 1
            b_total += nb
        top = dict(sorted(by.items(),
                          key=lambda kv: -kv[1]["bytes"])[:max_classes])
        return {"n": n_total, "bytes": b_total, "classes": len(by),
                "by_class": top}
    except Exception:  # noqa: BLE001 — no census beats a crashed loop
        return None


class LeakSentinel:
    """Trailing-window growth detector over live-tensor censuses.

    ``observe(step=...)`` takes one census (at a batch/epoch boundary).
    When a shape class's count has grown STRICTLY across every consecutive
    delta of the full window (``window`` deltas, so ``window+1``
    censuses), it is named in a ``memory_leak_suspect`` event along with
    its byte growth; the window then resets, so an ongoing leak re-fires
    once per window rather than once per batch.  A class whose count
    fluctuates, or stays flat, never trips it.  ``min_interval_s``
    rate-limits the census itself for hot loops."""

    def __init__(self, window: int = 4, min_growth_bytes: int = 0,
                 min_interval_s: float = 0.0, scope: str = ""):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = int(window)
        self.min_growth_bytes = int(min_growth_bytes)
        self.min_interval_s = float(min_interval_s)
        self.scope = scope
        self._censuses: Deque[Dict[str, Any]] = deque(maxlen=window + 1)
        self._last_t: Optional[float] = None
        self._obs_lock = threading.Lock()

    def observe(self, step: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """Take one census; returns the emitted suspect event's fields when
        the detector fired, else None.  Fail-open end to end; safe to call
        from several threads (one census at a time)."""
        try:
            with self._obs_lock:
                now = time.monotonic()
                if self._last_t is not None and self.min_interval_s > 0 \
                        and now - self._last_t < self.min_interval_s:
                    return None
                census = live_tensor_census()
                if census is None:
                    return None
                self._last_t = now
                self._censuses.append(census)
                if len(self._censuses) < self.window + 1:
                    return None
                suspects = self._suspects()
                if not suspects:
                    return None
                fields: Dict[str, Any] = {
                    "scope": self.scope, "window": self.window,
                    "suspects": suspects,
                    "live_n": census["n"], "live_bytes": census["bytes"],
                }
                if step is not None:
                    fields["step"] = int(step)
                self._censuses.clear()  # re-arm: one event per full window
            _events.emit("memory_leak_suspect", **fields)
            return fields
        except Exception:  # noqa: BLE001 — the sentinel never kills the loop
            return None

    def _suspects(self) -> List[Dict[str, Any]]:
        seq = list(self._censuses)
        first, last = seq[0]["by_class"], seq[-1]["by_class"]
        out: List[Dict[str, Any]] = []
        for cls in last:
            counts = []
            for c in seq:
                d = c["by_class"].get(cls)
                if d is None:
                    break
                counts.append(d["n"])
            if len(counts) != len(seq):
                continue  # absent somewhere in the window: not monotone
            if all(b > a for a, b in zip(counts, counts[1:])):
                growth = last[cls]["bytes"] - first[cls]["bytes"]
                if growth >= self.min_growth_bytes:
                    out.append({
                        "shape_class": cls,
                        "n_first": counts[0], "n_last": counts[-1],
                        "bytes_first": first[cls]["bytes"],
                        "bytes_last": last[cls]["bytes"],
                        "growth_bytes": growth,
                    })
        out.sort(key=lambda s: -s["growth_bytes"])
        return out


# ---------------------------------------------------------------------------
# OOM test
# ---------------------------------------------------------------------------

_OOM_MARKERS = ("out of memory", "resource_exhausted", "resource exhausted",
                "allocation failure", "failed to allocate")
# bare "oom" must be word-bounded: a path like ".../reading_room_3.mat" in
# an IO error contains the substring but is not a memory failure
_OOM_RE = re.compile(r"\boom\b", re.IGNORECASE)


# the mark of an exception already reported: one failure passes several
# seams of the serving failure ladder, and gives exactly one postmortem (a
# mark on the object, as a built-in exception takes no weak reference)
_REPORTED_ATTR = "_ncnet_memory_postmortem"


def is_oom(exc: BaseException) -> bool:
    """Whether an exception is a memory failure: ``torch.cuda.
    OutOfMemoryError``, or an error whose message carries an out-of-memory
    marker."""
    try:
        import torch

        if isinstance(exc, torch.cuda.OutOfMemoryError):
            return True
        msg = f"{type(exc).__name__}: {exc}".lower()
        return any(m in msg for m in _OOM_MARKERS) \
            or _OOM_RE.search(msg) is not None
    except Exception:  # noqa: BLE001
        return False


def report_oom(exc: BaseException, *, program: Optional[str] = None,
               scope: str = "", **extra: Any) -> bool:
    """Classify ``exc`` as a memory failure and emit one
    ``memory_postmortem`` event with the device snapshot, the failed
    program's ledger rows and the live-tensor census.  True when emitted;
    False for a non-OOM error or one already reported at another seam."""
    try:
        if not is_oom(exc):
            return False
        if getattr(exc, _REPORTED_ATTR, False):
            return False
        setattr(exc, _REPORTED_ATTR, True)
        from ncnet_tpu_torch.observability.device import device_snapshot

        rows = ledger_rows(program=program) if program else ledger_rows()
        _events.emit(
            "memory_postmortem",
            scope=scope, program=program, kind="oom",
            error=f"{type(exc).__name__}: {exc}"[:500],
            snapshot=device_snapshot(),
            ledger=rows[:16],
            census=live_tensor_census(max_classes=16),
            **extra,
        )
        return True
    except Exception:  # noqa: BLE001 — the postmortem never adds a failure
        return False
