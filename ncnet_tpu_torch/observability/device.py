"""Device introspection, the port of ``ncnet_tpu/observability/device.py``:
:func:`device_snapshot` and :class:`DeviceMonitor` on ``torch.cuda``, and
the :class:`Heartbeat` file.

A snapshot is one dict per CUDA device (index, name, platform, and the
caching allocator's watermarks: ``bytes_in_use``, ``peak_bytes_in_use``,
``bytes_reserved``, ``bytes_limit`` = the card's memory, ``bytes_free`` =
``torch.cuda.mem_get_info``'s free bytes), emitted as ``device_snapshot`` events so a
replayed run shows memory pressure beside its timeline.  It reads the
devices only when this process has already initialized CUDA (it never
initializes it), so on the CPU it stays silent, as the JAX one does on a
backend without memory stats.  Everything is fail-open.

The heartbeat is a small JSON file (``{"time", "pid", "step", "run"}``)
that a long run rewrites atomically every step: a watchdog reads its mtime
(one ``stat``) to tell a live run from a hung one.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from ncnet_tpu_torch.observability import events as _events
from ncnet_tpu_torch.utils.profiling import annotate

# the caching allocator's counters behind the JAX package's key names
_STAT_KEYS = (("bytes_in_use", "allocated_bytes.all.current"),
              ("peak_bytes_in_use", "allocated_bytes.all.peak"),
              ("bytes_reserved", "reserved_bytes.all.current"))


def cuda_memory(index: int) -> Optional[Dict[str, int]]:
    """The watermarks of CUDA device ``index`` (see the module docstring),
    or None when CUDA is not initialized in this process."""
    import torch

    if not torch.cuda.is_initialized():
        return None
    stats = torch.cuda.memory_stats(index)
    out = {key: int(stats.get(name, 0)) for key, name in _STAT_KEYS}
    free, total = torch.cuda.mem_get_info(index)
    out["bytes_limit"] = int(total)
    out["bytes_free"] = int(free)
    return out


def device_snapshot() -> List[Dict[str, Any]]:
    """One dict per CUDA device: id/kind/platform and its memory
    watermarks; ``[]`` when CUDA is not initialized (the CPU)."""
    try:
        import torch

        if not torch.cuda.is_initialized():
            return []
        out: List[Dict[str, Any]] = []
        for i in range(torch.cuda.device_count()):
            entry: Dict[str, Any] = {
                "id": i, "kind": torch.cuda.get_device_name(i),
                "platform": "gpu"}
            entry.update(cuda_memory(i) or {})
            out.append(entry)
        return out
    except Exception:  # noqa: BLE001 — a snapshot never kills the run
        return []


class DeviceMonitor:
    """Rate-limited ``device_snapshot`` event emitter.

    ``maybe_emit(step=...)`` snapshots at most once per ``every_s`` seconds
    (the first call always emits) and only when a device is there to
    report (nothing on the CPU)."""

    def __init__(self, every_s: float = 60.0):
        self.every_s = float(every_s)
        self._last: Optional[float] = None

    def maybe_emit(self, step: Optional[int] = None) -> bool:
        now = time.monotonic()
        if self._last is not None and now - self._last < self.every_s:
            return False
        with annotate("device_snapshot"):
            snap = device_snapshot()
        if not snap:
            return False
        self._last = now
        _events.emit("device_snapshot", devices=snap,
                     **({"step": step} if step is not None else {}))
        return True


class Heartbeat:
    """Atomic-mtime heartbeat file (see the module docstring).

    ``beat()`` writes ``{"time", "pid", "step", "run"}`` to a temp file and
    ``os.replace``s it over ``path``: the mtime and the payload move as one,
    so a reader never sees a torn document."""

    def __init__(self, path: str, run_id: Optional[str] = None):
        self.path = path
        self.run_id = run_id
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def beat(self, step: Optional[int] = None, **fields) -> None:
        doc = {"time": time.time(), "pid": os.getpid()}
        if step is not None:
            doc["step"] = int(step)
        if self.run_id:
            doc["run"] = self.run_id
        doc.update(fields)
        tmp = self.path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, self.path)
        except OSError:
            # fail-open: a beat that cannot land (disk full) must not kill
            # the step it reports on; the stale mtime is the right signal
            try:
                os.remove(tmp)
            except OSError:
                pass

    @staticmethod
    def read(path: str) -> Optional[Dict[str, Any]]:
        """The last beat's payload, or None (missing or unreadable)."""
        try:
            with open(path) as f:
                doc = json.load(f)
            return doc if isinstance(doc, dict) else None
        except (OSError, ValueError):
            return None

    @staticmethod
    def age_s(path: str) -> Optional[float]:
        """Seconds since the last beat (from the mtime), or None when the
        file is missing."""
        try:
            return max(0.0, time.time() - os.stat(path).st_mtime)
        except OSError:
            return None
