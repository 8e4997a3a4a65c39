"""Device introspection, the part of ``ncnet_tpu/observability/device.py``
the eval path calls: :func:`device_snapshot` and :class:`DeviceMonitor`,
on ``torch.cuda``.

A snapshot is one dict per CUDA device (index, name, platform, and the
caching allocator's watermarks: ``bytes_in_use``, ``peak_bytes_in_use``,
``bytes_reserved``, ``bytes_limit`` = the card's memory, ``bytes_free`` =
``torch.cuda.mem_get_info``'s free bytes), emitted as ``device_snapshot`` events so a
replayed run shows memory pressure beside its timeline.  It reads the
devices only when this process has already initialized CUDA (it never
initializes it), so on the CPU it stays silent, as the JAX one does on a
backend without memory stats.  Everything is fail-open.  The heartbeat
file comes with the training loop (ROADMAP A6).
"""

from __future__ import annotations

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
