"""Memory observability, the part of ``ncnet_tpu/observability/memory.py``
the eval path calls, on ``torch.cuda``: live memory pressure
(:func:`hbm_stats`), the live-tensor census and the leak sentinel
(:func:`live_tensor_census`, :class:`LeakSentinel`), and the OOM test
(:func:`is_oom`).

  * :func:`hbm_stats` reads one CUDA device's caching-allocator watermarks
    (bytes in use, peak, reserved; the card's memory as the limit; fill %).
  * :class:`LeakSentinel` takes a census of the live CUDA tensors (count
    and bytes by shape class) at batch boundaries; a shape class whose
    count grows strictly across the whole trailing window is named in a
    ``memory_leak_suspect`` event.

Like the JAX module on a backend without memory stats, everything here is
silent where this process has not initialized CUDA (the CPU), and
fail-open.  The compiled-program ledger and the OOM postmortem wait in
ROADMAP A11.
"""

from __future__ import annotations

import gc
import re
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

from ncnet_tpu_torch.observability import events as _events


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
