"""Metrics registry, the port of ``ncnet_tpu/observability/metrics.py``:
counters, gauges, timers and histograms flushed into the event log.

One registry per run scope.  ``snapshot()`` renders everything to plain
numbers; ``flush()`` emits one ``metrics`` event carrying the snapshot.

Also here: the NC filter's FLOP counts (the MFU numerator) and the card's
peaks (the denominator), keyed by CUDA device name: the NVIDIA H100 SXM
data sheet's dense bf16 tensor-core rate and HBM3 bandwidth at 700 W.
"""

from __future__ import annotations

import statistics
import threading
import time
from collections import deque
from typing import Dict, Optional, Sequence

from ncnet_tpu_torch.observability import events as _events

# dense bf16 tensor-core peak, TFLOP/s, by CUDA device name (data sheet)
PEAK_BF16_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.0,
}

# HBM bandwidth, GB/s, by CUDA device name (data sheet)
PEAK_HBM_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
}


def filter_flops(feat_side: int, kernels: Sequence[int],
                 channels: Sequence[int]) -> float:
    """FLOPs a pair of the symmetric NC filter (both volume directions) at
    a square ``feat_side``, counting every tap (same padding): ~281.2 GFLOP
    at the PF-Pascal arch (25⁴, k = 5³, channels 16/16/1).  Not the
    roofline's count: ``roofline.filter_work`` counts only the taps inside
    the volume, 231.0 GFLOP a pair there."""
    cells = (feat_side * feat_side) ** 2
    chans = list(zip((1,) + tuple(channels[:-1]), channels))
    return 2 * cells * sum(
        2 * (k ** 4) * ci * co for k, (ci, co) in zip(kernels, chans))


def train_step_flops(feat_side: int, kernels: Sequence[int],
                     channels: Sequence[int]) -> float:
    """FLOPs a pair of one weak-supervision training step on the
    6×-filter basis (2 filter forwards, positive and negative, and a
    backward of about twice a forward each)."""
    return 6.0 * filter_flops(feat_side, kernels, channels)


def device_peak_tflops() -> Optional[float]:
    """bf16 peak of the local CUDA device, or None (no card in use, or an
    unknown one): callers then skip MFU rather than emit a wrong one."""
    return PEAK_BF16_TFLOPS.get(_events.local_device_kind())


class Counter:
    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> int:
        self.value += int(n)
        return self.value


class Gauge:
    def __init__(self):
        self.value: Optional[float] = None

    def set(self, v) -> None:
        self.value = v


class Timer:
    """Accumulates wall intervals: a context manager, or measured seconds
    fed to :meth:`observe`.  Keeps a bounded window of recent observations
    for the median (``p50_s``): a run's first step or batch, which pays
    the warm-up, dominates the mean."""

    _WINDOW = 1024  # recent observations kept for the median

    def __init__(self):
        self.count = 0
        self.total_s = 0.0
        self.last_s: Optional[float] = None
        self.min_s: Optional[float] = None
        self.max_s: Optional[float] = None
        self._recent: deque = deque(maxlen=self._WINDOW)

    def observe(self, seconds: float) -> None:
        s = float(seconds)
        self.count += 1
        self.total_s += s
        self.last_s = s
        self.min_s = s if self.min_s is None else min(self.min_s, s)
        self.max_s = s if self.max_s is None else max(self.max_s, s)
        self._recent.append(s)

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.observe(time.perf_counter() - self._t0)

    def snapshot(self) -> Dict[str, float]:
        out = {"count": self.count, "total_s": round(self.total_s, 6)}
        for k in ("last_s", "min_s", "max_s"):
            v = getattr(self, k)
            if v is not None:
                out[k] = round(v, 6)
        if self.count:
            out["mean_s"] = round(self.total_s / self.count, 6)
        if self._recent:
            out["p50_s"] = round(statistics.median(self._recent), 6)
        return out


class Histogram:
    """Fixed-bin histogram digest: ``bins`` counters over ``[lo, hi]``
    (values outside clamped to the edge bins, so they are counted) plus the
    exact count, sum, min and max; bounded memory for a per-pair signal
    over a whole run.  Digests with the same binning merge by adding
    counts; percentiles interpolate linearly inside a bin (exact to a bin
    width)."""

    def __init__(self, lo: float = 0.0, hi: float = 1.0, bins: int = 32):
        if not (hi > lo and bins > 0):
            raise ValueError(f"bad histogram binning [{lo}, {hi}] x {bins}")
        self.lo, self.hi, self.bins = float(lo), float(hi), int(bins)
        self.counts = [0] * int(bins)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def add(self, values) -> None:
        """Accumulate value(s); NaN and inf are dropped (a failed pair must
        not shift the distribution it failed to measure)."""
        import math

        try:
            values = list(values)
        except TypeError:
            values = [values]
        w = (self.hi - self.lo) / self.bins
        for v in values:
            v = float(v)
            if not math.isfinite(v):
                continue
            i = min(self.bins - 1, max(0, int((v - self.lo) / w)))
            self.counts[i] += 1
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)

    def bucket_edges(self) -> list:
        """Upper edge of each finite bin (``lo + (i+1)·width``) — the
        Prometheus exporter's ``le`` values.  Edge-bin clamping means the
        first/last bins absorb out-of-range observations, so the cumulative
        ``_bucket`` series stays consistent with ``count`` by construction."""
        w = (self.hi - self.lo) / self.bins
        return [self.lo + (i + 1) * w for i in range(self.bins)]

    def merge(self, other: "Histogram") -> None:
        if (other.lo, other.hi, other.bins) != (self.lo, self.hi, self.bins):
            raise ValueError("cannot merge histograms with different binning")
        for i, n in enumerate(other.counts):
            self.counts[i] += n
        self.count += other.count
        self.sum += other.sum
        for name, pick in (("min", min), ("max", max)):
            ov = getattr(other, name)
            if ov is not None:
                mine = getattr(self, name)
                setattr(self, name, ov if mine is None else pick(mine, ov))

    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def percentile(self, q: float) -> Optional[float]:
        """Approximate q-th percentile (0-100), linear within the bin."""
        if not self.count:
            return None
        target = q / 100.0 * self.count
        w = (self.hi - self.lo) / self.bins
        seen = 0
        for i, n in enumerate(self.counts):
            if seen + n >= target and n:
                frac = (target - seen) / n
                return self.lo + (i + frac) * w
            seen += n
        return self.hi

    def snapshot(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "count": self.count, "lo": self.lo, "hi": self.hi,
            "counts": list(self.counts),
        }
        if self.count:
            out["mean"] = round(self.sum / self.count, 6)
            out["min"] = round(self.min, 6)
            out["max"] = round(self.max, 6)
            for q in (50, 90):
                out[f"p{q}"] = round(self.percentile(q), 6)
        return out

    @classmethod
    def from_snapshot(cls, snap: Dict[str, object]) -> "Histogram":
        """Rebuild a digest from its snapshot dict; min, max and sum
        degrade to bin-resolution estimates where absent."""
        counts = list(snap["counts"])
        h = cls(float(snap["lo"]), float(snap["hi"]), len(counts))
        h.counts = [int(n) for n in counts]
        h.count = int(snap.get("count", sum(h.counts)))
        if h.count:
            h.sum = float(snap.get("mean", 0.0)) * h.count
            h.min = float(snap.get("min", h.lo))
            h.max = float(snap.get("max", h.hi))
        return h


class MetricsRegistry:
    """Named counters, gauges, timers and histograms of one run scope.
    Creation is thread-safe; each metric is updated from one loop."""

    def __init__(self, scope: str = ""):
        self.scope = scope
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls()
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def timer(self, name: str) -> Timer:
        return self._get(name, Timer)

    def histogram(self, name: str, lo: float = 0.0, hi: float = 1.0,
                  bins: int = 32) -> Histogram:
        """Fixed-bin digest; binning is set at first creation (later calls
        return the existing digest — mismatched binning raises rather than
        silently rebinning a live distribution)."""
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Histogram(lo, hi, bins)
            elif not isinstance(m, Histogram):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not Histogram"
                )
            elif (m.lo, m.hi, m.bins) != (float(lo), float(hi), int(bins)):
                raise ValueError(
                    f"histogram {name!r} already registered with binning "
                    f"[{m.lo}, {m.hi}] x {m.bins}"
                )
            return m

    def snapshot(self) -> Dict[str, object]:
        """Plain-data view: counters/gauges to their value, timers to their
        stat dict.  Unset gauges are omitted (a null metric is noise)."""
        out: Dict[str, object] = {}
        with self._lock:
            items = list(self._metrics.items())
        for name, m in items:
            if isinstance(m, Counter):
                out[name] = m.value
            elif isinstance(m, Gauge):
                if m.value is not None:
                    out[name] = m.value
            elif isinstance(m, Timer):
                if m.count:
                    out[name] = m.snapshot()
            elif isinstance(m, Histogram):
                if m.count:
                    out[name] = m.snapshot()
        return out

    def flush(self, sink: Optional["_events.EventLog"] = None,
              event: str = "metrics", **extra) -> Dict[str, object]:
        """Emit one ``metrics`` event carrying the current snapshot (to
        ``sink``, else the global sink) and return the snapshot."""
        snap = self.snapshot()
        fields = dict(extra)
        if self.scope:
            fields.setdefault("scope", self.scope)
        if sink is not None:
            sink.emit(event, metrics=snap, **fields)
        else:
            _events.emit(event, metrics=snap, **fields)
        return snap
