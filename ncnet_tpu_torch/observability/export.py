"""Prometheus text-format exposition of the in-process metrics objects, the
port of ``ncnet_tpu/observability/export.py`` (no device code: a copy with
the port's imports, so both packages render the same text).

The event log, the registry and the perf store are written during a run
and replayed after it.  This module is the LIVE read side's wire format:
it renders any
:class:`~ncnet_tpu_torch.observability.metrics.MetricsRegistry` snapshot (or
hand-built metric families) as Prometheus exposition text (version 0.0.4),
the format every scraping stack (Prometheus, VictoriaMetrics, Grafana
agent, or just ``curl``) ingests natively.  ``serving/introspect.py``
serves the result on ``/metrics``; the scrape-validation tests read it
back through :func:`parse_prometheus`.

Contract highlights (the tests pin these):

  * **Counters are monotonic across scrapes** — a ``Counter``'s value only
    ever increments, and the renderer never rebases or resets it, so two
    scrapes under load always satisfy ``v2 >= v1`` per series.
  * **Histograms are cumulative** — each fixed-bin
    :class:`~ncnet_tpu_torch.observability.metrics.Histogram` renders as
    ``_bucket{le="<edge>"}`` series with cumulative counts, a final
    ``le="+Inf"`` bucket equal to ``_count``, plus ``_sum``/``_count``
    consistent with the in-process digest.  (Edge-bin clamping means the
    first/last finite buckets absorb out-of-range observations — counted,
    never lost, exactly like the digest itself.)
  * **Label escaping** — label values escape ``\\``, ``"`` and newlines per
    the exposition spec; metric names are sanitized to the legal charset
    (bucket labels like ``64x64-96x64`` ride as LABELS, never as name
    fragments).

Like every telemetry layer here, rendering is fail-open by construction: it
only reads plain snapshots, holds no locks, and raises nothing for a metric
it cannot represent (it skips it).
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from ncnet_tpu_torch.observability.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Timer,
)

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_NAME_BAD_CHARS = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_metric_name(name: str) -> str:
    """Coerce an arbitrary registry key to a legal Prometheus metric name
    (illegal characters → ``_``, leading digit prefixed).  Curated
    exporters should prefer labels over name-mangling; this is the
    fallback that keeps the GENERIC registry dump legal."""
    if _NAME_OK.match(name):
        return name
    out = _NAME_BAD_CHARS.sub("_", name)
    if out[:1].isdigit():
        out = "_" + out
    return out or "_"


def escape_label_value(value: Any) -> str:
    """Exposition-format label-value escaping: backslash, double quote,
    newline (in that order — escaping the escapes first)."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def format_value(v: Any) -> str:
    """One sample value: integers render bare, floats shortest-round-trip,
    non-finite as the spec's ``+Inf``/``-Inf``/``NaN``."""
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class Family:
    """One metric family: a name, a TYPE, optional HELP, and its samples.

    ``add(value, **labels)`` appends one sample; ``suffix`` covers the
    histogram/summary series (``_bucket``/``_sum``/``_count``) that share
    the family name."""

    def __init__(self, name: str, kind: str, help: str = ""):
        if kind not in ("counter", "gauge", "histogram", "summary",
                        "untyped"):
            raise ValueError(f"unknown metric kind {kind!r}")
        self.name = sanitize_metric_name(name)
        self.kind = kind
        self.help = help
        self.samples: List[Tuple[str, Dict[str, Any], float]] = []

    def add(self, value: Any, suffix: str = "", **labels: Any) -> "Family":
        self.samples.append((self.name + suffix, dict(labels), value))
        return self

    def add_histogram(self, hist: Histogram, **labels: Any) -> "Family":
        """Append one :class:`Histogram` digest as cumulative ``_bucket``
        series + ``_sum``/``_count`` under the given labels.  The bin
        counts are copied ONCE and the ``+Inf`` bucket / ``_count`` derive
        from that copy, so ``le="+Inf" == _count == sum(buckets)`` holds
        even when a writer lands mid-scrape."""
        counts = list(hist.counts)
        cum = 0
        for edge, n in zip(hist.bucket_edges(), counts):
            cum += n
            self.add(cum, suffix="_bucket",
                     **{**labels, "le": format_value(edge)})
        self.add(cum, suffix="_bucket", **{**labels, "le": "+Inf"})
        self.add(hist.sum, suffix="_sum", **labels)
        self.add(cum, suffix="_count", **labels)
        return self


def render(families: Iterable[Family]) -> str:
    """Render families as one exposition document (trailing newline
    included, as scrapers expect)."""
    lines: List[str] = []
    for fam in families:
        if not fam.samples:
            continue
        if fam.help:
            lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for name, labels, value in fam.samples:
            if labels:
                body = ",".join(
                    f'{sanitize_metric_name(str(k))}='
                    f'"{escape_label_value(v)}"'
                    for k, v in sorted(labels.items()))
                lines.append(f"{name}{{{body}}} {format_value(value)}")
            else:
                lines.append(f"{name} {format_value(value)}")
    return "\n".join(lines) + "\n"


def registry_families(registry: MetricsRegistry,
                      prefix: str = "ncnet") -> List[Family]:
    """The GENERIC renderer: every metric in a registry becomes one family
    (counters → ``<prefix>_<name>_total``, gauges → gauge, timers →
    summary with a p50 quantile, histograms → cumulative histogram).
    Curated exporters (``serving/introspect.py``) build label-structured
    families instead; this covers everything else so any registry can be
    scraped with zero per-metric code."""
    fams: List[Family] = []
    with registry._lock:
        items = sorted(registry._metrics.items())
    for name, m in items:
        base = f"{prefix}_{sanitize_metric_name(name)}"
        if isinstance(m, Counter):
            fams.append(Family(base + "_total", "counter").add(m.value))
        elif isinstance(m, Gauge):
            if m.value is not None:
                try:
                    fams.append(Family(base, "gauge").add(float(m.value)))
                except (TypeError, ValueError):
                    continue  # a non-numeric gauge cannot be plotted
        elif isinstance(m, Timer):
            if not m.count:
                continue
            fam = Family(base + "_seconds", "summary")
            snap = m.snapshot()
            if "p50_s" in snap:
                fam.add(snap["p50_s"], quantile="0.5")
            fam.add(m.total_s, suffix="_sum")
            fam.add(m.count, suffix="_count")
            fams.append(fam)
        elif isinstance(m, Histogram):
            if m.count:
                fams.append(Family(base, "histogram").add_histogram(m))
    return fams


# ---------------------------------------------------------------------------
# the read side: a minimal exposition parser (serve_top + the scrape tests)
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?\s+(?P<value>\S+)\s*$")
_LABEL_RE = re.compile(
    r'\s*(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)\s*=\s*"(?P<v>(?:[^"\\]|\\.)*)"\s*,?')


def _unescape(v: str) -> str:
    out: List[str] = []
    i = 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            out.append({"n": "\n", '"': '"', "\\": "\\"}.get(nxt, nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _parse_value(s: str) -> float:
    low = s.lower()
    if low in ("+inf", "inf"):
        return math.inf
    if low == "-inf":
        return -math.inf
    if low == "nan":
        return math.nan
    return float(s)


def parse_prometheus(text: str) -> Dict[str, Dict[str, Any]]:
    """Parse one exposition document into
    ``{family_name: {"type": ..., "help": ..., "samples":
    [(series_name, labels_dict, value), ...]}}``.

    A sample series like ``x_bucket``/``x_sum``/``x_count`` files under its
    ``# TYPE``'d family name when one precedes it, else under its own
    name.  Raises ``ValueError`` on a malformed sample line — the scrape
    tests WANT a hard failure, a tolerant parser would mask a renderer
    bug."""
    families: Dict[str, Dict[str, Any]] = {}
    current: Optional[str] = None

    def fam(name: str) -> Dict[str, Any]:
        return families.setdefault(
            name, {"type": "untyped", "help": "", "samples": []})

    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            _, _, rest = line.partition("# HELP ")
            name, _, help_text = rest.partition(" ")
            fam(name)["help"] = help_text
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, kind = rest.partition(" ")
            fam(name)["type"] = kind.strip()
            current = name
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"malformed exposition sample line: {raw!r}")
        sname = m.group("name")
        labels: Dict[str, str] = {}
        body = m.group("labels")
        if body is not None:
            pos = 0
            while pos < len(body):
                lm = _LABEL_RE.match(body, pos)
                if lm is None:
                    if body[pos:].strip():
                        raise ValueError(
                            f"malformed label body in: {raw!r}")
                    break
                labels[lm.group("k")] = _unescape(lm.group("v"))
                pos = lm.end()
        value = _parse_value(m.group("value"))
        home = current if current is not None and (
            sname == current or sname.startswith(current + "_")) else sname
        fam(home)["samples"].append((sname, labels, value))
    return families


def histogram_percentile(bucket_samples: Sequence[Tuple[str, Dict[str, Any],
                                                        float]],
                         q: float) -> Optional[float]:
    """Approximate q-th percentile (0-100) from one series' cumulative
    ``_bucket`` samples (the serve_top read-side twin of
    ``Histogram.percentile``): linear interpolation inside the winning
    bucket, lower edge taken from the previous bucket's ``le``."""
    edges: List[Tuple[float, float]] = []
    for name, labels, value in bucket_samples:
        if not name.endswith("_bucket") or "le" not in labels:
            continue
        edges.append((_parse_value(str(labels["le"])), value))
    edges.sort(key=lambda p: p[0])
    if not edges or edges[-1][1] <= 0:
        return None
    total = edges[-1][1]
    target = q / 100.0 * total
    prev_edge, prev_cum = None, 0.0
    for edge, cum in edges:
        if cum >= target and cum > prev_cum:
            if math.isinf(edge):
                return prev_edge  # the overflow bucket has no upper edge
            lo = prev_edge if prev_edge is not None and \
                not math.isinf(prev_edge) else 0.0
            frac = (target - prev_cum) / (cum - prev_cum)
            return lo + frac * (edge - lo)
        prev_edge, prev_cum = edge, cum
    return edges[-1][0] if not math.isinf(edges[-1][0]) else None
