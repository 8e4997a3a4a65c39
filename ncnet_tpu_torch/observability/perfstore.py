"""Persistent cross-run perf history and the noise-aware regression
check, the port of ``ncnet_tpu/observability/perfstore.py``.

  * :class:`PerfStore`: append-only JSONL, one self-describing record a
    line (``{"kind": "perf", "schema", "metric", "value", "device_kind",
    "git_rev", ...}``), no header; torn, foreign or newer-schema lines are
    skipped on read.  History is keyed by ``(device_kind, metric)``.  The
    record format is the JAX package's, so one history holds both.
  * The store path: an explicit path, else ``NCNET_TPU_PERF_STORE``
    (``0``/``off``/``none`` disables ingestion), else
    ``<repo>/perf/history.jsonl``.
  * :func:`ingest_bench_artifact`: one bench artefact (a bare stdout line
    of ``tools/bench.py``, or a harness wrapper around one, as the
    committed ``BENCH_r*.json`` are) into a store: the seed path of
    ``tools/perf_regress.py --seed``.
  * :func:`check_regressions`: the newest value of each gated metric
    against a trailing window of its predecessors, by a median + MAD
    threshold with a relative floor.  The direction comes from the metric's
    name (:func:`metric_direction`); derived ratios are report-only.

Every write path is fail-open (:func:`maybe_record`).
"""

from __future__ import annotations

import json
import os
import statistics
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence

SCHEMA_VERSION = 1
STORE_ENV = "NCNET_TPU_PERF_STORE"

_lock = threading.Lock()


def default_store_path() -> str:
    """``<repo>/perf/history.jsonl``, the repo's perf history."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(repo, "perf", "history.jsonl")


def resolve_store_path(path: Optional[str] = None) -> Optional[str]:
    """Explicit path > ``$NCNET_TPU_PERF_STORE`` > the repo default.
    Returns None (ingestion disabled) for env values ``0``/``off``/``none``."""
    if path:
        return path
    raw = os.environ.get(STORE_ENV)
    if raw is not None:
        raw = raw.strip()
        if raw.lower() in ("", "0", "off", "none"):
            return None
        return raw
    return default_store_path()


class PerfStore:
    """Append-only JSONL perf history (see module docstring)."""

    def __init__(self, path: str):
        self.path = path

    # -- write ------------------------------------------------------------

    def append(self, metric: str, value: float, *,
               device_kind: Optional[str] = None,
               git_rev: Optional[str] = None,
               run_id: Optional[str] = None,
               unit: Optional[str] = None,
               source: Optional[str] = None,
               t: Optional[float] = None) -> Dict[str, Any]:
        """Append one record; returns it.  The write is flushed+fsynced so a
        killed process costs at most its own torn trailing line."""
        rec: Dict[str, Any] = {
            "kind": "perf", "schema": SCHEMA_VERSION,
            "metric": str(metric), "value": float(value),
            "device_kind": device_kind or "unknown",
            "t": float(t) if t is not None else time.time(),
        }
        for key, v in (("git_rev", git_rev), ("run_id", run_id),
                       ("unit", unit), ("source", source)):
            if v:
                rec[key] = v
        line = json.dumps(rec, sort_keys=True)
        with _lock:
            parent = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(parent, exist_ok=True)
            with open(self.path, "a") as f:
                f.write(line + "\n")
                f.flush()
                os.fsync(f.fileno())
        return rec

    def append_many(self, metrics: Dict[str, float], **meta) -> int:
        n = 0
        for name, value in metrics.items():
            if isinstance(value, bool) or not isinstance(value, (int, float)):
                continue
            if value != value:  # NaN: a failed measurement is not history
                continue
            self.append(name, value, **meta)
            n += 1
        return n

    # -- read -------------------------------------------------------------

    def records(self) -> List[Dict[str, Any]]:
        """All readable records in file order.  Torn/foreign/newer-schema
        lines are skipped, not fatal — records are independent."""
        try:
            with open(self.path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return []
        out: List[Dict[str, Any]] = []
        for line in raw.split(b"\n"):
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if (isinstance(rec, dict) and rec.get("kind") == "perf"
                    and rec.get("schema", 0) <= SCHEMA_VERSION
                    and isinstance(rec.get("metric"), str)
                    and isinstance(rec.get("value"), (int, float))):
                out.append(rec)
        return out

    def history(self, metric: str,
                device_kind: Optional[str] = None) -> List[Dict[str, Any]]:
        """Records for one metric (optionally one device kind), file order —
        which is append order, i.e. chronology."""
        return [r for r in self.records()
                if r["metric"] == metric
                and (device_kind is None or r["device_kind"] == device_kind)]


def maybe_record(metrics: Dict[str, float], *, source: str,
                 path: Optional[str] = None,
                 device_kind: Optional[str] = None,
                 git_rev: Optional[str] = None,
                 run_id: Optional[str] = None) -> int:
    """Best-effort ingestion for run exit paths: resolves the store (no-op
    when disabled), fills device/git metadata when not supplied, and absorbs
    I/O errors — returns the number of records written (0 on any failure)."""
    store_path = resolve_store_path(path)
    if store_path is None or not metrics:
        return 0
    try:
        if device_kind is None:
            from ncnet_tpu_torch.observability.events import local_device_kind

            device_kind = local_device_kind()
        if git_rev is None:
            from ncnet_tpu_torch.observability.events import git_revision

            git_rev = git_revision()
        return PerfStore(store_path).append_many(
            metrics, device_kind=device_kind, git_rev=git_rev,
            run_id=run_id, source=source,
        )
    except (OSError, ValueError):
        return 0


# ---------------------------------------------------------------------------
# bench artefact ingestion (the seed path)
# ---------------------------------------------------------------------------


def _bench_metric_lines(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The ``{"metric": ...}`` dicts inside one artefact: a bare bench
    stdout line, or the harness wrapper (``{"n", "cmd", "parsed", "tail"}``),
    falling back to scanning ``tail`` when ``parsed`` is null (a failed
    round still yields whatever lines it printed)."""
    if "metric" in doc:
        return [doc]
    lines: List[Dict[str, Any]] = []
    if isinstance(doc.get("parsed"), dict):
        lines.append(doc["parsed"])
    elif isinstance(doc.get("tail"), str):
        for line in doc["tail"].splitlines():
            line = line.strip()
            if line.startswith("{"):
                try:
                    cand = json.loads(line)
                except ValueError:
                    continue
                if isinstance(cand, dict) and "metric" in cand:
                    lines.append(cand)
    return lines


def ingest_bench_artifact(store: PerfStore, path: str,
                          source: Optional[str] = None) -> int:
    """Ingest one bench artefact (bare line or harness wrapper) into the
    store; returns the record count.  Metadata comes from the artefact's
    envelope when present, else from the ``device_kind`` extra; the record
    time falls back to the wrapper's round number, so seeding from the same
    files is deterministic."""
    with open(path) as f:
        doc = json.load(f)
    n_round = doc.get("n") if isinstance(doc.get("n"), (int, float)) else None
    total = 0
    for line in _bench_metric_lines(doc):
        extra = line.get("extra") or {}
        env = line.get("envelope") or {}
        device_kind = env.get("device_kind") or extra.get("device_kind")
        meta = dict(
            device_kind=device_kind, git_rev=env.get("git_rev"),
            run_id=env.get("run_id"),
            source=source or f"bench:{os.path.basename(path)}",
            t=env.get("time") if isinstance(env.get("time"), (int, float))
            else (float(n_round) if n_round is not None else 0.0),
        )
        metrics: Dict[str, float] = {}
        if isinstance(line.get("value"), (int, float)) and line.get("metric"):
            metrics[line["metric"]] = line["value"]
        if isinstance(line.get("vs_baseline"), (int, float)):
            metrics["vs_baseline"] = line["vs_baseline"]
        for k, v in extra.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                metrics[k] = v
        total += store.append_many(metrics, **meta)
    return total


# ---------------------------------------------------------------------------
# regression sentinel
# ---------------------------------------------------------------------------

# report-only metrics: derived ratios move for benign reasons (a faster
# wall lowers measured MFU at a fixed batch); roofline_* and torch_cpu*
# are constants or a reference's numbers
_UNGATED_PREFIXES = ("roofline_", "torch_cpu")
_UNGATED_TOKENS = ("mfu", "tflops", "vs_baseline", "gflops")
# the ungated tokens are all higher-is-better: the direction a forced gate
# on one of them uses
_FORCED_HIGHER_TOKENS = _UNGATED_TOKENS
# the JAX package's naming conventions, token for token
_HIGHER_TOKENS = ("pck", "pairs_per_s", "pairs_per_sec", "qps",
                  "localization_rate", "margin", "mnn_agreement", "coherence",
                  "score_gap", "quality_score", "hit_pct", "coverage_pct",
                  "recovery_pct", "skip_pct")
_LOWER_TOKENS = ("_ms", "ms_per_pair", "wall", "_s_per_pair", "_eval_s_",
                 "_step_s", "_wall_s", "entropy", "shed_pct", "burn_pct",
                 "_bytes", "hedge_pct", "_overhead_pct")


def metric_direction(name: str) -> Optional[str]:
    """``"lower"`` / ``"higher"`` = smaller/bigger is better (gated), None =
    report-only.  Inference is by name token so new bench metrics get gated
    by following the existing naming conventions, not by registration."""
    n = name.lower()
    if n.startswith(_UNGATED_PREFIXES):
        return None
    if any(tok in n for tok in _UNGATED_TOKENS):
        return None
    if any(tok in n for tok in _HIGHER_TOKENS):
        return "higher"
    if any(tok in n for tok in _LOWER_TOKENS) or n.endswith("_s"):
        return "lower"
    return None


_median = statistics.median


def check_regressions(records: Iterable[Dict[str, Any]], *,
                      window: int = 8, mad_k: float = 4.0,
                      min_rel: float = 0.10, min_history: int = 2,
                      metrics: Optional[Sequence[str]] = None,
                      device_kind: Optional[str] = None) -> List[Dict[str, Any]]:
    """Judge the NEWEST value of each gated ``(device_kind, metric)`` series
    against its trailing baseline window.

    Threshold: the new value regresses when it is worse than the window
    median by more than ``max(mad_k · 1.4826 · MAD, min_rel · |median|)`` —
    the MAD term absorbs real run-to-run noise (scaled to a normal sigma),
    the relative floor absorbs a degenerate MAD from repeated identical
    values.  Series with fewer than ``min_history`` baseline points are
    reported as ``skipped`` (a gate that guesses is worse than no gate).

    Returns one finding dict per series: ``{"metric", "device_kind",
    "status": "ok"|"regression"|"skipped", "value", "baseline_median",
    "threshold", "direction", "n_history", ...}``, regressions first.
    """
    series: Dict[tuple, List[Dict[str, Any]]] = {}
    for rec in records:
        if device_kind is not None and rec.get("device_kind") != device_kind:
            continue
        if metrics is not None and rec["metric"] not in metrics:
            continue
        series.setdefault((rec.get("device_kind"), rec["metric"]), []).append(rec)

    findings: List[Dict[str, Any]] = []
    for (dev, name), recs in sorted(series.items(),
                                    key=lambda kv: (str(kv[0][0]), kv[0][1])):
        direction = metric_direction(name)
        explicit = metrics is not None and name in metrics
        if direction is None and not explicit:
            continue  # report-only metric: not a gate
        if direction is None and explicit:
            # force-gated but deliberately-ungated by name: the derived
            # ratios are all higher-is-better
            if any(tok in name.lower() for tok in _FORCED_HIGHER_TOKENS):
                direction = "higher"
        finding: Dict[str, Any] = {
            "metric": name, "device_kind": dev,
            "direction": direction or "unknown",
            "value": recs[-1]["value"], "n_history": len(recs) - 1,
            "source": recs[-1].get("source"),
        }
        if direction is None:
            # a gate that guesses the direction is worse than no gate
            finding["status"] = "skipped"
            finding["reason"] = ("direction not inferrable from the metric "
                                 "name; rename or gate a directional twin")
            findings.append(finding)
            continue
        baseline = [r["value"] for r in recs[:-1]][-window:]
        if len(baseline) < min_history:
            finding["status"] = "skipped"
            finding["reason"] = (
                f"only {len(baseline)} baseline point(s) "
                f"(< min_history={min_history})")
            findings.append(finding)
            continue
        med = _median(baseline)
        mad = _median([abs(v - med) for v in baseline])
        slack = max(mad_k * 1.4826 * mad, min_rel * abs(med))
        worse_by = ((recs[-1]["value"] - med)
                    if finding["direction"] == "lower"
                    else (med - recs[-1]["value"]))
        finding.update(
            baseline_median=round(med, 6), baseline_mad=round(mad, 6),
            slack=round(slack, 6), worse_by=round(worse_by, 6),
            status="regression" if worse_by > slack else "ok",
        )
        findings.append(finding)
    findings.sort(key=lambda f: (f["status"] != "regression",
                                 f["status"] == "skipped", f["metric"]))
    return findings
