"""Match-quality signals over the filtered 4D volume, the port of
``ncnet_tpu/observability/quality.py``: the in-graph half
(:data:`QUALITY_SIGNALS`, the signal extractor and the ``(B, 6, N)`` wire
row), the host half the eval loop and the service call
(:data:`SIGNAL_RANGE`, :data:`DIGEST_BINS`, :func:`active_tier`,
:func:`emit_quality`, :func:`spearman`), and the drift gate the live
rollout judges by (:func:`digests_from_events`, :func:`psi`,
:func:`write_reference`, :func:`load_reference`, :func:`check_drift`).
Reference files keep the JAX record format, keyed by device kind, so a
file either package writes is read by the other; a device kind the file
has no series for is judged as the JAX gate judges it (every series
skipped with its reason).

Signals, all per pair and in [0, 1], over the B→A direction that
:func:`~ncnet_tpu_torch.ops.matching.corr_to_matches` scores by:
``score`` (mean max softmax probability), ``entropy`` (mean normalized
entropy of the per-B-cell softmax), ``margin`` (mean top1−top2 gap),
``mnn_agreement`` (hard mutual-argmax ratio) and ``coherence`` (share of
adjacent B cells whose matched A cells advance within 0.9 of a grid step).
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ncnet_tpu_torch.observability.metrics import Histogram
from ncnet_tpu_torch.ops.matching import mutual_argmax_agreement

# signal order IS the wire order of the quality row
QUALITY_SIGNALS = ("score", "entropy", "margin", "mnn_agreement", "coherence")

# per-signal digest range; everything the volume extractor emits is [0, 1]
# by construction, the training score gap is a difference of [0, 1] means
SIGNAL_RANGE: Dict[str, Tuple[float, float]] = {
    **{name: (0.0, 1.0) for name in QUALITY_SIGNALS},
    "score_gap": (-1.0, 1.0),
}
DIGEST_BINS = 32

REF_KIND = "ncnet_tpu_quality_ref"
REF_SCHEMA = 1


def quality_signals(corr: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-pair quality signals of a ``(B, hA, wA, hB, wB)`` volume;
    ``{name: (B,)}`` float32 tensors."""
    b, ha, wa, hb, wb = corr.shape
    n_a = ha * wa
    flat = corr.to(torch.float32).reshape(b, n_a, hb * wb)
    p = torch.softmax(flat, dim=1)  # distribution over A cells per B cell

    top2 = torch.topk(p.transpose(1, 2), 2, dim=2).values  # (B, n_b, 2)
    score = top2[..., 0].mean(dim=1)
    margin = (top2[..., 0] - top2[..., 1]).mean(dim=1)

    ent = -(p * torch.log(p + 1e-12)).sum(dim=1)  # (B, n_b)
    entropy = ent.mean(dim=1) / math.log(float(n_a))

    agreement = mutual_argmax_agreement(corr)

    # displacement-field coherence (see the JAX module for why the band is
    # 0.9 of a step: a collapsed constant-argmax field must not score 1.0)
    idx_a = torch.argmax(flat, dim=1)
    ia = (idx_a // wa).reshape(b, hb, wb).to(torch.float32)
    ja = (idx_a % wa).reshape(b, hb, wb).to(torch.float32)
    step_i = (ha - 1) / max(hb - 1, 1)
    step_j = (wa - 1) / max(wb - 1, 1)
    tol_i = 0.9 * max(step_i, 1.0)
    tol_j = 0.9 * max(step_j, 1.0)
    ok_terms = []
    if hb > 1:
        di = ia[:, 1:, :] - ia[:, :-1, :] - step_i
        dj = ja[:, 1:, :] - ja[:, :-1, :]
        ok_terms.append(((di.abs() <= tol_i) & (dj.abs() <= tol_j))
                        .to(torch.float32).reshape(b, -1))
    if wb > 1:
        di = ia[:, :, 1:] - ia[:, :, :-1]
        dj = ja[:, :, 1:] - ja[:, :, :-1] - step_j
        ok_terms.append(((di.abs() <= tol_i) & (dj.abs() <= tol_j))
                        .to(torch.float32).reshape(b, -1))
    if ok_terms:
        coherence = torch.cat(ok_terms, dim=1).mean(dim=1)
    else:  # 1x1 B grid: no adjacency to judge
        coherence = torch.ones(b, dtype=torch.float32, device=corr.device)
    return {"score": score, "entropy": entropy, "margin": margin,
            "mnn_agreement": agreement, "coherence": coherence}


def quality_table(corr: torch.Tensor) -> torch.Tensor:
    """``(B, len(QUALITY_SIGNALS))`` float32 signal table."""
    sigs = quality_signals(corr)
    return torch.stack([sigs[n].to(torch.float32) for n in QUALITY_SIGNALS],
                       dim=1)


def append_quality_rows(table: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
    """``(B, 5, N)`` match table → ``(B, 6, N)``: row 5 holds the pair's
    signals in its first ``len(QUALITY_SIGNALS)`` slots, zeros after.  A
    table narrower than the signal count is returned unchanged."""
    q = quality_table(corr)
    if table.shape[2] < q.shape[1]:
        return table
    row = torch.zeros((table.shape[0], 1, table.shape[2]), dtype=torch.float32,
                      device=table.device)
    row[:, 0, : q.shape[1]] = q
    return torch.cat([table, row], dim=1)


def split_quality_rows(table: np.ndarray):
    """Invert :func:`append_quality_rows` on a fetched numpy batch table:
    ``(match_tables (B, 5, N), [per-pair {signal: float}] | None)``."""
    if table.ndim != 3 or table.shape[1] not in (5, 6):
        raise ValueError(f"not a batched match table: {table.shape}")
    if table.shape[1] == 5:
        return table, None
    quality = [
        dict(zip(QUALITY_SIGNALS,
                 (float(v) for v in table[b, 5, : len(QUALITY_SIGNALS)])))
        for b in range(table.shape[0])
    ]
    return table[:, :5], quality


def append_quality_row(table: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
    """Single-pair form of :func:`append_quality_rows` for ``(5, N)``
    tables (``corr`` must be batch 1)."""
    return append_quality_rows(table[None], corr)[0]


def split_quality_row(table: np.ndarray):
    """Invert :func:`append_quality_row`: ``(match_rows (5, N), {signal:
    float} | None)``."""
    if table.shape[0] != 6:
        return table, None
    signals = dict(zip(QUALITY_SIGNALS,
                       (float(v) for v in table[5, : len(QUALITY_SIGNALS)])))
    return table[:5], signals


# ---------------------------------------------------------------------------
# host half: tier tagging, events and digests, signal-vs-PCK validation
# ---------------------------------------------------------------------------


def active_tier(eligible: bool = True, stage: str = "forward") -> str:
    """The NC-stack tier label for quality events.

    ``eligible``: whether the program that produced the signals could take
    the kernel tier at all (callers pass their config's
    ``half_precision``: the chooser offers B2 to bf16 volumes only); an
    ineligible program is ``"xla"`` unless an arithmetic tier ran.  The
    match-pipeline decision outranks the stack's: when the latest
    ``sparse_corr.choose_match_pipeline`` consult chose ``"coarse2fine"``
    the signals describe that pipeline's volume, in any precision.  The
    arithmetic tiers (``"cp"``, ``"fft"``) pass through in any precision;
    otherwise the stage's latest decision
    (``nc_fused_lane.last_selected_tier``), or ``"xla"``."""
    from ncnet_tpu_torch.ops.nc_fused_lane import last_selected_tier

    if stage == "forward" and last_selected_tier("pipeline") == "coarse2fine":
        return "coarse2fine"
    selected = last_selected_tier(stage)
    if stage == "forward" and selected in ("cp", "fft"):
        return selected
    if not eligible:
        return "xla"
    return selected or "xla"


def emit_quality(scope: str, signals: Dict[str, Any], *,
                 tier: Optional[str] = None,
                 pck: Optional[Iterable[float]] = None,
                 registry=None, **ids) -> None:
    """Stream one unit's per-pair signals: a ``quality`` event into the
    bound sink (no-op when unbound), tagged with the active tier, and —
    when a registry is given — into its per-signal histogram digests (NaNs
    dropped there; they mark quarantined pairs).  ``pck`` rides along when
    labels exist so consumers can rank-correlate signal vs PCK."""
    from ncnet_tpu_torch.observability import events as _events

    tier = tier or active_tier()
    sig_lists = {}
    for name, vals in signals.items():
        arr = np.atleast_1d(np.asarray(vals, dtype=np.float64))
        sig_lists[name] = [round(float(v), 6) for v in arr]
        if registry is not None:
            lo, hi = SIGNAL_RANGE.get(name, (0.0, 1.0))
            registry.histogram(f"q_{name}", lo, hi, DIGEST_BINS).add(
                arr[np.isfinite(arr)])
    if _events.get_global_sink() is not None:
        fields = dict(ids)
        if pck is not None:
            fields["pck"] = [round(float(v), 6)
                             for v in np.atleast_1d(np.asarray(pck))]
        _events.emit("quality", scope=scope, tier=tier,
                     signals=sig_lists, **fields)


def digests_from_events(events: Iterable[dict],
                        bins_like: Optional[dict] = None
                        ) -> Dict[Tuple[str, str], Histogram]:
    """Aggregate ``quality`` events into digests keyed ``(tier, signal)``.

    ``bins_like`` optionally maps signal name → snapshot dict whose binning
    must be matched (the drift check bins the current run exactly like the
    reference it is judged against)."""
    out: Dict[Tuple[str, str], Histogram] = {}
    for e in events:
        if e.get("event") != "quality":
            continue
        tier = str(e.get("tier") or "xla")
        for name, vals in (e.get("signals") or {}).items():
            key = (tier, name)
            h = out.get(key)
            if h is None:
                if bins_like is not None and name in bins_like:
                    ref = bins_like[name]
                    h = Histogram(float(ref["lo"]), float(ref["hi"]),
                                  len(ref["counts"]))
                else:
                    lo, hi = SIGNAL_RANGE.get(name, (0.0, 1.0))
                    h = Histogram(lo, hi, DIGEST_BINS)
                out[key] = h
            arr = np.atleast_1d(np.asarray(vals, dtype=np.float64))
            h.add(arr[np.isfinite(arr)])
    return out


# ---------------------------------------------------------------------------
# drift: PSI divergence against a committed reference distribution
# ---------------------------------------------------------------------------


def psi(ref: Histogram, cur: Histogram, eps: float = 1e-3) -> float:
    """Population Stability Index between two same-binned digests.

    ``sum((q_i - p_i) * ln(q_i / p_i))`` over bins with ``eps`` flooring
    (empty bins must not produce infinities).  Standard reading: < 0.1 no
    shift, 0.1-0.25 moderate, > 0.25 major — the drift gate defaults to
    0.25.  Symmetric and 0 for identical distributions.
    """
    if (ref.lo, ref.hi, ref.bins) != (cur.lo, cur.hi, cur.bins):
        raise ValueError("PSI requires identically-binned digests")
    if not ref.count or not cur.count:
        raise ValueError("PSI over an empty digest")
    p = np.maximum(np.asarray(ref.counts, np.float64) / ref.count, eps)
    q = np.maximum(np.asarray(cur.counts, np.float64) / cur.count, eps)
    p, q = p / p.sum(), q / q.sum()
    return float(np.sum((q - p) * np.log(q / p)))


DEFAULT_PSI_THRESHOLD = 0.25


def default_reference_path() -> str:
    """``<repo>/perf/quality_ref.jsonl`` — beside the perf history it is the
    accuracy twin of."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(repo, "perf", "quality_ref.jsonl")


def write_reference(path: str,
                    digests: Dict[Tuple[str, str], Histogram], *,
                    device_kind: Optional[str],
                    meta: Optional[dict] = None) -> int:
    """Write (replace) a reference-distribution file: one self-describing
    JSONL record per (device_kind, tier, signal) series.  Returns the record
    count.  The file is the drift gate's committed baseline — re-seed it
    only from a CLEAN eval of the committed weights (README "Quality
    observability" documents the policy)."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    n = 0
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        for (tier, signal), h in sorted(digests.items()):
            if not h.count:
                continue
            rec = {"kind": REF_KIND, "schema": REF_SCHEMA,
                   "device_kind": device_kind or "unknown",
                   "tier": tier, "signal": signal,
                   "digest": h.snapshot()}
            if meta:
                rec["meta"] = meta
            f.write(json.dumps(rec, sort_keys=True) + "\n")
            n += 1
    os.replace(tmp, path)
    return n


def load_reference(path: str) -> Dict[Tuple[str, str, str], Histogram]:
    """Reference digests keyed ``(device_kind, tier, signal)``.  Foreign or
    newer-schema lines are skipped (the perf-store tolerance discipline);
    a missing file is an empty reference, not an error — the drift tool
    reports the series it could not judge."""
    out: Dict[Tuple[str, str, str], Histogram] = {}
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except FileNotFoundError:
        return out
    for line in raw.split(b"\n"):
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if (not isinstance(rec, dict) or rec.get("kind") != REF_KIND
                or rec.get("schema", 0) > REF_SCHEMA):
            continue
        try:
            h = Histogram.from_snapshot(rec["digest"])
        except (KeyError, TypeError, ValueError):
            continue
        out[(str(rec.get("device_kind", "unknown")),
             str(rec.get("tier", "xla")),
             str(rec.get("signal", "")))] = h
    return out


def reference_binning(
        reference: Dict[Tuple[str, str, str], Histogram]) -> Dict[str, dict]:
    """Per-signal binning spec (``bins_like`` for
    :func:`digests_from_events`) from :func:`load_reference` output — THE
    rule both the standalone drift gate and ``run_report --quality`` bin
    current runs by, so their verdicts can never diverge.  First entry
    wins when one signal is binned differently across device kinds."""
    out: Dict[str, dict] = {}
    for (_dk, _tier, signal), h in reference.items():
        out.setdefault(signal, {"lo": h.lo, "hi": h.hi,
                                "counts": [0] * h.bins})
    return out


def check_drift(reference: Dict[Tuple[str, str, str], Histogram],
                current: Dict[Tuple[str, str], Histogram], *,
                device_kind: Optional[str],
                threshold: float = DEFAULT_PSI_THRESHOLD,
                min_count: int = 4) -> List[Dict[str, Any]]:
    """Judge every current (tier, signal) digest against the reference.

    Returns one finding per series — ``{"tier", "signal", "status":
    "ok"|"drift"|"skipped", "psi", ...}``, drifts first.  Series absent from
    the reference, binned differently, or with fewer than ``min_count``
    samples are ``skipped`` with a reason (a gate that guesses is worse
    than no gate) — and so are reference series this device kind SHOULD
    have produced but the run did not: a tier that silently stopped
    emitting must surface in the findings, not vanish from them.
    ``device_kind`` keys the reference lookup: digests are only comparable
    within one backend (the very shifts the gate hunts — bf16 tiers,
    kernel rewrites — are device-kind-shaped).
    """
    dk = device_kind or "unknown"
    findings: List[Dict[str, Any]] = []
    for (rdk, tier, signal) in sorted(reference):
        if rdk == dk and (tier, signal) not in current:
            findings.append({
                "tier": tier, "signal": signal, "device_kind": dk,
                "count": 0, "mean": None, "status": "skipped",
                "reason": "series present in the reference but absent "
                          "from this run (emitter broken, or the tier "
                          "never executed here)",
            })
    for (tier, signal), cur in sorted(current.items()):
        finding: Dict[str, Any] = {
            "tier": tier, "signal": signal, "device_kind": dk,
            "count": cur.count, "mean": cur.mean(),
        }
        ref = reference.get((dk, tier, signal))
        if ref is None:
            finding.update(status="skipped",
                           reason="no reference series for "
                                  f"({dk}, {tier}, {signal})")
        elif cur.count < min_count:
            finding.update(status="skipped",
                           reason=f"only {cur.count} sample(s) "
                                  f"(< min_count={min_count})")
        elif (ref.lo, ref.hi, ref.bins) != (cur.lo, cur.hi, cur.bins):
            finding.update(status="skipped",
                           reason="binning mismatch vs reference")
        else:
            d = psi(ref, cur)
            finding.update(
                psi=round(d, 6), threshold=threshold,
                ref_mean=ref.mean(), ref_count=ref.count,
                status="drift" if d > threshold else "ok",
            )
        findings.append(finding)
    findings.sort(key=lambda f: (f["status"] != "drift",
                                 f["status"] == "skipped",
                                 f["tier"], f["signal"]))
    return findings


def spearman(a, b) -> float:
    """Spearman rank correlation with average ranks for ties; NaN pairs are
    dropped, degenerate inputs (under 3 pairs, or a constant side) return
    NaN rather than a fake verdict."""
    a = np.asarray(a, dtype=np.float64).ravel()
    b = np.asarray(b, dtype=np.float64).ravel()
    m = np.isfinite(a) & np.isfinite(b)
    a, b = a[m], b[m]
    if a.size < 3:
        return float("nan")

    def rank(x):
        order = np.argsort(x, kind="stable")
        r = np.empty(x.size, dtype=np.float64)
        r[order] = np.arange(1, x.size + 1)
        for v in np.unique(x):  # average ranks over tie groups
            tie = x == v
            if np.sum(tie) > 1:
                r[tie] = np.mean(r[tie])
        return r

    ra, rb = rank(a), rank(b)
    sa, sb = np.std(ra), np.std(rb)
    if sa == 0 or sb == 0:
        return float("nan")
    return float(np.mean((ra - np.mean(ra)) * (rb - np.mean(rb))) / (sa * sb))


def signal_pck_correlation(events: Iterable[dict]) -> Dict[str, float]:
    """Per-signal Spearman rank correlation between quality signals and
    per-pair PCK, over every ``quality`` event that carries both (the
    PF-Pascal eval emits them side by side).  The check that validates the
    signals as label-free PCK proxies; ``run_report --quality`` reads it."""
    pairs: Dict[str, List[Tuple[float, float]]] = {}
    for e in events:
        if e.get("event") != "quality" or not e.get("pck"):
            continue
        pck = e["pck"]
        for name, vals in (e.get("signals") or {}).items():
            if isinstance(vals, list) and len(vals) == len(pck):
                pairs.setdefault(name, []).extend(zip(vals, pck))
    return {
        name: spearman([p[0] for p in ps], [p[1] for p in ps])
        for name, ps in sorted(pairs.items())
    }
