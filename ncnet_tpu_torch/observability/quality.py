"""Match-quality signals over the filtered 4D volume, the port of
``ncnet_tpu/observability/quality.py``: the in-graph half
(:data:`QUALITY_SIGNALS`, the signal extractor and the ``(B, 6, N)`` wire
row) and the host half the eval loop calls (:data:`SIGNAL_RANGE`,
:data:`DIGEST_BINS`, :func:`active_tier`, :func:`emit_quality`,
:func:`spearman`).  The drift gate (``psi``, ``write_reference``,
``check_drift``) waits in ROADMAP A11.

Signals, all per pair and in [0, 1], over the B→A direction that
:func:`~ncnet_tpu_torch.ops.matching.corr_to_matches` scores by:
``score`` (mean max softmax probability), ``entropy`` (mean normalized
entropy of the per-B-cell softmax), ``margin`` (mean top1−top2 gap),
``mnn_agreement`` (hard mutual-argmax ratio) and ``coherence`` (share of
adjacent B cells whose matched A cells advance within 0.9 of a grid step).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

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
