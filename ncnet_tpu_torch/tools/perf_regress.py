"""Perf regression sentinel over the persistent perf store, the port of the
root ``tools/perf_regress.py``.

The perf store (``ncnet_tpu_torch/observability/perfstore.py``) accumulates
every fit/eval metric as an append-only JSONL history keyed by
``(device_kind, metric, git rev)``.  This tool is the gate on top:

  * ``--check``: judge the NEWEST value of each gated ``(device_kind,
    metric)`` series against its trailing baseline window with the
    median + MAD threshold (``check_regressions``) and **exit 1 on any
    regression** — wire it after a fit/eval run and a >threshold step-wall
    jump fails the job.  Metrics whose direction cannot be inferred from
    their name (MFU, TFLOP/s, vs_baseline, roofline constants) are
    report-only; ``--metrics`` focuses (and force-gates) an explicit list.
  * ``--seed``: refused.  The JAX tool ingests the TPU bench's
    ``BENCH_r*.json`` artefacts; the port's bench (A13 in ROADMAP.md) has
    not been written, so there is nothing of the port's to seed from, and
    a TPU artefact's numbers are not the port's.

Usage::

    python -m ncnet_tpu_torch.tools.perf_regress --check [--store ...] [--device-kind ...]
        [--window 8] [--mad-k 4.0] [--min-rel 0.10] [--metrics a,b,...] [--json]

Exit codes: 0 = no regression, 1 = regression detected, 2 = usage/store
error (``--seed`` included).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List

from ncnet_tpu_torch.observability.perfstore import (
    PerfStore,
    check_regressions,
    resolve_store_path,
)


def _render(findings: List[dict]) -> str:
    lines: List[str] = []
    n_reg = sum(1 for f in findings if f["status"] == "regression")
    n_ok = sum(1 for f in findings if f["status"] == "ok")
    n_skip = sum(1 for f in findings if f["status"] == "skipped")
    lines.append(f"=== perf_regress: {n_reg} regression(s), {n_ok} ok, "
                 f"{n_skip} skipped ===")
    for f in findings:
        tag = {"regression": "REGRESSION", "ok": "ok",
               "skipped": "skipped"}[f["status"]]
        line = (f"[{tag}] {f['metric']} ({f['device_kind']}, "
                f"{f['direction']}-is-better): value={f['value']:.6g}")
        if f["status"] == "skipped":
            line += f"  ({f['reason']})"
        else:
            line += (f"  baseline median={f['baseline_median']:.6g} "
                     f"mad={f['baseline_mad']:.6g} slack={f['slack']:.6g} "
                     f"worse_by={f['worse_by']:.6g} "
                     f"n_history={f['n_history']}")
        lines.append(line)
    if not findings:
        lines.append("(no gated series in the store)")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Gate the persistent perf history")
    ap.add_argument("--store", default=None,
                    help="perf store path (default: $NCNET_TPU_PERF_STORE "
                         "or <repo>/perf/history.jsonl)")
    ap.add_argument("--seed", nargs="+", metavar="BENCH.json", default=None,
                    help="refused: the port's bench artefacts come with "
                         "A13 (ROADMAP.md)")
    ap.add_argument("--check", action="store_true",
                    help="judge newest values against the trailing baseline; "
                         "exit 1 on regression")
    ap.add_argument("--window", type=int, default=8,
                    help="trailing baseline window size (default 8)")
    ap.add_argument("--mad-k", type=float, default=4.0,
                    help="MAD multiplier (sigma-scaled) for the noise "
                         "threshold (default 4.0)")
    ap.add_argument("--min-rel", type=float, default=0.10,
                    help="relative slack floor vs the baseline median "
                         "(default 0.10)")
    ap.add_argument("--min-history", type=int, default=2,
                    help="baseline points required before gating a series "
                         "(default 2)")
    ap.add_argument("--metrics", default=None,
                    help="comma-separated metric names to check (forces "
                         "gating even for report-only names)")
    ap.add_argument("--device-kind", default=None,
                    help="restrict the check to one device kind")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as one JSON document")
    args = ap.parse_args(argv)

    if args.seed:
        sys.stderr.write("perf_regress: --seed is not ported: it ingests the "
                         "TPU bench's BENCH_r*.json artefacts, and the port's "
                         "bench is A13 (ROADMAP.md), not written yet\n")
        return 2
    if not args.check:
        sys.stderr.write("perf_regress: nothing to do (pass --check)\n")
        return 2
    store_path = resolve_store_path(args.store)
    if store_path is None:
        sys.stderr.write("perf_regress: store disabled "
                         "(NCNET_TPU_PERF_STORE=off) and no --store given\n")
        return 2
    store = PerfStore(store_path)

    records = store.records()
    if not records:
        sys.stderr.write(f"perf_regress: store {store_path} is missing or "
                         "empty\n")
        return 2
    metrics = ([m.strip() for m in args.metrics.split(",") if m.strip()]
               if args.metrics else None)
    findings = check_regressions(
        records, window=args.window, mad_k=args.mad_k,
        min_rel=args.min_rel, min_history=args.min_history,
        metrics=metrics, device_kind=args.device_kind,
    )
    if args.json:
        print(json.dumps({"store": store_path, "findings": findings},
                         indent=2, sort_keys=True))
    else:
        print(_render(findings))
    return 1 if any(f["status"] == "regression" for f in findings) else 0


if __name__ == "__main__":
    raise SystemExit(main())
