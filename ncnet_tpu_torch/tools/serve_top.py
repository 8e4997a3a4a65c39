"""``top`` for the resident match service: a live console over the
introspection plane.

The port of the root ``tools/serve_top.py``: the same reading of the same
records, with the same text, JSON and exit codes, on the port's own
modules, so an operator of the port needs no JAX.

Polls a running service's ``/metrics`` (Prometheus text,
``ncnet_tpu_torch/observability/export.py``) and ``/healthz`` (the unified
schema-versioned health document) and renders the operator view: service
state, queue depth against the elastic bound, the replica table (state,
routing score, EWMA wall, load, failures), per-bucket latency p50/p95/p99
derived from the cumulative ``_bucket`` series, and the SLO error-budget
burn.  The endpoints are the ones any scraping stack consumes — this tool
adds nothing the plane does not already export, it only renders it.

Usage::

    python -m ncnet_tpu_torch.tools.serve_top http://127.0.0.1:8080 [--interval 2]
        [--once] [--json]
    python -m ncnet_tpu_torch.tools.serve_top --pod http://h0:8080 http://h1:8080 ...

``--once`` renders a single frame and exits (0 = service reachable and
admitting, 3 = reachable but draining/stopped, 2 = unreachable) — the
scripting / smoke-test mode.  Without it the tool refreshes in place
(ANSI clear) every ``--interval`` seconds until interrupted.  ``--json``
emits the merged raw payloads instead of the rendered frame (``--once``
implied).

``--pod`` is the FEDERATED scrape: every given host's ``/metrics`` +
``/healthz`` in one frame — per-host state rows, the ``ncnet_serve_*``
counter families SUMMED across hosts, and the cumulative latency
histogram buckets merged by ``le`` edge so the p50/p95/p99 shown are the
POD's percentiles (bucket counts are additive; merged-then-interpolated
is exact at the bucket resolution, unlike averaging per-host
percentiles, which is wrong).  An unreachable host degrades to a named
row, never a crash; exit 0 only if every host is reachable and
admitting.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Tuple

from ncnet_tpu_torch.observability.export import (
    histogram_percentile,
    parse_prometheus,
)


def _out(text: str) -> None:
    sys.stdout.write(text)


def fetch(base: str, timeout: float = 5.0
          ) -> Tuple[Optional[Dict[str, Any]], Optional[Dict[str, Any]],
                     Optional[str]]:
    """One poll: ``(health_doc, metric_families, error)``.  A 503 from
    ``/healthz`` is a VALID answer (a draining service reports itself);
    only transport failures return an error."""
    base = base.rstrip("/")
    try:
        try:
            with urllib.request.urlopen(base + "/healthz",
                                        timeout=timeout) as r:
                health = json.loads(r.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            if e.code != 503:
                raise
            health = json.loads(e.read().decode("utf-8"))
        with urllib.request.urlopen(base + "/metrics", timeout=timeout) as r:
            fams = parse_prometheus(r.read().decode("utf-8"))
    except Exception as e:  # noqa: BLE001 — every transport failure is
        # the same verdict: the plane is unreachable
        return None, None, f"{type(e).__name__}: {e}"
    return health, fams, None


def _bucket_latencies(fams: Dict[str, Any]) -> List[Dict[str, Any]]:
    fam = fams.get("ncnet_serve_latency_ms")
    if not fam:
        return []
    by_bucket: Dict[str, List] = {}
    for name, labels, value in fam["samples"]:
        if "bucket" in labels:
            by_bucket.setdefault(labels["bucket"], []).append(
                (name, labels, value))
    rows = []
    for bucket, samples in sorted(by_bucket.items()):
        n = next((v for nm, lb, v in samples if nm.endswith("_count")), 0)
        rows.append({
            "bucket": bucket, "n": int(n),
            "p50": histogram_percentile(samples, 50),
            "p95": histogram_percentile(samples, 95),
            "p99": histogram_percentile(samples, 99),
        })
    return rows


def render_frame(health: Dict[str, Any], fams: Dict[str, Any],
                 base: str) -> str:
    lines: List[str] = []
    add = lines.append
    svc = health.get("service", {})
    q = health.get("queue", {})
    pool = health.get("pool", {})
    add(f"ncnet serve_top — {base}  (healthz schema "
        f"{health.get('schema')})")
    add(f"state: {health.get('state')}  for {svc.get('age_s')}s"
        + (f"  reason: {svc.get('reason')}" if svc.get("reason") else ""))
    add(f"queue: {q.get('depth')}/{q.get('effective_max_queue')}  "
        f"inflight batches: {q.get('inflight_batches')}  "
        f"pipeline depth: {q.get('pipeline_depth')}  "
        f"replicas ready: {pool.get('ready')}/{pool.get('total')}")
    c = health.get("counters", {})
    add(f"outcomes: admitted={c.get('admitted')} results={c.get('results')}"
        f" deadline={c.get('deadline')} quarantined={c.get('quarantined')}"
        f" shed={c.get('shed')}")
    slo = health.get("slo")
    if slo and slo.get("admitted"):
        w = slo["window"]
        add(f"SLO burn: {slo['budget_burn_pct']}% of budget cumulative  |  "
            f"window({w['n']}): {w['burn_pct']}%  "
            f"[bad: {slo['bad']}]")
    st = health.get("store")
    if st:
        c = st.get("counters") or {}
        hp = st.get("hit_pct")
        add(f"store: {st.get('state')}"
            + (f" ({st.get('reason')})" if st.get("reason") else "")
            + f"  hit%: {f'{hp:.1f}' if hp is not None else '-'}"
            f"  entries: {st.get('entries')}"
            f"  {(st.get('bytes') or 0) / 2 ** 20:.1f} MiB"
            f"  corrupt: {c.get('corrupt', 0)}"
            f"  evict: {c.get('evictions', 0)}")
    add("")
    mem = health.get("memory") or {}
    hbm = mem.get("hbm") or {}
    add(f"{'replica':<8} {'state':<6} {'score':>10} {'ewma_ms':>9} "
        f"{'load':>4} {'batches':>8} {'fail':>5} {'deaths':>6} "
        f"{'dead_s':>7} {'hbm%':>6}")
    for r in pool.get("replicas", []):
        ewma = r.get("ewma_wall_ms")
        dead = r.get("dead_age_s")
        fill = (hbm.get(r["id"]) or {}).get("fill_pct")
        add(f"{r['id']:<8} {r['state']:<6} {r['score']:>10.4f} "
            f"{(f'{ewma:.2f}' if ewma is not None else '-'):>9} "
            f"{r['load']:>4} {r['batches']:>8} {r['failures']:>5} "
            f"{r['deaths']:>6} "
            f"{(f'{dead:.1f}' if dead is not None else '-'):>7} "
            f"{(f'{fill:.1f}' if fill is not None else '-'):>6}")
    pred = mem.get("predicted_ladder_bytes")
    if pred is not None or hbm:
        parts = []
        if pred is not None:
            parts.append(f"predicted ladder {pred / 2 ** 20:.1f} MiB "
                         f"({mem.get('ledger_programs')} warmed program(s))")
        head = mem.get("headroom_bytes")
        if head is not None:
            parts.append(f"headroom {head / 2 ** 20:.1f} MiB")
        peaks = [s.get("peak_bytes_in_use") for s in hbm.values()
                 if s.get("peak_bytes_in_use") is not None]
        if peaks:
            parts.append(f"peak in use {max(peaks) / 2 ** 20:.1f} MiB")
        if parts:
            add("")
            add("memory: " + "  ".join(parts))
    lat = _bucket_latencies(fams)
    if lat:
        add("")
        add(f"{'bucket':<16} {'n':>6} {'p50_ms':>9} {'p95_ms':>9} "
            f"{'p99_ms':>9}")
        for row in lat:
            fmt = lambda v: f"{v:.2f}" if v is not None else "-"  # noqa: E731
            add(f"{row['bucket']:<16} {row['n']:>6} {fmt(row['p50']):>9} "
                f"{fmt(row['p95']):>9} {fmt(row['p99']):>9}")
    act = health.get("activity")
    if act is not None:
        add("")
        add(f"activity: last dispatch/idle tick {act.get('age_s')}s ago  "
            f"({act.get('batches')} batches dispatched)")
    return "\n".join(lines) + "\n"


def merge_pod_metrics(per_host: List[Tuple[str, Optional[Dict[str, Any]]]]
                      ) -> Dict[str, Any]:
    """Sum the ``ncnet_serve_*`` families across hosts: counter/gauge
    samples add by (family, labels); histogram ``_bucket``/``_count``/
    ``_sum`` series are themselves cumulative counters, so the same
    summation merges the histograms exactly — ``histogram_percentile``
    over the merged buckets IS the pod percentile."""
    merged: Dict[str, Dict[str, Any]] = {}
    for _, fams in per_host:
        if not fams:
            continue
        for name, fam in fams.items():
            if not name.startswith("ncnet_serve_"):
                continue
            m = merged.setdefault(
                name, {"type": fam.get("type", "untyped"),
                       "help": fam.get("help", ""), "acc": {}})
            for sname, labels, value in fam["samples"]:
                key = (sname, tuple(sorted(labels.items())))
                m["acc"][key] = m["acc"].get(key, 0.0) + float(value)
    out: Dict[str, Any] = {}
    for name, m in merged.items():
        out[name] = {
            "type": m["type"], "help": m["help"],
            "samples": [(sname, dict(lbl), v)
                        for (sname, lbl), v in sorted(m["acc"].items())],
        }
    return out


def render_pod_frame(per_host, merged: Dict[str, Any]) -> str:
    """One federated frame: per-host state rows + pod-summed outcome
    counters + pod-merged latency percentiles."""
    lines: List[str] = []
    add = lines.append
    n_up = sum(1 for _, h, _, e in per_host if e is None)
    add(f"ncnet serve_top — POD of {len(per_host)} host(s), "
        f"{n_up} reachable")
    add(f"{'host':<28} {'state':<9} {'queue':>7} {'ready':>7} "
        f"{'results':>8} {'shed':>6}")
    for base, health, fams, err in per_host:
        if err is not None:
            add(f"{base:<28} {'UNREACH':<9} {'-':>7} {'-':>7} {'-':>8} "
                f"{'-':>6}  ({err})")
            continue
        q = health.get("queue", {})
        pool = health.get("pool", {})
        c = health.get("counters", {})
        ready = f"{pool.get('ready')}/{pool.get('total')}"
        add(f"{base:<28} {str(health.get('state')):<9} "
            f"{q.get('depth', '-'):>7} {ready:>7} "
            f"{c.get('results', '-'):>8} {c.get('shed', '-'):>6}")
    # pod-summed outcome counters from the merged families
    fam = merged.get("ncnet_serve_requests_total")
    if fam:
        totals: Dict[str, float] = {}
        for _, labels, v in fam["samples"]:
            key = labels.get("outcome", labels.get("state", "?"))
            totals[key] = totals.get(key, 0.0) + v
        add("")
        add("pod outcomes: " + "  ".join(
            f"{k}={int(v)}" for k, v in sorted(totals.items())))
    lat = _bucket_latencies(merged)
    if lat:
        add("")
        add(f"pod latency   {'bucket':<16} {'n':>6} {'p50_ms':>9} "
            f"{'p95_ms':>9} {'p99_ms':>9}")
        for row in lat:
            fmt = lambda v: f"{v:.2f}" if v is not None else "-"  # noqa: E731
            add(f"{'':<14}{row['bucket']:<16} {row['n']:>6} "
                f"{fmt(row['p50']):>9} {fmt(row['p95']):>9} "
                f"{fmt(row['p99']):>9}")
    return "\n".join(lines) + "\n"


def run_pod(urls: List[str], args) -> int:
    while True:
        per_host = []
        for u in urls:
            health, fams, err = fetch(u)
            per_host.append((u.rstrip("/"), health, fams, err))
        merged = merge_pod_metrics(
            [(b, f) for b, _, f, _ in per_host])
        if args.json:
            doc = {
                "hosts": {b: {"healthz": h, "error": e}
                          for b, h, _, e in per_host},
                "pod_metrics": {name: fam["samples"]
                                for name, fam in sorted(merged.items())},
            }
            _out(json.dumps(doc, indent=2, sort_keys=True) + "\n")
        else:
            frame = render_pod_frame(per_host, merged)
            if not args.once:
                _out("\x1b[2J\x1b[H")
            _out(frame)
        if args.once or args.json:
            if any(e is not None for _, _, _, e in per_host):
                return 2
            return 0 if all(
                h.get("state") in ("STARTING", "READY", "DEGRADED")
                for _, h, _, _ in per_host) else 3
        sys.stdout.flush()
        try:
            time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Live console over a match service's /metrics + "
                    "/healthz introspection plane")
    ap.add_argument("url", nargs="?", default=None,
                    help="base URL of the introspection endpoint "
                         "(e.g. http://127.0.0.1:8080)")
    ap.add_argument("--pod", nargs="+", metavar="URL", default=None,
                    help="federated mode: scrape EVERY given host, sum "
                         "the ncnet_serve_* counters and merge the "
                         "cumulative latency buckets into pod "
                         "p50/p95/p99 (one frame for the whole pod)")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="refresh period in seconds (default 2)")
    ap.add_argument("--once", action="store_true",
                    help="render one frame and exit (scripting mode): "
                         "0 admitting, 3 draining/stopped, 2 unreachable")
    ap.add_argument("--json", action="store_true",
                    help="emit the merged raw payloads as one JSON "
                         "document (implies --once)")
    args = ap.parse_args(argv)
    if args.pod:
        return run_pod(args.pod, args)
    if not args.url:
        ap.error("a URL is required (or use --pod url1 url2 ...)")

    while True:
        health, fams, err = fetch(args.url)
        if err is not None:
            _out(f"unreachable: {args.url} ({err})\n")
            if args.once or args.json:
                return 2
        elif args.json:
            doc = {"healthz": health,
                   "metrics": {name: fam["samples"]
                               for name, fam in sorted(fams.items())}}
            _out(json.dumps(doc, indent=2, sort_keys=True) + "\n")
            return 0 if health.get("state") in (
                "STARTING", "READY", "DEGRADED") else 3
        else:
            frame = render_frame(health, fams, args.url)
            if not args.once:
                _out("\x1b[2J\x1b[H")  # clear + home: refresh in place
            _out(frame)
            if args.once:
                return 0 if health.get("state") in (
                    "STARTING", "READY", "DEGRADED") else 3
        sys.stdout.flush()
        try:
            time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":
    try:
        raise SystemExit(main())
    except KeyboardInterrupt:
        raise SystemExit(0)
