"""Reference implementation of the heartbeat watchdog contract.

The port of the root ``tools/stall_watchdog.py``: the same reading of the same
records, with the same text, JSON and exit codes, on the port's own
modules, so an operator of the port needs no JAX.

The training loop bumps ``<telemetry_dir>/heartbeat.json`` atomically every
step (``ncnet_tpu_torch/observability/device.py::Heartbeat``); the documented
contract for external watchdogs is *mtime age > a few step walls ⇒ the
process is stalled or dead*.  This tool is that watchdog: one invocation
judges liveness NOW (cron / a supervisor loop / a CI babysitter runs it
periodically), with the stall threshold derived from the run's own cadence
rather than a guessed constant:

  * the recent median step wall comes from the sibling event log's last
    ``step`` events (default: ``events.jsonl`` beside the heartbeat file) —
    a run stepping at 30 s/step gets a proportionally longer leash than one
    at 0.3 s/step;
  * stalled ⇔ heartbeat mtime age > ``N × median`` (default N=10), floored
    at ``--min-age`` seconds (default 60) so startup jitter, checkpoint
    pauses, or a watchdog racing the very first beat cannot false-positive;
  * no event log / no step events ⇒ the threshold degrades to ``--min-age``
    alone, and the tool says so.

Exit codes: 0 = alive, 3 = STALLED, 2 = no heartbeat file (not started, or
already cleaned up — distinct so supervisors can treat it differently).

**Remote mode (``--url``)**: a serving process with the introspection plane
(``ncnet_tpu_torch/serving/introspect.py``) exports the same liveness signal over
HTTP — ``/healthz``'s ``activity.age_s`` is seconds since the pool last
dispatched a batch or deliberately idled, exactly the heartbeat-mtime
semantics.  ``--url http://host:port`` polls that instead of a local file,
so the watchdog runs from ANOTHER host (the multi-host deployment shape)
with no shared filesystem.  The event-log cadence backstop keeps its
semantics in BOTH modes: when ``--events`` is readable, the stall
threshold derives from the run's own batch cadence and a recent
per-replica lane overrides a stale primary signal (one wedged replica
cannot flag a healthy pool STALLED); without a readable log the threshold
degrades to ``--min-age`` alone.  An unreachable endpoint maps to the
``missing`` verdict (exit 2) — "not started or already gone", the same
supervisor semantics as a missing heartbeat file.

A document carrying a ``model_version`` / ``rollout`` section
(ncnet_tpu_torch/serving/rollout.py) ships a model advisory: a pod mid-rollout
is intentionally mixed-version with one replica drained at a time, so the
verdict names the phase and the version split instead of letting either
read as trouble — and, like the store advisory, never flags a stall.

A health document carrying a feature-store section (ncnet_tpu_torch/store/)
ships a store advisory in the verdict: a DEGRADED store fails OPEN (every
query still answered, via recompute), so store-DEGRADED is rendered as a
warning about the disk and NEVER flags the process STALLED.

``--url`` also judges a multi-host **router** (``serving/router.py``): the
primary signal is the router document's aggregate ``activity.age_s``
(advances when ANY backend settles a result), and the document's
per-backend rows (``last_result_age_s`` vs a threshold from each
backend's own wall EWMA) ship as a staleness breakdown — a recent backend
overrides a stale aggregate, the router-tier mirror of the per-replica
backstop, with no shared filesystem needed.

**Pod mode (repeated ``--url``)**: one watchdog invocation judges every
process of a pod — pass ``--url`` once per host (router, backends,
retrieval coordinator) and the tool renders ONE staleness table, one row
per target, each judged by its own document exactly as in single-URL
mode.  The exit status is the WORST verdict across the pod (stalled=3 >
missing=2 > alive=0), so a supervisor watching the whole deployment
needs exactly one cron line.

Usage::

    python -m ncnet_tpu_torch.tools.stall_watchdog <telemetry_dir>/heartbeat.json
        [--events <events.jsonl>] [--factor 10] [--min-age 60] [--json]
    python -m ncnet_tpu_torch.tools.stall_watchdog --url http://host:8080
        [--events <events.jsonl>] [--factor 10] [--min-age 60] [--json]
    python -m ncnet_tpu_torch.tools.stall_watchdog --url http://router:8080 \
        --url http://backend1:8081 --url http://backend2:8082 [--json]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time
from typing import Any, Dict, List, Optional

from ncnet_tpu_torch.observability.device import Heartbeat
from ncnet_tpu_torch.observability.events import replay_events


def recent_median_step_wall(events_path: str,
                            tail: int = 32) -> Optional[float]:
    """Median ``wall_s`` of the last ``tail`` cadence events, or None when
    the log is missing/unreadable/cadence-less (the caller falls back to
    the static floor).  Cadence events: training ``step``s, and serving
    ``serve_batch``es (the match service beats its heartbeat once per
    dispatched batch, so the batch wall IS its step wall — one watchdog
    contract for both process shapes).  Torn tails are tolerated by
    ``replay_events``."""
    try:
        _, events = replay_events(events_path)
    except (OSError, ValueError):
        return None
    walls: List[float] = [
        e["wall_s"] for e in events
        if e.get("event") in ("step", "serve_batch")
        and isinstance(e.get("wall_s"), (int, float)) and e["wall_s"] > 0
    ][-tail:]
    if not walls:
        return None
    return float(statistics.median(walls))


def replica_batch_cadence(events_path: str,
                          tail: int = 256) -> Dict[str, Dict[str, Any]]:
    """Per-replica ``serve_batch`` cadence from a replica-pool service's
    event log: ``{replica_id: {"last_t", "median_wall_s", "n"}}`` (empty
    when the log has no replica-tagged batches — a training run, or a
    pre-pool serving log).  ``last_t`` is the wall-clock timestamp of the
    replica's most recent completed batch."""
    try:
        _, events = replay_events(events_path)
    except (OSError, ValueError):
        return {}
    per: Dict[str, Dict[str, Any]] = {}
    for e in events:
        if e.get("event") != "serve_batch" or e.get("replica") is None:
            continue
        d = per.setdefault(str(e["replica"]), {"walls": [], "last_t": None})
        if isinstance(e.get("wall_s"), (int, float)) and e["wall_s"] > 0:
            d["walls"].append(e["wall_s"])
        if isinstance(e.get("t"), (int, float)):
            d["last_t"] = e["t"]
    out: Dict[str, Dict[str, Any]] = {}
    for rid, d in per.items():
        walls = d["walls"][-tail:]
        out[rid] = {
            "last_t": d["last_t"],
            "median_wall_s": (float(statistics.median(walls))
                              if walls else None),
            "n": len(walls),
        }
    return out


def _apply_replica_backstop(verdict: Dict[str, Any], events_path: str,
                            factor: float, min_age: float) -> None:
    """The per-replica backstop, shared by both modes: per-replica ``serve_batch``
    cadence always ships in the verdict, and a recent lane overrides a
    stale primary signal (heartbeat mtime or HTTP activity age) — one
    wedged replica must not flag a healthy pool STALLED."""
    cadence = replica_batch_cadence(events_path)
    replicas: Dict[str, Any] = {}
    alive_via = None
    now = time.time()
    for rid, c in sorted(cadence.items()):
        rep_threshold = max(min_age, factor * c["median_wall_s"]) \
            if c["median_wall_s"] else min_age
        rep_age = (now - c["last_t"]) if c["last_t"] else None
        recent = rep_age is not None and rep_age <= rep_threshold
        replicas[rid] = {
            "last_batch_age_s": round(rep_age, 3) if rep_age is not None
            else None,
            "median_wall_s": (round(c["median_wall_s"], 6)
                              if c["median_wall_s"] else None),
            "threshold_s": round(rep_threshold, 3),
            "n": c["n"],
            "recent": recent,
        }
        if verdict["status"] == "stalled" and recent and alive_via is None:
            alive_via = f"replica_cadence:{rid}"
            verdict["status"] = "alive"
    if replicas:
        verdict["replicas"] = replicas
    if alive_via:
        verdict["alive_via"] = alive_via


def _apply_backend_backstop(verdict: Dict[str, Any], doc: Dict[str, Any],
                            factor: float, min_age: float) -> None:
    """The router-tier backstop (mirror of the per-replica one, but
    sourced from the ``/healthz`` document itself — cross-host, no shared
    filesystem needed): a router document carries per-backend rows with
    ``last_result_age_s`` and the backend's wall EWMA, so the verdict
    ships a per-backend staleness breakdown and a RECENT backend overrides
    a stale aggregate activity stamp — one wedged host cannot flag a
    healthy pod STALLED."""
    rows = (doc.get("pod") or {}).get("backends")
    if not isinstance(rows, list) or not rows:
        return
    backends: Dict[str, Any] = {}
    alive_via = None
    for row in rows:
        if not isinstance(row, dict) or row.get("id") is None:
            continue
        ewma_ms = row.get("ewma_wall_ms")
        threshold = max(min_age, factor * ewma_ms / 1e3) \
            if isinstance(ewma_ms, (int, float)) and ewma_ms > 0 else min_age
        age = row.get("last_result_age_s")
        recent = isinstance(age, (int, float)) and age <= threshold
        backends[str(row["id"])] = {
            "state": row.get("state"),
            "last_result_age_s": age if isinstance(age, (int, float))
            else None,
            "threshold_s": round(threshold, 3),
            "recent": recent,
        }
        if verdict["status"] == "stalled" and recent and alive_via is None:
            alive_via = f"backend_cadence:{row['id']}"
            verdict["status"] = "alive"
    if backends:
        verdict["backends"] = backends
    if alive_via:
        verdict["alive_via"] = alive_via


def _apply_store_advisory(verdict: Dict[str, Any],
                          doc: Dict[str, Any]) -> None:
    """Feature-store advisory from the health document's ``store`` section
    (ncnet_tpu_torch/store/): a DEGRADED store FAILS OPEN — every query is still
    answered via recompute — so degraded-but-serving is an operator
    warning about the DISK, never a stall.  This helper surfaces the state
    in the verdict and deliberately never touches the liveness status."""
    st = doc.get("store")
    if not isinstance(st, dict):
        return
    c = st.get("counters") or {}
    verdict["store"] = {
        "state": st.get("state"),
        "reason": st.get("reason"),
        "hit_pct": st.get("hit_pct"),
        "corrupt": c.get("corrupt", 0),
        "degraded_ops": c.get("degraded_ops", 0),
    }


def _apply_retrieval_advisory(verdict: Dict[str, Any],
                              doc: Dict[str, Any]) -> None:
    """Retrieval-tier advisory (ncnet_tpu_torch/retrieval/): a coordinator's
    document carries shard capacity and the served coverage distribution.
    Like the store advisory this never touches liveness — a DEGRADED
    coordinator is still answering every query with an honest ``coverage``
    field; what the operator needs surfaced is HOW MUCH of the database
    those answers consulted, and which shards the per-row breakdown
    (``verdict["backends"]``, the shard rows here) says are dead."""
    if doc.get("role") != "retrieval":
        return
    r = doc.get("retrieval") or {}
    pod = doc.get("pod") or {}
    verdict["retrieval"] = {
        "shards_ready": pod.get("ready"),
        "shards_total": pod.get("total"),
        "replication": r.get("replication"),
        "coverage_p50": r.get("coverage_p50"),
        "coverage_min": r.get("coverage_min"),
        "min_coverage": r.get("min_coverage"),
    }


def _apply_rollout_advisory(verdict: Dict[str, Any],
                            doc: Dict[str, Any]) -> None:
    """Model-version / live-rollout advisory
    (ncnet_tpu_torch/serving/rollout.py).  A pod mid-rollout is INTENTIONALLY
    mixed-version — one canary or rolling-swap replica on the candidate
    while the rest serve the incumbent — so this surfaces the phase and
    the version split instead of letting an operator read the drained
    replica or the version skew as trouble.  Strictly an advisory: a
    rollout never touches the liveness status (the whole design point is
    that the pod keeps serving through it)."""
    out: Dict[str, Any] = {}
    if doc.get("model_version"):
        out["model_version"] = doc["model_version"]
    ro = doc.get("rollout")
    if isinstance(ro, dict) and ro.get("phase") not in (None, "IDLE"):
        out["rollout"] = {
            "phase": ro.get("phase"),
            "old_version": ro.get("old_version"),
            "new_version": ro.get("new_version"),
            "reason": ro.get("reason"),
        }
    # per-replica version split (service doc) / per-pod version list
    # (router doc): more than one distinct version = mixed-version window
    versions: List[str] = []
    for row in (doc.get("pool") or {}).get("replicas") or []:
        if isinstance(row, dict) and row.get("model_version"):
            versions.append(str(row["model_version"]))
    pod_versions = (doc.get("pod") or {}).get("model_versions")
    if isinstance(pod_versions, list):
        versions.extend(str(v) for v in pod_versions)
    distinct = sorted(set(versions))
    if len(distinct) > 1:
        out["mixed_versions"] = distinct
    if out:
        verdict["model"] = out


def _apply_hbm_warning(verdict: Dict[str, Any], doc: Dict[str, Any],
                       warn_pct: float) -> None:
    """HBM-pressure advisory from the health document's memory section
    (observability/memory.py): any replica whose fill exceeds
    ``warn_pct`` lands in ``verdict["hbm_warning"]``.  Strictly a WARNING —
    pressure is not a stall, so the liveness status never changes here."""
    hbm = ((doc.get("memory") or {}).get("hbm")) or {}
    hot = {}
    for rid, s in sorted(hbm.items()):
        fill = s.get("fill_pct")
        if isinstance(fill, (int, float)) and fill >= warn_pct:
            hot[str(rid)] = {
                "fill_pct": fill,
                "bytes_in_use": s.get("bytes_in_use"),
                "bytes_limit": s.get("bytes_limit"),
            }
    if hot:
        verdict["hbm_warning"] = {"threshold_pct": warn_pct,
                                  "replicas": hot}


def judge_url(url: str, events_path: Optional[str] = None,
              factor: float = 10.0, min_age: float = 60.0,
              timeout: float = 5.0,
              hbm_warn_pct: float = 90.0) -> Dict[str, Any]:
    """Remote liveness verdict over the introspection plane: the primary
    signal is ``/healthz``'s ``activity.age_s`` (seconds since the pool
    last dispatched or deliberately idled — the HTTP twin of the heartbeat
    mtime), thresholded by the event-log cadence when one is readable.
    Judges a ``MatchRouter``'s document the same way (its aggregate
    activity stamp advances on any backend's result), plus a per-backend
    staleness breakdown read from the document's backend rows — the
    cross-host mirror of the per-replica backstop, so one wedged host
    cannot flag a healthy pod STALLED.  Unreachable ⇒ ``missing``
    (exit 2), same as a missing heartbeat file."""
    import json as _json
    import urllib.error
    import urllib.request

    base = url.rstrip("/")
    if not base.endswith("/healthz"):
        base += "/healthz"
    try:
        try:
            with urllib.request.urlopen(base, timeout=timeout) as r:
                doc = _json.loads(r.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            if e.code != 503:
                raise
            # 503 is a DRAINING/STOPPED service answering honestly — the
            # plane is alive even though probes should stop routing
            doc = _json.loads(e.read().decode("utf-8"))
    except Exception as e:  # noqa: BLE001 — any transport failure is the
        # same verdict: nothing is answering there
        return {"status": "missing", "url": base,
                "error": f"{type(e).__name__}: {e}"}
    age = (doc.get("activity") or {}).get("age_s")
    if not isinstance(age, (int, float)):
        return {"status": "missing", "url": base,
                "error": "healthz document has no activity.age_s"}
    median = recent_median_step_wall(events_path) if events_path else None
    threshold = max(min_age, factor * median) if median else min_age
    verdict: Dict[str, Any] = {
        "status": "stalled" if age > threshold else "alive",
        "mode": "url",
        "url": base,
        "state": doc.get("state"),
        "role": doc.get("role", "service"),
        "age_s": round(float(age), 3),
        "threshold_s": round(threshold, 3),
        "median_step_wall_s": round(median, 6) if median else None,
        "factor": factor,
        "min_age_s": min_age,
        "events": events_path if median else None,
    }
    if events_path:
        _apply_replica_backstop(verdict, events_path, factor, min_age)
    _apply_backend_backstop(verdict, doc, factor, min_age)
    _apply_rollout_advisory(verdict, doc)
    _apply_retrieval_advisory(verdict, doc)
    _apply_hbm_warning(verdict, doc, hbm_warn_pct)
    _apply_store_advisory(verdict, doc)
    return verdict


def judge(heartbeat_path: str, events_path: Optional[str] = None,
          factor: float = 10.0, min_age: float = 60.0) -> Dict[str, Any]:
    """One liveness verdict: ``{"status": "alive"|"stalled"|"missing", ...}``
    with the evidence (age, threshold, median step wall, last payload).

    Replica-pool awareness: the service is alive if ANY replica shows
    recent batch cadence — one wedged replica (whose lane stops emitting
    ``serve_batch``) must not flag a healthy pool as STALLED.  Normally the
    pool-wide heartbeat (bumped per dispatched batch on any replica)
    already says so; the per-replica check is the backstop when the
    heartbeat file is stale or unwritable but the event log shows a lane
    still draining, and the ``replicas`` breakdown in the verdict names
    which lanes are fresh vs wedged either way."""
    age = Heartbeat.age_s(heartbeat_path)
    if age is None:
        return {"status": "missing", "heartbeat": heartbeat_path}
    if events_path is None:
        events_path = os.path.join(
            os.path.dirname(os.path.abspath(heartbeat_path)), "events.jsonl")
    median = recent_median_step_wall(events_path)
    threshold = max(min_age, factor * median) if median else min_age
    verdict: Dict[str, Any] = {
        "status": "stalled" if age > threshold else "alive",
        "mode": "heartbeat",
        "heartbeat": heartbeat_path,
        "age_s": round(age, 3),
        "threshold_s": round(threshold, 3),
        "median_step_wall_s": round(median, 6) if median else None,
        "factor": factor,
        "min_age_s": min_age,
    }
    # per-replica cadence: the breakdown always ships; a recent lane also
    # overrides a stale heartbeat
    _apply_replica_backstop(verdict, events_path, factor, min_age)
    verdict["events"] = events_path \
        if (median or verdict.get("replicas")) else None
    payload = Heartbeat.read(heartbeat_path)
    if payload:
        verdict["last_beat"] = payload
    return verdict


_EXIT_OF_STATUS = {"alive": 0, "missing": 2, "stalled": 3}


def judge_pod(urls: List[str], events_path: Optional[str] = None,
              factor: float = 10.0, min_age: float = 60.0,
              hbm_warn_pct: float = 90.0) -> Dict[str, Any]:
    """One verdict per ``--url`` target plus a pod roll-up: each target is
    judged independently by :func:`judge_url` (so a wedged backend cannot
    hide behind a healthy router, and vice versa), and the pod status is
    the WORST individual verdict — stalled beats missing beats alive —
    because a supervisor acting on the exit code must react to the
    sickest process, not the average one."""
    targets: Dict[str, Any] = {}
    worst = "alive"
    for url in urls:
        v = judge_url(url, events_path=events_path, factor=factor,
                      min_age=min_age, hbm_warn_pct=hbm_warn_pct)
        targets[url] = v
        if _EXIT_OF_STATUS[v["status"]] > _EXIT_OF_STATUS[worst]:
            worst = v["status"]
    return {"status": worst, "mode": "pod", "targets": targets}


def render_pod_table(pod: Dict[str, Any]) -> str:
    """The pod staleness table: one row per ``--url`` target with its own
    age-vs-threshold evidence, advisory flags compressed into a notes
    column, and a one-line worst-verdict summary on top."""
    lines = [f"POD {pod['status'].upper()}: "
             f"{len(pod['targets'])} target(s), worst verdict wins"]
    lines.append(f"  {'STATUS':<8} {'STATE':<10} {'AGE':>8} {'THRESH':>8} "
                 f"{'ROLE':<10} TARGET")
    for url, v in pod["targets"].items():
        if v["status"] == "missing":
            note = v.get("error", "no liveness signal")
            lines.append(f"  {'MISSING':<8} {'-':<10} {'-':>8} {'-':>8} "
                         f"{'-':<10} {url}  [{note}]")
            continue
        notes = []
        if v.get("alive_via"):
            notes.append(f"alive via {v['alive_via']}")
        stale = [bid for bid, b in (v.get("backends") or {}).items()
                 if not b["recent"]]
        if stale:
            notes.append("stale backends: " + ", ".join(stale))
        if (v.get("model") or {}).get("rollout"):
            notes.append(f"rollout {v['model']['rollout'].get('phase')}")
        if v.get("hbm_warning"):
            notes.append("HBM pressure")
        if (v.get("store") or {}).get("state") == "DEGRADED":
            notes.append("store DEGRADED")
        tail = ("  [" + "; ".join(notes) + "]") if notes else ""
        lines.append(f"  {v['status'].upper():<8} "
                     f"{str(v.get('state')):<10} "
                     f"{v['age_s']:>7.1f}s {v['threshold_s']:>7.1f}s "
                     f"{str(v.get('role')):<10} {url}{tail}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Judge a training run's or serving process's liveness "
                    "from its heartbeat file + event log, or remotely via "
                    "the serving introspection plane (--url)")
    ap.add_argument("heartbeat", nargs="?", default=None,
                    help="path to heartbeat.json (omit when using --url)")
    ap.add_argument("--url", action="append", default=None, metavar="URL",
                    help="poll a serving process's /healthz instead of a "
                         "heartbeat file (base URL or full /healthz URL) — "
                         "the cross-host mode; --events still feeds the "
                         "cadence threshold + replica backstop when the "
                         "log is readable from here.  Repeat the flag to "
                         "judge a whole pod in one invocation: one "
                         "staleness table, worst verdict as exit status")
    ap.add_argument("--events", default=None,
                    help="event log for the step-wall cadence (default: "
                         "events.jsonl beside the heartbeat file; no "
                         "default in --url mode)")
    ap.add_argument("--factor", type=float, default=10.0,
                    help="stall threshold = factor x median step wall "
                         "(default 10)")
    ap.add_argument("--min-age", type=float, default=60.0,
                    help="threshold floor in seconds (default 60; also the "
                         "whole threshold when no step cadence is readable)")
    ap.add_argument("--hbm-warn-pct", type=float, default=90.0,
                    help="(--url mode) warn — never flag STALLED — when any "
                         "replica's HBM fill exceeds this percent "
                         "(default 90)")
    ap.add_argument("--json", action="store_true",
                    help="emit the verdict as one JSON document")
    args = ap.parse_args(argv)
    if (args.heartbeat is None) == (not args.url):
        ap.error("give exactly one of: a heartbeat path, or --url")

    if args.url and len(args.url) > 1:
        pod = judge_pod(args.url, events_path=args.events,
                        factor=args.factor, min_age=args.min_age,
                        hbm_warn_pct=args.hbm_warn_pct)
        if args.json:
            print(json.dumps(pod, indent=2, sort_keys=True))
        else:
            print(render_pod_table(pod))
        return _EXIT_OF_STATUS[pod["status"]]

    if args.url:
        verdict = judge_url(args.url[0], events_path=args.events,
                            factor=args.factor, min_age=args.min_age,
                            hbm_warn_pct=args.hbm_warn_pct)
    else:
        verdict = judge(args.heartbeat, events_path=args.events,
                        factor=args.factor, min_age=args.min_age)
    if args.json:
        print(json.dumps(verdict, indent=2, sort_keys=True))
    elif verdict["status"] == "missing":
        where = verdict.get("heartbeat") or verdict.get("url")
        print(f"no liveness signal at {where} (run not started, telemetry "
              "off, endpoint unreachable, or already cleaned up)"
              + (f" [{verdict['error']}]" if verdict.get("error") else ""))
    else:
        cadence = (f"median step wall {verdict['median_step_wall_s']}s "
                   f"x {verdict['factor']}"
                   if verdict["median_step_wall_s"]
                   else f"no step cadence; floor {verdict['min_age_s']}s")
        via = (f" [alive via {verdict['alive_via']}]"
               if verdict.get("alive_via") else "")
        if verdict.get("mode") == "url":
            print(f"{verdict['status'].upper()}{via}: activity age "
                  f"{verdict['age_s']}s vs threshold "
                  f"{verdict['threshold_s']}s ({cadence}); service state "
                  f"{verdict.get('state')} at {verdict['url']}")
        else:
            beat = verdict.get("last_beat") or {}
            print(f"{verdict['status'].upper()}{via}: heartbeat age "
                  f"{verdict['age_s']}s vs threshold "
                  f"{verdict['threshold_s']}s "
                  f"({cadence}); last beat: step {beat.get('step')}, "
                  f"pid {beat.get('pid')}, run {beat.get('run')}")
        for rid, r in (verdict.get("replicas") or {}).items():
            tag = "fresh" if r["recent"] else "wedged/idle"
            print(f"  replica {rid}: last batch "
                  f"{r['last_batch_age_s']}s ago vs {r['threshold_s']}s "
                  f"({tag}; n={r['n']})")
        for bid, b in (verdict.get("backends") or {}).items():
            tag = "fresh" if b["recent"] else "wedged/idle"
            print(f"  backend {bid} [{b.get('state')}]: last result "
                  f"{b['last_result_age_s']}s ago vs {b['threshold_s']}s "
                  f"({tag})")
        mv = verdict.get("model")
        if mv:
            ro = mv.get("rollout")
            if ro:
                phase = ro.get("phase")
                vers = (f"({ro.get('old_version')} -> "
                        f"{ro.get('new_version')})")
                if phase in ("COMPLETE", "ROLLED_BACK"):
                    print(f"  last rollout: {phase} {vers}")
                else:
                    print(f"  rollout in progress: {phase} {vers} — mixed "
                          "versions and one DRAINING replica are expected "
                          "here, not trouble")
            if mv.get("mixed_versions"):
                print("  MIXED-VERSION pod: "
                      + ", ".join(mv["mixed_versions"]))
            elif mv.get("model_version") and not ro:
                print(f"  model version: {mv['model_version']}")
        rt = verdict.get("retrieval")
        if rt:
            print(f"  retrieval pod: {rt.get('shards_ready')}/"
                  f"{rt.get('shards_total')} shards ready (R="
                  f"{rt.get('replication')}); coverage p50 "
                  f"{rt.get('coverage_p50')}, min {rt.get('coverage_min')} "
                  f"vs floor {rt.get('min_coverage')} — answers below the "
                  "floor arrive DEGRADED, never silent")
        hw = verdict.get("hbm_warning")
        if hw:
            for rid, s in hw["replicas"].items():
                print(f"  WARNING: replica {rid} HBM {s['fill_pct']}% full "
                      f"(>= {hw['threshold_pct']}%; "
                      f"{s.get('bytes_in_use')}/{s.get('bytes_limit')} "
                      "bytes) — pressure, not a stall")
        st = verdict.get("store")
        if st:
            if st.get("state") == "DEGRADED":
                print(f"  WARNING: feature store DEGRADED "
                      f"({st.get('reason')}; "
                      f"degraded_ops={st.get('degraded_ops')}) — failing "
                      "open to recompute: degraded-but-serving, NOT a "
                      "stall")
            else:
                hp = st.get("hit_pct")
                print(f"  feature store {st.get('state')}"
                      + (f" (hit% {hp})" if hp is not None else ""))
    return _EXIT_OF_STATUS[verdict["status"]]


if __name__ == "__main__":
    raise SystemExit(main())
