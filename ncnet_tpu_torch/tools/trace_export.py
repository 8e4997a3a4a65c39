"""Export ncnet_tpu event logs as Chrome trace-event JSON (Perfetto-viewable).

The port of the root ``tools/trace_export.py``: the same reading of the same
records, with the same text, JSON and exit codes, on the port's own
modules, so an operator of the port needs no JAX.

The span events (``ncnet_tpu_torch/observability/tracing.py``) give the event log
hierarchical structure — ``span``/``ph="B"`` at entry, ``ph="E"`` with a
monotonic ``dur_s`` at exit, ``parent``/``tid`` stamped on the ``B``.  This
tool renders any such log (or several: resumed runs append to one file,
sharded runs write many) into the Chrome trace-event format that
https://ui.perfetto.dev and chrome://tracing load directly:

  * every CLOSED span becomes one complete ("X") slice, timed by the entry
    event's wall clock and the exit event's monotonic duration;
  * an UNCLOSED span (the process was SIGKILLed mid-span, or the sink died)
    is emitted as a bare "B" — Perfetto renders it as a slice that never
    ends, which is exactly the postmortem signal: *this* is what was in
    flight when the process died;
  * non-span events (step, checkpoint_commit, tier_selected, retry,
    quarantine, …) become instant ("i") markers on a dedicated track, so
    the trace shows the run's milestones against its time structure;
  * ``request_timeline`` events (the serving plane's per-request
    attribution, ncnet_tpu_torch/serving/service.py) become Perfetto ASYNC
    nestable slices keyed by request id: one enclosing ``req <id>
    [<outcome>]`` slice spanning the request's end-to-end wall, with the
    queue/device/fetch segments nested inside it — laid out from the
    event's ``t0`` (wall-clock submission) plus the segment durations,
    which sum to ``total_ms`` by construction, so the slices tile the
    request exactly;
  * ``quality`` and ``metrics`` events become counter ("C") tracks —
    Perfetto renders them as stacked value-over-time plots, so a
    match-quality drift (observability/quality.py) is visible on the SAME
    timeline as the spans that caused it (a tier demotion's quality cost
    lines up under its ``tier_recovery`` span).  Per-pair signal lists
    collapse to their mean per event; metrics snapshots contribute their
    scalars (and timers their ``last_s``);
  * each run id in the lineage gets its own trace process, each recorded
    thread its own track, with "M" metadata records naming them.

Replay is torn-tail tolerant (``replay_events``): a log whose writer was
SIGKILLed mid-append still exports minus at most the torn trailing line.

**Pod federation** (``--federate``): N event logs from DIFFERENT hosts
merge into ONE trace.  Three things plain multi-file export cannot do:

  * **clock alignment** — every wire round trip leaves ``clock_sync``
    events (``serving/wire.py``: NTP-style half-RTT offset samples,
    ``offset_s`` = peer wall − local wall).  The exporter builds the
    sync graph over RUN IDS (hostnames collide in test pods; run ids
    never do), takes the minimum-RTT sample per edge, and BFS-propagates
    corrections from the first log's run so every process's timestamps
    land on one pod clock.  A run unreachable in the graph keeps its raw
    clock, is listed under ``otherData.federation.unaligned``, and gets
    NO flow arrows — an unaligned arrow would be a wrong arrow;
  * **router request slices** — each ``route_admit`` paired with its
    terminal ``route_*`` event becomes an "X" slice on the router run's
    ``requests`` track, so the pod view shows the edge-observed request
    wall above the backend's queue/device/fetch attribution;
  * **cross-host flow arrows** — requests stamped with a pod trace id
    (``observability/tracing.py``) link router slice → backend request
    slice(s) with Chrome flow events ("s"/"t"/"f" sharing the trace id),
    so one click in Perfetto follows a request across processes —
    including a failover's second backend.

Usage::

    python -m ncnet_tpu_torch.tools.trace_export <events.jsonl> [more.jsonl ...] [-o trace.json]
    python -m ncnet_tpu_torch.tools.trace_export --federate router.jsonl b0.jsonl b1.jsonl \
        [-o pod.trace.json]

``-o -`` writes the trace JSON to stdout.  Default output:
``<first input>.trace.json``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Tuple

from ncnet_tpu_torch.observability.events import replay_events

# span "B" bookkeeping fields that should not be duplicated into args
_B_META = ("t", "run", "seq", "event", "ph", "name", "span", "parent", "tid")
# instant-event fields that are envelope, not payload
_I_META = ("t", "run", "seq", "event")


def _us(t: float) -> float:
    return t * 1e6


def _finite_mean(vals) -> "float | None":
    xs = [float(v) for v in vals
          if isinstance(v, (int, float)) and not isinstance(v, bool)
          and float(v) == float(v)]
    return sum(xs) / len(xs) if xs else None


def timeline_events(e: dict, pid: int) -> List[Dict[str, Any]]:
    """Render one ``request_timeline`` event as Perfetto async nestable
    slices ("b"/"e" pairs sharing ``id`` = the request id): the enclosing
    request slice plus its queue/device/fetch segments in submission
    order.  Returns [] when the event carries no usable total."""
    total_ms = e.get("total_ms")
    t0 = e.get("t0")
    if not isinstance(total_ms, (int, float)) \
            or not isinstance(t0, (int, float)):
        return []
    rid = str(e.get("request", "?"))
    run = e.get("run", "?")
    # request ids restart per service process: scope the async id by run
    # so two lineages in one file cannot interleave their slices
    async_id = f"{run}/{rid}"
    cat = "serve_request"
    outcome = e.get("outcome", "?")
    args = {k: e[k] for k in
            ("request", "client", "bucket", "outcome", "replica", "where",
             "attempts", "queue_ms", "device_ms", "fetch_ms", "total_ms")
            if k in e}
    out: List[Dict[str, Any]] = []

    def slice_pair(name: str, start_s: float, dur_ms: float,
                   slice_args: Dict[str, Any]) -> None:
        out.append({"ph": "b", "cat": cat, "id": async_id, "name": name,
                    "pid": pid, "tid": 0, "ts": _us(start_s),
                    "args": slice_args})
        out.append({"ph": "e", "cat": cat, "id": async_id, "name": name,
                    "pid": pid, "tid": 0,
                    "ts": _us(start_s + dur_ms * 1e-3)})

    slice_pair(f"req {rid} [{outcome}]", t0, total_ms, args)
    cursor = float(t0)
    for seg in ("queue_ms", "device_ms", "fetch_ms"):
        dur = e.get(seg)
        if not isinstance(dur, (int, float)):
            continue
        slice_pair(seg[:-3], cursor, float(dur), {seg: dur})
        cursor += float(dur) * 1e-3
    return out


def counter_events(e: dict) -> List[Dict[str, Any]]:
    """Render one ``quality`` or ``metrics`` event as Chrome counter ("C")
    args — numbers only (a counter track cannot plot strings or NaN).
    Returns [] when nothing numeric survives."""
    args: Dict[str, float] = {}
    if e.get("event") == "quality":
        name = f"quality/{e.get('scope', '?')}/{e.get('tier') or '?'}"
        for sig, vals in (e.get("signals") or {}).items():
            m = _finite_mean(vals if isinstance(vals, list) else [vals])
            if m is not None:
                args[sig] = m
        pck = e.get("pck")
        if isinstance(pck, list):
            m = _finite_mean(pck)
            if m is not None:
                args["pck"] = m
    else:  # metrics
        name = f"metrics/{e.get('scope', '?')}"
        for k, v in (e.get("metrics") or {}).items():
            if isinstance(v, dict):
                # timer/histogram snapshot: the most recent wall (timers)
                # or the running mean (histograms) is the plottable scalar
                v = v.get("last_s", v.get("mean"))
            m = _finite_mean([v])
            if m is not None:
                args[k] = m
    if not args:
        return []
    return [{"name": name, "args": args}]


class _TraceBuilder:
    """Incremental Chrome-trace assembly shared by the single-log and the
    federated exports: process/track allocation plus the per-log event
    rendering loop."""

    def __init__(self) -> None:
        self.trace_events: List[Dict[str, Any]] = []
        self.headers: List[Dict[str, Any]] = []
        self.pid_of_run: Dict[str, int] = {}
        # (pid, raw tid) -> track id
        self.tid_of: Dict[Tuple[int, Any], int] = {}

    def pid_for(self, run: Any, header: Dict[str, Any]) -> int:
        key = str(run)
        if key not in self.pid_of_run:
            self.pid_of_run[key] = len(self.pid_of_run) + 1
            self.trace_events.append({
                "ph": "M", "name": "process_name",
                "pid": self.pid_of_run[key],
                "tid": 0, "args": {"name": (
                    f"run {key} @ {header.get('host', '?')}"
                    f" [{header.get('device_kind') or 'no-device'}]")},
            })
            self.trace_events.append({
                "ph": "M", "name": "thread_name",
                "pid": self.pid_of_run[key],
                "tid": 0, "args": {"name": "events"},
            })
        return self.pid_of_run[key]

    def tid_for(self, pid: int, raw) -> int:
        key = (pid, raw)
        if key not in self.tid_of:
            # track 0 is the instant-marker track; spans start at 1
            self.tid_of[key] = 1 + sum(1 for k in self.tid_of
                                       if k[0] == pid)
            self.trace_events.append({
                "ph": "M", "name": "thread_name", "pid": pid,
                "tid": self.tid_of[key],
                "args": {"name": (raw if isinstance(raw, str)
                                  else f"thread {raw}")},
            })
        return self.tid_of[key]

    def add_log(self, path: str, head: Dict[str, Any],
                events: List[Dict[str, Any]]) -> None:
        trace_events = self.trace_events
        pid_for, tid_for = self.pid_for, self.tid_for
        self.headers.append({"path": path, **head})
        pid_of_run = self.pid_of_run
        # pair span B/E by (run, span id) — ids are process-unique ints, so
        # the run id disambiguates resume lineages appending to one file
        open_spans: Dict[Tuple[Any, Any], Dict[str, Any]] = {}
        for e in events:
            run = e.get("run", "?")
            pid = pid_for(run, head)
            if e.get("event") == "request_timeline":
                # the per-request attribution renders as async slices (no
                # instant marker — the slices ARE the event's display)
                trace_events.extend(timeline_events(e, pid))
                continue
            if e.get("event") == "quality" or \
                    isinstance(e.get("metrics"), dict):
                # value-over-time payloads render as counter tracks —
                # Perfetto plots them beside the spans, which is exactly
                # how a quality drift is seen against its cause.  Registry
                # flushes carry their snapshot under `metrics` whatever the
                # event name (fit flushes as `metrics`, the eval loops as
                # `eval_summary`): the snapshot becomes counter samples
                # either way, and an event that is MORE than a flush
                # (eval_summary's completed/quarantined fields) also keeps
                # its instant marker below, minus the plotted snapshot.
                for c in counter_events(e):
                    trace_events.append({
                        "ph": "C", "name": c["name"], "pid": pid, "tid": 0,
                        "ts": _us(float(e.get("t", 0.0))),
                        "cat": "counter", "args": c["args"],
                    })
                if e.get("event") in ("quality", "metrics"):
                    continue
                e = {k: v for k, v in e.items() if k != "metrics"}
            if e.get("event") != "span":
                args = {k: v for k, v in e.items() if k not in _I_META}
                trace_events.append({
                    "ph": "i", "name": str(e.get("event")), "pid": pid,
                    "tid": 0, "ts": _us(float(e.get("t", 0.0))), "s": "t",
                    "cat": "event", "args": args,
                })
                continue
            if e.get("ph") == "B":
                open_spans[(run, e.get("span"))] = e
                continue
            b = open_spans.pop((run, e.get("span")), None)
            if b is None:
                continue  # E without B (sink bound mid-span): undisplayable
            args = {k: v for k, v in b.items() if k not in _B_META}
            if e.get("error"):
                args["error"] = e["error"]
            trace_events.append({
                "ph": "X", "name": str(b.get("name")), "pid": pid,
                "tid": tid_for(pid, b.get("tid")),
                "ts": _us(float(b.get("t", 0.0))),
                "dur": _us(float(e.get("dur_s") or 0.0)),
                "cat": "span", "args": args,
            })
        # unclosed spans: what was in flight at SIGKILL.  A bare "B" is
        # valid trace JSON; Perfetto draws it as a never-ending slice.
        for (run, _), b in sorted(open_spans.items(),
                                  key=lambda kv: kv[1].get("t", 0.0)):
            pid = pid_of_run[str(run)]
            args = {k: v for k, v in b.items() if k not in _B_META}
            args["unclosed"] = True
            trace_events.append({
                "ph": "B", "name": str(b.get("name")), "pid": pid,
                "tid": tid_for(pid, b.get("tid")),
                "ts": _us(float(b.get("t", 0.0))),
                "cat": "span", "args": args,
            })

    def doc(self, federation: "Dict[str, Any] | None" = None
            ) -> Dict[str, Any]:
        other: Dict[str, Any] = {"logs": self.headers,
                                 "exporter": "ncnet_tpu trace_export"}
        if federation is not None:
            other["federation"] = federation
        return {
            "traceEvents": self.trace_events,
            "displayTimeUnit": "ms",
            "otherData": other,
        }


def _load_logs(paths: List[str]
               ) -> List[Tuple[str, Dict[str, Any], List[Dict[str, Any]]]]:
    out = []
    for path in paths:
        header, events = replay_events(path)
        out.append((path, header.get("header", {}), events))
    return out


def build_trace(paths: List[str]) -> Dict[str, Any]:
    """One Chrome trace document over every given event log."""
    b = _TraceBuilder()
    for path, head, events in _load_logs(paths):
        b.add_log(path, head, events)
    return b.doc()


# terminal route_* events that close a router request slice (mirrors the
# router's outcome-total contract; `route_admit` opens the slice)
_ROUTE_TERMINALS = ("route_result", "route_deadline", "route_shed",
                    "route_quarantine")


def _clock_corrections(
    logs, warn,
) -> Tuple[Dict[str, float], List[str], List[str]]:
    """Per-run additive clock corrections from the ``clock_sync`` graph.

    Nodes are run ids; an edge is the MINIMUM-RTT sample between a pair
    (lowest-RTT exchange = tightest offset bound, the classic NTP filter).
    The first log's first run is the reference (correction 0); BFS
    propagates ``corrected = t + c[run]`` both ways across each edge.
    Returns ``(corrections, aligned, unaligned)``; unaligned runs keep
    correction 0 and the caller must not draw cross-host arrows to them.
    """
    runs: List[str] = []
    for _, head, events in logs:
        for e in events:
            r = str(e.get("run", "?"))
            if r not in runs:
                runs.append(r)
    # min-RTT sample per undirected pair, kept directed as measured
    best: Dict[Tuple[str, str], Tuple[float, float]] = {}
    for _, _, events in logs:
        for e in events:
            if e.get("event") != "clock_sync":
                continue
            a, b = str(e.get("run", "?")), e.get("peer_run")
            off, rtt = e.get("offset_s"), e.get("rtt_s")
            if not b or not isinstance(off, (int, float)) \
                    or not isinstance(rtt, (int, float)) or rtt < 0:
                continue
            key = tuple(sorted((a, str(b))))
            if key not in best or rtt < best[key][0]:
                # store as (rtt, offset a->b) normalized to key order
                o = float(off) if (a, str(b)) == key else -float(off)
                best[key] = (float(rtt), o)
    adj: Dict[str, List[Tuple[str, float]]] = {}
    for (a, b), (_, off) in best.items():
        # off = wall_b − wall_a at one instant ⇒ c[b] = c[a] − off
        adj.setdefault(a, []).append((b, -off))
        adj.setdefault(b, []).append((a, +off))
    corr: Dict[str, float] = {}
    if runs:
        ref = runs[0]
        corr[ref] = 0.0
        queue = [ref]
        while queue:
            u = queue.pop(0)
            for v, d in adj.get(u, []):
                if v not in corr:
                    corr[v] = corr[u] + d
                    queue.append(v)
    aligned = [r for r in runs if r in corr]
    unaligned = [r for r in runs if r not in corr]
    for r in unaligned:
        corr[r] = 0.0
    if unaligned:
        warn(f"no clock_sync path to run(s) {', '.join(unaligned)}: "
             "their timestamps stay UNALIGNED (raw local clock) and no "
             "cross-host flow arrows are drawn to them")
    return corr, aligned, unaligned


def build_federated_trace(paths: List[str],
                          warn=None) -> Dict[str, Any]:
    """N per-host event logs → ONE pod trace: clock-skew-corrected
    timestamps, per-run process tracks, router request slices, and
    trace-id flow arrows stitching each pod request across processes.
    ``warn`` (a callable, default stderr) receives human-readable
    degradation notes (unaligned runs)."""
    if warn is None:
        def warn(msg: str) -> None:
            sys.stderr.write(f"federate: WARNING: {msg}\n")
    logs = _load_logs(paths)
    corr, aligned, unaligned = _clock_corrections(logs, warn)
    aligned_set = set(aligned)
    # shift every wall stamp onto the pod clock BEFORE rendering, so the
    # ordinary renderer needs no knowledge of federation
    for _, _, events in logs:
        for e in events:
            c = corr.get(str(e.get("run", "?")), 0.0)
            if isinstance(e.get("t"), (int, float)):
                e["t"] = float(e["t"]) + c
            if e.get("event") == "request_timeline" \
                    and isinstance(e.get("t0"), (int, float)):
                e["t0"] = float(e["t0"]) + c
    b = _TraceBuilder()
    for path, head, events in logs:
        b.add_log(path, head, events)
    # --- router request slices: route_admit paired with its terminal ----
    # (run, request) -> admit event / terminal event
    admits: Dict[Tuple[str, str], Dict[str, Any]] = {}
    terminals: Dict[Tuple[str, str], Dict[str, Any]] = {}
    # trace id -> router slice / backend timeline slices, for the flows
    router_of: Dict[str, List[Tuple[str, float, float]]] = {}
    backend_of: Dict[str, List[Tuple[str, float, float]]] = {}
    head_of_run: Dict[str, Dict[str, Any]] = {}
    for _, head, events in logs:
        for e in events:
            run = str(e.get("run", "?"))
            head_of_run.setdefault(run, head)
            name = e.get("event")
            rid = e.get("request")
            if name == "route_admit" and rid is not None:
                admits[(run, str(rid))] = e
            elif name in _ROUTE_TERMINALS and rid is not None:
                terminals.setdefault((run, str(rid)), e)
            elif name == "request_timeline" and e.get("trace") \
                    and isinstance(e.get("t0"), (int, float)) \
                    and isinstance(e.get("total_ms"), (int, float)):
                backend_of.setdefault(str(e["trace"]), []).append(
                    (run, float(e["t0"]),
                     float(e["t0"]) + float(e["total_ms"]) * 1e-3))
    n_router_slices = 0
    for (run, rid), adm in sorted(
            admits.items(), key=lambda kv: kv[1].get("t", 0.0)):
        term = terminals.get((run, rid))
        if term is None:
            continue  # request still in flight when the log was cut
        t0 = float(adm.get("t", 0.0))
        t1 = max(t0, float(term.get("t", t0)))
        pid = b.pid_for(run, head_of_run.get(run, {}))
        tid = b.tid_for(pid, "requests")
        outcome = str(term.get("event", "?"))[len("route_"):]
        args = {k: adm[k] for k in ("request", "client", "trace")
                if k in adm}
        args["outcome"] = outcome
        b.trace_events.append({
            "ph": "X", "name": f"req {rid} [{outcome}]", "pid": pid,
            "tid": tid, "ts": _us(t0), "dur": _us(t1 - t0),
            "cat": "route_request", "args": args,
        })
        n_router_slices += 1
        tr = adm.get("trace") or term.get("trace")
        if tr:
            router_of.setdefault(str(tr), []).append((run, t0, t1))
    # --- cross-host flow arrows, keyed by trace id ----------------------
    # drawn ONLY between runs the sync graph aligned: a flow between
    # uncorrected clocks would render a confidently WRONG arrow
    n_flows = 0
    for tr, routers in sorted(router_of.items()):
        backends = sorted(backend_of.get(tr, []), key=lambda s: s[1])
        if not backends:
            continue
        involved = {r for r, _, _ in routers} | {r for r, _, _ in backends}
        if not involved <= aligned_set:
            continue
        run, t0, _ = routers[0]
        pid = b.pid_for(run, head_of_run.get(run, {}))
        b.trace_events.append({
            "ph": "s", "id": tr, "name": "pod_request",
            "cat": "pod_request", "pid": pid,
            "tid": b.tid_for(pid, "requests"), "ts": _us(t0),
        })
        for i, (brun, bt0, _bt1) in enumerate(backends):
            bpid = b.pid_for(brun, head_of_run.get(brun, {}))
            b.trace_events.append({
                # "t" = intermediate step (a failover's first backend),
                # "f" with bp=e binds the arrowhead to the LAST slice
                "ph": ("f" if i == len(backends) - 1 else "t"),
                "id": tr, "name": "pod_request", "cat": "pod_request",
                "pid": bpid, "tid": b.tid_for(bpid, "requests"),
                "ts": _us(bt0),
                **({"bp": "e"} if i == len(backends) - 1 else {}),
            })
            # flow endpoints must land INSIDE a slice on their track:
            # mirror the backend's request wall as an X slice there
            b.trace_events.append({
                "ph": "X", "name": f"req[{tr[:8]}]", "pid": bpid,
                "tid": b.tid_for(bpid, "requests"), "ts": _us(bt0),
                "dur": _us(max(0.0, _bt1 - bt0)),
                "cat": "serve_request", "args": {"trace": tr},
            })
            n_flows += 1
    federation = {
        "runs": {r: {"correction_s": round(corr.get(r, 0.0), 6),
                     "aligned": r in aligned_set}
                 for r in sorted(set(corr))},
        "unaligned": sorted(unaligned),
        "router_slices": n_router_slices,
        "flows": n_flows,
    }
    return b.doc(federation=federation)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Export ncnet_tpu event logs as Chrome trace JSON")
    ap.add_argument("logs", nargs="+", help="events.jsonl file(s)")
    ap.add_argument("--federate", action="store_true",
                    help="merge the logs as one POD: clock-skew-corrected "
                         "timestamps from the clock_sync graph, router "
                         "request slices, and cross-host flow arrows "
                         "keyed by pod trace id")
    ap.add_argument("-o", "--output", default=None,
                    help="output path ('-' for stdout; default: "
                         "<first input>.trace.json)")
    args = ap.parse_args(argv)
    trace = (build_federated_trace(args.logs) if args.federate
             else build_trace(args.logs))
    out = args.output or (args.logs[0] + ".trace.json")
    text = json.dumps(trace)
    if out == "-":
        sys.stdout.write(text + "\n")
    else:
        with open(out, "w") as f:
            f.write(text)
        n_spans = sum(1 for e in trace["traceEvents"] if e["ph"] in "XB")
        fed = trace["otherData"].get("federation")
        extra = (f", {fed['router_slices']} router slices, "
                 f"{fed['flows']} flow steps" if fed else "")
        sys.stderr.write(
            f"wrote {out}: {n_spans} spans, "
            f"{len(trace['traceEvents'])} trace events{extra} — open in "
            "https://ui.perfetto.dev\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
