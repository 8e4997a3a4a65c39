"""Pod trace federation over the port's network plane: the case of
``tests/test_pod_tracing.py::test_acceptance_pod_trace_federation`` with a
port router fronting two port backends
(``python -m ncnet_tpu_torch.tools.serve_backend``).

Each backend's wall clock is skewed by ±50 ms (``NCNET_TPU_CLOCK_SKEW_S``,
read by the port's ``observability/events.py`` as by JAX's); one backend
is SIGKILLed while it holds requests.  The port's ``trace_export`` and the
root ``tools/trace_export.py`` federate the three event logs into the same
span tree as the JAX pod's: the skew recovered from the wire's clock-sync
samples, every backend slice nested in its router slice, flows drawn; and
both packages' ``run_report --pod`` recompute the pod's outcome identity
from the merged logs alone.

An NTP sample's offset error is bounded by half its RTT, and the backend
stamps ``recv_t`` after its thread reads the request, so the error comes
close to that bound: the ±20 ms window needs a sample of RTT ≤ 40 ms per
backend.  The router keeps its production cadence (one sample a second and
client, plus every new RTT minimum: ``serving/wire.py::ClockSampler``), and
the test sends rounds of 12 requests until it holds such a sample for each
backend.  The backend ends a request's slice where it settled the request,
before its reply leaves, so the slice nests in the router's on both ends
(ROADMAP C5).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

from ncnet_tpu_torch.observability import EventLog
from ncnet_tpu_torch.observability import events as obs_events
from ncnet_tpu_torch.serving import BACKEND_DEAD, MatchRouter, RouterConfig
from ncnet_tpu_torch.utils import faults

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_REPO, "tools"))

import run_report  # noqa: E402
import trace_export  # noqa: E402

from ncnet_tpu_torch.tools import run_report as port_run_report  # noqa: E402
from ncnet_tpu_torch.tools import trace_export as port_trace_export  # noqa: E402

from torch_port_tool_twins import canon  # noqa: E402


def u8(side=32, seed=0):
    return np.random.default_rng(seed).integers(
        0, 255, (side, side, 3), dtype=np.uint8)


def wait_until(pred, timeout=30.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def spawn_skewed_backends(tmp_path, skews, latency=0.05, max_queue=32):
    """Port backend processes, each with its whole wall clock shifted by
    its skew and its own event log; started together."""
    procs = {}
    for name, skew in skews.items():
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=_REPO,
                   NCNET_TPU_PERF_STORE="off",
                   NCNET_TPU_CLOCK_SKEW_S=repr(skew))
        log = str(tmp_path / f"{name}.jsonl")
        procs[name] = (subprocess.Popen(
            [sys.executable, "-m", "ncnet_tpu_torch.tools.serve_backend",
             "--fake-engine", "--replicas", "1", "--latency", str(latency),
             "--max-queue", str(max_queue), "--max-batch", "1",
             "--events", log],
            stdout=subprocess.PIPE, text=True, env=env, cwd=_REPO), log)
    return {name: (p, json.loads(p.stdout.readline())["url"], log)
            for name, (p, log) in procs.items()}


def run_id_of(log_path):
    head, _ = obs_events.replay_events(log_path)
    return str(head.get("header", {}).get("run_id"))


def clock_rtts(log_path):
    """The RTTs of a log's ``clock_sync`` samples, by the peer's run."""
    rtts = {}
    for e in obs_events.replay_events(log_path)[1]:
        if e.get("event") == "clock_sync":
            rtts.setdefault(str(e.get("peer_run")), []).append(e["rtt_s"])
    return rtts


def test_port_pod_trace_federation(tmp_path):
    faults.clear()
    obs_events.set_global_sink(None)
    router_log = str(tmp_path / "router.jsonl")
    procs = spawn_skewed_backends(tmp_path, {"bplus": +0.05,
                                             "bminus": -0.05})
    with obs_events.bound(EventLog(router_log)):
        router = MatchRouter(
            [url for _, url, _ in procs.values()],
            RouterConfig(probe_period_s=0.2, resurrect_after_s=120.0,
                         backend_max_failures=2, retries=1,
                         request_timeout_s=15.0, per_backend_depth=2,
                         max_queue=256, max_in_flight_per_client=256)).start()
        img = u8()
        peers = [run_id_of(log) for _, _, log in procs.values()]
        submitted = 0
        try:
            # rounds of 12 until each backend has a sample tight enough for
            # the skew window (a loaded host slows some round trips)
            deadline = time.monotonic() + 120.0
            while True:
                futs = [router.submit(img, img) for _ in range(12)]
                for f in futs:
                    f.result(timeout=120)
                assert all(f.outcome == "result" for f in futs)
                submitted += 12
                rtts = clock_rtts(router_log)
                if all(min(rtts.get(r, [1.0])) <= 0.04 for r in peers) \
                        or time.monotonic() > deadline:
                    break
            p_kill, url_kill, _ = procs["bplus"]
            victim = next(b for b in router.backends if b.url in url_kill)
            futs = [router.submit(img, img) for _ in range(12)]
            assert wait_until(lambda: victim.inflight > 0)
            p_kill.kill()
            for f in futs:
                f.result(timeout=120)
            assert all(f.outcome == "result" for f in futs)
            submitted += 12
            assert wait_until(lambda: victim.state == BACKEND_DEAD)
        finally:
            router.stop()
            for p, _, _ in procs.values():
                if p.poll() is None:
                    p.terminate()
            for p, _, _ in procs.values():
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()

    logs = [router_log, procs["bplus"][2], procs["bminus"][2]]
    run_router, run_plus, run_minus = (run_id_of(p) for p in logs)

    # the offset error of the kept (min-RTT) sample is at most half its RTT
    rtts = clock_rtts(router_log)
    assert min(rtts[run_plus]) <= 0.04 and min(rtts[run_minus]) <= 0.04

    warns, port_warns = [], []
    doc = trace_export.build_federated_trace(logs, warn=warns.append)
    assert canon(port_trace_export.build_federated_trace(
        logs, warn=port_warns.append)) == canon(doc)
    assert warns == [] and port_warns == [], warns
    json.loads(json.dumps(doc))
    fed = doc["otherData"]["federation"]
    assert fed["unaligned"] == []
    assert all(r["aligned"] for r in fed["runs"].values())
    assert fed["runs"][run_router]["correction_s"] == 0.0
    assert abs(fed["runs"][run_plus]["correction_s"] + 0.05) < 0.02
    assert abs(fed["runs"][run_minus]["correction_s"] - 0.05) < 0.02
    assert fed["router_slices"] == submitted
    assert fed["flows"] >= 12

    route_slice = {}
    for e in doc["traceEvents"]:
        if e.get("cat") == "route_request" and e["ph"] == "X" \
                and e["args"].get("trace"):
            route_slice[e["args"]["trace"]] = (e["ts"], e["ts"] + e["dur"])
    nested = 0
    eps_us = 10_000.0
    for e in doc["traceEvents"]:
        if e.get("cat") == "serve_request" and e["ph"] == "X":
            tr = e["args"]["trace"]
            assert tr in route_slice, f"orphan backend slice {tr}"
            r0, r1 = route_slice[tr]
            assert e["ts"] >= r0 - eps_us
            assert e["ts"] + e["dur"] <= r1 + eps_us
            nested += 1
    assert nested >= 12
    assert sum(1 for e in doc["traceEvents"] if e["ph"] == "s") >= 12
    assert sum(1 for e in doc["traceEvents"] if e["ph"] == "f") >= 12

    events = []
    for p in logs:
        events.extend(obs_events.replay_events(p)[1])
    pod = run_report.build_pod_section(events)
    assert canon(port_run_report.build_pod_section(events)) == canon(pod)
    out = pod["outcomes"]
    assert out["admitted"] == out["results"] == out["terminals"] == submitted
    assert out["unresolved"] == 0 and pod["lost_requests"] == []
    assert pod["traced_admits"] == submitted
    assert pod["dark_trails"] == []
    assert pod["failovers"]
    assert all(fo["trace"] and fo["recovered"] is True
               for fo in pod["failovers"])
    syncs = {str(e.get("peer_run")) for e in events
             if e.get("event") == "clock_sync"}
    assert {run_plus, run_minus} <= syncs
    assert pod["overhead_samples"] >= 12
    assert pod["overhead_joined_by_trace"] >= 12

    out_path = str(tmp_path / "pod.trace.json")
    port_path = str(tmp_path / "pod.port.trace.json")
    assert trace_export.main(logs + ["--federate", "-o", out_path]) == 0
    assert port_trace_export.main(logs + ["--federate", "-o", port_path]) == 0
    with open(out_path) as f, open(port_path) as g:
        text = f.read()
        assert g.read() == text
        json.loads(text)
    assert run_report.main(logs + ["--pod"]) == 0
    assert port_run_report.main(logs + ["--pod"]) == 0
