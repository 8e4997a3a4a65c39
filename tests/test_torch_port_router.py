"""The port's pod tier (``ncnet_tpu_torch/serving/router.py`` over the
``POST /match`` wire of ``serving/introspect.py``) against the JAX
package's.

Every in-process case of ``tests/test_router.py`` runs once with each
package's modules (``pkg``): fake-engine backends behind real services,
the router fronting them, outcome counts recomputed from the event log by
both packages' ``run_report``, which must agree (the logs share one
format).
The process cases spawn real backends (``tools/serve_backend.py`` for JAX,
``python -m ncnet_tpu_torch.tools.serve_backend`` for the port) behind a
router of either package: a mixed pod must give the outcome counts of a
single-package pod, which proves the wire is shared.  Every wait is on a
state or an event (a backend's shed count, a drain's state), never on a
wall-clock bound, so the cases hold under xdist.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_REPO, "tools"))


from torch_port_tool_twins import both, both_main  # noqa: E402

PKGS = ("jax", "torch")


def load(name):
    if name == "jax":
        from ncnet_tpu import ops, serving
        from ncnet_tpu.observability import EventLog
        from ncnet_tpu.observability import events
        from ncnet_tpu.serving import admission
        from ncnet_tpu.utils import faults

        reset = ops.reset_fused_tier_demotions
    else:
        from ncnet_tpu_torch import serving
        from ncnet_tpu_torch.observability import EventLog
        from ncnet_tpu_torch.observability import events
        from ncnet_tpu_torch.serving import admission
        from ncnet_tpu_torch.utils import faults

        def reset():
            pass
    return types.SimpleNamespace(name=name, serving=serving, faults=faults,
                                 events=events, EventLog=EventLog,
                                 admission=admission, reset=reset)


def clean(p):
    p.faults.clear()
    p.reset()
    p.events.set_global_sink(None)


@pytest.fixture(params=PKGS)
def pkg(request):
    p = load(request.param)
    clean(p)
    yield p
    clean(p)


def u8(side=32, seed=0):
    return np.random.default_rng(seed).integers(
        0, 255, (side, side, 3), dtype=np.uint8)


def make_fake(p):
    class FakeEngine:
        """Device stand-in: the wire and router layers sit above the
        engine.  ``latency_s`` is read at every poll, so a test can hold
        batches and then release them."""

        split = staticmethod(p.serving.BatchMatchEngine.split)
        half_precision = False

        def __init__(self, latency_s=0.01):
            self.latency_s = latency_s

        def dispatch(self, src, tgt):
            p.faults.device_error_hook("fake_serve")
            return (src.shape[0], time.monotonic())

        def fetch(self, handle):
            b, t0 = handle
            while time.monotonic() - t0 < self.latency_s:
                time.sleep(0.005)
            table = np.zeros((b, 6, 16), np.float32)
            table[:, 4, :] = 1.0
            table[:, 5, :5] = [0.5, 0.1, 0.4, 0.9, 0.8]
            return table

        def retrace(self):
            pass

    return FakeEngine


def wire_backend(p, n=2, latency_s=0.01, **over):
    cfg = dict(bucket_multiple=32, max_image_side=64, max_batch=2,
               max_queue=64, max_in_flight_per_client=64,
               introspect_port=0)
    cfg.update(over)
    engines = [make_fake(p)(latency_s) for _ in range(n)]
    svc = p.serving.MatchService(
        engine=engines, serving=p.serving.ServingConfig(**cfg)).start()
    assert svc.introspect_url is not None
    svc.engines = engines
    return svc


def make_router(p, services, **over):
    cfg = dict(probe_period_s=0.2, resurrect_after_s=0.3,
               backend_max_failures=2, max_queue=256,
               max_in_flight_per_client=256)
    cfg.update(over)
    urls = [s if isinstance(s, str) else s.introspect_url
            for s in services]
    return p.serving.MatchRouter(urls, p.serving.RouterConfig(**cfg)).start()


def wait_until(pred, timeout=30.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


# ---------------------------------------------------------------------------
# the /match endpoint against a real (fake-engine) service
# ---------------------------------------------------------------------------


def test_match_endpoint_serves_and_classifies(pkg):
    svc = wire_backend(pkg, n=2)
    try:
        client = pkg.serving.MatchClient(svc.introspect_url)
        img = u8()
        r = client.match(img, img, client="edge", budget_s=10.0,
                         request_id="e1")
        assert r.table.shape == (5, 16)
        assert r.quality and "score" in r.quality
        assert r.bucket == ((32, 32), (32, 32))
        with pytest.raises(pkg.serving.DeadlineExceeded) as e:
            client.match(img, img, budget_s=-0.5)
        assert e.value.where == "admission"
        client.close()
    finally:
        svc.stop()
    # the propagated client identity meets the backend's per-client cap:
    # the held engine keeps the first request in flight until the other
    # two were answered
    svc = wire_backend(pkg, n=1, latency_s=60.0, max_queue=32,
                       max_in_flight_per_client=1, max_batch=1)
    try:
        img = u8()
        results = {}

        def call(tag):
            c2 = pkg.serving.MatchClient(svc.introspect_url)
            try:
                c2.match(img, img, client="one-edge-client", budget_s=120.0)
                results[tag] = "result"
            except pkg.serving.Overloaded as e:
                results[tag] = e.reason
            finally:
                c2.close()

        ts = [threading.Thread(target=call, args=(i,)) for i in range(3)]
        for t in ts:
            t.start()
        assert wait_until(lambda: len(results) == 2)
        svc.engines[0].latency_s = 0.0
        for t in ts:
            t.join(60)
        assert sorted(results.values()) == ["client_cap", "client_cap",
                                            "result"], results
    finally:
        svc.engines[0].latency_s = 0.0
        svc.stop()


def test_match_endpoint_refuses_garbage(pkg):
    svc = wire_backend(pkg, n=1)
    try:
        req = urllib.request.Request(
            svc.introspect_url + "/match", data=b"not a wire frame",
            method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        assert e.value.code == 400
        from importlib import import_module

        wire = import_module(pkg.serving.__name__ + ".wire")
        with pytest.raises(pkg.serving.RequestQuarantined,
                           match="unserviceable"):
            wire.decode_response(e.value.read())
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(urllib.request.Request(
                svc.introspect_url + "/metrics", data=b"x", method="POST"),
                timeout=10)
        assert e.value.code == 404
    finally:
        svc.stop()


# ---------------------------------------------------------------------------
# router: routing, accounting, failover, backpressure, deadlines, drain
# ---------------------------------------------------------------------------


def test_router_routes_and_recomputes_outcome_totals(pkg, tmp_path):
    log_path = str(tmp_path / "events.jsonl")
    with pkg.events.bound(pkg.EventLog(log_path)):
        s1, s2 = wire_backend(pkg), wire_backend(pkg)
        router = make_router(pkg, [s1, s2])
        try:
            img = u8()
            futs = [router.submit(img, img, client="edge")
                    for _ in range(16)]
            for f in futs:
                f.result(timeout=60)
            assert all(f.outcome == "result" for f in futs)
            h = router.health()
            assert h["schema"] == 1 and h["role"] == "router"
            assert h["pod"]["ready"] == 2
            assert all(b.results >= 1 for b in router.backends)
        finally:
            router.stop()
            s1.stop()
            s2.stop()
    _, events = pkg.events.replay_events(log_path)
    sec = both("run_report", "build_router_section", events)
    assert sec["outcomes"]["admitted"] == 16
    assert sec["outcomes"]["results"] == 16
    assert sec["outcomes"]["unresolved"] == 0 and not sec["lost_requests"]
    assert set(sec["backends"]) == {"b0", "b1"}
    assert sum(b["results"] for b in sec["backends"].values()) == 16
    assert all(b["backend_wall_ms"]["n"] == b["results"]
               for b in sec["backends"].values())
    assert sec["drains"] and sec["drains"][0]["drained"] is True
    assert both_main("run_report", [log_path, "--serving"]) == 0


def test_injected_backend_death_fails_over_and_resurrects(pkg, tmp_path):
    log_path = str(tmp_path / "events.jsonl")
    S = pkg.serving
    with pkg.events.bound(pkg.EventLog(log_path)):
        s1, s2 = wire_backend(pkg), wire_backend(pkg)
        router = make_router(pkg, [s1, s2])
        try:
            img = u8()
            for f in [router.submit(img, img) for _ in range(6)]:
                f.result(timeout=60)
            pkg.faults.install(pkg.faults.FaultPlan(
                dead_backend_urls=(s1.introspect_url,)))
            futs = [router.submit(img, img) for _ in range(12)]
            for f in futs:
                f.result(timeout=60)
            assert all(f.outcome == "result" for f in futs)
            b0 = router.backends[0]
            assert wait_until(lambda: b0.state == S.BACKEND_DEAD)
            assert router.state == S.DEGRADED
            # probes fire while armed: the backend must stay dead (the
            # wire probe gates resurrection, not /healthz alone)
            n_probes = b0.last_probe_t
            assert wait_until(lambda: b0.last_probe_t != n_probes)
            assert b0.state == S.BACKEND_DEAD
            h = router.health()
            assert h["queue"]["effective_max_queue"] < router.cfg.max_queue
            pkg.faults.clear()
            assert wait_until(lambda: b0.state == S.BACKEND_READY)
            assert wait_until(lambda: router.state == S.READY)
            futs = [router.submit(img, img) for _ in range(12)]
            for f in futs:
                f.result(timeout=60)
            assert wait_until(lambda: b0.results >= 1)
        finally:
            pkg.faults.clear()
            router.stop()
            s1.stop()
            s2.stop()
    _, events = pkg.events.replay_events(log_path)
    reroutes = [e for e in events if e.get("event") == "retry"
                and e.get("scope") == "router"
                and e.get("via") == "reroute"]
    assert reroutes and all(e["backend"] == "b0" for e in reroutes)
    assert all(e["on_budget"] is False for e in reroutes)
    states = [(e.get("backend"), e.get("state")) for e in events
              if e.get("event") == "route_backend"]
    assert ("b0", S.BACKEND_DEAD) in states
    assert states.index(("b0", S.BACKEND_READY)) \
        > states.index(("b0", S.BACKEND_DEAD))
    sec = both("run_report", "build_router_section", events)
    assert sec["outcomes"]["unresolved"] == 0
    assert sec["backends"]["b0"]["deaths"] == 1
    assert sec["backends"]["b0"]["resurrections"] == 1


def fill_door(svc, img, hold, overloaded):
    """Submit to ``svc`` until its door is shut for good: the queue at its
    bound AND the pipeline at its depth (held batches never complete, so
    the worker can take nothing more)."""

    def steady():
        q = svc.health()["queue"]
        return (q["depth"] >= q["effective_max_queue"]
                and q["inflight_batches"] >= q["pipeline_depth"])

    while True:
        try:
            hold.append(svc.submit(img, img))
            continue
        except overloaded:
            pass
        q = svc.health()["queue"]
        if steady():
            return
        # the worker may still move a queued request into the pipeline
        wait_until(lambda: steady() or svc.health()["queue"]["depth"]
                   < q["effective_max_queue"])


def test_backpressure_propagates_with_aggregate_hint(pkg, tmp_path):
    """Backend ``Overloaded`` answers are neither retried against the same
    host nor failures: each live backend is tried once, then the edge sees
    ``Overloaded(reason="backpressure")`` with the soonest hint.  The
    backends' engines hold their batches until the router has answered, so
    the doors stay full whatever the scheduling."""
    log_path = str(tmp_path / "events.jsonl")
    S = pkg.serving
    with pkg.events.bound(pkg.EventLog(log_path)):
        s1 = wire_backend(pkg, n=1, latency_s=120.0, max_queue=2,
                          max_batch=1)
        s2 = wire_backend(pkg, n=1, latency_s=120.0, max_queue=2,
                          max_batch=1)
        router = make_router(pkg, [s1, s2])
        hold = []
        try:
            img = u8()
            for s in (s1, s2):
                fill_door(s, img, hold, S.Overloaded)
            f = router.submit(img, img)
            with pytest.raises(S.Overloaded) as e:
                f.result(timeout=60)
            assert e.value.reason == "backpressure"
            assert e.value.retry_after_s is not None
            assert f.outcome == "overloaded"
            assert all(b.backpressure >= 1 for b in router.backends)
            assert all(b.consecutive_failures == 0
                       for b in router.backends)
            assert all(b.state == S.BACKEND_READY for b in router.backends)
        finally:
            for s in (s1, s2):
                s.engines[0].latency_s = 0.0
            for h in hold:
                h.result(timeout=60)
            router.stop()
            s1.stop()
            s2.stop()
    _, events = pkg.events.replay_events(log_path)
    bp = [e for e in events if e.get("event") == "retry"
          and e.get("via") == "backpressure"]
    assert sorted(e["backend"] for e in bp) == ["b0", "b1"]
    sheds = [e for e in events if e.get("event") == "route_shed"
             and e.get("admitted") is True]
    assert len(sheds) == 1 and sheds[0]["reason"] == "backpressure"
    assert isinstance(sheds[0]["retry_after_s"], float)


def test_edge_deadline_never_a_silent_timeout(pkg, tmp_path):
    log_path = str(tmp_path / "events.jsonl")
    S = pkg.serving
    with pkg.events.bound(pkg.EventLog(log_path)):
        s1 = wire_backend(pkg, n=2, latency_s=0.01)
        router = make_router(pkg, [s1], retries=0)
        try:
            img = u8()
            router.submit(img, img).result(timeout=30)
            f = router.submit(img, img, deadline_s=0.001)
            with pytest.raises(S.DeadlineExceeded):
                f.result(timeout=30)
            assert f.outcome == "deadline"
            # the hung-wire shape: the send stalls past the budget
            pkg.faults.install(pkg.faults.FaultPlan(
                hang_backend_urls=(s1.introspect_url,),
                hang_backend_seconds=0.4))
            f = router.submit(img, img, deadline_s=0.15)
            with pytest.raises(S.DeadlineExceeded):
                f.result(timeout=30)
            assert f.outcome == "deadline"
            pkg.faults.clear()
        finally:
            pkg.faults.clear()
            router.stop()
            s1.stop()
    _, events = pkg.events.replay_events(log_path)
    deadlines = [e for e in events if e.get("event") == "route_deadline"
                 and e.get("admitted") is not False]
    assert len(deadlines) == 2
    assert {e["where"] for e in deadlines} <= {
        "dequeue", "fetch", "backend_admission", "backend_dequeue",
        "backend_fetch", "backend_failure", "backpressure"}
    assert both("run_report", "build_router_section", events)["outcomes"][
        "unresolved"] == 0


def test_draining_backend_demoted_before_its_drain_completes(pkg):
    """A backend answering 503 DRAINING leaves routing without a failure
    streak while its held batches are still in flight (the drain cannot
    complete before they are released)."""
    S = pkg.serving
    s1 = wire_backend(pkg, n=1, latency_s=120.0)
    s2 = wire_backend(pkg)
    router = make_router(pkg, [s1, s2], probe_period_s=0.1)
    try:
        img = u8()
        s1.engines[0].latency_s = 0.01
        for f in [router.submit(img, img) for _ in range(4)]:
            f.result(timeout=60)
        s1.engines[0].latency_s = 120.0
        hold = [s1.submit(img, img) for _ in range(4)]
        s1.request_drain("rollout")
        b0 = router.backends[0]
        assert wait_until(lambda: b0.state == S.BACKEND_DRAINING)
        assert not any(h.done() for h in hold)  # its drain is not over
        assert b0.consecutive_failures == 0
        assert router.state == S.DEGRADED
        futs = [router.submit(img, img) for _ in range(6)]
        for f in futs:
            f.result(timeout=60)
        assert all(f.outcome == "result" for f in futs)
        assert router.backends[1].results >= 6
        s1.engines[0].latency_s = 0.0
        for h in hold:
            h.result(timeout=60)
        s1.stop()
        assert wait_until(lambda: b0.state == S.BACKEND_DEAD)
    finally:
        s1.engines[0].latency_s = 0.0
        router.stop()
        s1.stop()
        s2.stop()


def test_router_drain_answers_503_and_completes_admitted_work(pkg):
    S = pkg.serving
    assert threading.current_thread() is threading.main_thread()
    s1 = wire_backend(pkg, n=1, latency_s=0.15, max_batch=1)
    router = make_router(pkg, [s1], introspect_port=0, install_sigterm=True)
    try:
        img = u8()
        futs = [router.submit(img, img) for _ in range(6)]
        os.kill(os.getpid(), signal.SIGTERM)
        assert wait_until(lambda: router.state == "DRAINING")
        with pytest.raises(S.Overloaded) as e:
            router.submit(img, img)
        assert e.value.reason == "draining"
        try:
            with urllib.request.urlopen(router.introspect_url + "/healthz",
                                        timeout=5) as r:
                code = r.status
        except urllib.error.HTTPError as he:
            code = he.code
        assert code == 503
        for f in futs:
            assert f.result(timeout=60).request_id
        assert wait_until(lambda: router.state == S.STOPPED)
    finally:
        router.stop()
        s1.stop()


def test_admission_units_track_pod_replica_capacity(pkg):
    S = pkg.serving
    a = pkg.admission.AdmissionController(
        max_queue=60, max_in_flight_per_client=64, max_batch=1,
        dead_retry_after_s=1.5)
    a.note_capacity(6, 6)
    assert a.effective_max_queue() == 60
    a.note_capacity(4, 6)
    assert a.effective_max_queue() == 40
    a.note_capacity(5, 6)
    assert a.effective_max_queue() == 50
    a.note_capacity(0, 6)
    with pytest.raises(S.Overloaded) as e:
        a.admit("c", 0)
    assert e.value.reason == "no_capacity"
    assert e.value.retry_after_s == pytest.approx(1.5)
    s1 = wire_backend(pkg, n=2)
    router = make_router(pkg, [s1], probe_period_s=0.1)
    try:
        assert wait_until(
            lambda: router.health()["pod"]["replicas_total"] == 2)
        h = router.health()
        assert h["pod"]["replicas_ready"] == 2
        assert h["queue"]["effective_max_queue"] == router.cfg.max_queue
    finally:
        router.stop()
        s1.stop()


@pytest.mark.parametrize("child_pkg", PKGS)
def test_routers_chain_as_wire_backends(pkg, child_pkg):
    """A router is itself a wire backend, across packages too: a parent
    router fronting a sub-router of either package serves through it and
    ingests the sub-pod's replica units."""
    c = load(child_pkg)
    s1 = wire_backend(c, n=2)
    child = make_router(c, [s1], introspect_port=0, probe_period_s=0.1)
    parent = make_router(pkg, [child.introspect_url], probe_period_s=0.1)
    try:
        img = u8()
        futs = [parent.submit(img, img) for _ in range(6)]
        for f in futs:
            assert f.result(timeout=60).table.shape == (5, 16)
        b0 = parent.backends[0]
        assert wait_until(lambda: b0.ready_replicas == 2)
        assert b0.schema_refused is False
        assert b0.consecutive_failures == 0
        assert parent.health()["pod"]["replicas_ready"] == 2
    finally:
        parent.stop()
        child.stop()
        s1.stop()


# ---------------------------------------------------------------------------
# real processes: SIGKILL, restart in place, SIGTERM drain, mixed pods
# ---------------------------------------------------------------------------


def backend_argv(backend_pkg, *args):
    if backend_pkg == "jax":
        return [sys.executable, os.path.join(_REPO, "tools",
                                             "serve_backend.py"), *args]
    return [sys.executable, "-m", "ncnet_tpu_torch.tools.serve_backend",
            *args]


def spawn_backends(backend_pkg, tmp_path, names, port=0, latency=0.05,
                   extra=()):
    """Real backend processes of ``backend_pkg`` started together; each
    prints one ``{"url", "pid"}`` line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=_REPO,
               NCNET_TPU_PERF_STORE="off", NCNET_TPU_TIER_CACHE="off")
    procs = []
    for name in names:
        args = list(extra) or ["--fake-engine", "--replicas", "1",
                               "--latency", str(latency),
                               "--max-queue", "8", "--max-batch", "1"]
        procs.append(subprocess.Popen(
            backend_argv(backend_pkg, *args, "--port", str(port),
                         "--events", str(tmp_path / f"{name}.jsonl")),
            stdout=subprocess.PIPE, text=True, env=env, cwd=_REPO))
    out = []
    for p in procs:
        line = p.stdout.readline()
        assert line, f"backend exited with {p.wait()}"
        out.append((p, json.loads(line)["url"]))
    return out


def healthz(url):
    """A backend's health document (it answers 503 once draining)."""
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
            return json.load(r)
    except urllib.error.HTTPError as e:
        return json.load(e)


def queued_or_served(url, before):
    """The backend holds a request admitted after ``before`` (its
    counters then) in its queue or pipeline, or has served it."""
    doc = healthz(url)
    q = doc["queue"]
    return doc["counters"]["admitted"] > before["admitted"] and (
        q["depth"] + q["inflight_batches"] > 0
        or doc["counters"]["results"] > before["results"])


def stop_procs(procs):
    for p, _ in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    for p, _ in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def pod_chain(router_pkg, backend_pkg, tmp_path):
    """Two backends of ``backend_pkg`` behind a router of ``router_pkg``:
    a healthy stream; one backend SIGKILLed under a stream (zero lost, it
    goes DEAD), restarted at the same port and re-admitted by the probes;
    the other SIGTERMed while it holds admitted work (demoted before its
    drain completes, zero edge errors); the router drained.  Returns the
    router-level outcome counts recomputed from its event log."""
    r = load(router_pkg)
    clean(r)
    S = r.serving
    log_path = str(tmp_path / "router.jsonl")
    procs = spawn_backends(backend_pkg, tmp_path, ["h0", "h1"])
    with r.events.bound(r.EventLog(log_path)):
        router = S.MatchRouter([u for _, u in procs], S.RouterConfig(
            probe_period_s=0.2, resurrect_after_s=0.3,
            backend_max_failures=2, retries=1, request_timeout_s=30.0,
            max_queue=512, max_in_flight_per_client=512,
            per_backend_depth=2, introspect_port=0)).start()
        img = u8()
        try:
            futs = [router.submit(img, img) for _ in range(16)]
            for f in futs:
                f.result(timeout=120)
            assert all(f.outcome == "result" for f in futs)
            assert router.state == S.READY

            (p1, url1) = procs[1]
            victim = next(b for b in router.backends if b.url in url1)
            futs = [router.submit(img, img) for _ in range(16)]
            assert wait_until(lambda: victim.inflight > 0)
            p1.kill()
            for f in futs:
                f.result(timeout=120)
            assert all(f.outcome == "result" for f in futs)
            assert wait_until(lambda: victim.state == S.BACKEND_DEAD)
            assert router.state == S.DEGRADED
            p1.wait(timeout=30)
            procs[1] = spawn_backends(backend_pkg, tmp_path, ["h1b"],
                                      port=int(url1.rsplit(":", 1)[1]))[0]
            assert wait_until(lambda: victim.state == S.BACKEND_READY)
            assert wait_until(lambda: router.state == S.READY)

            # SIGTERM h0 while its queue holds work: the router demotes it
            # (DRAINING) and the edge sees no error
            (p0, url0) = procs[0]
            other = next(b for b in router.backends if b.url in url0)
            c = r.serving.MatchClient(url0)
            held = []
            before = healthz(url0)["counters"]
            ht = threading.Thread(target=lambda: held.append(
                c.match(img, img, budget_s=60.0)))
            ht.start()
            # queued (or already served), not only admitted: a request
            # between its admission and its enqueue when the drain finds
            # the queue empty settles Overloaded("service stopped")
            assert wait_until(lambda: queued_or_served(url0, before))
            p0.send_signal(signal.SIGTERM)
            futs = [router.submit(img, img) for _ in range(8)]
            for f in futs:
                f.result(timeout=120)
            assert all(f.outcome == "result" for f in futs)
            assert wait_until(lambda: other.state in (S.BACKEND_DRAINING,
                                                      S.BACKEND_DEAD))
            ht.join(60)
            c.close()
            assert len(held) == 1  # the drain completed its admitted work
            assert p0.wait(timeout=60) == 0
            assert wait_until(lambda: other.state == S.BACKEND_DEAD)
            router.request_drain("test")
            assert wait_until(lambda: router.state == S.STOPPED)
        finally:
            router.stop()
            stop_procs(procs)
    _, events = r.events.replay_events(log_path)
    sec = both("run_report", "build_router_section", events)
    states = [(e.get("backend"), e.get("state")) for e in events
              if e.get("event") == "route_backend"]
    vid = victim.id
    assert states.index((vid, S.BACKEND_READY)) \
        > states.index((vid, S.BACKEND_DEAD))
    reroutes = [e for e in events if e.get("event") == "retry"
                and e.get("scope") == "router" and e.get("via") == "reroute"]
    assert all(e["on_budget"] is False for e in reroutes)
    o = sec["outcomes"]
    return {k: o[k] for k in ("admitted", "results", "unresolved",
                              "deadline_exceeded", "quarantined",
                              "shed_admitted")}


WANT = {"admitted": 40, "results": 40, "unresolved": 0,
        "deadline_exceeded": 0, "quarantined": 0, "shed_admitted": 0}


@pytest.mark.parametrize("router_pkg,backend_pkg", [
    ("torch", "torch"), ("jax", "torch"), ("torch", "jax"), ("jax", "jax")])
def test_pod_chain_single_and_mixed_packages(router_pkg, backend_pkg,
                                             tmp_path):
    """The mixed pods (the JAX router over port backends, the port router
    over JAX backends) give the outcome counts of the single-package pods:
    every admitted request a result through the kill, the restart and
    the drain."""
    assert pod_chain(router_pkg, backend_pkg, tmp_path) == WANT


@pytest.mark.parametrize("router_pkg", PKGS)
def test_router_over_a_tiny_port_backend_on_the_cpu(router_pkg, tmp_path):
    """A real model behind the wire: the port's ``serve_backend --tiny
    --device cpu`` answers a pair through a router of either package with
    the table the same engine gives in process."""
    r = load(router_pkg)
    clean(r)
    procs = spawn_backends("torch", tmp_path, ["tiny"], extra=(
        "--tiny", "--device", "cpu", "--bucket-side", "64"))
    router = r.serving.MatchRouter([procs[0][1]], r.serving.RouterConfig(
        probe_period_s=0.2)).start()
    try:
        rng = np.random.default_rng(3)
        src = rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)
        tgt = np.roll(src, 16, axis=1)
        res = router.submit(src, tgt, deadline_s=120.0).result(timeout=120)
    finally:
        router.stop()
        stop_procs(procs)
    from ncnet_tpu_torch.config import ModelConfig
    from ncnet_tpu_torch.models.ncnet import init_ncnet
    from ncnet_tpu_torch.serving import BatchMatchEngine

    cfg = ModelConfig(backbone="tiny", ncons_kernel_sizes=(3,),
                      ncons_channels=(1,), half_precision=False)
    eng = BatchMatchEngine(cfg, init_ncnet(cfg, seed=0), device="cpu")
    tables, quality = eng.split(eng.fetch(eng.dispatch(src[None], tgt[None])))
    assert res.table.shape == tables[0].shape
    np.testing.assert_allclose(res.table, tables[0], rtol=0, atol=1e-5)
    assert set(res.quality) == set(quality[0])
