"""The port's serving plane against the JAX package's, on fake engines
(``ncnet_tpu_torch/serving/``: request, admission, buckets, slo, health,
replica, service).

Every case runs once with each package's modules (``pkg`` is ``"jax"`` or
``"torch"``), the cases of ``tests/test_serving.py`` and
``tests/test_serving_pool.py`` that need no device.  Both must make the
same decisions: shed reasons, retry hints, buckets, health transitions,
routing, and the same outcome counts, recomputed from each event log by
both packages' ``run_report``, which must agree (the logs share one
format).

ROADMAP D4: the port has no demote-and-retrace.  Where the JAX service
grants a free retry after a tier demotion (a single replica, or a request
that failed everywhere), the port charges the request's retry budget and
runs the same program again.  Those cases assert the same outcome counts in
both packages and the package's own retry accounting
(``on_budget`` False and DEGRADED for JAX, True and READY for the port).
"""

import os
import signal
import subprocess
import sys
import time
import types

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_REPO, "tools"))

import run_report  # noqa: E402

from ncnet_tpu_torch.tools import run_report as port_run_report  # noqa: E402

from torch_port_tool_twins import same  # noqa: E402

PKGS = ("jax", "torch")


def load(name):
    if name == "jax":
        from ncnet_tpu import ops
        from ncnet_tpu import serving
        from ncnet_tpu.evaluation import resilience
        from ncnet_tpu.observability import events
        from ncnet_tpu.serving import health, replica
        from ncnet_tpu.utils import faults

        reset = ops.reset_fused_tier_demotions
    else:
        from ncnet_tpu_torch import serving
        from ncnet_tpu_torch.evaluation import resilience
        from ncnet_tpu_torch.observability import events
        from ncnet_tpu_torch.serving import health, replica
        from ncnet_tpu_torch.utils import faults

        def reset():
            pass
    return types.SimpleNamespace(name=name, serving=serving, faults=faults,
                                 events=events, health=health,
                                 replica=replica, resilience=resilience,
                                 reset=reset)


@pytest.fixture(params=PKGS)
def pkg(request):
    p = load(request.param)
    p.faults.clear()
    p.reset()
    p.events.set_global_sink(None)
    yield p
    p.faults.clear()
    p.reset()
    p.events.set_global_sink(None)


def u8(side=32, seed=0):
    return np.random.default_rng(seed).integers(
        0, 255, (side, side, 3), dtype=np.uint8)


def make_fake(p):
    class FakeEngine:
        """Device stand-in: deterministic tables, a configurable fetch
        latency, and the real engines' seams (``device_error_hook`` at
        dispatch; the hang hook fires inside ``call_with_watchdog``).
        ``retrace`` exists for the JAX ladder only."""

        split = staticmethod(p.serving.BatchMatchEngine.split)
        half_precision = False

        def __init__(self, latency_s=0.0):
            self.latency_s = latency_s
            self.retraces = 0
            self.dispatches = 0
            self.batch_sizes = []

        def dispatch(self, src, tgt):
            p.faults.device_error_hook("fake_serve")
            self.dispatches += 1
            self.batch_sizes.append(src.shape[0])
            return (src.shape[0], time.monotonic())

        def fetch(self, handle):
            b, t0 = handle
            while time.monotonic() - t0 < self.latency_s:
                time.sleep(0.01)
            table = np.zeros((b, 6, 16), np.float32)
            table[:, 4, :] = 1.0
            table[:, 5, :5] = [0.5, 0.1, 0.4, 0.9, 0.8]
            return table

        def retrace(self):
            self.retraces += 1

    return FakeEngine


def fake_service(p, latency_s=0.0, **over):
    cfg = dict(bucket_multiple=32, max_image_side=128, max_batch=8)
    cfg.update(over)
    engine = make_fake(p)(latency_s=latency_s)
    return p.serving.MatchService(
        engine=engine, serving=p.serving.ServingConfig(**cfg)), engine


def pool_service(p, n=4, latency_s=0.02, **over):
    cfg = dict(bucket_multiple=32, max_image_side=64, max_batch=2,
               replica_max_failures=1, resurrect_after_s=0.2,
               max_queue=128, max_in_flight_per_client=128)
    cfg.update(over)
    engines = [make_fake(p)(latency_s=latency_s) for _ in range(n)]
    return p.serving.MatchService(
        engine=engines, serving=p.serving.ServingConfig(**cfg)), engines


def wait_until(pred, timeout=10.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def logged(p, tmp_path):
    path = str(tmp_path / "events.jsonl")
    return path, p.events.bound(p.events.EventLog(path))


def section(p, path):
    _, events = p.events.replay_events(path)
    sec = run_report.build_serving_section(events)
    assert same(port_run_report.build_serving_section(events), sec)
    return sec, events


# ---------------------------------------------------------------------------
# units: bucketer, admission, health, split, pool routing
# ---------------------------------------------------------------------------


def test_bucketer_rounds_caps_and_bounds(pkg):
    S = pkg.serving
    b = S.ShapeBucketer(multiple=32, max_side=64, max_buckets=2)
    assert b.bucket_for((30, 33), (10, 10)) == ((32, 64), (32, 32))
    with pytest.raises(S.Overloaded) as e:
        b.bucket_for((100, 10), (10, 10))
    assert e.value.reason == "unservable_shape"
    b.bucket_for((64, 64), (64, 64))
    with pytest.raises(S.Overloaded) as e:
        b.bucket_for((10, 10), (10, 10))
    assert e.value.reason == "bucket_capacity"
    fixed = S.ShapeBucketer(fixed=[(48, 48), (96, 96)], max_buckets=4)
    assert fixed.bucket_for((40, 40), (50, 50)) == ((48, 48), (96, 96))
    padded = S.pad_to_bucket([u8(30, 1), None], (32, 64))
    assert padded.shape == (2, 32, 64, 3) and not padded[1].any()
    assert (padded[0, :30, :30] == u8(30, 1)).all()


def test_shed_request_does_not_consume_bucket_budget(pkg):
    S = pkg.serving
    svc, _ = fake_service(pkg, latency_s=0.3, max_queue=1, max_batch=1,
                          pipeline_depth=1, max_buckets=2)
    svc.start()
    try:
        f1 = svc.submit(u8(32, 1), u8(32, 1))
        time.sleep(0.05)
        f2 = svc.submit(u8(32, 2), u8(32, 2))
        with pytest.raises(S.Overloaded) as e:
            svc.submit(u8(40, 3), u8(40, 3))
        assert e.value.reason == "queue_full"
        assert svc.health()["queue"]["buckets"] == ["32x32-32x32"]
        f1.result(timeout=30)
        f2.result(timeout=30)
        assert svc.submit(u8(40, 4), u8(40, 4)).result(timeout=30)
    finally:
        svc.stop()


def test_admission_controller_bounds_and_retry_after(pkg):
    S = pkg.serving
    a = S.AdmissionController(max_queue=2, max_in_flight_per_client=2,
                              max_batch=2)
    a.admit("c1", 0)
    a.note_admit("c1")
    a.admit("c1", 1)
    a.note_admit("c1")
    with pytest.raises(S.Overloaded) as e:
        a.admit("c2", 2)
    assert e.value.reason == "queue_full" and e.value.retry_after_s > 0
    with pytest.raises(S.Overloaded) as e:
        a.admit("c1", 1)
    assert e.value.reason == "client_cap"
    a.note_done("c1")
    a.admit("c1", 1)
    a.note_batch_wall(0.2)
    hints = [a.retry_after_s(d) for d in (1, 8, 64)]
    # elastic capacity: queue bounds and hints follow ready/total
    e = S.AdmissionController(max_queue=64, max_in_flight_per_client=64,
                              max_batch=8, dead_retry_after_s=2.5)
    e.note_batch_wall(0.4)
    e.note_capacity(4, 4)
    hints.append(e.retry_after_s(8))
    e.note_capacity(1, 4)
    hints.append(e.retry_after_s(8))
    bounds = [e.effective_max_queue()]
    e.note_capacity(0, 4)
    with pytest.raises(S.Overloaded) as x:
        e.admit("c", 0)
    assert x.value.reason == "no_capacity"
    assert x.value.retry_after_s == pytest.approx(2.5)
    # the JAX package's decisions, number for number
    J = load("jax").serving
    ja = J.AdmissionController(max_queue=2, max_in_flight_per_client=2,
                               max_batch=2)
    ja.note_batch_wall(0.2)
    je = J.AdmissionController(max_queue=64, max_in_flight_per_client=64,
                               max_batch=8, dead_retry_after_s=2.5)
    je.note_batch_wall(0.4)
    je.note_capacity(4, 4)
    want = [ja.retry_after_s(d) for d in (1, 8, 64)] + [je.retry_after_s(8)]
    je.note_capacity(1, 4)
    want.append(je.retry_after_s(8))
    assert hints == want and bounds == [je.effective_max_queue()] == [16]


def test_health_machine_transitions(pkg, tmp_path):
    H = pkg.health
    path, sink = logged(pkg, tmp_path)
    with sink:
        h = H.HealthMachine()
        assert h.state == H.STARTING and h.admitting
        assert h.to(H.READY, "warm")
        assert not h.to(H.READY)
        assert h.to(H.DEGRADED, "replicas_ready:1/2")
        assert h.to(H.READY, "pool_restored")
        assert h.to(H.DRAINING, "sigterm") and not h.admitting
        with pytest.raises(RuntimeError):
            h.to(H.READY)
        assert h.to(H.STOPPED)
    _, events = pkg.events.replay_events(path)
    states = [e["state"] for e in events if e["event"] == "serve_health"]
    assert states == ["READY", "DEGRADED", "READY", "DRAINING", "STOPPED"]
    doc = H.build_health_document(h, [{"state": "READY"}], queue={},
                                  counters={"admitted": 0})
    assert doc["schema"] == H.HEALTH_DOC_SCHEMA == 1
    assert doc["state"] == "STOPPED" and doc["pool"]["ready"] == 1


def test_engine_split_protocol(pkg):
    split = pkg.serving.BatchMatchEngine.split
    t6 = np.zeros((2, 6, 8), np.float32)
    t6[:, 5, :5] = [0.5, 0.1, 0.4, 0.9, 0.8]
    tables, quality = split(t6)
    assert tables.shape == (2, 5, 8)
    assert quality[1]["score"] == pytest.approx(0.5)
    assert quality[0]["coherence"] == pytest.approx(0.8)
    tables, quality = split(np.zeros((2, 5, 8), np.float32))
    assert tables.shape == (2, 5, 8) and quality is None


def test_replica_health_score_and_routing(pkg):
    R = pkg.replica
    a, b, c = (R.Replica("a", object()), R.Replica("b", object()),
               R.Replica("c", object()))
    pool = R.ReplicaPool([a, b, c])
    a.note_success(0.01)
    b.note_success(0.2)
    assert pool.route(max_load=2).id == "a"
    a.pending.extend([object(), object()])
    assert pool.route(max_load=2).id == "c"
    c.note_failure()
    c.note_failure()
    assert c.health_score() == pytest.approx(0.05 * 4)
    assert pool.route(max_load=2).id == "b"
    c.note_success(0.01)
    assert c.consecutive_failures == 0
    assert pool.route(max_load=2, exclude=frozenset({"c"})).id == "b"
    pool.mark_dead(b, "test")
    pool.mark_dead(c, "test")
    assert b.state == R.REPLICA_DEAD and b.deaths == 1
    assert pool.route(max_load=2) is None
    pool.resurrect(c)
    assert c.state == R.REPLICA_READY and c.ewma_wall_s is None
    assert pool.route(max_load=2).id == "c"
    with pytest.raises(ValueError):
        R.ReplicaPool([R.Replica("x", object()), R.Replica("x", object())])


def test_pool_due_probes_are_periodic_and_skip_loaded(pkg):
    R = pkg.replica
    a, b = R.Replica("a", object()), R.Replica("b", object())
    pool = R.ReplicaPool([a, b])
    pool.mark_dead(a, "test")
    pool.mark_dead(b, "test")
    b.pending.append(object())
    t0 = a.dead_since
    assert pool.due_probes(t0 + 0.05, 0.2) == []
    assert pool.due_probes(t0 + 0.25, 0.2) == [a]
    assert a.probing is True
    assert pool.due_probes(t0 + 10.0, 0.2) == []
    a.probing = False
    assert pool.due_probes(t0 + 0.3, 0.2) == []
    assert pool.due_probes(t0 + 0.5, 0.2) == [a]


def test_slo_tracker_burn_matches_jax(pkg):
    """The same outcome stream gives the same SLO snapshot in both."""
    J = load("jax").serving

    def feed(S):
        t = S.SLOTracker(default_ms=50.0, by_bucket=(("64x64-64x64", 20.0),),
                         budget_pct=10.0, window=8, emit_every=1000)
        rng = np.random.default_rng(3)
        for i in range(40):
            outcome = ("result", "result", "deadline", "shed",
                       "quarantined")[int(rng.integers(0, 5))]
            bucket = ("32x32-32x32", "64x64-64x64")[i % 2]
            t.observe(outcome, bucket=bucket,
                      wall_ms=float(rng.uniform(0, 80))
                      if outcome == "result" else None)
        return t.snapshot()

    assert feed(pkg.serving) == feed(J)


# ---------------------------------------------------------------------------
# batching, admission, deadlines
# ---------------------------------------------------------------------------


def test_continuous_batching_coalesces(pkg, tmp_path):
    path, sink = logged(pkg, tmp_path)
    with sink:
        svc, eng = fake_service(pkg, latency_s=0.05)
        svc.start()
        img = u8()
        futs = [svc.submit(img, img) for _ in range(12)]
        for f in futs:
            f.result(timeout=30)
        svc.stop()
    _, events = pkg.events.replay_events(path)
    sizes = [e["size"] for e in events if e["event"] == "serve_batch"]
    assert sum(sizes) == 12 and max(sizes) >= 2 and len(sizes) < 12
    assert set(eng.batch_sizes) <= {1, 2, 4, 8}


def test_overload_burst_sheds_never_deadline_blows_admitted(pkg, tmp_path):
    path, sink = logged(pkg, tmp_path)
    with sink:
        svc, _ = fake_service(pkg, latency_s=0.03, max_queue=4, max_batch=2,
                              default_deadline_s=20.0)
        svc.start()
        img = u8()
        futs, sheds = pkg.faults.queue_overflow_burst(
            lambda: svc.submit(img, img), 30)
        for f in futs:
            f.result(timeout=30)
        svc.stop()
    assert sheds and all(s.reason == "queue_full" for s in sheds)
    assert all(s.retry_after_s and s.retry_after_s > 0 for s in sheds)
    assert all(f.outcome == "result" for f in futs)
    sec, _ = section(pkg, path)
    assert sec["outcomes"]["deadline_exceeded"] == 0
    assert sec["outcomes"]["unresolved"] == 0
    assert sec["shed_reasons"]["queue_full"] == len(sheds)


def test_per_client_cap_isolates_misbehaving_client(pkg):
    svc, _ = fake_service(pkg, latency_s=0.1, max_queue=32,
                          max_in_flight_per_client=2)
    svc.start()
    try:
        img = u8()
        futs, sheds = [], []
        for _ in range(6):
            try:
                futs.append(svc.submit(img, img, client="noisy"))
            except pkg.serving.Overloaded as e:
                sheds.append(e)
        assert sheds and all(s.reason == "client_cap" for s in sheds)
        assert svc.submit(img, img, client="polite").result(timeout=30)
        for f in futs:
            f.result(timeout=30)
    finally:
        svc.stop()


def test_deadline_checked_at_admission_dequeue_and_fetch(pkg, tmp_path):
    S = pkg.serving
    path, sink = logged(pkg, tmp_path)
    with sink:
        svc, eng = fake_service(pkg, latency_s=0.25, pipeline_depth=1,
                                max_batch=1)
        svc.start()
        img = u8()
        with pytest.raises(S.DeadlineExceeded) as e:
            svc.submit(img, img, deadline_s=0)
        assert e.value.where == "admission"
        f1 = svc.submit(img, img)
        time.sleep(0.02)
        f2 = svc.submit(img, img, deadline_s=0.05)
        with pytest.raises(S.DeadlineExceeded) as e:
            f2.result(timeout=30)
        assert e.value.where == "dequeue"
        assert f1.result(timeout=30)
        n = eng.dispatches
        eng.latency_s = 0.5
        f3 = svc.submit(img, img, deadline_s=0.2)
        with pytest.raises(S.DeadlineExceeded) as e:
            f3.result(timeout=30)
        assert e.value.where == "fetch" and eng.dispatches == n + 1
        svc.stop()
    sec, _ = section(pkg, path)
    assert sec["deadline_where"] == {"admission": 1, "dequeue": 1,
                                     "fetch": 1}
    assert sec["outcomes"]["admitted"] == 3
    assert sec["outcomes"]["unresolved"] == 0


def test_trace_ids_ride_every_event_of_a_request(pkg, tmp_path):
    tracing = (__import__("ncnet_tpu.observability.tracing", fromlist=["x"])
               if pkg.name == "jax" else
               __import__("ncnet_tpu_torch.observability.tracing",
                          fromlist=["x"]))
    ctx = tracing.new_trace(origin="edge")
    path, sink = logged(pkg, tmp_path)
    with sink:
        svc, _ = fake_service(pkg)
        svc.start()
        svc.submit(u8(), u8(), trace=ctx.to_header()).result(timeout=30)
        svc.submit(u8(), u8(), trace="opaque-id").result(timeout=30)
        svc.stop()
    _, events = pkg.events.replay_events(path)
    by = {}
    for e in events:
        if e.get("request") and e.get("trace"):
            by.setdefault(e["trace"], set()).add(e["event"])
    assert set(by) == {ctx.trace_id, "opaque-id"}
    for names in by.values():
        assert {"serve_admit", "serve_result", "request_timeline"} <= names


def test_timeline_ends_before_the_caller_holds_its_result(pkg, tmp_path):
    """A request's ``request_timeline`` is the backend's slice in a
    federated pod trace, and the router's slice ends when the reply
    arrives.  The port ends the timeline where the request was settled,
    before its caller can wake: with a slow result event (80 ms after its
    append) the slice still ends before the ``serve_result`` stamp and
    before the caller took the result.  The JAX service ends it after the
    result event, 80 ms late here (ROADMAP C5)."""
    class SlowResultLog(pkg.events.EventLog):
        def emit(self, event, **fields):
            super().emit(event, **fields)
            if event == "serve_result":
                time.sleep(0.08)

    path = str(tmp_path / "events.jsonl")
    held = []
    with pkg.events.bound(SlowResultLog(path)):
        svc, _ = fake_service(pkg)
        svc.start()
        for seed in range(3):
            svc.submit(u8(seed=seed), u8(seed=seed)).result(timeout=30)
            held.append(pkg.events.wall_now())
        svc.stop()
    _, events = pkg.events.replay_events(path)
    result_t = {e["request"]: e["t"] for e in events
                if e.get("event") == "serve_result"}
    ends = {e["request"]: e["t0"] + e["total_ms"] * 1e-3 for e in events
            if e.get("event") == "request_timeline"}
    assert len(ends) == len(result_t) == len(held) == 3
    rounding = 2e-6  # t0 to the µs, total_ms to the µs
    for rid, held_t in zip(sorted(ends, key=ends.get), held):
        if pkg.name == "torch":
            assert ends[rid] <= result_t[rid] + rounding
            assert ends[rid] <= held_t + rounding
        else:
            assert ends[rid] >= result_t[rid] + 0.08 - rounding


# ---------------------------------------------------------------------------
# failure handling (D4 cases stated)
# ---------------------------------------------------------------------------


def test_device_failure_mid_stream_zero_lost(pkg, tmp_path):
    """The second dispatched batch fails.  Both: every request a result,
    nothing unresolved, nothing quarantined.  D4: JAX demotes a tier and
    retries free (DEGRADED, one retrace); the port charges the budget and
    re-runs the same program (READY, no retrace)."""
    path, sink = logged(pkg, tmp_path)
    with sink:
        svc, eng = fake_service(pkg, max_batch=2, retries=1,
                                quarantine_dir=str(tmp_path / "q"))
        svc.start()
        pkg.faults.install(pkg.faults.FaultPlan(device_fail_calls=(2,)))
        try:
            futs = [svc.submit(u8(32, i), u8(32, i + 100)) for i in range(8)]
            for f in futs:
                f.result(timeout=60)
            state = svc.state
        finally:
            pkg.faults.clear()
            svc.stop()
    assert all(f.outcome == "result" for f in futs)
    sec, events = section(pkg, path)
    assert sec["outcomes"]["admitted"] == sec["outcomes"]["results"] == 8
    assert sec["outcomes"]["unresolved"] == 0 and not sec["lost_requests"]
    assert not pkg.resilience.manifest_has_quarantined(
        str(tmp_path / "q" / "manifest.json"))
    retries = [e for e in events if e.get("event") == "retry"
               and e.get("scope") == "serving"]
    assert retries
    if pkg.name == "jax":
        assert state == "DEGRADED" and eng.retraces == 1
        assert all(e["on_budget"] is False for e in retries)
    else:
        assert state == "READY" and eng.retraces == 0
        assert all(e["on_budget"] is True and e["attempt"] == 1
                   for e in retries)


def test_exhausted_failures_quarantine_and_stream_continues(pkg, tmp_path):
    """Retry budget 0 and every dispatch failing: the request quarantines
    into the manifest and as a classified error; the next one serves.
    (JAX: every tier demoted first, so its ladder has nothing left.)"""
    if pkg.name == "jax":
        from ncnet_tpu import ops

        while ops.demote_fused_tier() is not None:
            pass
    path, sink = logged(pkg, tmp_path)
    with sink:
        svc, _ = fake_service(pkg, retries=0,
                              quarantine_dir=str(tmp_path / "q"))
        svc.start()
        pkg.faults.install(pkg.faults.FaultPlan(
            device_fail_calls=tuple(range(1, 10))))
        try:
            f = svc.submit(u8(32, 1), u8(32, 2))
            with pytest.raises(pkg.serving.RequestQuarantined) as e:
                f.result(timeout=60)
            assert e.value.kind == "device" and f.outcome == "quarantined"
            pkg.faults.clear()
            ok = svc.submit(u8(32, 3), u8(32, 4))
            assert ok.result(timeout=60).table.shape[0] == 5
        finally:
            pkg.faults.clear()
            svc.stop()
    m = pkg.resilience.RunManifest(str(tmp_path / "q" / "manifest.json"),
                                   meta={"scope": "serving"})
    assert list(m.data["quarantined"].values())[0]["kind"] == "device"
    sec, _ = section(pkg, path)
    assert sec["outcomes"]["quarantined"] == 1
    assert sec["outcomes"]["results"] == 1
    assert sec["outcomes"]["unresolved"] == 0


def test_hung_fetch_surfaces_as_timeout_and_retries(pkg, tmp_path):
    path, sink = logged(pkg, tmp_path)
    with sink:
        svc, _ = fake_service(pkg, fetch_timeout_s=0.3, retries=1)
        svc.start()
        pkg.faults.install(pkg.faults.FaultPlan(hang_fetch_calls=(1,),
                                                hang_fetch_seconds=1.5))
        try:
            t0 = time.monotonic()
            f = svc.submit(u8(), u8())
            assert f.result(timeout=30).request_id and f.outcome == "result"
            assert time.monotonic() - t0 < 10
        finally:
            pkg.faults.clear()
            svc.stop()
    _, events = pkg.events.replay_events(path)
    assert any(e.get("event") == "watchdog_timeout" for e in events)
    retries = [e for e in events if e.get("event") == "retry"
               and e.get("scope") == "serving"]
    assert retries[0]["kind"] == "timeout" and retries[0]["on_budget"] is True


# ---------------------------------------------------------------------------
# drain: SIGTERM, abort, kill mid-drain
# ---------------------------------------------------------------------------


def test_sigterm_drains_in_flight_then_stops(pkg, tmp_path):
    path, sink = logged(pkg, tmp_path)
    with sink:
        svc, _ = fake_service(pkg, latency_s=0.04, max_batch=2,
                              install_sigterm=True)
        svc.start()
        img = u8()
        futs = [svc.submit(img, img) for _ in range(6)]
        os.kill(os.getpid(), signal.SIGTERM)
        for f in futs:
            f.result(timeout=30)
        assert wait_until(lambda: svc.state == "STOPPED")
        with pytest.raises(pkg.serving.Overloaded) as e:
            svc.submit(img, img)
        assert e.value.reason in ("draining", "stopped")
        svc.stop()
    assert all(f.outcome == "result" for f in futs)
    sec, events = section(pkg, path)
    drains = [e for e in events if e.get("event") == "serve_drain"]
    assert len(drains) == 1 and drains[0]["drained"] is True \
        and drains[0]["leftover"] == 0
    d = drains[0]
    # the one drain event sums the counters: every admitted request
    # resolved in exactly one outcome
    assert d["n_admitted"] == 6 == d["n_results"] + d["n_deadline"] \
        + d["n_quarantined"]
    states = [e["state"] for e in events if e.get("event") == "serve_health"]
    assert states[-2:] == ["DRAINING", "STOPPED"]
    assert sec["outcomes"]["unresolved"] == 0


def test_device_failure_during_drain_still_completes(pkg, tmp_path):
    """A failure while DRAINING never fights the lifecycle (no DRAINING ->
    DEGRADED edge) and every admitted request completes.  D4: JAX
    retraces once; the port retries on budget."""
    path, sink = logged(pkg, tmp_path)
    with sink:
        svc, eng = fake_service(pkg, latency_s=0.03, max_batch=1,
                                pipeline_depth=1, retries=1)
        svc.start()
        img = u8()
        pkg.faults.install(pkg.faults.FaultPlan(device_fail_calls=(3,)))
        try:
            futs = [svc.submit(img, img) for _ in range(6)]
            svc.request_drain()
            for f in futs:
                f.result(timeout=30)
        finally:
            pkg.faults.clear()
            svc.stop(timeout=30)
    assert all(f.outcome == "result" for f in futs)
    assert eng.retraces == (1 if pkg.name == "jax" else 0)
    sec, events = section(pkg, path)
    assert sec["outcomes"]["unresolved"] == 0
    states = [e["state"] for e in events if e.get("event") == "serve_health"]
    assert "DEGRADED" not in states and states[-2:] == ["DRAINING", "STOPPED"]


def test_abort_stop_settles_queued_work_classified(pkg, tmp_path):
    path, sink = logged(pkg, tmp_path)
    with sink:
        svc, _ = fake_service(pkg, latency_s=0.2, max_batch=1,
                              pipeline_depth=1)
        svc.start()
        img = u8()
        futs = [svc.submit(img, img) for _ in range(5)]
        svc.stop(drain=False, timeout=30)
    outcomes = set()
    for f in futs:
        try:
            f.result(timeout=10)
            outcomes.add("result")
        except pkg.serving.Overloaded as e:
            assert e.reason == "shutdown"
            outcomes.add("overloaded")
    assert "overloaded" in outcomes
    assert all(f.outcome is not None for f in futs)
    _, events = pkg.events.replay_events(path)
    drains = [e for e in events if e.get("event") == "serve_drain"]
    assert len(drains) == 1 and drains[0]["drained"] is False \
        and drains[0]["leftover"] > 0


_KILL_MID_DRAIN_CHILD = """
import sys, time
import numpy as np

sys.path.insert(0, {repo!r})
from {pkg}.observability import EventLog
from {pkg}.observability import events as obs_events
from {pkg}.serving import MatchService, ServingConfig
from {pkg}.serving.engine import BatchMatchEngine


class FakeEngine:
    split = staticmethod(BatchMatchEngine.split)
    half_precision = False

    def dispatch(self, s, t):
        return s.shape[0]

    def fetch(self, b):
        time.sleep(0.03)
        tab = np.zeros((b, 6, 16), np.float32)
        tab[:, 5, :5] = 0.5
        return tab

    def retrace(self):
        pass


obs_events.set_global_sink(EventLog(sys.argv[1]))
svc = MatchService(engine=FakeEngine(), serving=ServingConfig(
    bucket_multiple=32, max_image_side=64, max_batch=1,
    pipeline_depth=1)).start()
img = np.zeros((32, 32, 3), np.uint8)
futs = [svc.submit(img, img) for _ in range(8)]
svc.request_drain()
svc.stop(timeout=60)
sys.stdout.write("CLEAN\\n")
"""


def test_kill_mid_drain_event_log_accounts_for_losses(pkg, tmp_path):
    """SIGKILL after the 3rd terminal outcome of the drain: the replayed
    log names exactly the admitted requests that died without one."""
    log_path = str(tmp_path / "events.jsonl")
    child = tmp_path / "child.py"
    child.write_text(_KILL_MID_DRAIN_CHILD.format(
        repo=_REPO, pkg="ncnet_tpu" if pkg.name == "jax" else "ncnet_tpu_torch"))
    env = dict(os.environ, JAX_PLATFORMS="cpu", NCNET_TPU_PERF_STORE="off",
               NCNET_TPU_FAULTS='{"kill_at_drain_result": 3}')
    proc = subprocess.run([sys.executable, str(child), log_path],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-2000:]
    assert "CLEAN" not in proc.stdout
    sec, _ = section(pkg, log_path)
    assert sec["outcomes"]["admitted"] == 8
    assert sec["outcomes"]["results"] == 3
    assert sec["outcomes"]["unresolved"] == 5
    assert len(sec["lost_requests"]) == 5


# ---------------------------------------------------------------------------
# the replica pool's chaos chain
# ---------------------------------------------------------------------------


def test_pool_spreads_load_and_tags_events(pkg, tmp_path):
    path, sink = logged(pkg, tmp_path)
    with sink:
        svc, _ = pool_service(pkg, n=3, latency_s=0.03, max_batch=1)
        svc.start()
        img = u8()
        for f in [svc.submit(img, img) for _ in range(18)]:
            f.result(timeout=60)
        svc.stop()
    sec, events = section(pkg, path)
    batch_reps = {e["replica"] for e in events
                  if e.get("event") == "serve_batch"}
    assert batch_reps == {"rep0", "rep1", "rep2"}
    quality_reps = {e.get("replica") for e in events
                    if e.get("event") == "quality"}
    assert quality_reps and None not in quality_reps
    assert sum(r["batches"] for r in sec["replicas"].values()) == 18
    assert sec["outcomes"]["unresolved"] == 0


def test_slow_replica_is_deprioritized(pkg):
    svc, _ = pool_service(pkg, n=2, latency_s=0.01, max_batch=1,
                          replica_max_failures=5)
    pkg.faults.install(pkg.faults.FaultPlan(slow_replica_ids=("rep1",),
                                            slow_replica_seconds=0.25))
    try:
        svc.start()
        img = u8()
        for f in [svc.submit(img, img) for _ in range(24)]:
            f.result(timeout=60)
        health = svc.health()
    finally:
        pkg.faults.clear()
        svc.stop()
    rep = {r["id"]: r for r in health["pool"]["replicas"]}
    assert rep["rep0"]["batches"] + rep["rep1"]["batches"] == 24
    assert rep["rep1"]["batches"] >= 1
    assert rep["rep0"]["batches"] >= 3 * rep["rep1"]["batches"]
    assert rep["rep1"]["ewma_wall_ms"] > rep["rep0"]["ewma_wall_ms"] * 5
    assert rep["rep1"]["score"] > rep["rep0"]["score"]


def test_acceptance_chain_kill_resurrect_drain(pkg, tmp_path):
    """4 replicas: a stream, rep2 dies mid-batch (zero lost, DEGRADED), the
    fault heals and a probe resurrects it (READY), rep2 serves again, and
    SIGTERM drains the pool."""
    path, sink = logged(pkg, tmp_path)
    with sink:
        svc, engines = pool_service(pkg, n=4, install_sigterm=True)
        svc.start()
        img = u8()
        for f in [svc.submit(img, img) for _ in range(8)]:
            f.result(timeout=60)
        assert svc.state == "READY"
        pkg.faults.install(pkg.faults.FaultPlan(dead_replica_ids=("rep2",)))
        futs = [svc.submit(img, img) for _ in range(16)]
        for f in futs:
            f.result(timeout=60)
        assert all(f.outcome == "result" for f in futs)
        assert wait_until(lambda: svc.health()["pool"]["ready"] == 3)
        h = svc.health()
        assert h["state"] == "DEGRADED"
        assert h["queue"]["effective_max_queue"] < svc.cfg.max_queue
        pkg.faults.clear()
        assert wait_until(lambda: svc.health()["pool"]["ready"] == 4)
        assert svc.state == "READY"
        for f in [svc.submit(img, img) for _ in range(16)]:
            f.result(timeout=60)
        os.kill(os.getpid(), signal.SIGTERM)
        assert wait_until(lambda: svc.state == "STOPPED")
        svc.stop()
    sec, events = section(pkg, path)
    assert sec["outcomes"]["admitted"] == sec["outcomes"]["results"] == 40
    assert sec["outcomes"]["unresolved"] == 0 and not sec["lost_requests"]
    assert sec["outcomes"]["quarantined"] == 0
    reroutes = [e for e in events if e.get("event") == "retry"
                and e.get("via") == "reroute"]
    assert reroutes and all(e["replica"] == "rep2" for e in reroutes)
    assert all(e["on_budget"] is False for e in reroutes)
    assert all(e.retraces == 0 for e in engines)
    rep2 = sec["replicas"]["rep2"]
    assert rep2["deaths"] == 1 and rep2["resurrections"] == 1
    svc_states = [e["state"] for e in events
                  if e.get("event") == "serve_health"
                  and e.get("replica") is None]
    assert svc_states == ["READY", "DEGRADED", "READY", "DRAINING",
                          "STOPPED"]


def test_all_replicas_dead_sheds_then_recovers(pkg, tmp_path):
    S = pkg.serving
    path, sink = logged(pkg, tmp_path)
    with sink:
        svc, _ = pool_service(pkg, n=2, max_batch=1, resurrect_after_s=0.25)
        svc.start()
        img = u8()
        pkg.faults.install(pkg.faults.FaultPlan(
            dead_replica_ids=("rep0", "rep1")))
        f1 = svc.submit(img, img)
        f_dl = svc.submit(img, img, deadline_s=0.3)
        assert wait_until(lambda: svc.health()["pool"]["ready"] == 0)
        assert svc.state == "DEGRADED" and f1.outcome is None
        with pytest.raises(S.Overloaded) as e:
            svc.submit(img, img)
        assert e.value.reason == "no_capacity"
        assert e.value.retry_after_s == pytest.approx(0.25)
        with pytest.raises(S.DeadlineExceeded) as de:
            f_dl.result(timeout=10)
        assert de.value.where == "dequeue"
        pkg.faults.clear()
        assert f1.result(timeout=60).request_id == f1.request_id
        assert wait_until(lambda: svc.health()["pool"]["ready"] == 2)
        assert svc.state == "READY"
        svc.stop()
    sec, events = section(pkg, path)
    parked = [e for e in events if e.get("event") == "retry"
              and e.get("via") == "awaiting_capacity"]
    assert parked and all(e["on_budget"] is False for e in parked)
    assert sec["outcomes"]["unresolved"] == 0
    assert sec["outcomes"]["results"] == 1
    assert sum(r["deaths"] for r in sec["replicas"].values()) == 2


def test_single_replica_pool_device_failure(pkg):
    """A pool of one has no survivor: the failed request still serves and
    the replica is not killed.  D4: JAX retries free after a demotion
    (its row counts one demotion); the port retries on the budget."""
    svc, engines = pool_service(pkg, n=1, max_batch=1, replica_max_failures=3,
                                retries=1)
    svc.start()
    pkg.faults.install(pkg.faults.FaultPlan(device_fail_calls=(1,)))
    try:
        f = svc.submit(u8(), u8())
        assert f.result(timeout=60).request_id and f.outcome == "result"
    finally:
        pkg.faults.clear()
        svc.stop()
    rep = svc.health()["pool"]["replicas"][0]
    assert rep["deaths"] == 0 and rep["failures"] == 1
    if pkg.name == "jax":
        assert engines[0].retraces == 1 and rep["demotions"] == 1
    else:
        # the port demotes no tier (ROADMAP D4); its row keeps the JAX key
        assert engines[0].retraces == 0 and rep["demotions"] == 0


def test_wedged_replica_does_not_stall_healthy_pool(pkg, tmp_path):
    """One replica's fetch hangs; the survivor keeps serving the rest."""
    svc, engines = pool_service(pkg, n=2, latency_s=0.02, max_batch=1,
                                replica_max_failures=100)
    svc.start()
    img = u8()
    try:
        for f in [svc.submit(img, img) for _ in range(8)]:
            f.result(timeout=60)
        engines[1].latency_s = 60.0
        futs = [svc.submit(img, img) for _ in range(12)]
        assert wait_until(lambda: sum(
            f.outcome is not None for f in futs) >= 8, timeout=20)
        futs2 = [svc.submit(img, img) for _ in range(4)]
        assert wait_until(lambda: all(
            f.outcome is not None for f in futs2), timeout=20)
        engines[1].latency_s = 0.0
        for f in futs:
            f.result(timeout=60)
    finally:
        engines[1].latency_s = 0.0
        svc.stop(timeout=60)


def test_unported_options_are_refused_by_name():
    """The network plane's options, refused by name before it was ported,
    now work: ``introspect_port`` starts the plane, ``attach_rollout``
    attaches a controller, ``rollout_swap`` swaps a drained replica and
    ``start_rollout`` runs a rollout to COMPLETE.  What stays refused is
    refused by name: ``POST /retrieve`` answers 404."""
    import json
    import urllib.error
    import urllib.request

    from ncnet_tpu_torch.serving import MatchService, ServingConfig

    Fake = make_fake(load("torch"))

    class SwapFake(Fake):
        def __init__(self):
            super().__init__()
            self.swapped = []

        def swap_params(self, params):
            self.swapped.append(params)

    engines = [SwapFake(), SwapFake()]
    svc = MatchService(engine=engines, serving=ServingConfig(
        bucket_multiple=32, max_image_side=64, max_batch=2,
        introspect_port=0)).start()
    try:
        url = svc.introspect_url
        assert url is not None
        with urllib.request.urlopen(url + "/healthz") as r:
            assert r.status == 200 and json.load(r)["state"] == "READY"
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(urllib.request.Request(
                url + "/retrieve", data=b"x", method="POST"))
        assert e.value.code == 404 and b"no /retrieve" in e.value.read()

        marker = object()
        svc.attach_rollout(marker)
        assert svc._rollout is marker
        svc.detach_rollout()

        rep = svc.rollout_replicas()[1]
        assert svc.rollout_drain(rep, 5.0)
        svc.rollout_swap(rep, {"w": 1}, "v1")
        svc.rollout_readmit(rep, reason="test")
        assert engines[1].swapped == [{"w": 1}] and rep.model_version == "v1"

        svc.rollout_loader = lambda c: (c, "v2", None, {"w": 2})
        from ncnet_tpu_torch.serving import RolloutConfig

        ctl = svc.start_rollout("/ckpt/v2", RolloutConfig(canary_min_results=0))
        assert wait_until(lambda: ctl.status()["phase"] == "COMPLETE", 20)
        assert svc.model_version == "v2"
        assert all(r.model_version == "v2" for r in svc.rollout_replicas())
    finally:
        svc.stop(timeout=30)


# ---------------------------------------------------------------------------
# stream sessions (the cases of tests/test_stream_serving.py without a
# device or the network plane)
# ---------------------------------------------------------------------------


def test_stream_table_cap_lru_and_idle_eviction(pkg):
    S = pkg.serving
    tbl = S.StreamTable(max_sessions=2, idle_evict_s=5.0)
    s1, s2 = tbl.acquire("a"), tbl.acquire("b")
    with s1.lock, s2.lock:
        with pytest.raises(S.Overloaded) as e:
            tbl.acquire("c")
        assert e.value.reason == "stream_cap"
    s1.last_activity -= 100.0
    tbl.acquire("c")
    d = tbl.doc()
    assert d["active"] == 2 and d["evicted"] == 1
    assert {r["stream"] for r in d["sessions"]} == {"b", "c"}
    s2.last_activity -= 100.0
    s3 = tbl.acquire("c")
    s3.last_activity -= 100.0
    with s3.lock:
        assert [s.id for s in tbl.evict_idle()] == ["b"]
    tbl.note_frame("tracked")
    tbl.note_frame("cold")
    d = tbl.doc()
    assert d["frames"] == 2 and d["tracked_frames"] == 1 \
        and d["cold_frames"] == 1 and d["evicted"] == 2


def test_stream_session_digest_memo_and_quality_baseline(pkg):
    sess = pkg.serving.StreamSession("x")
    bucket = ((32, 32), (32, 32))
    src, hashes = u8(32, 1), []

    def padded():
        hashes.append(1)
        return src

    d1 = sess.src_digest(src, bucket, padded)
    assert sess.src_digest(src, bucket, padded) == d1 and len(hashes) == 1
    other = u8(32, 2)
    assert sess.src_digest(other, bucket, lambda: other) != d1
    assert sess.src_digest(src, bucket, padded) == d1 and len(hashes) == 2
    from ncnet_tpu.store import content_digest

    assert d1 == content_digest(src)
    assert not sess.quality_collapsed({"score": 0.1}, 0.5)  # no baseline
    for s in (0.8, 0.6, 0.7):
        sess.note_quality({"score": s, "coherence": 0.9})
    assert sess.score_ema == pytest.approx(0.3 * 0.7 + 0.7 * (0.3 * 0.6 + 0.7 * 0.8))
    assert sess.quality_collapsed({"score": 0.3, "coherence": 0.9}, 0.5)
    assert not sess.quality_collapsed({"score": 0.5, "coherence": 0.9}, 0.5)
    sess.reset_tracking()
    assert sess.score_ema is None and sess.prior_ab is None


def test_stream_schedule_matches_jax(pkg):
    from ncnet_tpu.serving import stream_schedule as jschedule

    for kw in (dict(), dict(jitter=0.0, burst_every=0), dict(seed=3)):
        assert pkg.serving.stream_schedule(9, 30.0, **kw) == \
            jschedule(9, 30.0, **kw)


def test_chaos_replica_death_mid_stream_zero_lost(pkg, tmp_path):
    """Streams over a 4-replica fake pool (no tracked capability, so every
    frame is cold); one replica dies mid-stream: every frame serves, and
    the log alone shows each stream's seqs contiguous and in order."""
    S, F = pkg.serving, pkg.faults
    path, sink = logged(pkg, tmp_path)

    class Engine:
        split = staticmethod(S.BatchMatchEngine.split)
        half_precision = False

        def dispatch(self, src, tgt):
            F.device_error_hook("fake_serve")
            return src.shape[0]

        def fetch(self, b):
            table = np.zeros((b, 6, 16), np.float32)
            table[:, 4, :] = 1.0
            table[:, 5, :5] = [0.5, 0.1, 0.4, 0.9, 0.8]
            return table

    with sink:
        svc = S.MatchService(engine=[Engine() for _ in range(4)],
                             serving=S.ServingConfig(
                                 bucket_multiple=32, max_image_side=64,
                                 max_batch=2, replica_max_failures=1,
                                 resurrect_after_s=0.2, max_queue=128,
                                 max_in_flight_per_client=128)).start()
        try:
            frame = lambda si, fi: (u8(32, si), u8(32, 100 + fi))  # noqa: E731
            recs = S.run_stream_load(svc, frame, streams=3, frames=3,
                                     rate_hz=200.0, seed=5)
            F.install(F.FaultPlan(dead_replica_ids=("rep1",)))
            recs += S.run_stream_load(svc, frame, streams=3, frames=4,
                                      rate_hz=200.0, seed=6)
            assert all(r["outcome"] == "result" for r in recs)
            sm = svc.health()["streams"]
            assert sm["frames"] == 21 and sm["active"] == 3
        finally:
            F.clear()
            svc.stop()
    _, events = pkg.events.replay_events(path)
    frames_ev = [e for e in events if e.get("event") == "stream_frame"]
    per = {}
    for e in frames_ev:
        per.setdefault(e["stream"], []).append(e["seq"])
    assert set(per) == {"cam0", "cam1", "cam2"}
    assert all(seqs == list(range(7)) for seqs in per.values())
    assert len(frames_ev) == 21 == len(recs)
    assert all(e["kind"] == "cold" for e in frames_ev)
    assert [e for e in events if e.get("event") == "stream_evict"
            and e["reason"] == "drain"]
