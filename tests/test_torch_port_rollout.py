"""The port's live rollout (``ncnet_tpu_torch/serving/rollout.py``, the
service's ``rollout_*`` seams, canary routing and DRAINING in
``serving/replica.py``, ``BatchMatchEngine.swap_params``) against the JAX
package's.

The cases of ``tests/test_rollout.py`` run once with each package's
modules (``pkg``) on fake engines: promotion under a stream with zero
lost, a canary quality shift rolled back automatically, a corrupt
candidate refused before any replica (each package's own ``save_params``
and default loader), a SIGKILL mid-swap restarting on the old version, a
mixed-version pod behind a router, and ``POST /rollout``.  Each asserts
the same phase sequence and verdict, so both packages give the same.
Then one rollout of the tiny real model, port against JAX: the same
weights (``params_from_numpy``), a native candidate written by each
package's ``save_params``, tables within the serving tests' fp32 bound
before and after the swap.
"""

import json
import os
import signal
import subprocess
import sys
import time
import types
import urllib.request

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_REPO, "tools"))


from torch_port_tool_twins import both  # noqa: E402

PKGS = ("jax", "torch")
TOL = dict(rtol=1e-4, atol=1e-7)  # the serving tests' fp32 bound


def load(name):
    if name == "jax":
        from ncnet_tpu import ops, serving, store
        from ncnet_tpu.observability import EventLog
        from ncnet_tpu.observability import events
        from ncnet_tpu.serving import rollout
        from ncnet_tpu.utils import faults

        reset = ops.reset_fused_tier_demotions
    else:
        from ncnet_tpu_torch import serving, store
        from ncnet_tpu_torch.observability import EventLog
        from ncnet_tpu_torch.observability import events
        from ncnet_tpu_torch.serving import rollout
        from ncnet_tpu_torch.utils import faults

        def reset():
            pass
    return types.SimpleNamespace(
        name=name, serving=serving, store=store, rollout=rollout,
        faults=faults, events=events, EventLog=EventLog, reset=reset)


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
        """Device stand-in plus the rollout's ``swap_params`` seam."""

        split = staticmethod(p.serving.BatchMatchEngine.split)
        half_precision = False

        def __init__(self, latency_s=0.0):
            self.latency_s = latency_s
            self.swapped = []

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

        def swap_params(self, params):
            self.swapped.append(params)

    return FakeEngine


def pool_service(p, n=4, latency_s=0.02, **over):
    cfg = dict(bucket_multiple=32, max_image_side=64, max_batch=2,
               replica_max_failures=1, resurrect_after_s=0.2,
               model_version="v0", max_queue=128,
               max_in_flight_per_client=128)
    cfg.update(over)
    engines = [make_fake(p)(latency_s=latency_s) for _ in range(n)]
    svc = p.serving.MatchService(
        engine=engines, serving=p.serving.ServingConfig(**cfg)).start()
    svc._model_params = "params-v0"
    return svc, engines


def wait_until(pred, timeout=30.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def drive_stream(p, svc, ctl, *, max_wall_s=120.0):
    """One repeated pair until ``ctl`` is terminal: (futures, sheds, the
    fewest READY replicas seen)."""
    R = p.rollout
    pair = (u8(seed=1), u8(seed=2))
    futs, shed, min_ready = [], 0, 10 ** 9
    deadline = time.monotonic() + max_wall_s
    while ctl.status()["phase"] not in (R.ROLLOUT_COMPLETE,
                                        R.ROLLOUT_ROLLED_BACK,
                                        R.ROLLOUT_IDLE):
        assert time.monotonic() < deadline, ctl.status()["phase"]
        try:
            futs.append(svc.submit(*pair))
        except p.serving.Overloaded as e:
            shed += 1
            time.sleep(min(e.retry_after_s or 0.05, 0.2))
        min_ready = min(min_ready, svc.health()["pool"]["ready"])
        time.sleep(0.005)
    return futs, shed, min_ready


def settle(futs, timeout=60.0):
    results = failures = 0
    for f in futs:
        try:
            f.result(timeout=timeout)
            results += 1
        except Exception:  # noqa: BLE001 — classified failure, not lost
            failures += 1
    return results, failures


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------


def test_rollout_state_pointer_two_phase(pkg, tmp_path):
    R = pkg.rollout
    path = str(tmp_path / "rollout_state.json")
    assert R.resolve_serving_checkpoint(path, "/ckpt/old") == "/ckpt/old"
    assert R.resolve_serving_checkpoint(None, "/ckpt/old") == "/ckpt/old"
    R.write_rollout_state(path, {"current": None, "candidate": "/ckpt/new",
                                 "phase": "STAGING"})
    st = R.read_rollout_state(path)
    assert st["candidate"] == "/ckpt/new" and st["schema"] == 1
    assert R.resolve_serving_checkpoint(path, "/ckpt/old") == "/ckpt/old"
    R.write_rollout_state(path, {"current": "/ckpt/new",
                                 "candidate": "/ckpt/new",
                                 "phase": "COMPLETE"})
    assert R.resolve_serving_checkpoint(path, "/ckpt/old") == "/ckpt/new"
    # the other package reads the same file to the same answer
    other = load("torch" if pkg.name == "jax" else "jax").rollout
    assert other.resolve_serving_checkpoint(path, "/x") == "/ckpt/new"
    with open(path, "w") as f:
        f.write("{nope")
    assert R.resolve_serving_checkpoint(path, "/ckpt/old") == "/ckpt/old"


def test_rollout_illegal_transition_raises(pkg):
    svc, _ = pool_service(pkg, n=2, latency_s=0.0)
    try:
        ctl = pkg.rollout.RolloutController(svc, pkg.rollout.RolloutConfig())
        with pytest.raises(RuntimeError, match="illegal rollout transition"):
            ctl._to(pkg.rollout.ROLLOUT_PROMOTING)
    finally:
        svc.stop(drain=False)


def test_canary_routing_credit_and_draining(pkg):
    """The pool's canary accumulator sends exactly every 1/fraction-th
    decision to the canary; a DRAINING replica gets no traffic and no
    resurrection probe."""
    from importlib import import_module

    rp = import_module(pkg.serving.__name__ + ".replica")
    reps = [rp.Replica(f"rep{i}", make_fake(pkg)()) for i in range(3)]
    pool = rp.ReplicaPool(reps)
    pool.set_canary(reps[2], 0.25)
    picks = [pool.route(max_load=4).id for _ in range(12)]
    assert picks.count("rep2") == 3 and picks[3::4] == ["rep2"] * 3
    pool.clear_canary()
    pool.drain_for_swap(reps[0], "test")
    assert reps[0].state == rp.REPLICA_DRAINING
    assert all(pool.route(max_load=4).id != "rep0" for _ in range(6))
    assert pool.due_probes(time.monotonic() + 100, 0.1) == []
    pool.resurrect(reps[0], reason="test")
    assert reps[0].state == rp.REPLICA_READY


def test_feature_store_gc_keeps_rollback_generation(pkg, tmp_path):
    FS, digest = pkg.store.FeatureStore, pkg.store.content_digest
    arr = u8(seed=3).astype(np.float32)
    d = digest(arr)
    root = str(tmp_path / "fstore")
    now = time.time()
    for i, fp in enumerate(["aaaa1111-s64-k2-f32", "bbbb2222-s64-k2-f32",
                            "cccc3333-s64-k2-f32"]):
        s = FS(root, fp)
        s.put(d, arr)
        s.close()
        os.utime(os.path.join(root, fp), (now - 100 + i, now - 100 + i))
    cur = FS(root, "dddd4444-s64-k2-f32")
    cur.put(d, arr)
    assert cur.gc_superseded(keep_generations=1) == 2
    left = sorted(n for n in os.listdir(root) if not n.startswith("quar"))
    assert left == ["cccc3333-s64-k2-f32", "dddd4444-s64-k2-f32"]
    assert cur.gc_superseded(keep_generations=0) == 1
    cur.close()


# ---------------------------------------------------------------------------
# the chaos chains on fake engines
# ---------------------------------------------------------------------------


def test_rollout_promotes_under_stream_zero_lost(pkg, tmp_path):
    R = pkg.rollout
    log_path = str(tmp_path / "events.jsonl")
    state_path = str(tmp_path / "rollout_state.json")
    with pkg.events.bound(pkg.EventLog(log_path)):
        svc, engines = pool_service(pkg, n=4)
        svc.rollout_loader = lambda cand: (cand, "v1", None, "params-v1")
        try:
            ctl = svc.start_rollout("/ckpt/v1", R.RolloutConfig(
                canary_fraction=0.5, canary_min_results=4,
                canary_timeout_s=60.0, drain_timeout_s=30.0,
                state_path=state_path))
            futs, _, min_ready = drive_stream(pkg, svc, ctl)
            assert wait_until(lambda: not svc._rollout_thread.is_alive())
            st = ctl.status()
            assert st["phase"] == R.ROLLOUT_COMPLETE
            assert svc.model_version == "v1"
            assert all(r.model_version == "v1"
                       for r in svc.rollout_replicas())
            assert all(e.swapped == ["params-v1"] for e in engines)
            results, failures = settle(futs)
            assert results == len(futs) > 0 and failures == 0
            assert min_ready >= 3
            assert st["verdict"]["breach"] is None
            assert st["verdict"]["results"]["old"] >= 4
            assert st["verdict"]["results"]["new"] >= 4
            m = svc.metrics()
            assert m.get("version_results_v1", 0) > 0
            assert m.get("version_results_v0", 0) > 0
            assert R.resolve_serving_checkpoint(state_path, "(old)") \
                == "/ckpt/v1"
        finally:
            svc.stop()
    _, events = pkg.events.replay_events(log_path)
    phases = [e["phase"] for e in events if e.get("event") == "rollout_phase"]
    assert phases == [R.ROLLOUT_STAGING, R.ROLLOUT_CANARY,
                      R.ROLLOUT_PROMOTING, R.ROLLOUT_COMPLETE]
    sec = both("run_report", "build_rollout_section", events)
    assert sec["terminal_phase"] == "COMPLETE"
    assert len(sec["swaps"]) == 4 and sec["swaps_failed"] == 0
    assert not sec["refusals"] and not sec["rollbacks"]
    assert sec["canary_verdicts"][0]["breach"] is None
    assert sec["versions"]["v0"]["failures"] == 0
    assert sec["versions"]["v1"]["failures"] == 0
    serving = both("run_report", "build_serving_section", events)
    assert sorted(serving["results_by_version"]) == ["v0", "v1"]


def test_canary_quality_shift_triggers_auto_rollback(pkg, tmp_path):
    R = pkg.rollout
    log_path = str(tmp_path / "events.jsonl")
    state_path = str(tmp_path / "rollout_state.json")
    with pkg.events.bound(pkg.EventLog(log_path)):
        svc, engines = pool_service(pkg, n=4)
        svc.rollout_loader = lambda cand: (cand, "v1", None, "params-v1")
        try:
            with pkg.faults.injected(pkg.faults.FaultPlan(
                    canary_quality_shift=0.4, canary_shift_version="v1")):
                ctl = svc.start_rollout("/ckpt/v1", R.RolloutConfig(
                    canary_fraction=0.5, canary_min_results=4,
                    canary_timeout_s=60.0, drain_timeout_s=30.0,
                    state_path=state_path))
                futs, _, min_ready = drive_stream(pkg, svc, ctl)
                assert wait_until(
                    lambda: not svc._rollout_thread.is_alive())
            st = ctl.status()
            assert st["phase"] == R.ROLLOUT_ROLLED_BACK
            assert st["verdict"]["breach"].startswith("quality_drift:")
            assert svc.model_version == "v0"
            assert all(r.model_version == "v0"
                       for r in svc.rollout_replicas())
            touched = [e for e in engines if e.swapped]
            assert len(touched) == 1
            assert touched[0].swapped == ["params-v1", "params-v0"]
            results, failures = settle(futs)
            assert results == len(futs) and failures == 0
            assert min_ready >= 3
            assert R.resolve_serving_checkpoint(state_path, "(old)") \
                == "(old)"
            st_file = R.read_rollout_state(state_path)
            assert st_file["current"] is None
            assert st_file["phase"] == R.ROLLOUT_ROLLED_BACK
        finally:
            svc.stop()
    _, events = pkg.events.replay_events(log_path)
    phases = [e["phase"] for e in events if e.get("event") == "rollout_phase"]
    assert phases == [R.ROLLOUT_STAGING, R.ROLLOUT_CANARY,
                      R.ROLLOUT_ROLLING_BACK, R.ROLLOUT_ROLLED_BACK]
    sec = both("run_report", "build_rollout_section", events)
    assert sec["terminal_phase"] == "ROLLED_BACK"
    assert sec["rollbacks"][0]["reason"].startswith("quality_drift:")
    verdict = sec["canary_verdicts"][0]
    assert [s for s, v in verdict["psi"].items()
            if v > verdict["psi_threshold"]]


def tiny_candidate(name, root, seed=0):
    """A native ``step_000050`` of the tiny model under ``root``, written
    by package ``name``'s ``save_params``; returns its config."""
    if name == "jax":
        import warnings

        import jax

        from ncnet_tpu import models
        from ncnet_tpu.config import ModelConfig
        from ncnet_tpu.models.checkpoint import save_params

        cfg = ModelConfig(backbone="tiny", ncons_kernel_sizes=(3,),
                          ncons_channels=(1,))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            params = models.init_ncnet(cfg, jax.random.key(seed))
    else:
        from ncnet_tpu_torch.config import ModelConfig
        from ncnet_tpu_torch.models.checkpoint import save_params
        from ncnet_tpu_torch.models.ncnet import init_ncnet

        cfg = ModelConfig(backbone="tiny", ncons_kernel_sizes=(3,),
                          ncons_channels=(1,))
        params = init_ncnet(cfg, seed=seed)
    save_params(os.path.join(root, "step_000050"), cfg, params)
    return cfg


def test_corrupt_candidate_refused_before_any_replica(pkg, tmp_path):
    R = pkg.rollout
    root = str(tmp_path / "ckpts")
    tiny_candidate(pkg.name, root)
    log_path = str(tmp_path / "events.jsonl")
    svc, engines = pool_service(pkg, n=2, latency_s=0.0)
    try:
        with pkg.events.bound(pkg.EventLog(log_path)), \
                pkg.faults.injected(pkg.faults.FaultPlan(
                    corrupt_candidate_checkpoint="step_000050")):
            ctl = R.RolloutController(svc, R.RolloutConfig(
                state_path=str(tmp_path / "state.json")))
            assert ctl.run(root) == R.ROLLOUT_IDLE
        st = ctl.status()
        assert st["reason"] == "refused:payload_sha_mismatch"
        assert all(e.swapped == [] for e in engines)
        assert all(r.state == "READY" and r.model_version == "v0"
                   for r in svc.rollout_replicas())
        assert svc.health()["state"] == "READY"
        assert R.resolve_serving_checkpoint(
            str(tmp_path / "state.json"), "(old)") == "(old)"
        # unarmed, the same candidate passes the sha gate and loads
        ctl = R.RolloutController(svc, R.RolloutConfig(canary_min_results=0))
        assert ctl.run(root) == R.ROLLOUT_COMPLETE
        assert svc.model_version == "step_000050"
    finally:
        svc.stop(drain=False)
    _, events = pkg.events.replay_events(log_path)
    ref = [e for e in events if e.get("event") == "rollout_refused"]
    assert len(ref) == 1 and ref[0]["reason"] == "payload_sha_mismatch"
    phases = [e["phase"] for e in events if e.get("event") == "rollout_phase"]
    assert phases == [R.ROLLOUT_STAGING, R.ROLLOUT_IDLE]


_KILL_CHILD = """
import sys, time
sys.path.insert(0, {repo!r})
import numpy as np
from {pkg}.serving import BatchMatchEngine, MatchService, ServingConfig
from {pkg}.serving.rollout import RolloutConfig, RolloutController

class FakeEngine:
    split = staticmethod(BatchMatchEngine.split)
    half_precision = False
    def dispatch(self, src, tgt):
        return (src.shape[0], time.monotonic())
    def fetch(self, handle):
        b, _ = handle
        t = np.zeros((b, 6, 16), np.float32)
        t[:, 4, :] = 1.0
        return t
    def retrace(self):
        pass
    def swap_params(self, params):
        pass

svc = MatchService(
    engine=[FakeEngine(), FakeEngine()],
    serving=ServingConfig(bucket_multiple=32, max_image_side=32,
                          max_batch=1, model_version="v0")).start()
ctl = RolloutController(
    svc, RolloutConfig(state_path=sys.argv[1], canary_min_results=0),
    loader=lambda cand: (cand, "v1", None, "params-v1"))
ctl.run("/ckpt/new")  # NCNET_TPU_FAULTS kills us inside the first swap
sys.stdout.write("SURVIVED\\n")
"""


def test_sigkill_mid_swap_recovers_on_old_version(pkg, tmp_path):
    R = pkg.rollout
    state_path = str(tmp_path / "rollout_state.json")
    child = tmp_path / "child.py"
    child.write_text(_KILL_CHILD.format(
        repo=_REPO, pkg="ncnet_tpu" if pkg.name == "jax" else "ncnet_tpu_torch"))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               NCNET_TPU_PERF_STORE="off", NCNET_TPU_TIER_CACHE="off",
               NCNET_TPU_FAULTS='{"kill_at_weight_swap": 1}')
    proc = subprocess.run([sys.executable, str(child), state_path],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == -signal.SIGKILL, \
        (proc.returncode, proc.stdout[-2000:], proc.stderr[-2000:])
    assert "SURVIVED" not in proc.stdout
    st = R.read_rollout_state(state_path)
    assert st is not None and st["candidate"] == "/ckpt/new"
    assert st.get("current") is None and st["phase"] == R.ROLLOUT_STAGING
    assert R.resolve_serving_checkpoint(state_path, "/ckpt/old") \
        == "/ckpt/old"


def test_router_reports_mixed_version_pod_and_post_rollout(pkg):
    """A router keeps routing a mixed-version pod and says so; the second
    backend was rolled out over ``POST /rollout``."""
    R = pkg.rollout
    svc_a, _ = pool_service(pkg, n=2, latency_s=0.0, introspect_port=0)
    svc_b, _ = pool_service(pkg, n=2, latency_s=0.0, introspect_port=0)
    svc_b.rollout_loader = lambda cand: (cand, "v1", None, "params-v1")
    router = None
    try:
        req = urllib.request.Request(
            svc_b.introspect_url + "/rollout", method="POST",
            data=json.dumps({"checkpoint": "/ckpt/v1",
                             "canary_min_results": 0}).encode())
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 202
        assert wait_until(lambda: svc_b.model_version == "v1")
        with urllib.request.urlopen(svc_b.introspect_url + "/rollout") as r:
            assert json.load(r)["phase"] == R.ROLLOUT_COMPLETE
        router = pkg.serving.MatchRouter(
            [svc_a.introspect_url, svc_b.introspect_url],
            pkg.serving.RouterConfig(probe_period_s=0.1,
                                     resurrect_after_s=0.3,
                                     backend_max_failures=2)).start()
        assert wait_until(
            lambda: router.health()["pod"]["model_versions"] == ["v0", "v1"])
        fut = router.submit(u8(seed=4), u8(seed=5))
        assert fut.result(timeout=60).table is not None
    finally:
        if router is not None:
            router.stop()
        svc_a.stop(drain=False)
        svc_b.stop(drain=False)


# ---------------------------------------------------------------------------
# the tiny real model: one rollout, port against JAX
# ---------------------------------------------------------------------------


SIDE = 64


def pair(i):
    src = np.random.default_rng(200 + i).integers(0, 256, (SIDE, SIDE, 3),
                                                  dtype=np.uint8)
    return src, np.roll(src, (16, 16), axis=(0, 1))


def tiny_rollout(name, cfg, params, root):
    """Serve 2 pairs, roll out to ``root``'s candidate (judging skipped),
    serve them again; (tables before, tables after, phases, version)."""
    p = load(name)
    S = p.serving
    kw = dict(bucket_multiple=32, max_image_side=SIDE, max_batch=1,
              replicas=2, warm_buckets=((SIDE, SIDE),))
    if name == "jax":
        svc = S.MatchService(cfg, params, S.ServingConfig(**kw))
    else:
        svc = S.MatchService(cfg, params, S.ServingConfig(**kw),
                             devices=["cpu"] * 2)
    svc.start()
    try:
        before = [svc.submit(*pair(i)).result(timeout=300).table
                  for i in range(2)]
        ctl = p.rollout.RolloutController(
            svc, p.rollout.RolloutConfig(canary_min_results=0))
        phase = ctl.run(root)
        after = [svc.submit(*pair(i)).result(timeout=300).table
                 for i in range(2)]
        versions = {r.model_version for r in svc.rollout_replicas()}
        return before, after, phase, svc.model_version, versions
    finally:
        svc.stop(timeout=120)


def test_tiny_model_rollout_port_against_jax(tmp_path):
    import jax

    from ncnet_tpu import config as jcfg
    from ncnet_tpu.models import ncnet as jnet
    from ncnet_tpu.models.checkpoint import save_params as jsave
    from ncnet_tpu_torch import config as tcfg
    from ncnet_tpu_torch.models.checkpoint import save_params as tsave
    from ncnet_tpu_torch.models.convert import params_from_numpy

    kw = dict(backbone="tiny", ncons_kernel_sizes=(3,), ncons_channels=(1,))
    jc, tc = jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)
    old = jnet.init_ncnet(jc, jax.random.key(3))
    new = jnet.init_ncnet(jc, jax.random.key(4))
    as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    jsave(str(tmp_path / "jax" / "step_000050"), jc, new)
    tsave(str(tmp_path / "torch" / "step_000050"), tc,
          params_from_numpy(as_np(new)))
    jb, ja, jphase, jver, jvers = tiny_rollout(
        "jax", jc, old, str(tmp_path / "jax"))
    tb, ta, tphase, tver, tvers = tiny_rollout(
        "torch", tc, params_from_numpy(as_np(old)), str(tmp_path / "torch"))
    assert jphase == tphase == "COMPLETE"
    assert jver == tver == "step_000050"
    assert jvers == tvers == {"step_000050"}
    for j, t in zip(jb + ja, tb + ta):
        assert j.shape == t.shape
        np.testing.assert_allclose(t, j, **TOL)
    # the swap changed the answer (new weights really served)
    assert any(not np.array_equal(a, b) for a, b in zip(tb, ta))
