"""The port's operator tools (``ncnet_tpu_torch/tools/{run_report,
trace_export,stall_watchdog,perf_regress,quality_drift,serve_top,
rollout}.py``) against the JAX package's root ``tools/``.

Each tool reads records that EACH package writes (event logs with a
SIGKILLed span and a torn tail, heartbeats, perf stores, quality events, a
live service's ``/healthz`` and ``/metrics``), and the two tools must give
the same answer: the same report dicts and text, trace documents,
watchdog verdicts and exit codes, regression and drift findings, written
reference records and ``serve_top`` frames; the rollout tool drives one
port CPU service to COMPLETE (exit 0) and ROLLED_BACK (exit 2) beside the
JAX tool watching the same rollout.  ``perf_regress --seed`` refuses an
artefact it cannot read as the JAX tool does (its agreement on the
committed artefacts is in ``test_torch_port_bench.py``), and the port's
synthetic quality reference
run (``quality_drift --synthetic``) gates itself green and its perturbed
twin red on the CPU.
"""

import importlib
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest

from torch_port_tool_twins import (
    REPO,
    canon,
    jax_tool,
    port_tool,
    same,
    without_ages,
)

PKGS = ("ncnet_tpu", "ncnet_tpu_torch")


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def tools(name):
    return jax_tool(name), port_tool(name)


def run_main(tool, argv):
    """``tool.main(argv)`` → (exit code, stdout, stderr).  A tool that
    bound ``sys.stdout.write`` at import (``_out``, ``_err``) writes
    through the bound method, so those are pointed at the capture too."""
    out, err = io.StringIO(), io.StringIO()
    bound = {k: getattr(tool, k) for k in ("_out", "_err")
             if getattr(getattr(tool, k, None), "__name__", "") == "write"}
    for k, stream in (("_out", out), ("_err", err)):
        if k in bound:
            setattr(tool, k, stream.write)
    try:
        with redirect_stdout(out), redirect_stderr(err):
            rc = tool.main(argv)
    finally:
        for k, v in bound.items():
            setattr(tool, k, v)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(autouse=True)
def _no_sink():
    for pkg in PKGS:
        mod(pkg, "observability.events").set_global_sink(None)
        mod(pkg, "utils.faults").clear()
    yield
    for pkg in PKGS:
        mod(pkg, "observability.events").set_global_sink(None)
        mod(pkg, "utils.faults").clear()


# ---------------------------------------------------------------------------
# records each package writes
# ---------------------------------------------------------------------------


def fake_service(pkg, n=2, latency_s=0.01, **over):
    """A service of ``pkg`` on its ``serve_backend`` fake engines."""
    S = mod(pkg, "serving")
    fake = (jax_tool("serve_backend") if pkg == "ncnet_tpu"
            else port_tool("serve_backend")).FakeEngine
    cfg = dict(bucket_multiple=32, max_image_side=64, max_batch=2,
               max_queue=64, max_in_flight_per_client=64)
    cfg.update(over)
    return S.MatchService(engine=[fake(latency_s=latency_s)
                                  for _ in range(n)],
                          serving=S.ServingConfig(**cfg))


def u8(seed, side=32):
    return np.random.default_rng(seed).integers(
        0, 255, (side, side, 3), dtype=np.uint8)


def write_run_log(pkg, path, seed=0):
    """A run's event log written through ``pkg``'s modules: seeded training
    steps under nested spans (one raising), the failure accounting, tier
    and checkpoint events, eval batches, quality events of two tiers, then
    a served burst of a fake-engine service."""
    ev = mod(pkg, "observability.events")
    tr = mod(pkg, "observability.tracing")
    q = mod(pkg, "observability.quality")
    rng = np.random.default_rng(seed)
    log = ev.EventLog(path, run_meta={"fit": "synthetic", "seed": seed})
    with ev.bound(log):
        log.emit("run_start", envelope=ev.run_envelope(log.run_id))
        ev.emit("tier_selected", tier="fft", stage="forward",
                shape=[4, 25, 25, 25, 25])
        for step in range(12):
            with tr.span("train_step", step=step):
                with tr.span("dispatch"):
                    pass
                with tr.span("fetch"):
                    pass
            ev.emit("step", step=step, epoch=step // 6,
                    wall_s=float(rng.uniform(0.3, 0.5)),
                    stage_wall_s=float(rng.uniform(0.01, 0.05)),
                    pairs_per_s=float(rng.uniform(30, 40)),
                    mfu_pct=float(rng.uniform(20, 30)),
                    loss=float(rng.normal()), grad_norm=float(rng.uniform()))
            if step == 5:
                ev.emit("epoch_end", epoch=0, step=step)
                ev.emit("checkpoint_commit", step=step, epoch=0, best=True,
                        path="ckpt/step_000005")
        try:
            with tr.span("save"):
                raise OSError("disk full")
        except OSError:
            pass
        ev.emit("nan_skip", step=7, streak=1)
        ev.emit("retry", kind="io", attempt=1, scope="checkpoint")
        ev.emit("quarantine", unit="batch3", kind="decode", attempts=2,
                scope="eval")
        ev.emit("tier_demoted", tier="resident", stage="forward",
                demoted=True)
        for b in range(3):
            ev.emit("eval_batch", batch=b,
                    wall_s=float(rng.uniform(0.04, 0.06)))
        for tier in ("xla", "coarse2fine"):
            for unit in range(4):
                sig = {s: rng.uniform(0.2, 0.9, 6)
                       for s in q.QUALITY_SIGNALS}
                q.emit_quality("pf_pascal_eval", sig, tier=tier,
                               pck=rng.uniform(0, 1, 6), batch=unit)
        svc = fake_service(pkg).start()
        try:
            futs = [svc.submit(u8(i), u8(i + 1)) for i in range(6)]
            for f in futs:
                f.result(timeout=60)
        finally:
            svc.stop()
    log.close()


KILLED_SPAN = """
import os, signal, sys
from {pkg}.observability import events as ev
from {pkg}.observability import tracing as tr
log = ev.EventLog(sys.argv[1])
with ev.bound(log):
    ev.emit("resume", checkpoint="ckpt/step_000005", epoch=1, batch=0,
            step=12)
    with tr.span("train_step", step=12):
        ev.emit("step", step=12, wall_s=0.4)
        os.kill(os.getpid(), signal.SIGKILL)
"""


def kill_mid_span(pkg, path):
    """A resumed run of ``pkg`` SIGKILLed inside a span, then a torn
    trailing line, as a dying writer leaves them."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", KILLED_SPAN.format(pkg=pkg),
                        path], env=env, cwd=REPO, timeout=240)
    assert r.returncode == -signal.SIGKILL
    with open(path, "ab") as f:
        f.write(b'{"event": "step", "step": 13, "wall_s": 0.')


@pytest.fixture(scope="module")
def run_logs(tmp_path_factory):
    """``{pkg: events.jsonl}``: each package's run, killed and torn."""
    out = {}
    for pkg in PKGS:
        path = str(tmp_path_factory.mktemp(pkg) / "events.jsonl")
        write_run_log(pkg, path, seed=3)
        kill_mid_span(pkg, path)
        out[pkg] = path
    return out


# ---------------------------------------------------------------------------
# run_report, trace_export
# ---------------------------------------------------------------------------


RENDERERS = ("render_text", "render_spans", "render_quality",
             "render_serving", "render_memory", "render_pod",
             "render_retrieval", "render_rollout", "render_slo",
             "render_store")


@pytest.mark.parametrize("writer", PKGS)
def test_run_report_agrees(writer, run_logs):
    jr, tr_ = tools("run_report")
    paths = [run_logs[writer]]
    ref = str(os.path.join(os.path.dirname(paths[0]), "no_ref.jsonl"))
    want = jr.build_report(paths, quality_ref=ref)
    got = tr_.build_report(paths, quality_ref=ref)
    assert canon(got) == canon(want)
    # the SIGKILLed span is counted unclosed, the torn tail dropped
    assert got["spans"]["unclosed"] == 1
    assert got["counts"]["steps"] == 13 and got["counts"]["resumes"] == 1
    assert got["serving"]["outcomes"]["results"] == 6
    for name in RENDERERS:
        assert getattr(tr_, name)(got) == getattr(jr, name)(want), name
    events = []
    for p in paths:
        events += mod(writer, "observability.events").replay_events(p)[1]
    for name in ("build_span_breakdown", "build_serving_section",
                 "build_slo_section", "build_router_section",
                 "build_pod_section", "build_rollout_section",
                 "build_memory_section", "build_store_section",
                 "build_retrieval_section"):
        assert same(getattr(tr_, name)(events), getattr(jr, name)(events)), \
            name
    for flags in ([], ["--spans", "--quality", "--serving", "--rollout",
                       "--memory", "--pod", "--retrieval", "--slo",
                       "--store", "--quality-ref", ref], ["--json"]):
        assert run_main(tr_, paths + flags) == run_main(jr, paths + flags)


@pytest.mark.parametrize("writer", PKGS)
def test_trace_export_agrees(writer, run_logs, tmp_path):
    je, te = tools("trace_export")
    paths = [run_logs[writer]]
    doc = te.build_trace(paths)
    assert canon(doc) == canon(je.build_trace(paths))
    assert any(e.get("ph") == "X" for e in doc["traceEvents"])
    outs = []
    for tool, name in ((je, "jax"), (te, "port")):
        out = str(tmp_path / f"{name}.trace.json")
        rc, _, _ = run_main(tool, paths + ["-o", out])
        assert rc == 0
        with open(out, "rb") as f:
            outs.append(f.read())
    assert outs[0] == outs[1]


def test_federated_trace_of_both_packages_agrees(run_logs):
    """Two runs with no clock_sync between them: the same document and the
    same warning that they stay unaligned."""
    je, te = tools("trace_export")
    paths = [run_logs[p] for p in PKGS]
    wj, wt = [], []
    doc = te.build_federated_trace(paths, warn=wt.append)
    assert canon(doc) == canon(je.build_federated_trace(paths, warn=wj.append))
    assert wt == wj and len(wt) == 1 and "UNALIGNED" in wt[0]
    assert len(doc["otherData"]["federation"]["unaligned"]) >= 1


# ---------------------------------------------------------------------------
# stall_watchdog
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", PKGS)
def test_stall_watchdog_heartbeat_agrees(writer, run_logs, tmp_path,
                                         monkeypatch):
    jw, tw = tools("stall_watchdog")
    hb_path = str(tmp_path / "heartbeat.json")
    mod(writer, "observability.device").Heartbeat(
        hb_path, run_id="r0").beat(step=12, epoch=1)
    t_beat = 1_800_000_000.0
    os.utime(hb_path, (t_beat, t_beat))
    monkeypatch.setattr(time, "time", lambda: t_beat + 30.0)
    events = run_logs[writer]
    for kw in (dict(min_age=60.0), dict(min_age=0.0), dict(factor=1.0,
                                                           min_age=1.0)):
        v = tw.judge(hb_path, events_path=events, **kw)
        assert same(v, jw.judge(hb_path, events_path=events, **kw))
    assert tw.judge(hb_path, events_path=events)["status"] == "alive"
    cases = {(): 0, ("--min-age", "0"): 3}
    for flags, code in cases.items():
        for extra in ([], ["--json"]):
            argv = [hb_path, "--events", events, *flags, *extra]
            got = run_main(tw, argv)
            assert got == run_main(jw, argv) and got[0] == code
    missing = [str(tmp_path / "none.json")]
    assert run_main(tw, missing) == run_main(jw, missing)
    assert run_main(tw, missing)[0] == 2


@pytest.mark.parametrize("writer", PKGS)
def test_stall_watchdog_url_and_pod_agree(writer, run_logs):
    jw, tw = tools("stall_watchdog")
    svc = fake_service(writer, introspect_port=0).start()
    dead = "http://127.0.0.1:9"
    try:
        svc.submit(u8(1), u8(2)).result(timeout=60)
        url = svc.introspect_url
        vj = jw.judge_url(url, events_path=run_logs[writer])
        vt = tw.judge_url(url, events_path=run_logs[writer])
        assert vt["status"] == vj["status"] == "alive"
        assert canon(without_ages(vt)) == canon(without_ages(vj))
        pj, pt = (t.judge_pod([url, dead]) for t in (jw, tw))
        assert pt["status"] == pj["status"] == "missing"
        assert canon(without_ages(pt)) == canon(without_ages(pj))
        assert tw.render_pod_table(pj) == jw.render_pod_table(pj)
        for argv, code in ((["--url", url], 0),
                           (["--url", url, "--min-age", "0",
                             "--factor", "0"], None),
                           (["--url", url, "--url", dead], 2)):
            rt, rj = run_main(tw, argv)[0], run_main(jw, argv)[0]
            assert rt == rj and (code is None or rt == code)
    finally:
        svc.stop()


# ---------------------------------------------------------------------------
# perf_regress
# ---------------------------------------------------------------------------


def write_store(pkg, path, seed, regress):
    """A perf history written through ``pkg``'s ``PerfStore``: gated and
    report-only series on two device kinds, the newest value of one a
    regression when ``regress``."""
    ps = mod(pkg, "observability.perfstore")
    store = ps.PerfStore(path)
    rng = np.random.default_rng(seed)
    for i in range(10):
        for kind in ("NVIDIA H100 80GB HBM3", "cpu"):
            last = i == 9
            wall = 400.0 + rng.normal(0, 4)
            if last and regress and kind == "cpu":
                wall *= 1.5
            store.append_many(
                {"train_step_ms": wall, "eval_pck": 0.8 + rng.normal(0, 0.01),
                 "mfu_pct": 30 + rng.normal(), "serve_p95_ms": 120 + i},
                device_kind=kind, git_rev=f"r{i}", source="fit",
                t=1_700_000_000.0 + i)
    return store


@pytest.mark.parametrize("writer", PKGS)
@pytest.mark.parametrize("regress", [False, True])
def test_perf_regress_check_agrees(writer, regress, tmp_path):
    jp, tp = tools("perf_regress")
    path = str(tmp_path / "history.jsonl")
    store = write_store(writer, path, 5, regress)
    want_code = 1 if regress else 0
    for extra in ([], ["--json"], ["--device-kind", "cpu"],
                  ["--metrics", "train_step_ms,mfu_pct", "--window", "4"]):
        argv = ["--check", "--store", path, *extra]
        got = run_main(tp, argv)
        assert got == run_main(jp, argv)
        if not extra or extra == ["--json"]:
            assert got[0] == want_code
    # the tool's findings are check_regressions' own
    _, out, _ = run_main(tp, ["--check", "--store", path, "--json"])
    direct = mod("ncnet_tpu_torch", "observability.perfstore"). \
        check_regressions(store.records())
    assert json.loads(out)["findings"] == json.loads(canon(direct))
    assert any(f["status"] == "skipped" or f["status"] == "ok"
               for f in direct)


def test_perf_regress_seed_is_refused_naming_a13(tmp_path):
    """``--seed`` was refused until the port's bench (A13) existed; now it
    ingests, and what it refuses is an artefact it cannot read: exit 2
    naming the file, nothing written, as the JAX tool does.  Without
    ``--seed`` or ``--check`` both tools exit 2 naming the flags."""
    jp, tp = tools("perf_regress")
    missing = str(tmp_path / "BENCH_missing.json")
    torn = tmp_path / "BENCH_torn.json"
    torn.write_text('{"metric": "pf_pascal_forward_ms_per_pair", "val')
    for bad in (missing, str(torn)):
        codes = []
        for tool, name in ((jp, "jax"), (tp, "port")):
            path = str(tmp_path / f"history_{name}.jsonl")
            rc, out, err = run_main(tool, ["--seed", os.path.join(
                REPO, "BENCH_r01.json"), bad, "--store", path, "--check"])
            assert rc == 2 and out == "" and f"cannot ingest {bad}" in err
            codes.append(rc)
        assert codes == [2, 2]
    path = str(tmp_path / "history_none.jsonl")
    for tool in (jp, tp):
        rc, _, err = run_main(tool, ["--store", path])
        assert rc == 2 and "--seed" in err and "--check" in err
    assert not os.path.exists(path)


# ---------------------------------------------------------------------------
# quality_drift
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", PKGS)
def test_quality_drift_agrees(writer, run_logs, tmp_path):
    jq, tq = tools("quality_drift")
    log = run_logs[writer]
    refs = {}
    for name, tool in (("jax", jq), ("port", tq)):
        refs[name] = str(tmp_path / f"ref_{name}.jsonl")
        rc, _, _ = run_main(tool, ["--seed-ref", log, "--ref", refs[name]])
        assert rc == 0
    with open(refs["jax"], "rb") as a, open(refs["port"], "rb") as b:
        assert a.read() == b.read()
    bad = str(tmp_path / "perturbed.jsonl")
    tq.perturbed_log(log, bad)
    for logs, code in (([log], 0), ([bad], 1)):
        for extra in ([], ["--json"]):
            argv = ["--check", *logs, "--ref", refs["port"], *extra]
            got = run_main(tq, argv)
            assert got == run_main(jq, argv) and got[0] == code
    # a reference written from the perturbed log flags the clean one
    red = str(tmp_path / "ref_red.jsonl")
    assert run_main(tq, ["--seed-ref", bad, "--ref", red])[0] == 0
    argv = ["--check", log, "--ref", red]
    assert run_main(tq, argv) == run_main(jq, argv)
    assert run_main(tq, argv)[0] == 1
    # the committed reference holds no series of the card's kind: every
    # series of a run on the card is skipped, as the JAX tool reports it
    card = str(tmp_path / "card.jsonl")
    with open(log) as f, open(card, "w") as g:
        head = json.loads(f.readline())
        head["header"]["device_kind"] = "NVIDIA H100 80GB HBM3"
        g.write(json.dumps(head) + "\n" + f.read())
    argv = ["--check", card, "--json"]
    got = run_main(tq, argv)
    assert got == run_main(jq, argv) and got[0] == 0
    assert {f["status"] for f in json.loads(got[1])["findings"]} \
        <= {"skipped"}
    # no quality events: an input error, not a clean run
    empty = str(tmp_path / "empty.jsonl")
    with open(empty, "w") as f:
        f.write('{"event": "step", "step": 0}\n')
    argv = ["--check", empty, "--ref", refs["port"]]
    assert run_main(tq, argv)[0] == run_main(jq, argv)[0] == 2


def test_quality_drift_synthetic_run_gates_itself(tmp_path):
    """The port's pinned synthetic eval on the CPU: a reference seeded from
    it judges a rerun green and the perturbed run red."""
    tq = port_tool("quality_drift")
    stats, log = tq.synthetic_reference_run(str(tmp_path / "a"),
                                            device="cpu")
    assert stats["total"] == tq.SYNTH_PAIRS
    pck = np.asarray(stats["per_pair"], dtype=float)
    confident = tq.SYNTH_PAIRS - tq.SYNTH_SCRAMBLED
    assert pck[:confident].mean() > pck[confident:].mean()
    ref = str(tmp_path / "ref.jsonl")
    assert run_main(tq, ["--seed-ref", log, "--ref", ref])[0] == 0
    _, log2 = tq.synthetic_reference_run(str(tmp_path / "b"), device="cpu")
    assert run_main(tq, ["--check", log2, "--ref", ref])[0] == 0
    _, log3 = tq.synthetic_reference_run(str(tmp_path / "c"), perturb=True,
                                         device="cpu")
    rc, out, _ = run_main(tq, ["--check", log3, "--ref", ref])
    assert rc == 1 and "DRIFT" in out


# ---------------------------------------------------------------------------
# serve_top
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", PKGS)
def test_serve_top_frames_and_exit_codes_agree(writer):
    js, ts = tools("serve_top")
    svc = fake_service(writer, introspect_port=0).start()
    other = fake_service(writer, introspect_port=0).start()
    dead = "http://127.0.0.1:9"
    try:
        for f in [svc.submit(u8(i), u8(i + 1)) for i in range(5)]:
            f.result(timeout=60)
        url = svc.introspect_url
        health, fams, err = ts.fetch(url)
        assert err is None
        assert ts.render_frame(health, fams, url) == \
            js.render_frame(health, fams, url)
        assert "state: READY" in ts.render_frame(health, fams, url)
        per_host = [(url, health, fams, None),
                    (dead, None, None, "URLError: refused")]
        merged = ts.merge_pod_metrics([(b, f) for b, _, f, _ in per_host])
        assert same(merged, js.merge_pod_metrics(
            [(b, f) for b, _, f, _ in per_host]))
        assert ts.render_pod_frame(per_host, merged) == \
            js.render_pod_frame(per_host, merged)
        for argv, code in (([url, "--once"], 0), ([dead, "--once"], 2),
                           (["--pod", url, other.introspect_url, "--once"],
                            0),
                           (["--pod", url, dead, "--once"], 2)):
            rt, rj = run_main(ts, argv)[0], run_main(js, argv)[0]
            assert rt == rj == code, argv
    finally:
        svc.stop()
        other.stop()


# ---------------------------------------------------------------------------
# rollout
# ---------------------------------------------------------------------------


def rollout_service():
    """A port CPU service of four fake replicas that take weight swaps,
    with a test loader: the candidate ``/ckpt/v1`` loads as version
    ``v1``."""
    S = mod("ncnet_tpu_torch", "serving")

    class SwappingEngine(port_tool("serve_backend").FakeEngine):
        def swap_params(self, params):
            self.params = params

    svc = S.MatchService(
        engine=[SwappingEngine(latency_s=0.02) for _ in range(4)],
        serving=S.ServingConfig(
            bucket_multiple=32, max_image_side=64, max_batch=2,
            introspect_port=0, replica_max_failures=1,
            resurrect_after_s=0.2, model_version="v0", max_queue=128,
            max_in_flight_per_client=128))
    svc.start()
    svc._model_params = "params-v0"
    svc.rollout_loader = lambda cand: (cand, "v1", None, "params-v1")
    return svc


@pytest.mark.parametrize("shift,phase,code", [
    (0.0, "COMPLETE", 0), (0.4, "ROLLED_BACK", 2)])
def test_rollout_tool_drives_a_port_service(shift, phase, code,
                                            monkeypatch):
    """The port's tool POSTs the rollout and watches it to its terminal
    phase while the JAX tool watches the same rollout: the same final
    document and exit code."""
    jr, tr_ = tools("rollout")
    faults = mod("ncnet_tpu_torch", "utils.faults")
    lines = {"port": [], "jax": []}
    monkeypatch.setattr(tr_, "_out", lines["port"].append)
    monkeypatch.setattr(jr, "_out", lines["jax"].append)
    svc = rollout_service()
    url = svc.introspect_url
    codes, done = {}, threading.Event()

    def port_run():
        codes["port"] = tr_.main([
            url, "/ckpt/v1", "--canary-fraction", "0.5",
            "--canary-min-results", "4", "--canary-timeout-s", "60",
            "--drain-timeout-s", "30", "--poll", "0.02",
            "--timeout", "120"])
        done.set()

    def jax_watch():
        codes["jax"] = jr.main([url, "--watch", "--poll", "0.02",
                                "--timeout", "120"])

    try:
        with faults.injected(faults.FaultPlan(
                canary_quality_shift=shift, canary_shift_version="v1")):
            t_port = threading.Thread(target=port_run)
            t_port.start()
            deadline = time.monotonic() + 60
            while svc._rollout is None and time.monotonic() < deadline:
                time.sleep(0.01)
            t_jax = threading.Thread(target=jax_watch)
            t_jax.start()
            pair = (u8(1), u8(2))
            futs = []
            while not done.wait(0.005):
                try:
                    futs.append(svc.submit(*pair))
                except mod("ncnet_tpu_torch", "serving").Overloaded:
                    time.sleep(0.05)
                assert time.monotonic() < deadline + 120
            t_port.join()
            t_jax.join(timeout=130)
        for f in futs:
            f.result(timeout=60)
        assert codes["port"] == codes["jax"] == code, lines
        assert f"-> {phase}" in "\n".join(lines["port"])
        assert f"-> {phase}" in "\n".join(lines["jax"])
        assert lines["port"][-1] == lines["jax"][-1]
        st_t = tr_.watch(url, 0.02, 10.0)
        st_j = jr.watch(url, 0.02, 10.0)
        assert st_t["phase"] == phase and same(st_t, st_j)
        assert svc.model_version == ("v1" if code == 0 else "v0")
    finally:
        svc.stop()


def test_rollout_refusal_and_unreachable_exit_1():
    jr, tr_ = tools("rollout")
    svc = fake_service("ncnet_tpu_torch", introspect_port=0).start()
    try:
        # no model to roll out from: the service refuses the POST
        for argv in ([svc.introspect_url, "/ckpt/v1", "--timeout", "5"],
                     ["http://127.0.0.1:9", "/ckpt/v1", "--timeout", "1"]):
            rt, rj = run_main(tr_, argv)[0], run_main(jr, argv)[0]
            assert rt == rj == 1
    finally:
        svc.stop()
