"""The port's program ledger, OOM postmortem, cross-process trace context and
event-log kill seam against the JAX package's
(``ncnet_tpu_torch/observability/{memory,tracing,events}.py``).

Ledger and postmortem cases of ``tests/test_memory.py`` run once with each
package's module (rows recorded explicitly: on the CPU no row is measured,
ROADMAP D9), and must give the same rows, sums and events.  The trace
helpers parse, render and adopt the same headers to the same ids.  An
event log killed mid-append leaves a torn tail that both packages' replay
drop.
"""

import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FAKE_ANALYSIS = {"argument_bytes": 1000, "output_bytes": 200,
                 "temp_bytes": 4096, "generated_code_bytes": 64,
                 "alias_bytes": 0}


def load(name):
    if name == "jax":
        from ncnet_tpu import serving
        from ncnet_tpu.observability import events, memory, tracing
        from ncnet_tpu.utils import faults
    else:
        from ncnet_tpu_torch import serving
        from ncnet_tpu_torch.observability import events, memory, tracing
        from ncnet_tpu_torch.utils import faults
    return types.SimpleNamespace(name=name, mem=memory, events=events,
                                 tracing=tracing, faults=faults,
                                 serving=serving)


@pytest.fixture(params=("jax", "torch"))
def pk(request, monkeypatch):
    p = load(request.param)
    monkeypatch.setenv(p.mem.LEDGER_ENV, "off")
    p.mem._reset_state()
    p.events.set_global_sink(None)
    yield p
    p.mem._reset_state()
    p.events.set_global_sink(None)


def test_ledger_round_trip_with_fake_analysis(pk, tmp_path, monkeypatch):
    mem = pk.mem
    monkeypatch.setenv(mem.LEDGER_ENV, str(tmp_path / "ledger.json"))
    mem._reset_state()
    log = pk.events.EventLog(str(tmp_path / "e.jsonl"))
    with pk.events.bound(log):
        row = mem.record_program("probe_prog", "25x25x25x25|k=5,5,5",
                                 analysis=FAKE_ANALYSIS, tier="resident",
                                 device_kind="NVIDIA H100 80GB HBM3")
    log.close()
    assert row["temp_bytes"] == 4096 and row["total_bytes"] == 5296
    _, evs = pk.events.replay_events(log.path)
    led = [e for e in evs if e["event"] == "memory_ledger"]
    assert len(led) == 1 and led[0]["schema"] == mem.SCHEMA_VERSION == 1
    doc = json.loads((tmp_path / "ledger.json").read_text())
    key = mem.ledger_key("probe_prog", "25x25x25x25|k=5,5,5", "resident",
                         "NVIDIA H100 80GB HBM3")
    assert key == "probe_prog|25x25x25x25|k=5,5,5|resident|NVIDIA H100 80GB HBM3"
    assert doc["rows"][key]["temp_bytes"] == 4096
    # a fresh process replays the file without measuring again
    mem._reset_state()
    calls = []
    log2 = pk.events.EventLog(str(tmp_path / "e2.jsonl"))
    with pk.events.bound(log2):
        row2 = mem.ensure_program(
            "probe_prog", "25x25x25x25|k=5,5,5",
            analyze=lambda: calls.append(1) or FAKE_ANALYSIS,
            tier="resident", device_kind="NVIDIA H100 80GB HBM3")
    log2.close()
    assert calls == [] and row2 == row
    cached = [e for e in pk.events.replay_events(log2.path)[1]
              if e["event"] == "memory_ledger"]
    assert len(cached) == 1 and cached[0]["source"] == "cache"
    mem.ensure_program("probe_prog", "25x25x25x25|k=5,5,5",
                       analyze=lambda: calls.append(1) or FAKE_ANALYSIS,
                       tier="xla", device_kind="NVIDIA H100 80GB HBM3")
    assert calls == [1]


def test_one_ledger_file_for_both_packages(tmp_path, monkeypatch):
    """The port writes the JAX package's file format under the same keys:
    each package replays the rows the other recorded."""
    J, T = load("jax").mem, load("torch").mem
    path = str(tmp_path / "ledger.json")
    monkeypatch.setenv(J.LEDGER_ENV, path)
    for m in (J, T):
        m._reset_state()
    T.record_program("serve_batch", "800x800-800x800xb4",
                     analysis=FAKE_ANALYSIS, tier="coarse2fine",
                     device_kind="gpu")
    J.record_program("serve_batch", "800x800-800x800xb2",
                     analysis=FAKE_ANALYSIS, tier="coarse2fine",
                     device_kind="gpu")
    for m in (J, T):
        m._reset_state()
        rows = [m.ensure_program("serve_batch", f"800x800-800x800xb{b}",
                                 analyze=lambda: None, tier="coarse2fine",
                                 device_kind="gpu") for b in (2, 4)]
        assert all(r is not None and r["temp_bytes"] == 4096 for r in rows)
        m._reset_state()
    monkeypatch.setenv(J.LEDGER_ENV, "off")


def test_predicted_footprint_sums_temp_plus_output(pk):
    mem = pk.mem
    for prog, shape in (("serve_batch", "a"), ("serve_batch", "b"),
                        ("other", "a"), ("serve_batch", "a")):
        mem.record_program(prog, shape, analysis=FAKE_ANALYSIS,
                           device_kind="cpu")
    assert mem.predicted_footprint_bytes(program="serve_batch") \
        == 2 * (4096 + 200)
    assert len(mem.ledger_rows(program="serve_batch")) == 2
    mem.record_program("serve_batch", "a", analysis=FAKE_ANALYSIS,
                       tier="other_tier", device_kind="cpu")
    assert len(mem.ledger_rows(program="serve_batch")) == 2
    mem._reset_state()
    assert mem.predicted_footprint_bytes(program="serve_batch") is None
    assert mem.analysis_dict(None) is None


def test_report_oom_classifies_and_dedupes(pk, tmp_path):
    mem, F = pk.mem, pk.faults
    mem.record_program("serve_batch", "32x32-32x32xb1",
                       analysis=FAKE_ANALYSIS, device_kind="cpu")
    log = pk.events.EventLog(str(tmp_path / "e.jsonl"))
    with pk.events.bound(log):
        exc = F.InjectedDeviceError(
            "RESOURCE_EXHAUSTED: out of memory allocating 56000000 bytes")
        assert mem.report_oom(exc, program="serve_batch", scope="serving")
        assert not mem.report_oom(exc, scope="second_seam")
        assert not mem.report_oom(F.InjectedDeviceError("link reset"),
                                  scope="serving")
        assert not mem.is_oom(OSError("no such file: reading_room_3.mat"))
        # a built-in exception, as torch raises for a CUDA allocation
        # failure, takes no weak reference: the JAX module's WeakSet cannot
        # hold it (its report_oom returns False); the port marks the
        # exception itself and reports it once
        plain = RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB")
        if pk.name == "torch":
            assert mem.report_oom(plain, scope="serving")
            assert not mem.report_oom(plain, scope="serving")
    log.close()
    pm = [e for e in pk.events.replay_events(log.path)[1]
          if e["event"] == "memory_postmortem"]
    assert len(pm) == (2 if pk.name == "torch" else 1)
    assert pm[0]["program"] == "serve_batch"
    assert pm[0]["kind"] == "oom" and "RESOURCE_EXHAUSTED" in pm[0]["error"]
    assert pm[0]["ledger"][0]["program"] == "serve_batch"


def test_serving_oom_emits_exactly_one_postmortem(pk, tmp_path):
    """The first dispatch dies out of memory; the request still serves
    (D4: JAX after its free retry, the port on its retry budget) and
    exactly one postmortem names the replica."""
    mem, F, S = pk.mem, pk.faults, pk.serving
    mem.record_program("serve_batch", "32x32-32x32xb1",
                       analysis=FAKE_ANALYSIS, device_kind="cpu")

    class OOMEngine:
        split = staticmethod(S.BatchMatchEngine.split)
        half_precision = False

        def __init__(self):
            self.dispatches = 0

        def dispatch(self, src, tgt):
            self.dispatches += 1
            if self.dispatches == 1:
                raise F.InjectedDeviceError(
                    "RESOURCE_EXHAUSTED: out of memory while allocating the "
                    "correlation volume")
            return src.shape[0]

        def fetch(self, b):
            table = np.zeros((b, 6, 16), np.float32)
            table[:, 4, :] = 1.0
            return table

        def retrace(self):
            pass

    log = pk.events.EventLog(str(tmp_path / "e.jsonl"))
    img = np.zeros((32, 32, 3), np.uint8)
    with pk.events.bound(log):
        with S.MatchService(engine=OOMEngine(), serving=S.ServingConfig(
                bucket_multiple=32, max_image_side=64, max_batch=2)) as svc:
            assert svc.submit(img, img).result(timeout=30).table.shape[0] == 5
    log.close()
    evs = pk.events.replay_events(log.path)[1]
    pm = [e for e in evs if e["event"] == "memory_postmortem"]
    assert len(pm) == 1 and pm[0]["replica"] == "rep0"
    assert pm[0]["scope"] == "serving" and pm[0]["program"] == "serve_batch"
    assert len([e for e in evs if e["event"] == "serve_result"]) == 1


def test_memory_section_of_the_health_document(pk):
    mem, S = pk.mem, pk.serving
    for b in (1, 2):
        mem.record_program("serve_batch", f"64x64-64x64xb{b}",
                           analysis=FAKE_ANALYSIS, device_kind="cpu")

    class Engine:
        split = staticmethod(S.BatchMatchEngine.split)

        def dispatch(self, s, t):
            return s.shape[0]

        def fetch(self, b):
            return np.zeros((b, 5, 4), np.float32)

    svc = S.MatchService(engine=Engine(), serving=S.ServingConfig())
    doc = svc.health()["memory"]
    assert doc["predicted_ladder_bytes"] == 2 * (4096 + 200)
    assert doc["ledger_programs"] == 2 and doc["hbm"] == {}


# ---------------------------------------------------------------------------
# the cross-process trace context
# ---------------------------------------------------------------------------


def test_trace_helpers_match_jax():
    J, T = load("jax").tracing, load("torch").tracing
    ctx = J.TraceContext("ab" * 16, parent_span=0x2a, origin="host-a-1")
    header = ctx.to_header()
    assert T.TraceContext("ab" * 16, 0x2a, "host-a-1").to_header() == header
    for h in (header, "00-" + "cd" * 16 + "-0-edge", "01-x-0-y", "00--0-x",
              "00-abc-zz-h", "garbage", "", None, 7):
        a, b = J.parse_trace(h), T.parse_trace(h)
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.trace_id, a.parent_span, a.origin) == \
                (b.trace_id, b.parent_span, b.origin)
        assert J.trace_id_of(h) == T.trace_id_of(h)
        assert J.normalize_trace(h) == T.normalize_trace(h)
    for v in (header, "bare-id"):
        assert J.adopt_trace(v, origin="o").trace_id \
            == T.adopt_trace(v, origin="o").trace_id
    fresh = T.adopt_trace(None, origin="o")
    assert len(fresh.trace_id) == 32 and fresh.origin == "o"
    assert T.normalize_trace(fresh) == fresh.trace_id
    with T.span("outer"):
        pass  # unbound: no sink, no cost
    assert T.new_trace().parent_span is None


def test_wall_now_carries_the_injected_skew(tmp_path):
    code = ("import time\nfrom ncnet_tpu_torch.observability import events\n"
            "print(events.wall_now() - time.time())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=_REPO, timeout=120,
                         env=dict(os.environ, NCNET_TPU_CLOCK_SKEW_S="42.5"))
    assert abs(float(out.stdout.strip()) - 42.5) < 1.0, out.stderr
    from ncnet_tpu_torch.observability import events

    log = events.EventLog(str(tmp_path / "e.jsonl"))
    log.emit("x")
    log.close()
    t = events.replay_events(log.path)[1][0]["t"]
    assert abs(t - time.time()) < 60


_KILL_CHILD = """
import sys
sys.path.insert(0, {repo!r})
from ncnet_tpu_torch.observability.events import EventLog

log = EventLog(sys.argv[1])
for i in range(5):
    log.emit("step", i=i)
"""


def test_event_log_killed_mid_append_leaves_a_torn_tail(tmp_path):
    path = str(tmp_path / "e.jsonl")
    child = tmp_path / "child.py"
    child.write_text(_KILL_CHILD.format(repo=_REPO))
    proc = subprocess.run(
        [sys.executable, str(child), path], capture_output=True, text=True,
        timeout=120, env=dict(os.environ,
                              NCNET_TPU_FAULTS='{"kill_at_event_append": 3}'))
    assert proc.returncode == -9, proc.stderr[-2000:]
    raw = open(path).read()
    assert not raw.endswith("\n")  # the torn prefix of the 3rd record
    from ncnet_tpu.observability import events as jevents
    from ncnet_tpu_torch.observability import events as tevents

    for ev in (jevents, tevents):
        _, recs = ev.replay_events(path)
        assert [r["i"] for r in recs] == [0, 1]
    log = tevents.EventLog(path)  # reopening appends after the good bytes
    log.emit("step", i=9)
    log.close()
    assert [r["i"] for r in tevents.replay_events(path)[1]] == [0, 1, 9]
