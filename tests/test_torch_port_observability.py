"""The port's observability core and host utils against the JAX package's,
on the same calls: the event log (header, lines, replay, torn tails, the
global sink), the leveled logger, the metrics registry, span tracing,
the perf store and its regression check, the run envelope
without CUDA, ``utils/seeding`` and ``utils/io``.

The port keeps the JAX package's on-disk formats, so each package's reader
is also run on the other's files.  Everything compared is exact (the same
Python arithmetic on the same values) except wall-clock fields, which are
checked for presence and order only.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from ncnet_tpu.observability import events as j_events
from ncnet_tpu.observability import logging as j_logging
from ncnet_tpu.observability import metrics as j_metrics
from ncnet_tpu.observability import perfstore as j_perf
from ncnet_tpu.utils import io as j_io
from ncnet_tpu.utils import seeding as j_seeding
from ncnet_tpu_torch.observability import events as t_events
from ncnet_tpu_torch.observability import logging as t_logging
from ncnet_tpu_torch.observability import metrics as t_metrics
from ncnet_tpu_torch.observability import perfstore as t_perf
from ncnet_tpu_torch.observability import tracing as t_tracing
from ncnet_tpu_torch.utils import io as t_io
from ncnet_tpu_torch.utils import seeding as t_seeding

EVENTS = {"port": t_events, "jax": j_events}


@pytest.fixture(autouse=True)
def _unbound_sinks():
    """No test leaks a global sink into another (in either package)."""
    for mod in EVENTS.values():
        mod.set_global_sink(None)
    yield
    for mod in EVENTS.values():
        mod.set_global_sink(None)


# ---------------------------------------------------------------------------
# event log
# ---------------------------------------------------------------------------


def write_log(mod, path):
    with mod.EventLog(path, run_meta={"note": "t"}) as log:
        log.emit("step", step=1, loss=0.5, shape=(2, 3))
        log.emit("step", step=2, loss=float("nan"), arr=np.float32(1.5),
                 vec=np.arange(2))
    return log.run_id


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("port", "jax"),
                                           ("jax", "port")])
def test_event_log_header_lines_and_replay(tmp_path, writer, reader):
    """The header, the typed lines and their JSON coercions, written by one
    package and replayed by either."""
    path = str(tmp_path / "events.jsonl")
    run_id = write_log(EVENTS[writer], path)
    header, events = EVENTS[reader].replay_events(path)
    h = header["header"]
    assert header["kind"] == "ncnet_tpu_events"
    assert h["schema"] == t_events.SCHEMA_VERSION == j_events.SCHEMA_VERSION
    assert h["run_id"] == run_id and h["meta"] == {"note": "t"}
    assert [e["event"] for e in events] == ["step", "step"]
    assert [e["seq"] for e in events] == [0, 1]
    assert all(e["run"] == run_id for e in events)
    assert events[0]["t"] <= events[1]["t"]
    assert events[0]["shape"] == [2, 3]
    assert events[1]["loss"] == "nan"
    assert events[1]["arr"] == 1.5
    assert events[1]["vec"] == [0, 1]


def test_event_log_lines_equal_the_jax_packages(tmp_path):
    """Line for line the same records, apart from the wall time and the
    run id, for the same emits (torch values coerced as numpy ones)."""
    logs = {}
    for name, mod in EVENTS.items():
        path = str(tmp_path / f"{name}.jsonl")
        with mod.EventLog(path, run_id="r") as log:
            log.emit("a", x=1, y=[1.0, "s"], z={"k": (1, 2)}, n=None)
            log.emit("b", v=np.float64(0.25), w=np.int64(3))
        logs[name] = [{k: v for k, v in e.items() if k != "t"}
                      for e in mod.replay_events(path)[1]]
    assert logs["port"] == logs["jax"]
    with t_events.EventLog(str(tmp_path / "torch.jsonl")) as log:
        log.emit("c", s=torch.tensor(2.5), v=torch.arange(3))
    (rec,) = t_events.replay_events(str(tmp_path / "torch.jsonl"))[1]
    assert rec["s"] == 2.5 and rec["v"] == [0, 1, 2]


def test_event_log_reopen_appends_under_new_run_id(tmp_path):
    path = str(tmp_path / "events.jsonl")
    with t_events.EventLog(path) as log1:
        log1.emit("run_start")
    with t_events.EventLog(path) as log2:
        log2.emit("resume", step=3)
    assert log1.run_id != log2.run_id
    header, events = j_events.replay_events(path)
    assert header["header"]["run_id"] == log1.run_id
    assert [e["run"] for e in events] == [log1.run_id, log2.run_id]


def test_event_log_sets_foreign_file_aside(tmp_path):
    path = str(tmp_path / "events.jsonl")
    with open(path, "w") as f:
        f.write("this is not an event log\n")
    with t_events.EventLog(path) as log:
        log.emit("run_start")
    with open(path + ".stale") as f:
        assert "not an event log" in f.read()
    assert len(t_events.replay_events(path)[1]) == 1


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_replay_tolerates_torn_tail_and_reopen_truncates(tmp_path, reader):
    path = str(tmp_path / "events.jsonl")
    with t_events.EventLog(path) as log:
        log.emit("a", i=1)
        log.emit("b", i=2)
    with open(path, "a") as f:
        f.write('{"t": 1, "run": "x", "seq": 2, "event": "torn')  # no \n
    replay = EVENTS[reader].replay_events
    assert [e["event"] for e in replay(path)[1]] == ["a", "b"]
    with t_events.EventLog(path) as log2:
        log2.emit("c", i=3)
    assert [e["event"] for e in replay(path)[1]] == ["a", "b", "c"]


def test_a_torn_append_is_sealed_before_the_next(tmp_path):
    """A write that failed part-way leaves a torn prefix; the next append
    starts on a fresh line, so replay loses only the torn record."""
    path = str(tmp_path / "events.jsonl")
    log = t_events.EventLog(path)
    log.emit("a")
    log._write_raw('{"t": 1, "event": "to')  # a crash mid-write, survived
    log.emit("b")
    log.close()
    assert [e["event"] for e in j_events.replay_events(path)[1]] == ["a", "b"]


def test_replay_rejects_foreign_and_newer_schema(tmp_path):
    with pytest.raises(FileNotFoundError):
        t_events.replay_events(str(tmp_path / "nope.jsonl"))
    foreign = str(tmp_path / "foreign.jsonl")
    with open(foreign, "w") as f:
        f.write('{"kind": "something_else"}\n')
    newer = str(tmp_path / "newer.jsonl")
    with open(newer, "w") as f:
        f.write(json.dumps({"kind": "ncnet_tpu_events",
                            "header": {"schema": t_events.SCHEMA_VERSION + 1},
                            "schema": t_events.SCHEMA_VERSION + 1}) + "\n")
    for path in (foreign, newer):
        with pytest.raises(ValueError):
            t_events.replay_events(path)


def test_emit_without_sink_and_a_failing_sink(tmp_path):
    """``emit`` is a no-op unbound; a sink whose append fails is unbound,
    and telemetry never raises into the run."""
    t_events.emit("anything", x=1)
    sink = t_events.EventLog(str(tmp_path / "events.jsonl"))
    with t_events.bound(sink):
        sink.close()
        t_events.emit("tick")
        assert t_events.get_global_sink() is None
        t_events.emit("tick")
    assert t_events.get_global_sink() is None


def test_run_envelope_without_cuda(monkeypatch):
    """No CUDA in use: the envelope builds, with the JAX envelope's keys
    minus the device fields, and opens no CUDA context; a device probe that
    raises is absorbed."""
    assert not torch.cuda.is_initialized()
    env = t_events.run_envelope("rid")
    jax_env = j_events.run_envelope("rid")
    device_keys = {"device_kind", "device_count", "process_index"}
    assert set(env) == set(jax_env) - device_keys
    assert {k: env[k] for k in ("schema", "run_id", "host", "pid")} == \
        {k: jax_env[k] for k in ("schema", "run_id", "host", "pid")}
    assert t_events.local_device_kind() is None
    assert not torch.cuda.is_initialized()

    def boom():
        raise RuntimeError("no CUDA device left")

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", boom)
    assert not device_keys & set(t_events.run_envelope())
    assert t_events.local_device_kind() is None
    assert t_metrics.device_peak_tflops() is None


def test_run_envelope_reads_the_card_where_cuda_is_in_use(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i: "NVIDIA H100 80GB HBM3")
    env = t_events.run_envelope()
    assert (env["device_kind"], env["device_count"], env["process_index"]) == \
        ("NVIDIA H100 80GB HBM3", 1, 0)
    assert t_metrics.device_peak_tflops() == 989.0


# ---------------------------------------------------------------------------
# leveled logger
# ---------------------------------------------------------------------------


def log_calls(mod_logging, mod_events, path, name):
    log = mod_logging.get_logger(name)
    with mod_events.EventLog(path) as sink, mod_events.bound(sink):
        log.debug("hidden")
        log.info("plain line")
        log.warning("recoverable thing", kind="decode")
        log.error("bad thing")
    return [{k: v for k, v in e.items() if k not in ("t", "run")}
            for e in mod_events.replay_events(path)[1]]


@pytest.mark.parametrize("level", ["", "error"])
def test_logger_console_and_tee_equal_the_jax_packages(tmp_path, capsys, monkeypatch,
                                                       level):
    monkeypatch.setenv(t_logging.LOG_LEVEL_ENV, level)
    assert t_logging.LOG_LEVEL_ENV == j_logging.LOG_LEVEL_ENV
    got = log_calls(t_logging, t_events, str(tmp_path / "t.jsonl"), "chan")
    got_out = capsys.readouterr().out
    want = log_calls(j_logging, j_events, str(tmp_path / "j.jsonl"), "chan")
    assert got == want and got_out == capsys.readouterr().out
    if level:
        assert got_out == "error: bad thing\n"
    else:
        assert got_out == ("plain line\nwarning: recoverable thing\n"
                           "error: bad thing\n")
        assert got[1]["kind"] == "decode" and "kind" not in got[0]
    assert t_logging.get_logger("chan") is t_logging.get_logger("chan")


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def fill_registry(mod, path):
    reg = mod.MetricsRegistry(scope="t")
    reg.counter("n").inc()
    reg.counter("n").inc(2)
    reg.gauge("loss").set(0.25)
    reg.gauge("unset")
    for s in (0.1, 0.3, 0.2):
        reg.timer("wall").observe(s)
    reg.histogram("q", 0.0, 1.0, 8).add([0.05, 0.5, 0.51, 2.0, float("nan")])
    with pytest.raises(TypeError):
        reg.gauge("n")
    with pytest.raises(ValueError):
        reg.histogram("q", 0.0, 2.0, 8)
    with mod_events(mod).EventLog(path) as sink:
        snap = reg.flush(sink=sink, epoch=2)
    return snap, mod_events(mod).replay_events(path)[1]


def mod_events(metrics_mod):
    return t_events if metrics_mod is t_metrics else j_events


def test_metrics_registry_equals_the_jax_packages(tmp_path):
    """Counters, gauges, timers and histograms: the same snapshot and the
    same ``metrics`` event for the same observations."""
    got, got_ev = fill_registry(t_metrics, str(tmp_path / "t.jsonl"))
    want, want_ev = fill_registry(j_metrics, str(tmp_path / "j.jsonl"))
    assert got == want
    assert got["n"] == 3 and got["loss"] == 0.25 and "unset" not in got
    assert got["wall"]["count"] == 3 and got["wall"]["p50_s"] == 0.2
    assert got["q"]["count"] == 4  # the NaN dropped, 2.0 clamped in
    strip = lambda evs: [{k: v for k, v in e.items() if k not in ("t", "run")}  # noqa: E731
                         for e in evs]
    assert strip(got_ev) == strip(want_ev)
    assert got_ev[0]["scope"] == "t" and got_ev[0]["epoch"] == 2
    with t_metrics.Timer() as timer:
        time.sleep(0.001)
    assert timer.count == 1 and timer.last_s >= 0.001


def test_histogram_percentiles_and_merge_equal_the_jax_packages():
    rng = np.random.default_rng(0)
    a, b = rng.uniform(-0.2, 1.2, 200), rng.uniform(0, 1, 50)
    out = []
    for mod in (t_metrics, j_metrics):
        h, h2 = mod.Histogram(0.0, 1.0, 16), mod.Histogram(0.0, 1.0, 16)
        h.add(a)
        h2.add(b)
        h.merge(h2)
        back = mod.Histogram.from_snapshot(h.snapshot())
        out.append((h.snapshot(), [h.percentile(q) for q in (5, 50, 95)],
                    h.mean(), back.counts))
        with pytest.raises(ValueError):
            h.merge(mod.Histogram(0.0, 2.0, 16))
    assert out[0] == out[1]


def test_flop_bases_and_peaks():
    """The FLOP counts equal the JAX package's; the peak tables hold the
    H100 SXM data sheet's numbers and no TPU entry."""
    for args in ((25, (5, 5, 5), (16, 16, 1)), (50, (3, 3), (10, 1))):
        assert t_metrics.filter_flops(*args) == j_metrics.filter_flops(*args)
        assert t_metrics.train_step_flops(*args) == j_metrics.train_step_flops(*args)
    assert abs(t_metrics.filter_flops(25, (5, 5, 5), (16, 16, 1)) / 1e9 - 281.2) < 0.1
    assert t_metrics.PEAK_BF16_TFLOPS == {"NVIDIA H100 80GB HBM3": 989.0}
    assert t_metrics.PEAK_HBM_GBPS == {"NVIDIA H100 80GB HBM3": 3350.0}
    assert t_metrics.device_peak_tflops() is None  # no card in use here


# ---------------------------------------------------------------------------
# span tracing
# ---------------------------------------------------------------------------


def test_span_is_inert_without_sink():
    with t_tracing.span("outer") as s:
        assert s._id is None
        assert t_tracing.current_span_id() is None


def spans_of(events):
    return [e for e in events if e["event"] == "span"]


def test_span_nesting_roundtrips_through_event_log(tmp_path):
    path = str(tmp_path / "events.jsonl")
    with t_events.bound(t_events.EventLog(path)):
        with t_tracing.span("step", step=7) as outer:
            assert t_tracing.current_span_id() == outer._id
            with t_tracing.span("dispatch") as inner:
                assert t_tracing.current_span_id() == inner._id
            with t_tracing.span("loss_sync"):
                time.sleep(0.01)
        assert t_tracing.current_span_id() is None
    sp = spans_of(j_events.replay_events(path)[1])
    begins = {e["span"]: e for e in sp if e["ph"] == "B"}
    ends = {e["span"]: e for e in sp if e["ph"] == "E"}
    assert set(begins) == set(ends) and len(begins) == 3
    by_name = {e["name"]: e for e in begins.values()}
    step_id = by_name["step"]["span"]
    assert by_name["step"]["parent"] is None and by_name["step"]["step"] == 7
    assert by_name["step"]["tid"] == threading.get_ident()
    assert by_name["dispatch"]["parent"] == step_id
    assert by_name["loss_sync"]["parent"] == step_id
    assert ends[by_name["loss_sync"]["span"]]["dur_s"] >= 0.01
    kinds = [(e["ph"], e["name"]) for e in sp]
    assert kinds[0] == ("B", "step") and kinds[-1] == ("E", "step")


def test_span_parents_are_per_thread(tmp_path):
    path = str(tmp_path / "events.jsonl")
    seen = {}
    with t_events.bound(t_events.EventLog(path)):
        with t_tracing.span("outer"):
            def worker():
                with t_tracing.span("in_thread") as s:
                    seen["parent"] = s._parent
            th = threading.Thread(target=worker)
            th.start()
            th.join()
    assert seen["parent"] is None
    b = {e["name"]: e for e in spans_of(t_events.replay_events(path)[1])
         if e["ph"] == "B"}
    assert b["in_thread"]["parent"] is None
    assert b["in_thread"]["tid"] != b["outer"]["tid"]


def test_traced_decorator_error_and_out_of_order_exit(tmp_path):
    path = str(tmp_path / "events.jsonl")

    @t_tracing.traced()
    def quick():
        return 42

    @t_tracing.traced("boom", phase="test")
    def explode():
        raise ValueError("no")

    with t_events.bound(t_events.EventLog(path)):
        assert quick() == 42
        with pytest.raises(ValueError):
            explode()
        a, b = t_tracing.span("a"), t_tracing.span("b")
        a.__enter__()
        b.__enter__()
        a.__exit__(None, None, None)  # out of order: never raises
        b.__exit__(None, None, None)
        assert t_tracing.current_span_id() is None
    sp = spans_of(t_events.replay_events(path)[1])
    assert {e["name"] for e in sp} == {"quick", "boom", "a", "b"}
    (boom_e,) = [e for e in sp if e["ph"] == "E" and e["name"] == "boom"]
    assert boom_e["error"] == "ValueError"
    (boom_b,) = [e for e in sp if e["ph"] == "B" and e["name"] == "boom"]
    assert boom_b["phase"] == "test"


# ---------------------------------------------------------------------------
# perf store and the regression check
# ---------------------------------------------------------------------------


def test_perfstore_roundtrip_across_packages(tmp_path):
    """Records, torn/foreign/newer lines skipped; each package's store
    reads the other's records."""
    path = str(tmp_path / "h.jsonl")
    store = t_perf.PerfStore(path)
    store.append("train_step_ms", 100.0, device_kind="cpu", git_rev="abc", t=1.0)
    j_perf.PerfStore(path).append("train_step_ms", 102.0, device_kind="cpu", t=2.0)
    with open(path, "a") as f:
        f.write("not json at all\n")
        f.write(json.dumps({"kind": "perf", "schema": 999, "metric": "x",
                            "value": 1}) + "\n")
        f.write('{"kind": "perf", "metric": "torn')
    assert store.records() == j_perf.PerfStore(path).records()
    assert [r["value"] for r in store.records()] == [100.0, 102.0]
    assert store.records()[0]["git_rev"] == "abc"
    assert [r["value"] for r in store.history("train_step_ms", "cpu")] == [100.0, 102.0]
    assert store.history("train_step_ms", "tpu") == []
    n = t_perf.PerfStore(str(tmp_path / "m.jsonl")).append_many(
        {"a_ms": 1.0, "nan_ms": float("nan"), "flag": True, "note": "x"},
        device_kind="cpu")
    assert n == 1


NAMES = ["train_step_ms", "pf_pascal_eval_s_fetch", "pf_pascal_pck",
         "train_pairs_per_sec", "forward_bf16_mfu_executed_pct", "vs_baseline",
         "roofline_filter_ms", "forward_bf16_tflops", "mem_peak_hbm_bytes",
         "quality_entropy", "serve_shed_pct", "fit_wall_s", "mystery"]


def test_metric_direction_equals_the_jax_packages():
    assert [t_perf.metric_direction(n) for n in NAMES] == \
        [j_perf.metric_direction(n) for n in NAMES]
    assert t_perf.metric_direction("train_step_ms") == "lower"
    assert t_perf.metric_direction("pf_pascal_pck") == "higher"
    assert t_perf.metric_direction("forward_bf16_mfu_executed_pct") is None


def recs(metric, values, device="cpu"):
    return [{"kind": "perf", "metric": metric, "value": v, "device_kind": device}
            for v in values]


BASE = [100.0, 103.0, 98.0, 101.0, 99.0]


@pytest.mark.parametrize("records,kw,status", [
    (recs("train_step_ms", BASE + [200.0]), {}, "regression"),
    (recs("train_step_ms", BASE + [104.0]), {}, "ok"),
    (recs("train_step_ms", BASE + [55.0]), {}, "ok"),
    (recs("train_step_ms", [100.0, 200.0]), {}, "skipped"),
    (recs("pf_pascal_pck", [0.8, 0.81, 0.79, 0.4]), {}, "regression"),
    (recs("train_mfu_pct", [40.0, 41.0, 20.0]), {}, None),
    (recs("train_mfu_pct", [40.0, 41.0, 20.0]), {"metrics": ["train_mfu_pct"]},
     "regression"),
    (recs("mystery_quantity", [1.0, 1.1, 9.0]), {"metrics": ["mystery_quantity"]},
     "skipped"),
    (recs("a_ms", BASE + [200.0]) + recs("a_ms", BASE + [100.0], "gpu"),
     {"device_kind": "gpu"}, "ok"),
])
def test_regression_check_equals_the_jax_packages(records, kw, status):
    got = t_perf.check_regressions(records, **kw)
    assert got == j_perf.check_regressions(records, **kw)
    assert [f["status"] for f in got] == ([] if status is None else [status])


def test_store_path_and_maybe_record(tmp_path, monkeypatch):
    monkeypatch.setenv(t_perf.STORE_ENV, "off")
    assert t_perf.resolve_store_path() is None
    assert t_perf.maybe_record({"a_ms": 1.0}, source="t") == 0
    assert t_perf.resolve_store_path("/x/y.jsonl") == "/x/y.jsonl"
    path = str(tmp_path / "h.jsonl")
    monkeypatch.setenv(t_perf.STORE_ENV, path)
    assert t_perf.resolve_store_path() == j_perf.resolve_store_path() == path
    assert t_perf.maybe_record({"a_ms": 1.5, "b": "x"}, source="t", git_rev="r") == 1
    (rec,) = j_perf.PerfStore(path).records()
    assert (rec["metric"], rec["value"], rec["device_kind"], rec["source"],
            rec["git_rev"]) == ("a_ms", 1.5, "unknown", "t", "r")
    monkeypatch.delenv(t_perf.STORE_ENV)
    assert os.path.relpath(t_perf.default_store_path(),
                           os.path.dirname(j_perf.default_store_path())) == "history.jsonl"


# ---------------------------------------------------------------------------
# utils: seeding and atomic writes
# ---------------------------------------------------------------------------


def test_seeding_streams_equal_the_jax_packages():
    assert np.array_equal(t_seeding.global_seed(5).random(4),
                          j_seeding.global_seed(5).random(4))
    t_seeding.global_seed(7)
    a = np.random.rand(3)
    j_seeding.global_seed(7)
    assert np.array_equal(a, np.random.rand(3))
    for w in (0, 3):
        assert np.array_equal(t_seeding.worker_rng(11, w).random(4),
                              j_seeding.worker_rng(11, w).random(4))
    assert not np.array_equal(t_seeding.worker_rng(11, 0).random(4),
                              t_seeding.worker_rng(11, 1).random(4))
    g1, g2 = t_seeding.torch_generator(3), t_seeding.torch_generator(3, "cpu")
    assert g1.device.type == "cpu"
    assert torch.equal(torch.rand(5, generator=g1), torch.rand(5, generator=g2))


@pytest.mark.parametrize("durable", [False, True])
def test_atomic_write_json_equals_the_jax_packages(tmp_path, durable):
    obj = {"b": [1, 2.5, None], "a": {"z": "s"}}
    t_io.atomic_write_json(str(tmp_path / "t.json"), obj, durable=durable)
    j_io.atomic_write_json(str(tmp_path / "j.json"), obj, durable=durable)
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    with pytest.raises(TypeError):
        t_io.atomic_write_json(str(tmp_path / "bad.json"), {"x": object()})
    assert sorted(os.listdir(tmp_path)) == ["j.json", "t.json"]  # no carcass


def test_atomic_write_bytes_and_savemat(tmp_path):
    path = str(tmp_path / "blob")
    t_io.atomic_write_bytes(path, [b"ab", b"cd"], durable=True)
    assert open(path, "rb").read() == b"abcd"

    def crash(p):
        raise KeyboardInterrupt("killed between write and rename")

    with pytest.raises(KeyboardInterrupt):
        t_io.atomic_write_bytes(str(tmp_path / "never"), b"x", commit_hook=crash)
    assert sorted(os.listdir(tmp_path)) == ["blob"]
    t_io.fsync_dir(str(tmp_path))
    t_io.fsync_dir(str(tmp_path / "missing"))  # best effort: no raise
    from scipy.io import loadmat

    mat = str(tmp_path / "m.mat")
    t_io.atomic_savemat(mat, {"matches": np.arange(6.0).reshape(2, 3)},
                        do_compression=True)
    np.testing.assert_array_equal(loadmat(mat)["matches"], np.arange(6.0).reshape(2, 3))
    assert not os.path.exists(mat + ".tmp")


def test_atomic_savemat_fault_hooks(tmp_path):
    """An armed ``savemat_hook`` fails the write before any byte lands (a
    transient one only on the first attempt)."""
    from ncnet_tpu_torch.utils import faults

    bad = str(tmp_path / "q_bad.mat")
    with faults.injected(faults.FaultPlan(savemat_fail_substring="q_bad",
                                          savemat_fail_times=1)):
        with pytest.raises(faults.InjectedFault):
            t_io.atomic_savemat(bad, {"x": np.zeros(2)})
        assert not os.path.exists(bad) and not os.path.exists(bad + ".tmp")
        t_io.atomic_savemat(bad, {"x": np.zeros(2)})  # the retry lands
    assert os.path.exists(bad)


def test_savemat_kill_leaves_a_carcass_and_no_file(tmp_path):
    """SIGKILL between the temp write and the rename (a subprocess armed
    through ``NCNET_TPU_FAULTS``): a ``.tmp`` carcass, no final file."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    mat = str(tmp_path / "q_kill.mat")
    code = (f"import sys; sys.path.insert(0, {repo!r}); import numpy as np; "
            "from ncnet_tpu_torch.utils.io import atomic_savemat; "
            f"atomic_savemat({mat!r}, {{'x': np.zeros(3)}})")
    env = dict(os.environ, NCNET_TPU_FAULTS=json.dumps(
        {"kill_in_savemat_substring": "q_kill"}))
    proc = subprocess.run([sys.executable, "-c", code], env=env, timeout=120)
    assert proc.returncode == -9
    assert not os.path.exists(mat) and os.path.exists(mat + ".tmp")


def test_fault_plan_from_the_environment(monkeypatch):
    """A plan armed through ``NCNET_TPU_FAULTS``; a field the port has no
    hook for raises instead of passing as armed (since the retrieval slice
    the port has every field of the JAX plan, so an unknown one)."""
    from ncnet_tpu_torch.utils import faults

    faults._plan, faults._env_read = None, False
    monkeypatch.setenv("NCNET_TPU_FAULTS", json.dumps({"device_fail_calls": [2]}))
    try:
        faults.device_error_hook()
        with pytest.raises(faults.InjectedDeviceError, match="call 2"):
            faults.device_error_hook("step")
        faults.clear()
        faults._env_read = False
        # the retrieval shards' hooks came with the retrieval slice: the
        # field arms them
        monkeypatch.setenv("NCNET_TPU_FAULTS",
                           json.dumps({"dead_shard_urls": ["s0"]}))
        with pytest.raises(ConnectionError, match="shard death"):
            faults.shard_fault_hook("http://s0:1", "send")
        faults.clear()
        faults._env_read = False
        monkeypatch.setenv("NCNET_TPU_FAULTS",
                           json.dumps({"dead_shard_url": ["s0"]}))
        with pytest.raises(ValueError, match="dead_shard_url"):
            faults.device_error_hook()
    finally:
        faults.clear()
