"""The port's PF-Pascal eval loop against the JAX package on the CPU:
``run_eval`` end to end, its fault tolerance (``evaluation/resilience.py``
under ROADMAP decision D4, ``evaluation/pipeline.py``), the reference
checkpoint importer and the CLI.

Both packages read the same pixels: the JAX writer's JPEGs, which
``tools/convert_images`` turns into the raw files the port reads.  Weights
go from the JAX package to the port through ``params_from_numpy``.
Tolerances: per-pair PCK exactly equal (the same pixels, crisp matches
on pairs shifted by whole feature cells); the quality columns rtol 1e-5,
atol 1e-6 (softmax and sums of two libraries); imported checkpoints exactly
equal (the same numbers moved between layouts).  Where the JAX loop demotes
a fused tier after a device error, the port retries the same program and
never changes a tier: those cases check that instead.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from ncnet_tpu import config as jcfg
from ncnet_tpu.cli import eval_pf_pascal as jcli
from ncnet_tpu.data.synthetic import write_pf_pascal_like
from ncnet_tpu.evaluation import resilience as jres
from ncnet_tpu.evaluation import run_eval as jax_run_eval
from ncnet_tpu.evaluation.pipeline import (
    PipelineDepthController as JaxController,
)
from ncnet_tpu.models import checkpoint as jckpt
from ncnet_tpu.models import ncnet as jnet
from ncnet_tpu_torch import config as tcfg
from ncnet_tpu_torch.cli import eval_pf_pascal as tcli
from ncnet_tpu_torch.data import SampleDecodeError
from ncnet_tpu_torch.evaluation import pipeline as tpipe
from ncnet_tpu_torch.evaluation import resilience as tres
from ncnet_tpu_torch.evaluation import run_eval
from ncnet_tpu_torch.evaluation.pf_pascal import RESULT_COLUMNS
from ncnet_tpu_torch.models import checkpoint as tckpt
from ncnet_tpu_torch.models import ncnet as tnet
from ncnet_tpu_torch.models.convert import params_from_numpy
from ncnet_tpu_torch.observability import events as tevents
from ncnet_tpu_torch.observability import memory as tmemory
from ncnet_tpu_torch.observability import quality as tquality
from ncnet_tpu_torch.ops import nc_fused_lane
from ncnet_tpu_torch.tools import convert_images
from ncnet_tpu_torch.utils import faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IDENTITY = dict(backbone="tiny", ncons_kernel_sizes=(3,), ncons_channels=(1,))
STACK16 = dict(backbone="tiny", ncons_kernel_sizes=(5, 5, 5),
               ncons_channels=(16, 16, 1))
SIDE = 96


@pytest.fixture(autouse=True)
def _clean_state():
    faults.clear()
    yield
    faults.clear()


def shared_params(kw, seed=0):
    """JAX params from ``seed`` for ``ModelConfig(**kw)`` with the NC
    kernels made crisp (a unit centre tap for the 1-layer stack; the
    centre tap raised and the biases moved off zero for the deeper one),
    and the same weights as port params."""
    jc = jcfg.ModelConfig(**kw)
    jp = jax.tree.map(np.asarray, jnet.init_ncnet(jc, jax.random.key(seed)))
    for layer in jp["nc"]:
        w = np.array(layer["w"])
        d = w.shape[0] // 2
        if len(jp["nc"]) == 1:
            w[:] = 0.0
            w[d, d, d, d] = 1.0
            layer["b"] = np.zeros_like(layer["b"])
        else:
            w[d, d, d, d] += 1.0 / w.shape[4]
            layer["b"] = np.asarray(layer["b"]) + 0.05
        layer["w"] = w
    return jp, params_from_numpy(jp)


def nets(kw, seed=0):
    jp, tp = shared_params(kw, seed)
    return (jnet.NCNet(jcfg.ModelConfig(**kw), jax.tree.map(jax.numpy.asarray, jp)),
            tnet.NCNet(tcfg.ModelConfig(**kw), tp, device="cpu"))


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    """5 JAX-written pairs (JPEGs) shifted by one feature cell, converted."""
    root = str(tmp_path_factory.mktemp("pf"))
    write_pf_pascal_like(root, n_pairs=5, image_hw=(SIDE, SIDE), shift=(16, 16),
                         seed=7)
    assert convert_images.main([root]) == 0
    return root


@pytest.fixture(scope="module")
def model_pairs():
    return {"identity": nets(IDENTITY), "stack16": nets(STACK16)}


def configs(root, **kw):
    return (jcfg.EvalPFPascalConfig(image_size=SIDE, eval_dataset_path=root, **kw),
            tcfg.EvalPFPascalConfig(image_size=SIDE, eval_dataset_path=root, **kw))


def assert_stats_equal(got, want, quality=True):
    np.testing.assert_array_equal(got["per_pair"], want["per_pair"])
    for k in ("total", "valid", "quarantined_batches"):
        assert got[k] == want[k], k
    assert got["pck"] == want["pck"] or (np.isnan(got["pck"]) and np.isnan(want["pck"]))
    if quality:
        for name in tquality.QUALITY_SIGNALS:
            np.testing.assert_allclose(got["quality"][name], want["quality"][name],
                                       rtol=1e-5, atol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# run_eval against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", ["identity", "stack16"])
@pytest.mark.parametrize("batch_size,device_normalize,depth", [
    (1, True, 0), (3, True, 0), (3, False, 2), (1, False, 1)])
def test_run_eval_matches_jax(fixture_root, model_pairs, model, batch_size,
                              device_normalize, depth):
    """Per-pair PCK exactly equal, the quality columns within rtol 1e-5,
    atol 1e-6, at batch 1 and at 3 (a trailing batch of 2 padded), with
    the uint8 upload and the host-normalized one, adaptive and pinned
    depth."""
    jnet_, tnet_ = model_pairs[model]
    jconf, tconf = configs(fixture_root)
    kw = dict(batch_size=batch_size, num_workers=0, progress=False,
              device_normalize=device_normalize, pipeline_depth=depth)
    want = jax_run_eval(jconf, net=jnet_, **kw)
    got = run_eval(tconf, net=tnet_, **kw)
    assert got["total"] == 5 and got["valid"] == 5 and got["pck"] > 0.5
    assert_stats_equal(got, want)
    assert set(got) == set(want)
    assert got["quality_tier"] == want["quality_tier"] == "xla"
    assert got["decode_quarantined"] == want["decode_quarantined"] == []
    for name, snap in got["quality_digests"].items():
        assert snap["counts"] == want["quality_digests"][name]["counts"], name


def test_run_eval_entry_points_need_cuda(fixture_root, monkeypatch):
    """Without ``device="cpu"`` (or a net on the CPU) the loop runs on
    CUDA, and without a GPU it raises instead of running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tconf = configs(fixture_root)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_eval(tconf, model_config=tcfg.ModelConfig(**IDENTITY), progress=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--eval_dataset_path", fixture_root, "--backbone", "tiny"])
    net = tnet.NCNet(tcfg.ModelConfig(**IDENTITY), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_eval(tconf, net=net, device="cuda", progress=False)


def test_run_eval_builds_its_net_and_telemetry(fixture_root, tmp_path):
    """``run_eval`` without a net builds it from the model config on the
    CPU; the telemetry dir gets the run's event log (run_start, a span
    and an ``eval_batch`` and ``quality`` event a batch, the summary),
    and the global sink is restored after."""
    _, tconf = configs(fixture_root, telemetry_dir=str(tmp_path / "tel"))
    prev = tevents.get_global_sink()
    stats = run_eval(tconf, model_config=tcfg.ModelConfig(**IDENTITY),
                     batch_size=2, num_workers=2, progress=False, device="cpu")
    assert tevents.get_global_sink() is prev
    assert stats["total"] == 5
    _, evs = tevents.replay_events(str(tmp_path / "tel" / "events.jsonl"))
    kinds = [e["event"] for e in evs]
    assert kinds[0] == "run_start"
    assert kinds.count("eval_batch") == kinds.count("quality") == 3
    assert kinds.count("eval_summary") == 1
    assert {e["name"] for e in evs if e["event"] == "span"} >= {
        "decode", "dispatch", "fetch", "watched_call"}
    assert not [e for e in evs if e["event"] in ("device_snapshot",
                                                 "memory_leak_suspect")]


def test_run_eval_sparse_topk_matches_jax(fixture_root):
    """``sparse_topk`` rides the model config the loop builds: at 192² the
    12² grid takes the coarse-to-fine pipeline in both packages, the
    quality tier says so, and the per-pair PCK is equal."""
    jp, tp = shared_params(IDENTITY, seed=1)
    jconf, tconf = configs(fixture_root, sparse_topk=4)
    jconf = jconf.__class__(**{**jconf.__dict__, "image_size": 192})
    tconf = tconf.__class__(**{**tconf.__dict__, "image_size": 192})
    jnet_ = jnet.NCNet(jcfg.ModelConfig(**IDENTITY, sparse_topk=4),
                       jax.tree.map(jax.numpy.asarray, jp))
    tnet_ = tnet.NCNet(tcfg.ModelConfig(**IDENTITY, sparse_topk=4), tp, device="cpu")
    kw = dict(batch_size=2, num_workers=0, progress=False)
    want = jax_run_eval(jconf, net=jnet_, **kw)
    got = run_eval(tconf, net=tnet_, **kw)
    assert got["quality_tier"] == want["quality_tier"] == "coarse2fine"
    assert_stats_equal(got, want)


# ---------------------------------------------------------------------------
# fault tolerance through run_eval
# ---------------------------------------------------------------------------


def pf_run(root, net, journal_dir="", fetch_timeout_s=0.0, **kw):
    _, tconf = configs(root, journal_dir=journal_dir, query_retries=1,
                       retry_backoff_s=0.0, fetch_timeout_s=fetch_timeout_s)
    return run_eval(tconf, net=net, **{"batch_size": 1, "num_workers": 0,
                                       "progress": False, **kw})


def test_quarantined_batch_never_aborts(fixture_root, model_pairs, tmp_path):
    """A batch whose dispatch keeps failing past its retries is
    quarantined (its pairs score NaN), the rest completes, the manifest
    names it, and no tier changed."""
    net = model_pairs["identity"][1]
    journal_dir = str(tmp_path / "j")
    nc_fused_lane.note_forced_tier("resident")
    with faults.injected(faults.FaultPlan(device_fail_calls=(1, 2, 3))):
        stats = pf_run(fixture_root, net, journal_dir=journal_dir,
                       pipeline_depth=1)
    assert stats["quarantined_batches"] == [0]
    assert stats["total"] == 5 and stats["valid"] == 4
    assert np.isnan(stats["per_pair"][0]) and np.isfinite(stats["per_pair"][1:]).all()
    manifest = json.load(open(os.path.join(journal_dir, "manifest.json")))
    assert manifest["quarantined"]["batch_0"]["kind"] == "device"
    assert manifest["quarantined"]["batch_0"]["attempts"] == 2
    assert tres.manifest_has_quarantined(os.path.join(journal_dir, "manifest.json"))


def test_device_error_is_retried_without_a_tier_change(fixture_root, model_pairs,
                                                       tmp_path):
    """An injected device error at dispatch, and one at the retry's
    re-dispatch: the same program runs again under the budget (a
    ``retry`` event on budget, no off-budget recovery), the per-pair PCK
    equals a clean run's, nothing is quarantined and the tier stays."""
    net = model_pairs["identity"][1]
    clean = pf_run(fixture_root, net)
    tier = nc_fused_lane.last_selected_tier()
    log_path = str(tmp_path / "ev.jsonl")
    with tevents.EventLog(log_path) as sink, tevents.bound(sink):
        with faults.injected(faults.FaultPlan(device_fail_calls=(1, 2))):
            faulty = pf_run(fixture_root, net, pipeline_depth=1)
    np.testing.assert_array_equal(clean["per_pair"], faulty["per_pair"])
    assert faulty["quarantined_batches"] == []
    assert nc_fused_lane.last_selected_tier() == tier
    _, evs = tevents.replay_events(log_path)
    retries = [e for e in evs if e["event"] == "retry"]
    assert [(e["kind"], e["on_budget"]) for e in retries] == [("device", True)]
    failures = [e for e in evs if e["event"] == "device_failure"]
    assert len(failures) == 1 and failures[0]["oom"] is False
    assert failures[0]["hbm"] is None  # the CPU has no device memory plane


def test_hung_fetch_becomes_a_retried_timeout(fixture_root, model_pairs):
    net = model_pairs["identity"][1]
    clean = pf_run(fixture_root, net)
    with faults.injected(faults.FaultPlan(hang_fetch_calls=(1,),
                                          hang_fetch_seconds=3.0)):
        faulty = pf_run(fixture_root, net, pipeline_depth=1, fetch_timeout_s=0.5)
    np.testing.assert_array_equal(clean["per_pair"], faulty["per_pair"])
    assert faulty["quarantined_batches"] == []


def test_quarantine_streak_aborts_as_systemic(fixture_root, model_pairs):
    """Every batch failing is systemic: the breaker aborts after 5
    consecutive quarantines instead of quarantining the whole run."""
    net = model_pairs["identity"][1]
    with faults.injected(faults.FaultPlan(device_fail_calls=tuple(range(1, 40)))):
        with pytest.raises(tres.SystemicEvalError, match="consecutive"):
            pf_run(fixture_root, net)


def test_journal_rerun_reuses_results_bitwise(fixture_root, model_pairs, tmp_path):
    """A completed journaled run re-invoked with the same settings replays
    every batch (nothing dispatched or journaled again) and returns the
    identical result; another batch size starts fresh."""
    net = model_pairs["identity"][1]
    journal_dir = str(tmp_path / "j")
    first = pf_run(fixture_root, net, journal_dir=journal_dir)
    journal_path = os.path.join(journal_dir, "pck_journal.jsonl")
    n_lines = len(open(journal_path).read().splitlines())
    assert n_lines == 1 + 5
    with faults.injected(faults.FaultPlan(device_fail_calls=tuple(range(1, 40)))):
        second = pf_run(fixture_root, net, journal_dir=journal_dir)
    np.testing.assert_array_equal(first["per_pair"], second["per_pair"])
    for name in tquality.QUALITY_SIGNALS:
        np.testing.assert_array_equal(first["quality"][name], second["quality"][name])
    assert len(open(journal_path).read().splitlines()) == n_lines
    stats = pf_run(fixture_root, net, journal_dir=journal_dir, batch_size=5)
    assert stats["total"] == 5
    assert os.path.exists(journal_path + ".stale")


def test_journal_is_the_jax_packages(fixture_root, model_pairs, tmp_path):
    """The journal format is shared: the JAX ``EvalJournal`` reads the
    port's rows bit for bit, with the same header."""
    net = model_pairs["identity"][1]
    journal_dir = str(tmp_path / "j")
    stats = pf_run(fixture_root, net, journal_dir=journal_dir, batch_size=2)
    header = json.loads(open(os.path.join(journal_dir, "pck_journal.jsonl"))
                        .readline())["header"]
    assert header["columns"] == list(RESULT_COLUMNS)
    j = jres.EvalJournal(os.path.join(journal_dir, "pck_journal.jsonl"), header)
    rows = np.concatenate([j.entries[i].reshape(-1, len(RESULT_COLUMNS))
                           for i in range(3)])
    j.close()
    np.testing.assert_array_equal(rows[:, 0], stats["per_pair"])


def test_kill_mid_eval_resumes_bitwise(fixture_root, model_pairs, tmp_path):
    """SIGKILL mid-append of the third journal record (a torn record on
    disk); the rerun resumes from the journal and its per-pair PCK and mean
    equal an uninterrupted run's bit for bit."""
    net = model_pairs["identity"][1]
    journal_dir = str(tmp_path / "j")
    params_path = str(tmp_path / "params.pt")
    torch.save(net.params, params_path)
    worker = tmp_path / "worker.py"
    worker.write_text(f"""
import sys
sys.path.insert(0, {REPO!r})
import torch
from ncnet_tpu_torch.config import EvalPFPascalConfig, ModelConfig
from ncnet_tpu_torch.evaluation import run_eval
from ncnet_tpu_torch.models.ncnet import NCNet

net = NCNet(ModelConfig(**{IDENTITY!r}), torch.load({params_path!r}),
            device="cpu")
config = EvalPFPascalConfig(image_size={SIDE}, eval_dataset_path={fixture_root!r},
                            journal_dir={journal_dir!r}, query_retries=1,
                            retry_backoff_s=0.0)
run_eval(config, net=net, batch_size=1, num_workers=0, progress=False)
""")
    env = dict(os.environ, NCNET_TPU_FAULTS=json.dumps({"kill_at_journal_append": 3}))
    proc = subprocess.run([sys.executable, str(worker)], env=env, cwd=str(tmp_path),
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=300)
    assert proc.returncode == -9, proc.stdout[-3000:]
    lines = open(os.path.join(journal_dir, "pck_journal.jsonl")).read().splitlines()
    assert len(lines) == 1 + 3  # header, 2 records, 1 torn record
    with pytest.raises(ValueError):
        json.loads(lines[-1])
    resumed = pf_run(fixture_root, net, journal_dir=journal_dir)
    full = pf_run(fixture_root, net)
    np.testing.assert_array_equal(resumed["per_pair"], full["per_pair"])
    assert resumed["pck"] == full["pck"] and resumed["valid"] == 5


def test_corrupt_image_scores_invalid_not_double_counted(fixture_root, model_pairs,
                                                         tmp_path):
    """A corrupt raw image: the run goes on (the loader substitutes), its
    pair scores NaN, and PCK is the clean pairs' mean, as in the JAX loop
    on the same corruption."""
    import shutil

    root = str(tmp_path / "data")
    shutil.copytree(fixture_root, root)
    bad = os.path.join(root, "images", "test_0_a.jpg")
    with open(bad + ".npy", "wb") as f:
        f.write(b"\x93NUMPYgarbage")
    with open(bad, "wb") as f:
        f.write(b"\xff\xd8garbage")
    stats = pf_run(root, model_pairs["identity"][1])
    assert stats["decode_quarantined"] == [bad + ".npy"]
    assert stats["total"] == 5 and stats["valid"] == 4
    assert np.isnan(stats["per_pair"][0]) and np.isfinite(stats["per_pair"][1:]).all()
    assert stats["pck"] == pytest.approx(float(np.mean(stats["per_pair"][1:])))
    jconf, _ = configs(root, query_retries=1, retry_backoff_s=0.0)
    want = jax_run_eval(jconf, net=model_pairs["identity"][0], batch_size=1,
                        num_workers=0, progress=False)
    np.testing.assert_array_equal(stats["per_pair"], want["per_pair"])


# ---------------------------------------------------------------------------
# unit: classification, policy loop, manifest, journal, watchdog, controller
# ---------------------------------------------------------------------------


def test_classify_failure_kinds():
    assert tres.classify_failure(tpipe.FetchTimeoutError("x")) == "timeout"
    assert tres.classify_failure(faults.InjectedDeviceError("x")) == "device"
    assert tres.classify_failure(torch.cuda.OutOfMemoryError("CUDA out of memory")) \
        == "device"
    assert tres.classify_failure(RuntimeError(
        "CUDA error: an illegal memory access was encountered")) == "device"
    assert tres.classify_failure(RuntimeError(
        "nc_conv4d_layer launch failed: too many resources")) == "device"
    assert tres.classify_failure(RuntimeError("shape mismatch")) == "other"
    assert tres.classify_failure(
        SampleDecodeError("x.jpg.npy", OSError("bad header"))) == "decode"
    assert tres.classify_failure(faults.InjectedFault("decode failure")) == "decode"
    assert tres.classify_failure(FileNotFoundError("no such file images/x")) == "io"
    assert tres.classify_failure(ValueError("boom")) == "other"


def test_is_oom():
    assert tmemory.is_oom(torch.cuda.OutOfMemoryError("x"))
    assert tmemory.is_oom(RuntimeError("CUDA out of memory. Tried to allocate"))
    assert not tmemory.is_oom(OSError("no such file: reading_room_3.mat"))
    assert not tmemory.is_oom(faults.InjectedDeviceError("launch"))


def test_run_manifest_transitions_and_reload(tmp_path):
    path = str(tmp_path / "manifest.json")
    m = tres.RunManifest(path, meta={"experiment": "e1"})
    m.begin("q1")
    assert "q1" in m.data["in_flight"]
    m.complete("q1", skipped=False)
    m.begin("q2")
    m.quarantine("q2", "decode", "bad pano", attempts=3)
    assert m.is_completed("q1") and not m.is_completed("q2")
    m2 = tres.RunManifest(path)
    assert m2.is_completed("q1")
    assert m2.data["quarantined"]["q2"]["kind"] == "decode"
    assert m2.data["in_flight"] == [] and m2.quarantined_ids == ("q2",)
    m2.complete("q2")
    assert not tres.RunManifest(path).data["quarantined"]
    assert tres.RunManifest(path, meta={"experiment": "e2"}).data["completed"] == {}
    assert tres.RunManifest(path, meta={"experiment": "e1"}).is_completed("q1")
    # the JAX package reads the same file
    assert jres.RunManifest(path, meta={"experiment": "e1"}).is_completed("q1")
    with open(path, "w") as f:
        f.write("{ torn json")
    assert tres.RunManifest(path, meta={"experiment": "e1"}).data["completed"] == {}
    assert not tres.manifest_has_quarantined(str(tmp_path / "missing.json"))


def test_run_isolated_retries_then_quarantines(tmp_path):
    m = tres.RunManifest(str(tmp_path / "m.json"))
    calls = []

    def flaky_then_ok():
        calls.append(1)
        if len(calls) < 2:
            raise OSError("transient")
        return 42

    ok, out = tres.run_isolated("u1", flaky_then_ok,
                                policy=tres.FaultPolicy(1, 0.0, True), manifest=m)
    assert (ok, out) == (True, 42) and m.is_completed("u1")

    def always_bad():
        raise OSError("permanent")

    ok, out = tres.run_isolated("u2", always_bad,
                                policy=tres.FaultPolicy(1, 0.0, True), manifest=m)
    assert (ok, out) == (False, None)
    assert m.data["quarantined"]["u2"] == {"kind": "io", "error": "permanent",
                                           "attempts": 2}
    with pytest.raises(OSError, match="permanent"):
        tres.run_isolated("u3", always_bad, policy=tres.FaultPolicy(0, 0.0, False))


def test_run_isolated_device_failure_counts_against_the_budget():
    """The JAX loop's free retry after a tier demotion does not exist here
    (D4): a device failure is retried on the same program and counts, so
    with ``retries=0`` one failure quarantines; ``on_failure`` still sees
    the kind."""
    seen = []

    def work():
        raise faults.InjectedDeviceError("oom")

    ok, out = tres.run_isolated("u", work, policy=tres.FaultPolicy(0, 0.0, True),
                                on_failure=lambda e, kind: seen.append(kind))
    assert (ok, out) == (False, None) and seen == ["device"]
    calls = []

    def second_time_lucky():
        calls.append(1)
        if len(calls) < 2:
            raise faults.InjectedDeviceError("oom")
        return "done"

    ok, out = tres.run_isolated("v", second_time_lucky,
                                policy=tres.FaultPolicy(1, 0.0, True))
    assert (ok, out) == (True, "done") and len(calls) == 2


def test_eval_journal_roundtrip_torn_tail_and_header_mismatch(tmp_path):
    path = str(tmp_path / "j.jsonl")
    header = {"batch_size": 2, "alpha": 0.1}
    j = tres.EvalJournal(path, header)
    a0 = np.asarray([0.25, 0.5], dtype=np.float32)
    a1 = np.asarray([1.0 / 3.0], dtype=np.float32)
    j.append(0, a0)
    j.append(1, a1)
    j.close()
    with open(path, "a") as f:
        f.write('{"batch": 2, "pck"')
    j2 = tres.EvalJournal(path, header)
    assert sorted(j2.entries) == [0, 1]
    np.testing.assert_array_equal(j2.entries[1], a1)
    a2 = np.asarray([0.75], dtype=np.float32)
    j2.append(2, a2)
    j2.close()
    assert sorted(tres.EvalJournal(path, header).entries) == [0, 1, 2]
    with open(path, "rb") as f:
        intact = f.read()
    with open(path, "wb") as f:
        f.write(intact[:-1])
    j2c = tres.EvalJournal(path, header)
    assert sorted(j2c.entries) == [0, 1]
    j2c.append(2, a2)
    j2c.close()
    # the JAX package resumes the port's journal
    assert sorted(jres.EvalJournal(path, header).entries) == [0, 1, 2]
    j3 = tres.EvalJournal(path, {"batch_size": 4, "alpha": 0.1})
    assert j3.entries == {}
    j3.close()
    stale = tres.EvalJournal(path + ".stale", header)
    assert sorted(stale.entries) == [0, 1, 2]
    stale.close()


def test_eval_journal_torn_write_sealed_before_next_append(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = tres.EvalJournal(path, {"v": 1})
    j.append(0, np.asarray([0.5], dtype=np.float32))
    j._f.write('{"batch": 1, "pck')
    j._f.flush()
    j._dirty = True
    a1 = np.asarray([0.25], dtype=np.float32)
    j.append(1, a1)
    j.close()
    j2 = tres.EvalJournal(path, {"v": 1})
    assert sorted(j2.entries) == [0, 1]
    np.testing.assert_array_equal(j2.entries[1], a1)
    j2.close()


def test_quarantine_breaker_trips_on_streak():
    b = tres.QuarantineBreaker(3)
    b.note(True)
    b.note(True)
    b.note(False)
    b.note(True)
    b.note(True)
    with pytest.raises(tres.SystemicEvalError, match="systemic"):
        b.note(True)
    disabled = tres.QuarantineBreaker(0)
    for _ in range(20):
        disabled.note(True)


def test_call_with_watchdog_paths():
    assert tpipe.call_with_watchdog(lambda x: x + 1, (1,), timeout=0.0) == 2
    assert tpipe.call_with_watchdog(lambda: "ok", timeout=5.0) == "ok"
    with pytest.raises(ValueError, match="inner"):
        tpipe.call_with_watchdog(
            lambda: (_ for _ in ()).throw(ValueError("inner")), timeout=5.0)
    with pytest.raises(tpipe.FetchTimeoutError, match="watchdog"):
        tpipe.call_with_watchdog(time.sleep, (5.0,), timeout=0.1, label="hung")


def test_controller_note_failure_clears_anchor_and_window(monkeypatch):
    now = [0.0]
    monkeypatch.setattr(tpipe.time, "perf_counter", lambda: now[0])
    ctl = tpipe.PipelineDepthController(0, high=0.7, low=0.45)
    ctl.note_drain()
    for _ in range(3):
        now[0] += 0.3
        ctl.note_drain()
    assert ctl._ewma == pytest.approx(0.3)
    ctl.note_failure()
    assert ctl._t_last is None and ctl._ewma is None
    assert ctl.best == pytest.approx(0.3)
    now[0] += 100.0
    ctl.note_drain()
    assert ctl._ewma is None
    for _ in range(4):
        now[0] += 0.3
        ctl.note_drain()
    assert ctl.depth == 2
    with pytest.raises(ValueError, match="pipeline_depth"):
        tpipe.PipelineDepthController(-1)


def test_controller_depths_follow_the_jax_controller(monkeypatch):
    """A wall sequence with a slow regime, a recovery and gaps: the port's
    controller takes the JAX one's depth at every drain."""
    import ncnet_tpu.evaluation.pipeline as jpipe

    walls = [0.2] * 6 + [1.5] * 10 + [0.2] * 12 + [None] + [0.9] * 8 + [0.1] * 6
    depths = []
    for mod, cls in ((jpipe, JaxController), (tpipe, tpipe.PipelineDepthController)):
        now = [0.0]
        monkeypatch.setattr(mod.time, "perf_counter", lambda: now[0])
        ctl, seq = cls(0), []
        ctl.note_drain()
        for w in walls:
            if w is None:
                ctl.note_gap()
                continue
            now[0] += w
            ctl.note_drain()
            seq.append(ctl.depth)
        depths.append(seq)
    assert depths[0] == depths[1] and max(depths[1]) > 2


def test_quality_host_half_matches_jax(tmp_path):
    from ncnet_tpu.observability import quality as jquality

    rng = np.random.default_rng(3)
    a, b = rng.uniform(size=12), rng.uniform(size=12)
    b[3] = np.nan
    a[5] = a[6]
    assert tquality.spearman(a, b) == jquality.spearman(a, b)
    assert np.isnan(tquality.spearman([1, 2], [2, 1]))
    assert tquality.SIGNAL_RANGE == jquality.SIGNAL_RANGE
    assert tquality.DIGEST_BINS == jquality.DIGEST_BINS
    nc_fused_lane._last_selected.update(forward="resident", pipeline="dense")
    assert tquality.active_tier(True) == "resident"
    assert tquality.active_tier(False) == "xla"
    nc_fused_lane._last_selected["forward"] = "fft"
    assert tquality.active_tier(False) == "fft"
    nc_fused_lane._last_selected["pipeline"] = "coarse2fine"
    assert tquality.active_tier(False) == "coarse2fine"
    nc_fused_lane._last_selected["pipeline"] = "dense"
    from ncnet_tpu_torch.observability.metrics import MetricsRegistry

    reg = MetricsRegistry()
    path = str(tmp_path / "q.jsonl")
    with tevents.EventLog(path) as sink, tevents.bound(sink):
        tquality.emit_quality("s", {"score": [0.5, np.nan]}, tier="xla",
                              pck=[1.0, np.nan], registry=reg, batch=0)
    _, evs = tevents.replay_events(path)
    q = [e for e in evs if e["event"] == "quality"][0]
    assert q["signals"]["score"][0] == 0.5 and q["batch"] == 0
    assert reg.histogram("q_score").snapshot()["count"] == 1


def test_device_and_memory_planes_are_silent_on_the_cpu():
    from ncnet_tpu_torch.observability import device as tdevice

    assert tdevice.device_snapshot() == []
    assert tmemory.hbm_stats() is None and tmemory.live_tensor_census() is None
    assert tdevice.DeviceMonitor(every_s=0.0).maybe_emit(step=0) is False
    assert tmemory.LeakSentinel(window=1).observe(step=0) is None


def test_leak_sentinel_names_a_growing_shape_class(monkeypatch):
    censuses = iter([{"n": n, "bytes": 4 * n, "classes": 2, "by_class": {
        "float32[4]": {"n": n, "bytes": 16 * n}, "uint8[2]": {"n": 3, "bytes": 6}}}
        for n in (1, 2, 3, 4, 5, 5)])
    monkeypatch.setattr(tmemory, "live_tensor_census", lambda: next(censuses))
    s = tmemory.LeakSentinel(window=3, scope="t")
    fired = [s.observe(step=i) for i in range(6)]
    assert fired[:3] == [None] * 3
    assert [x["shape_class"] for x in fired[3]["suspects"]] == ["float32[4]"]
    assert fired[4] is None and fired[5] is None


# ---------------------------------------------------------------------------
# the reference checkpoint importer
# ---------------------------------------------------------------------------


def reference_ckpt(config, jp, vgg_prefix=False):
    """A reference ``.pth.tar`` dict from JAX numpy params: the trunk under
    ``FeatureExtraction.model.<idx>`` (``vgg`` for the legacy spelling)
    with ``num_batches_tracked``, the NC weights in the stored Conv4d
    layout, and the run's ``args``."""
    sd = {}
    root = "FeatureExtraction." + ("vgg" if vgg_prefix else "model")
    trunk = jp["backbone"]
    conv = lambda w: torch.from_numpy(np.ascontiguousarray(  # noqa: E731
        np.transpose(w, (3, 2, 0, 1))))

    def bn(prefix, p):
        for name, leaf in (("weight", "scale"), ("bias", "bias"),
                           ("running_mean", "mean"), ("running_var", "var")):
            sd[f"{prefix}.{name}"] = torch.from_numpy(np.array(p[leaf]))
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(7)

    sd[f"{root}.0.weight"] = conv(trunk["conv1"]["w"])
    bn(f"{root}.1", trunk["bn1"])
    for stage, seq in (("layer1", 4), ("layer2", 5), ("layer3", 6)):
        for i, blk in enumerate(trunk[stage]):
            p = f"{root}.{seq}.{i}"
            for j in (1, 2, 3):
                sd[f"{p}.conv{j}.weight"] = conv(blk[f"conv{j}"]["w"])
                bn(f"{p}.bn{j}", blk[f"bn{j}"])
            if "downsample" in blk:
                sd[f"{p}.downsample.0.weight"] = conv(blk["downsample"]["conv"]["w"])
                bn(f"{p}.downsample.1", blk["downsample"]["bn"])
    for j, layer in enumerate(jp["nc"]):
        sd[f"NeighConsensus.conv.{2 * j}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.transpose(layer["w"], (0, 5, 4, 1, 2, 3))))
        sd[f"NeighConsensus.conv.{2 * j}.bias"] = torch.from_numpy(np.array(layer["b"]))
    args = argparse.Namespace(ncons_kernel_sizes=list(config.ncons_kernel_sizes),
                              ncons_channels=list(config.ncons_channels),
                              feature_extraction_cnn="resnet101")
    return {"epoch": 3, "args": args, "state_dict": sd}


@pytest.fixture(scope="module")
def resnet_ckpt(tmp_path_factory):
    """A ResNet-101 PF-Pascal-architecture checkpoint, both key spellings."""
    arch = jcfg.ModelConfig(ncons_kernel_sizes=(5, 5, 5), ncons_channels=(16, 16, 1))
    jp = jax.tree.map(np.asarray, jnet.init_ncnet(arch, jax.random.key(4)))
    jp["backbone"]["bn1"]["mean"] = np.linspace(-1, 1, 64).astype(np.float32)
    out = {}
    for vgg in (False, True):
        path = str(tmp_path_factory.mktemp("ck") / "ncnet_pfpascal.pth.tar")
        torch.save(reference_ckpt(arch, jp, vgg_prefix=vgg), path)
        out[vgg] = path
    return out, jp


def assert_trees_equal(got, want, path="params"):
    """Port tensors equal, key for key, to a port tree (or to JAX numpy
    params, converted by ``params_from_numpy``)."""
    if path == "params" and not isinstance(tnet.tree_leaves(want)[0], torch.Tensor):
        want = params_from_numpy(want)
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f"{path}[{i}]")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert torch.equal(got, want), path


@pytest.mark.parametrize("vgg_prefix", [False, True])
def test_import_torch_checkpoint_equals_jax(resnet_ckpt, vgg_prefix):
    """The arch override from ``args`` and every imported array equal the
    JAX importer's (the trunk in the port's OIHW layout); the legacy
    ``vgg`` key spelling and ``num_batches_tracked`` are handled."""
    paths, _ = resnet_ckpt
    base = dict(half_precision=True, backbone_bf16=True)
    jc, jp = jckpt.import_torch_checkpoint(paths[vgg_prefix], jcfg.ModelConfig(**base))
    tc, tp = tckpt.import_torch_checkpoint(paths[vgg_prefix], tcfg.ModelConfig(**base))
    assert tc == tcfg.ModelConfig(**{**jc.__dict__})
    assert tc.ncons_kernel_sizes == (5, 5, 5) and tc.half_precision
    assert_trees_equal(tp, jax.tree.map(np.asarray, jp))


def test_ncnet_loads_the_checkpoint_as_the_jax_package(resnet_ckpt):
    paths, jp = resnet_ckpt
    jn = jnet.NCNet(jcfg.ModelConfig(checkpoint=paths[False]))
    tn = tnet.NCNet(tcfg.ModelConfig(checkpoint=paths[False]), device="cpu")
    assert tn.config == tcfg.ModelConfig(**jn.config.__dict__)
    assert_trees_equal(tn.params, jax.tree.map(np.asarray, jn.params))
    # and the port's weights written back in the reference layout import
    # to themselves
    sd = tckpt.reference_state_dict(tn.config, tn.params)
    back = tckpt.import_torch_checkpoint({"state_dict": sd}, tn.config)[1]
    assert_trees_equal(back, tn.params)


def test_backbone_weights_load_as_the_jax_package(resnet_ckpt, tmp_path):
    """A torchvision-named trunk ``state_dict``: the port's
    ``init_ncnet`` trunk equals the JAX one's."""
    _, jp = resnet_ckpt
    sd = {}
    arch = jcfg.ModelConfig(ncons_kernel_sizes=(5, 5, 5), ncons_channels=(16, 16, 1))
    for k, v in reference_ckpt(arch, jp)["state_dict"].items():
        if k.startswith("FeatureExtraction.model."):
            idx, _, tail = k[len("FeatureExtraction.model."):].partition(".")
            sd[f"{ {'0': 'conv1', '1': 'bn1', '4': 'layer1', '5': 'layer2', '6': 'layer3'}[idx]}.{tail}"] = v
    path = str(tmp_path / "resnet101.pth")
    torch.save(sd, path)
    jtrunk = jnet.init_ncnet(jcfg.ModelConfig(backbone_weights=path),
                             jax.random.key(0))["backbone"]
    ttrunk = tnet.init_ncnet(tcfg.ModelConfig(backbone_weights=path))["backbone"]
    assert_trees_equal({"nc": [], "backbone": ttrunk},
                       {"nc": [], "backbone": jax.tree.map(np.asarray, jtrunk)})


def test_checkpoint_directory_and_unported_trunks_refuse(tmp_path):
    """Directories load since the native format (ROADMAP D5): an empty one
    has no ``config.json`` (as in the JAX package), and a JAX-written
    orbax ``params/`` is refused by name.  A reference file loads for
    ResNet-101, VGG-16 and DenseNet-201 since the trunk slice: a VGG-16
    ``.pth.tar`` written by the port loads as a model, with the weights the
    JAX importer reads from it; the ``tiny`` test trunk has no reference
    file and stays refused."""
    with pytest.raises(FileNotFoundError, match="config.json"):
        tckpt.load_params(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="config.json"):
        tnet.NCNet(tcfg.ModelConfig(checkpoint=str(tmp_path)), device="cpu")
    (tmp_path / "params").mkdir()
    (tmp_path / "config.json").write_text(
        json.dumps(dataclasses.asdict(tcfg.ModelConfig(backbone="tiny"))))
    with pytest.raises(ValueError, match="orbax"):
        tckpt.load_params(str(tmp_path))
    vgg = tcfg.ModelConfig(backbone="vgg", ncons_kernel_sizes=(3,),
                           ncons_channels=(1,))
    with pytest.warns(UserWarning, match="RANDOM"):
        params = tnet.init_ncnet(vgg, seed=4)
    path = str(tmp_path / "vgg.pth.tar")
    torch.save({"state_dict": tckpt.reference_state_dict(vgg, params),
                "args": argparse.Namespace(feature_extraction_cnn="vgg",
                                           ncons_kernel_sizes=[3],
                                           ncons_channels=[1])}, path)
    model = tnet.NCNet(tcfg.ModelConfig(backbone="vgg", checkpoint=path),
                       device="cpu")
    assert model.config.backbone == "vgg"
    assert_trees_equal(tckpt.cpu_tree(model.params), params)
    _, jp = jckpt.import_torch_checkpoint(path, jcfg.ModelConfig())
    assert_trees_equal(params, jax.tree.map(np.asarray, jp))
    with pytest.raises(NotImplementedError, match="checkpoint"):
        tnet.NCNet(tcfg.ModelConfig(backbone="tiny", checkpoint="x.pth.tar"),
                   device="cpu")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.fixture
def shared_init(monkeypatch):
    """The two packages draw different random weights from one seed; the
    CLI tests make both draw the JAX package's (identity NC layer)."""
    orig = jnet.init_ncnet

    def jinit(config, key):
        p = orig(config, key)
        w = np.zeros((3, 3, 3, 3, 1, 1), np.float32)
        w[1, 1, 1, 1, 0, 0] = 1.0
        p["nc"] = [{"w": jax.numpy.asarray(w), "b": jax.numpy.zeros((1,))}]
        return p

    def tinit(config, seed=1):
        jc = jcfg.ModelConfig(**{k: getattr(config, k) for k in config.__dict__})
        return params_from_numpy(jax.tree.map(np.asarray,
                                              jinit(jc, jax.random.key(seed))))

    monkeypatch.setattr(jnet, "init_ncnet", jinit)
    monkeypatch.setattr(tnet, "init_ncnet", tinit)


@pytest.mark.parametrize("extra", [[], ["--host_normalize", "--batch_size", "2"]])
def test_cli_prints_the_jax_clis_lines(fixture_root, shared_init, capsys, extra):
    argv = ["--eval_dataset_path", fixture_root, "--image_size", str(SIDE),
            "--backbone", "tiny"] + extra
    assert jcli.main(argv) == 0
    want = capsys.readouterr().out
    assert tcli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert got.splitlines()[0] == "NCNet evaluation script - PF Pascal dataset"
    assert "Total: 5\nValid: 5\nPCK: " in got


def test_cli_degraded_run_exits_2(fixture_root, shared_init, capsys, tmp_path):
    """An undecodable image (pair scored invalid) and a quarantined batch
    each make the run degraded: exit 2 with the culprits printed."""
    import shutil

    root = str(tmp_path / "data")
    shutil.copytree(fixture_root, root)
    with open(os.path.join(root, "images", "test_2_b.jpg.npy"), "wb") as f:
        f.write(b"garbage")
    argv = ["--eval_dataset_path", root, "--image_size", str(SIDE),
            "--backbone", "tiny", "--device", "cpu"]
    assert tcli.main(argv) == 2
    out = capsys.readouterr().out
    assert "Valid: 4" in out and "Undecodable images" in out
    with faults.injected(faults.FaultPlan(device_fail_calls=(1, 2, 3, 4))):
        assert tcli.main(["--eval_dataset_path", fixture_root, "--image_size",
                          str(SIDE), "--backbone", "tiny", "--device", "cpu",
                          "--query_retries", "1", "--retry_backoff_s", "0",
                          "--journal_dir", str(tmp_path / "j")]) == 2
    out = capsys.readouterr().out
    assert "Quarantined batches: [0]" in out
    assert tres.manifest_has_quarantined(str(tmp_path / "j" / "manifest.json"))


def test_cli_flags_are_the_jax_clis():
    jp, tp = jcli.build_parser(), tcli.build_parser()
    jflags = {a.dest: a.default for a in jp._actions}
    tflags = {a.dest: a.default for a in tp._actions}
    assert tflags.pop("device") == "cuda"
    assert tflags == jflags


def test_cli_runs_as_a_module(fixture_root):
    """``python -m ncnet_tpu_torch.cli.eval_pf_pascal --help`` from the
    repository root, without JAX on the path's use."""
    proc = subprocess.run([sys.executable, "-m", "ncnet_tpu_torch.cli.eval_pf_pascal",
                           "--help"], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and "--device" in proc.stdout
