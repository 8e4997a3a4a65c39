"""The port's retrieval tier (``ncnet_tpu_torch/retrieval/``) against the
JAX package's (``ncnet_tpu/retrieval/``) on the CPU.

Every in-process case of ``tests/test_retrieval.py`` runs once with each
package's modules (``pkg``): assignment, scoring, the index manifests, the
verified store under a bit flip, the wire, in-process shard pods behind a
coordinator (R = 1 honesty, hedging, a corrupt shard, a zero budget), the
shard's control plane, and both packages' tools reading either package's
event log and coordinator document (``run_report``, ``stall_watchdog``),
which must agree.  The fixtures are the port's
(``serve_probe.build_coarse_fixture``, whose bytes are the JAX tool's:
``tests/test_torch_port_probe_tools.py``), so both packages serve the
same store.
The process cases (real shard hosts, SIGKILL, mixed pods) are in
``tests/test_torch_port_retrieval_pod.py``.

Beside them: the scoring functions bit-equal to JAX's (remainder rows and
columns, exact ties), the retrieve frames byte-identical with the wall
clock pinned, and the port's ``build_coarse_index --raw`` writing the JAX
tool's manifests and store bytes.  Waits are on states (a shard's DEAD,
the hedge counter), never on wall bounds, so the cases hold under xdist.
"""

import glob
import io
import json
import os
import sys
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
from PIL import Image
from scipy.io import savemat

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_REPO, "tools"))

import stall_watchdog  # noqa: E402

from ncnet_tpu_torch.tools import serve_probe as port_serve_probe  # noqa: E402
from ncnet_tpu_torch.tools import stall_watchdog as port_stall_watchdog  # noqa: E402

from torch_port_tool_twins import both, both_judge_url, same  # noqa: E402

PKGS = ("jax", "torch")
FACTOR = 4
GRID = 16


def load(name):
    if name == "jax":
        from ncnet_tpu import retrieval, serving, store
        from ncnet_tpu.observability import EventLog
        from ncnet_tpu.observability import events
        from ncnet_tpu.observability.export import parse_prometheus
        from ncnet_tpu.observability.perfstore import metric_direction
        from ncnet_tpu.retrieval import wire as rwire
        from ncnet_tpu.serving.wire import WireError
        from ncnet_tpu.store import feature_store
        from ncnet_tpu.utils import faults
    else:
        from ncnet_tpu_torch import retrieval, serving, store
        from ncnet_tpu_torch.observability import EventLog
        from ncnet_tpu_torch.observability import events
        from ncnet_tpu_torch.observability.export import parse_prometheus
        from ncnet_tpu_torch.observability.perfstore import metric_direction
        from ncnet_tpu_torch.retrieval import wire as rwire
        from ncnet_tpu_torch.serving.wire import WireError
        from ncnet_tpu_torch.store import feature_store
        from ncnet_tpu_torch.utils import faults
    return types.SimpleNamespace(
        name=name, r=retrieval, serving=serving, store=store, events=events,
        EventLog=EventLog, parse_prometheus=parse_prometheus,
        metric_direction=metric_direction, rwire=rwire, WireError=WireError,
        feature_store=feature_store, faults=faults)


def clean(p):
    p.faults.clear()
    p.events.set_global_sink(None)


@pytest.fixture(params=PKGS)
def pkg(request):
    p = load(request.param)
    clean(p)
    yield p
    clean(p)


def wait_until(pred, timeout=30.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def make_img(i, hw=(96, 128)):
    """A structured pano (distinct hue levels and stripe cadence): the raw
    extractor scores noise images all alike (cosine ~0.9999), so a noise
    fixture could never show a ranking."""
    img = np.zeros((*hw, 3), np.uint8)
    img[..., 0] = (37 * i) % 256
    img[..., 1] = (91 * i + 13) % 256
    img[:: (i % 5) + 2, :, 2] = 255
    return img


def descriptor(p, img):
    return p.r.pooled_descriptor(p.r.raw_coarse_volume(img, FACTOR, grid=GRID))


def build_fixture(root, n_panos=12):
    return port_serve_probe.build_coarse_fixture(str(root), n_panos,
                                                 factor=FACTOR, grid=GRID)


def start_inproc_pod(p, root, n_shards, replication, n_panos=12):
    """N ``ShardService``s of ``p`` over one store and index, each behind
    its own introspection plane: ``(services, {sid: url}, index, images)``."""
    index_path, images = build_fixture(root, n_panos)
    index = p.r.load_index_manifests(index_path)
    shard_ids = [f"s{i}" for i in range(n_shards)]
    services, urls = [], {}
    for sid in shard_ids:
        st = p.store.FeatureStore(str(root), index["fingerprint"],
                                  scope=f"test_{sid}")
        svc = p.r.ShardService(sid, shard_ids, index, st,
                               replication=replication, introspect_port=0)
        svc.start()
        assert svc.introspect_url is not None
        services.append(svc)
        urls[sid] = svc.introspect_url
    return services, urls, index, images


def stop_all(coord, services):
    if coord is not None:
        coord.stop()
    for s in services:
        s.stop()


# ---------------------------------------------------------------------------
# the cases of tests/test_retrieval.py, once per package
# ---------------------------------------------------------------------------


def test_rendezvous_assignment_properties(pkg):
    shards = [f"s{i}" for i in range(4)]
    panos = [f"p{i:03d}" for i in range(200)]
    t1 = pkg.r.assignment_table(panos, shards, 2)
    assert t1 == pkg.r.assignment_table(panos, shards, 2)
    owners = {p: [s for s in shards if p in set(t1[s])] for p in panos}
    assert all(len(o) == 2 for o in owners.values())
    assert all(set(o) == set(pkg.r.replica_shards(p, shards, 2))
               for p, o in owners.items())
    counts = [len(t1[s]) for s in shards]
    assert sum(counts) == 400
    assert min(counts) > 50 and max(counts) < 150
    survivors = shards[:-1]
    for p in panos:
        old = pkg.r.replica_shards(p, shards, 2)
        new = pkg.r.replica_shards(p, survivors, 2)
        if "s3" not in old:
            assert new == old
        else:
            assert set(old) & set(new)
    with pytest.raises(ValueError):
        pkg.r.replica_shards("p0", shards, 0)


def test_raw_extractor_discriminates_and_topk_deterministic(pkg):
    vols = {f"p{i}": pkg.r.raw_coarse_volume(make_img(i), FACTOR, grid=GRID)
            for i in range(6)}
    desc = descriptor(pkg, make_img(3))
    scores = {n: pkg.r.score_coarse_volume(desc, v) for n, v in vols.items()}
    ranked = pkg.r.top_k(scores, 3)
    assert ranked[0][0] == "p3"
    assert ranked == pkg.r.top_k(scores, 3)
    assert pkg.r.top_k([("b", 1.0), ("a", 1.0), ("c", 0.5)], 2) == \
        (("a", 1.0), ("b", 1.0))
    with pytest.raises(ValueError):
        pkg.r.score_coarse_volume(np.ones(5, np.float32), vols["p0"])
    feat = np.random.default_rng(0).normal(size=(1, 16, 16, 8))
    vol = pkg.r.coarse_volume_from_features(feat, FACTOR)
    assert vol.shape == (4, 4, 8)
    assert np.allclose(np.linalg.norm(vol, axis=-1), 1.0, atol=1e-5)


def test_coarse_fingerprint_is_own_generation_same_weights_segment(pkg):
    base = "abc123-s3200-k2-bf16"
    fp = pkg.store.coarse_fingerprint(base, 4)
    assert fp == "abc123-s3200-k2-bf16-c4"
    assert fp != pkg.store.coarse_fingerprint(base, 2)
    assert pkg.feature_store._weights_segment(fp) == \
        pkg.feature_store._weights_segment(base)


def test_retrieval_metrics_gate_directions(pkg):
    assert pkg.metric_direction("retrieve_coverage_pct") == "higher"
    assert pkg.metric_direction("retrieve_hedge_pct") == "lower"
    assert pkg.metric_direction("retrieve_p95_ms") == "lower"


def test_wire_roundtrip_and_checksum_refusal(pkg):
    desc = descriptor(pkg, make_img(0))
    data = pkg.r.encode_retrieve_request(desc, panos=["a", "b"], topk=3,
                                         client="t", budget_s=1.5,
                                         request_id="q1")
    got, meta = pkg.r.decode_retrieve_request(data)
    np.testing.assert_array_equal(got, desc)
    assert meta["panos"] == ["a", "b"] and meta["topk"] == 3
    assert meta["budget_s"] == 1.5 and meta["request"] == "q1"
    answer = {"shard": "s0", "scores": [["p1", 0.9]], "coverage": 1.0}
    status, payload = pkg.r.encode_retrieve_response(answer)
    assert status == 200
    assert pkg.r.decode_retrieve_response(payload) == answer
    corrupt = bytearray(payload)
    corrupt[-2] ^= 0x01
    with pytest.raises(pkg.WireError):
        pkg.r.decode_retrieve_response(bytes(corrupt))


def test_fault_plan_shard_hooks(pkg):
    f = pkg.faults
    url = "http://127.0.0.1:45678"
    f.shard_fault_hook(url, "send")
    assert f.shard_payload_hook(url, b"abc") == b"abc"
    f.install(f.FaultPlan(dead_shard_urls=("127.0.0.1:45678",),
                          shard_bitflip_urls=("127.0.0.1:9",)))
    with pytest.raises(ConnectionError):
        f.shard_fault_hook(url, "send")
    f.shard_fault_hook("http://127.0.0.1:1", "send")
    assert f.shard_payload_hook(url, b"abc") == b"abc"
    assert f.shard_payload_hook("http://127.0.0.1:9", b"abc") == b"abb"
    f.clear()
    f.shard_fault_hook(url, "send")
    # a hang dies after its sleep, a straggler proceeds after its sleep
    f.install(f.FaultPlan(hang_shard_urls=(":45678",),
                          hang_shard_seconds=0.0,
                          slow_shard_urls=(":1",), slow_shard_seconds=0.0))
    with pytest.raises(ConnectionError, match="hang"):
        f.shard_fault_hook(url, "send")
    f.shard_fault_hook("http://127.0.0.1:1", "send")


def test_local_shortlist_bitflip_quarantines_recomputes_identical(pkg,
                                                                  tmp_path):
    index_path, images = build_fixture(tmp_path, n_panos=6)
    index = pkg.r.load_index_manifests(index_path)

    def compute(name):
        return pkg.r.raw_coarse_volume(images[name], FACTOR, grid=GRID)

    st = pkg.store.FeatureStore(str(tmp_path), index["fingerprint"],
                                scope="t")
    try:
        victim = sorted(images)[2]
        desc = descriptor(pkg, images[victim])
        baseline = pkg.r.local_shortlist(st, index, desc, topk=4,
                                         compute=compute)
        assert baseline["coverage"] == 1.0
        assert baseline["scores"][0][0] == victim
        digest = index["panos"][victim]
        arr = compute(victim)
        with pkg.faults.injected(pkg.faults.FaultPlan(
                store_bitflip_paths=(digest,))):
            st.put(digest, arr)
        again = pkg.r.local_shortlist(st, index, desc, topk=4,
                                      compute=compute)
        assert st.counters["corrupt"] == 1
        assert again["scores"] == baseline["scores"]
        assert again["coverage"] == 1.0
        with pkg.faults.injected(pkg.faults.FaultPlan(
                store_bitflip_paths=(digest,))):
            st.put(digest, arr)
        partial = pkg.r.local_shortlist(st, index, desc, topk=4)
        assert partial["coverage"] < 1.0
        assert victim in partial["unavailable"]
    finally:
        st.close()


def test_r1_dead_shard_reports_degraded_coverage_never_silent(pkg, tmp_path):
    services, urls, index, _ = start_inproc_pod(pkg, tmp_path, 2, 1)
    coord = None
    try:
        cfg = pkg.r.RetrievalConfig(replication=1, topk=5, max_failures=2,
                                    probe_period_s=5.0)
        coord = pkg.r.RetrievalCoordinator(urls, list(index["panos"]), cfg)
        coord.start()
        dead = urls["s1"].replace("http://", "")
        pkg.faults.install(pkg.faults.FaultPlan(dead_shard_urls=(dead,)))
        ans = coord.retrieve(descriptor(pkg, make_img(1)), budget_s=10.0,
                             request_id="r1-q0")
        assert ans["degraded"] is True
        assert 0.0 < ans["coverage"] < 1.0
        assert ans["consulted"] < ans["total"]
        assert all(p in index["panos"] for p, _ in ans["scores"])
    finally:
        pkg.faults.clear()
        stop_all(coord, services)


def test_hedging_beats_slow_straggler(pkg, tmp_path):
    """A merely slow shard is hedged: its panos go to replicas after
    ``hedge_after_s`` and the query answers at full coverage while the
    straggler still sleeps (30 s against a 0.12 s hedge, so no wall bound
    is tight), the straggler never marked dead."""
    services, urls, index, images = start_inproc_pod(pkg, tmp_path, 4, 2)
    coord = None
    try:
        cfg = pkg.r.RetrievalConfig(replication=2, topk=5,
                                    hedge_after_s=0.12, probe_period_s=5.0)
        coord = pkg.r.RetrievalCoordinator(urls, list(index["panos"]), cfg)
        coord.start()
        slow = urls["s2"].replace("http://", "")
        pkg.faults.install(pkg.faults.FaultPlan(slow_shard_urls=(slow,),
                                                slow_shard_seconds=30.0))
        t0 = time.perf_counter()
        ans = coord.retrieve(descriptor(pkg, make_img(2)), budget_s=60.0,
                             request_id="hedge-q0")
        assert time.perf_counter() - t0 < 30.0
        assert ans["coverage"] == 1.0
        assert ans["hedges"] >= 1
        assert ans["scores"][0][0] == sorted(images)[2]
        assert coord._backends["s2"].state == "READY"
    finally:
        pkg.faults.clear()
        stop_all(coord, services)


def test_wire_bitflip_refused_replica_covers(pkg, tmp_path):
    services, urls, index, _ = start_inproc_pod(pkg, tmp_path, 4, 2)
    coord = None
    try:
        cfg = pkg.r.RetrievalConfig(replication=2, topk=5, max_failures=2,
                                    probe_period_s=5.0)
        coord = pkg.r.RetrievalCoordinator(urls, list(index["panos"]), cfg)
        coord.start()
        clean_ans = coord.retrieve(descriptor(pkg, make_img(4)),
                                   budget_s=10.0, request_id="bf-base")
        assert clean_ans["coverage"] == 1.0
        flip = urls["s0"].replace("http://", "")
        pkg.faults.install(pkg.faults.FaultPlan(shard_bitflip_urls=(flip,)))
        for i in range(3):
            ans = coord.retrieve(descriptor(pkg, make_img(4)), budget_s=10.0,
                                 request_id=f"bf-q{i}")
            assert ans["coverage"] == 1.0
            assert ans["scores"] == clean_ans["scores"]
        assert coord._backends["s0"].state == "DEAD"
    finally:
        pkg.faults.clear()
        stop_all(coord, services)


def test_zero_budget_classifies_deadline(pkg, tmp_path):
    services, urls, index, _ = start_inproc_pod(pkg, tmp_path, 2, 2,
                                                n_panos=4)
    coord = None
    try:
        coord = pkg.r.RetrievalCoordinator(
            urls, list(index["panos"]),
            pkg.r.RetrievalConfig(probe_period_s=5.0))
        coord.start()
        with pytest.raises(pkg.serving.DeadlineExceeded):
            coord.retrieve(descriptor(pkg, make_img(0)), budget_s=0.0,
                           request_id="dl-q0")
    finally:
        stop_all(coord, services)


def test_shard_wire_plane_and_metrics(pkg, tmp_path):
    services, urls, _, _ = start_inproc_pod(pkg, tmp_path, 2, 2, n_panos=6)
    try:
        url = urls["s0"]
        client = pkg.r.RetrieveClient(url)
        ans = client.retrieve(descriptor(pkg, make_img(1)), budget_s=5.0,
                              request_id="wire-q0")
        client.close()
        assert ans["shard"] == "s0"
        assert ans["consulted"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(
                urllib.request.Request(f"{url}/match", data=b"x",
                                       method="POST"), timeout=5)
        assert ei.value.code == 404
        body = urllib.request.urlopen(f"{url}/metrics",
                                      timeout=5).read().decode()
        families = pkg.parse_prometheus(body)
        up = [v for _n, _l, v in
              families["ncnet_retrieve_shard_up"]["samples"]]
        assert up == [1.0]
        assert "ncnet_retrieve_shard_requests_total" in families
    finally:
        for s in services:
            s.stop()


def test_run_report_retrieval_identity_flags_lost(pkg, tmp_path):
    """The JAX ``run_report`` replays either package's retrieval events:
    an admit with no terminal outcome reads as unresolved and lost, and a
    degraded result is split out of the full-coverage count."""
    log_path = str(tmp_path / "ev.jsonl")
    sink = pkg.EventLog(log_path)
    with pkg.events.bound(sink):
        pkg.events.emit("retrieve_admit", request="q1", client="t",
                        panos=4, budget_s=1.0)
        pkg.events.emit("retrieve_result", request="q1", client="t",
                        coverage=0.5, degraded=True, hedges=0,
                        attempts=2, consulted=2, total=4, wall_ms=3.0)
        pkg.events.emit("retrieve_admit", request="q2", client="t",
                        panos=4, budget_s=1.0)
    sink.close()
    r = both("run_report", "build_report", [log_path])["retrieval"]
    assert r["outcomes"]["admitted"] == 2
    assert r["outcomes"]["results"] == 1
    assert r["outcomes"]["results_degraded"] == 1
    assert r["outcomes"]["unresolved"] == 1
    assert len(r["lost_requests"]) == 1
    assert r["coverage"]["below_full"] == 1
    assert "VIOLATED" in both("run_report", "render_retrieval",
                              {"retrieval": r})


def test_stall_watchdog_retrieval_advisory(pkg, tmp_path):
    """The JAX ``stall_watchdog`` reads a coordinator's document of either
    package: its shard capacity and coverage advisory, DEGRADED once a
    shard of the pod is dead (the case of ``tests/test_retrieval.py`` on a
    hand-written document, here on a live one)."""
    services, urls, index, _ = start_inproc_pod(pkg, tmp_path, 2, 2,
                                                n_panos=4)
    coord = None
    try:
        coord = pkg.r.RetrievalCoordinator(
            urls, list(index["panos"]),
            pkg.r.RetrievalConfig(probe_period_s=5.0, max_failures=1,
                                  introspect_port=0))
        coord.start()
        ans = coord.retrieve(descriptor(pkg, make_img(1)), budget_s=10.0,
                             request_id="wd-q0")
        assert ans["coverage"] == 1.0
        pkg.faults.install(pkg.faults.FaultPlan(
            dead_shard_urls=(urls["s1"].replace("http://", ""),)))
        coord.retrieve(descriptor(pkg, make_img(1)), budget_s=10.0,
                       request_id="wd-q1")
        assert wait_until(lambda: coord._backends["s1"].state == "DEAD")
        doc = pkg.r.build_retrieval_document(coord)
        verdict, port_verdict = {"status": "alive"}, {"status": "alive"}
        stall_watchdog._apply_retrieval_advisory(verdict, doc)
        port_stall_watchdog._apply_retrieval_advisory(port_verdict, doc)
        assert same(port_verdict, verdict)
        rt = verdict["retrieval"]
        assert rt["shards_ready"] == 1 and rt["shards_total"] == 2
        assert rt["replication"] == 2 and rt["min_coverage"] == 1.0
        assert rt["coverage_min"] == 1.0
        v = both_judge_url(coord.introspect_url, factor=5, min_age=30.0)
        assert v["status"] == "alive" and v["role"] == "retrieval"
        assert v["retrieval"]["shards_total"] == 2
        verdict2 = {"status": "alive"}
        stall_watchdog._apply_retrieval_advisory(verdict2, {"role": "router"})
        port_stall_watchdog._apply_retrieval_advisory(verdict2,
                                                      {"role": "router"})
        assert "retrieval" not in verdict2
    finally:
        pkg.faults.clear()
        stop_all(coord, services)


def test_index_manifests_refuse_mixed_generations(pkg, tmp_path):
    fp = pkg.store.coarse_fingerprint(f"raw-s{GRID}-k0-f32", FACTOR)
    a = str(tmp_path / "a.json")
    b = str(tmp_path / "b.json")
    pkg.r.write_index_manifest(a, fingerprint=fp, factor=4, extractor="raw",
                               panos={"p0": "d0"})
    pkg.r.write_index_manifest(b, fingerprint=fp, factor=4, extractor="raw",
                               panos={"p1": "d1"})
    merged = pkg.r.load_index_manifests([a, b])
    assert set(merged["panos"]) == {"p0", "p1"}
    assert pkg.r.load_index_manifests(str(tmp_path / "*.json")) == merged
    pkg.r.write_index_manifest(b, fingerprint=fp, factor=2, extractor="raw",
                               panos={"p1": "d1"})
    with pytest.raises(ValueError):
        pkg.r.load_index_manifests([a, b])
    with pytest.raises(ValueError):
        pkg.r.load_index_manifests(str(tmp_path / "nothing*.json"))


# ---------------------------------------------------------------------------
# bit-equal to the JAX package
# ---------------------------------------------------------------------------


def test_assignment_table_equals_jax():
    jr, tr = load("jax").r, load("torch").r
    panos = [f"DUC1/DUC_cutout_{i:03d}_30_0.jpg" for i in range(300)]
    for n, r in ((1, 1), (3, 2), (5, 3), (8, 2)):
        shards = [f"s{i}" for i in range(n)]
        assert tr.assignment_table(panos, shards, r) == \
            jr.assignment_table(panos, shards, r)
        assert [tr.rendezvous_score(p, "s0") for p in panos[:20]] == \
            [jr.rendezvous_score(p, "s0") for p in panos[:20]]


@pytest.mark.parametrize("hw", [(96, 128), (61, 83), (1200, 1600)])
@pytest.mark.parametrize("factor,grid", [(4, 16), (3, 16), (2, 10)])
def test_raw_coarse_volume_equals_jax(hw, factor, grid):
    jr, tr = load("jax").r, load("torch").r
    img = np.random.default_rng(hw[0] + factor).integers(
        0, 255, (*hw, 3), dtype=np.uint8)
    img[::3, :, 2] = 255
    want = jr.raw_coarse_volume(img, factor, grid=grid)
    got = tr.raw_coarse_volume(img[None], factor, grid=grid)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hwc,factor", [((16, 16, 8), 4), ((37, 50, 24), 4),
                                        ((9, 7, 5), 2), ((3, 2, 4), 4),
                                        ((25, 19, 1024), 3)])
def test_scoring_equals_jax(hwc, factor):
    """``coarse_volume_from_features`` (remainder rows and columns folded
    into the last cell), ``pooled_descriptor`` and ``score_coarse_volume``
    bit-equal to JAX's on the same features, batched or not."""
    jr, tr = load("jax").r, load("torch").r
    feat = np.random.default_rng(sum(hwc)).normal(size=hwc).astype(np.float32)
    want = jr.coarse_volume_from_features(feat, factor)
    got = tr.coarse_volume_from_features(feat[None], factor)
    np.testing.assert_array_equal(got, want)
    assert got.shape[:2] == (max(1, hwc[0] // factor),
                             max(1, hwc[1] // factor))
    dj, dt = jr.pooled_descriptor(want), tr.pooled_descriptor(got)
    np.testing.assert_array_equal(dt, dj)
    other = tr.coarse_volume_from_features(feat[::-1].copy(), factor)
    assert tr.score_coarse_volume(dt, other) == \
        jr.score_coarse_volume(dj, other)


def test_top_k_ties_equal_jax():
    jr, tr = load("jax").r, load("torch").r
    rng = np.random.default_rng(5)
    scores = {f"p{i:02d}": float(rng.integers(0, 4)) / 4 for i in range(40)}
    for k in (0, 1, 7, 40, 50):
        assert tr.top_k(scores, k) == jr.top_k(scores, k)
        items = list(scores.items())[::-1]
        assert tr.top_k(items, k) == jr.top_k(dict(items), k)


@pytest.fixture
def frozen_clock(monkeypatch):
    """Both packages' wall clock pinned: requests stamp ``sent_t`` and
    responses ``recv_t``/``resp_t`` with it."""
    for name in PKGS:
        monkeypatch.setattr(load(name).events, "wall_now",
                            lambda: 1760000000.123456)


REQUESTS = [
    dict(),
    dict(panos=["a.jpg", "b.jpg"], topk=3, client="t", budget_s=1.5,
         request_id="q1"),
    dict(panos=[], topk=0, client="edge", budget_s=12.3456789,
         request_id="x", probe=True,
         trace="00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"),
]


@pytest.mark.parametrize("case", range(len(REQUESTS)))
def test_retrieve_frames_are_byte_identical(frozen_clock, case):
    """Requests, answers, classified errors and the handler's responses
    are the JAX package's bytes, and each package decodes the other's."""
    j, t = load("jax"), load("torch")
    desc = np.random.default_rng(case).normal(size=8).astype(np.float32)
    a = j.r.encode_retrieve_request(desc, **REQUESTS[case])
    b = t.r.encode_retrieve_request(desc, **REQUESTS[case])
    assert a == b
    dj, mj = j.r.decode_retrieve_request(b)
    dt, mt = t.r.decode_retrieve_request(a)
    np.testing.assert_array_equal(dj, dt)
    assert mj == mt
    answer = {"shard": "s1", "scores": [["p1", 0.91], ["p0", 0.5]],
              "consulted": ["p0", "p1"], "unavailable": [], "wall_ms": 1.25}
    extra = {"recv_t": 1.5, "resp_t": 2.5, "peer_run": None}
    assert t.r.encode_retrieve_response(answer, extra=extra) == \
        j.r.encode_retrieve_response(answer, extra=extra)
    assert t.r.decode_retrieve_response(
        j.r.encode_retrieve_response(answer)[1]) == answer
    for exc_j, exc_t in (
            (j.serving.Overloaded("full", reason="queue_full",
                                  retry_after_s=0.5),
             t.serving.Overloaded("full", reason="queue_full",
                                  retry_after_s=0.5)),
            (j.serving.DeadlineExceeded("late", where="shard_score"),
             t.serving.DeadlineExceeded("late", where="shard_score")),
            (j.serving.RequestQuarantined("bad", kind="wire", attempts=2),
             t.serving.RequestQuarantined("bad", kind="wire", attempts=2)),
            (ValueError("boom"), ValueError("boom"))):
        ej = j.rwire.encode_retrieve_error(exc_j)
        et = t.rwire.encode_retrieve_error(exc_t)
        assert ej == et
        with pytest.raises(type(exc_t) if not isinstance(exc_t, ValueError)
                           else t.serving.RequestQuarantined):
            t.r.decode_retrieve_response(ej[1])

    def fake_retrieve(desc, **kw):
        return {"shard": "s0", "dim": int(desc.shape[0]),
                "panos": kw["panos"], "topk": kw["topk"]}

    assert t.r.serve_retrieve(fake_retrieve, a) == \
        j.r.serve_retrieve(fake_retrieve, a)
    assert t.r.serve_retrieve(fake_retrieve, b"junk") == \
        j.r.serve_retrieve(fake_retrieve, b"junk")


# ---------------------------------------------------------------------------
# the raw index: the port's tool writes the JAX tool's bytes
# ---------------------------------------------------------------------------


def write_image(path, arr):
    """PNG bytes under the ``.jpg`` name (what the JAX tool decodes) and the
    raw array beside it (what the port reads)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    with open(path, "wb") as f:
        f.write(buf.getvalue())
    np.save(path + ".npy", arr)


def write_pano_tree(root, n_queries=2, n_panos=7, overlap=3):
    """A shortlist of ``n_queries`` rows over structured panos, rows sharing
    ``overlap`` panos: ``(shortlist path, pano root)``."""
    entries = np.zeros((1, n_queries), dtype=np.dtype(
        [("queryname", object), ("topNname", object)]))
    pano_root = os.path.join(root, "pano")
    for q in range(n_queries):
        names = []
        for p in range(n_panos):
            i = q * (n_panos - overlap) + p
            name = f"DUC{i % 2 + 1}/DUC_cutout_{i:03d}_30_0.jpg"
            path = os.path.join(pano_root, name)
            if not os.path.exists(path):
                write_image(path, make_img(i, hw=(60 + i, 80 + 2 * i)))
            names.append(name)
        entries[0, q] = (np.array([f"q{q}.jpg"]),
                         np.array(names, dtype=object)[:, None])
    shortlist = os.path.join(root, "shortlist.mat")
    savemat(shortlist, {"ImgList": entries})
    return shortlist, pano_root


ENTRY_SUFFIX = load("torch").feature_store._ENTRY_SUFFIX


def tree_bytes(root):
    """``{relative path: bytes}`` of the index manifests and store entries
    under ``root``, an entry as its header without the commit time ``t``
    and its payload bytes (the run manifests carry wall times, the journal
    its own record times: neither is an index byte)."""
    out = {}
    for path in glob.glob(os.path.join(root, "**", "*"), recursive=True):
        rel = os.path.relpath(path, root)
        if not os.path.isfile(path):
            continue
        with open(path, "rb") as f:
            data = f.read()
        if rel.startswith("coarse_index"):
            out[rel] = data
        elif rel.endswith(ENTRY_SUFFIX):
            head, payload = data.split(b"\n", 1)
            head = json.loads(head)
            assert isinstance(head.pop("t"), float)
            out[rel] = (head, payload)
    return out


def test_build_coarse_index_raw_equals_the_jax_tool(tmp_path, capsys):
    """The port's ``build_coarse_index --raw`` over two stripes writes the
    JAX tool's index manifests and entry bytes (one shared raw index for
    both packages), a rerun of a stripe builds nothing, and each package
    merges the other's manifests into the same index."""
    import build_coarse_index as jtool

    from ncnet_tpu_torch.tools import build_coarse_index as ttool

    shortlist, pano_root = write_pano_tree(str(tmp_path / "tree"))
    docs = {}
    for name, tool in (("jax", jtool), ("torch", ttool)):
        store = str(tmp_path / name)
        for stripe in (0, 1):
            rc = tool.main(["--store_dir", store, "--inloc_shortlist",
                            shortlist, "--pano_path", pano_root, "--raw",
                            "--factor", "4", "--n_panos", "5",
                            "--shard_index", str(stripe),
                            "--shard_count", "2"])
            assert rc == 0
            docs[name, stripe] = json.loads(
                capsys.readouterr().out.strip().splitlines()[-1])
    assert ttool.raw_base_fingerprint(16) == jtool.raw_base_fingerprint(16)
    jb, tb = tree_bytes(str(tmp_path / "jax")), tree_bytes(str(tmp_path /
                                                               "torch"))
    assert len(jb) == 2 + 9 and set(tb) == set(jb)  # rows 0-4 and 4-8
    for rel in jb:
        assert tb[rel] == jb[rel], rel
    for stripe in (0, 1):
        j, t = docs["jax", stripe], docs["torch", stripe]
        for key in ("fingerprint", "extractor", "factor", "shard", "built",
                    "stripe_panos", "skipped_indexed", "quarantined"):
            assert t[key] == j[key], key
    pattern = "coarse_index.*.json"
    merged = {name: load(name).r.load_index_manifests(
        str(tmp_path / other / pattern))
        for name, other in (("jax", "torch"), ("torch", "jax"))}
    for m in merged.values():
        m.pop("sources")
    assert merged["jax"] == merged["torch"]
    assert len(merged["torch"]["panos"]) == 9
    rc = ttool.main(["--store_dir", str(tmp_path / "torch"),
                     "--inloc_shortlist", shortlist, "--pano_path",
                     pano_root, "--raw", "--n_panos", "5",
                     "--shard_index", "0", "--shard_count", "2"])
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and again["built"] == 0
    assert again["skipped_indexed"] == docs["torch", 0]["stripe_panos"]
