"""The port's ``MatchService`` on real engines against the JAX package's,
on the CPU (``ncnet_tpu_torch/serving/``, ``serving/engine.py``'s store
path).

The same sequence of requests goes through the JAX service (two replicas
on two of the test run's forced CPU devices) and the port's (two replicas
on ``["cpu"] * 2``), both fp32 with the same weights: the tiny trunk, an
identity-peaked NC kernel, targets their sources rolled by one coarse cell
(so every argmax is decisive), dense and coarse-to-fine
(``sparse_topk=4``), and a stream of tracked frames through
``stream_submit``.

  * each request id gets the same outcome in both;
  * each result's table equals JAX's: coordinates equal, scores and the
    quality row within rtol 1e-4, atol 1e-7 (the engine tests' tolerance,
    tests/test_torch_port_temporal.py);
  * the outcome identity ``admitted == results + deadlines + quarantines +
    admitted_sheds`` holds in each event log.

The store: a warm second pass of the same sources through the port's
service gives tables bitwise equal to the cold pass (one request a batch,
so each pass runs the same batch compositions), with hits.  The drain:
work in flight when ``request_drain`` lands resolves, and one
``serve_drain`` event sums the counters.  And a stream cut's fallback
frame is bitwise a cold query of the same pair (the property of JAX's
``test_cut_fallback_is_bitwise_cold_and_reseeds``, held for the port
alone).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ncnet_tpu import config as jcfg
from ncnet_tpu import serving as jserving
from ncnet_tpu.models import ncnet as jnet
from ncnet_tpu.observability import events as jevents
from ncnet_tpu_torch import config as tcfg
from ncnet_tpu_torch import serving as tserving
from ncnet_tpu_torch.models.convert import params_from_numpy
from ncnet_tpu_torch.observability import events as tevents
from ncnet_tpu_torch.ops import nc_fused_lane as tlane
from ncnet_tpu_torch.ops import sparse_corr as tsc

jops = importlib.import_module("ncnet_tpu.ops")

SIDE = 96
BASE = dict(backbone="tiny", ncons_kernel_sizes=(3,), ncons_channels=(1,),
            sparse_factor=2)
TOL = dict(rtol=1e-4, atol=1e-7)


@pytest.fixture(autouse=True)
def _clean():
    jops.reset_fused_tier_demotions()
    for ev in (jevents, tevents):
        ev.set_global_sink(None)
    yield
    for ev in (jevents, tevents):
        ev.set_global_sink(None)


def shared(seed=9, **kw):
    """JAX and port configs and the same weights, NC kernel the identity."""
    kw = {**BASE, **kw}
    jc, tc = jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)
    jp = jnet.init_ncnet(jc, jax.random.key(seed))
    w = np.zeros((3, 3, 3, 3, 1, 1), np.float32)
    w[1, 1, 1, 1, 0, 0] = 1.0
    jp["nc"] = [{"w": jnp.asarray(w), "b": jnp.zeros((1,), jnp.float32)}]
    return jc, tc, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def u8(seed):
    return np.random.default_rng(seed).integers(0, 256, (SIDE, SIDE, 3),
                                                dtype=np.uint8)


def pair(i, shift=32):
    src = u8(100 + i)
    return src, np.roll(src, (shift, shift), axis=(0, 1))


def serving_config(S, **kw):
    return S.ServingConfig(**{**dict(bucket_multiple=32, max_image_side=SIDE,
                                     max_batch=2, replicas=2), **kw})


def service(name, cfg, params, **kw):
    if name == "jax":
        return jserving.MatchService(cfg, params, serving_config(jserving, **kw))
    return tserving.MatchService(cfg, params, serving_config(tserving, **kw),
                                 devices=["cpu"] * 2)


def drive(name, cfg, params, path, n=6, **kw):
    """Submit ``n`` pairs and one request whose budget is already spent;
    returns ``{request id: (outcome, table, quality)}`` and the events."""
    S, ev = (jserving, jevents) if name == "jax" else (tserving, tevents)
    out = {}
    with ev.bound(ev.EventLog(path)):
        svc = service(name, cfg, params, **kw).start()
        try:
            futs = [svc.submit(*pair(i)) for i in range(n)]
            with pytest.raises(S.DeadlineExceeded):
                svc.submit(*pair(n), deadline_s=0)
            for f in futs:
                r = f.result(timeout=600)
                out[r.request_id] = (f.outcome, r.table, r.quality)
            health = svc.health()
        finally:
            svc.stop(timeout=120)
    return out, ev.replay_events(path)[1], health


def outcome_identity(events):
    n = {k: 0 for k in ("admit", "result", "deadline", "quarantine", "shed")}
    for e in events:
        kind = e.get("event", "")[len("serve_"):]
        if kind == "admit" or kind == "result" or kind == "quarantine":
            n[kind] += 1
        elif kind in ("deadline", "shed") and e.get("admitted") is True:
            n[kind] += 1
    assert n["admit"] == (n["result"] + n["deadline"] + n["quarantine"]
                          + n["shed"])
    return n


@pytest.mark.parametrize("topk", [0, 4], ids=["dense", "coarse2fine"])
def test_service_two_replicas_matches_jax(tmp_path, topk):
    jc, tc, jp, tp = shared(sparse_topk=topk)
    launches = tsc.launches, tlane.launches
    want, jev, _ = drive("jax", jc, jp, str(tmp_path / "jax.jsonl"))
    got, tev, health = drive("torch", tc, tp, str(tmp_path / "port.jsonl"))
    assert sorted(got) == sorted(want) == [f"r{i}" for i in range(1, 7)]
    for rid, (outcome, table, quality) in got.items():
        w_outcome, w_table, w_quality = want[rid]
        assert outcome == w_outcome == "result"
        assert table.shape == w_table.shape == (5, 36)
        np.testing.assert_array_equal(table[:4], w_table[:4])
        np.testing.assert_allclose(table[4], w_table[4], **TOL)
        assert quality.keys() == w_quality.keys()
        np.testing.assert_allclose(list(quality.values()),
                                   list(w_quality.values()), **TOL)
    assert outcome_identity(jev) == outcome_identity(tev)
    assert outcome_identity(tev)["result"] == 6
    # both replicas on their CPU device, and no kernel launched on the CPU
    assert [r["device"] for r in health["pool"]["replicas"]] == ["cpu", "cpu"]
    assert (tsc.launches, tlane.launches) == launches


def stream(name, cfg, params, frames):
    svc = service(name, cfg, params, max_batch=1)
    svc.start()
    try:
        return [svc.stream_submit("cam0", src, tgt) for src, tgt in frames]
    finally:
        svc.stop(timeout=120)


def test_stream_of_tracked_frames_matches_jax():
    jc, tc, jp, tp = shared(sparse_topk=4)
    src = u8(7)
    frames = [(src, np.roll(src, (s, s), axis=(0, 1)))
              for s in (32, 16, 16, 32, 16)]
    want = stream("jax", jc, jp, frames)
    got = stream("torch", tc, tp, frames)
    assert [f.tracked for f in got] == [f.tracked for f in want]
    assert [f.fallback for f in got] == [f.fallback for f in want]
    assert any(f.tracked for f in got)
    for g, w in zip(got, want):
        assert g.seq == w.seq
        np.testing.assert_array_equal(g.table[:4], w.table[:4])
        np.testing.assert_allclose(g.table[4], w.table[4], **TOL)
        if w.recall is not None:
            assert g.recall == pytest.approx(w.recall, abs=1e-6)


def test_store_warm_pass_is_bitwise_the_cold_pass(tmp_path):
    _, tc, _, tp = shared(sparse_topk=4)
    cfg = serving_config(tserving, max_batch=1,
                         feature_store_dir=str(tmp_path / "store"))
    svc = tserving.MatchService(tc, tp, cfg, devices=["cpu"] * 2).start()
    try:
        engines = [r.engine for r in svc._pool.replicas]
        srcs = [pair(i) for i in range(4)]
        cold = [svc.submit(*p).result(timeout=300).table for p in srcs]
        extracted = sum(e.feature_extractions for e in engines)
        warm = [svc.submit(*p).result(timeout=300).table for p in srcs]
        health = svc.health()
    finally:
        svc.stop(timeout=120)
    assert extracted == 4
    assert sum(e.feature_extractions for e in engines) == 4  # all hits
    for c, w in zip(cold, warm):
        np.testing.assert_array_equal(c, w)
    store = health["store"]
    assert store["counters"]["hits"] == 4 and store["counters"]["misses"] == 4
    assert store["hit_pct"] == 50.0
    assert store["fingerprint"].endswith("-torch.cpu")


def test_engine_store_hit_is_bitwise_a_miss(tmp_path):
    """``BatchMatchEngine(store=)``: the store path's table equals the
    store-less engine's within the fp32 bound, and a hit's table is a
    miss's bit for bit."""
    from ncnet_tpu_torch.serving.engine import BatchMatchEngine
    from ncnet_tpu_torch.store import FeatureStore

    _, tc, _, tp = shared(sparse_topk=4)
    src, tgt = (np.stack(x) for x in zip(pair(1), pair(2)))
    store = FeatureStore(str(tmp_path / "s"), "x-s0-k1-f32-torch.cpu")
    eng = BatchMatchEngine(tc, tp, device="cpu", store=store)
    miss = eng.fetch(eng.dispatch(src, tgt))
    hit = eng.fetch(eng.dispatch(src, tgt))
    assert store.counters["misses"] == 2 and store.counters["hits"] == 2
    np.testing.assert_array_equal(hit, miss)
    plain = BatchMatchEngine(tc, tp, device="cpu")
    base = plain.fetch(plain.dispatch(src, tgt))
    np.testing.assert_array_equal(miss[:, :4], base[:, :4])
    np.testing.assert_allclose(miss[:, 4:], base[:, 4:], **TOL)
    eng.attach_store(None)
    np.testing.assert_array_equal(eng.fetch(eng.dispatch(src, tgt)), base)


def test_request_drain_resolves_work_in_flight(tmp_path):
    _, tc, _, tp = shared()
    path = str(tmp_path / "events.jsonl")
    with tevents.bound(tevents.EventLog(path)):
        svc = tserving.MatchService(
            tc, tp, serving_config(tserving, max_batch=1),
            devices=["cpu"] * 2).start()
        futs = [svc.submit(*pair(i)) for i in range(6)]
        svc.request_drain()
        with pytest.raises(tserving.Overloaded) as e:
            svc.submit(*pair(9))
        assert e.value.reason == "draining"
        outcomes = [f.result(timeout=300) and f.outcome for f in futs]
        svc.stop(timeout=120)
    assert outcomes == ["result"] * 6
    events = tevents.replay_events(path)[1]
    drains = [e for e in events if e["event"] == "serve_drain"]
    assert len(drains) == 1 and drains[0]["drained"] is True
    assert drains[0]["n_admitted"] == drains[0]["n_results"] == 6
    assert drains[0]["n_shed"] == 1 and drains[0]["leftover"] == 0
    assert outcome_identity(events)["result"] == 6


def test_cut_fallback_is_bitwise_a_cold_query():
    """A frame the cut detector rejects re-runs through the full pipeline:
    its table is bitwise a cold query of the same pair (one request a
    batch), and the next frame is tracked again from the fallback's
    table."""
    _, tc, _, tp = shared(sparse_topk=4)
    svc = tserving.MatchService(
        tc, tp, serving_config(tserving, max_batch=1, replicas=1,
                               stream_cut_recall=1.01),
        devices=["cpu"]).start()
    try:
        src = u8(7)
        f0 = svc.stream_submit("cam", src, np.roll(src, (32, 32), (0, 1)))
        cut_tgt = u8(8)
        f1 = svc.stream_submit("cam", src, cut_tgt)
        cold = svc.submit(src, cut_tgt).result(timeout=300)
    finally:
        svc.stop(timeout=120)
    assert not f0.tracked and not f0.fallback
    assert f1.fallback and not f1.tracked
    np.testing.assert_array_equal(f1.table, cold.table)
