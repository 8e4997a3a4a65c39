"""The port's live introspection plane (``ncnet_tpu_torch/serving/
introspect.py``, ``observability/export.py``) against the JAX package's.

The cases of ``tests/test_introspect.py`` that need no device run once with
each package's modules (``pkg``), fake-engine services behind real HTTP
endpoints.  Across packages: ``render`` of the same registry contents is
the same text, and the ``/healthz`` documents of two services driven alike
have the same keys and status codes.  Waits are on states (a held fake
engine keeps a drain open), never on wall-clock bounds.
"""

import json
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

PKGS = ("jax", "torch")


def load(name):
    if name == "jax":
        from ncnet_tpu import ops, serving
        from ncnet_tpu.observability import MetricsRegistry, export
        from ncnet_tpu.observability.metrics import Histogram
        from ncnet_tpu.serving import health, introspect
        from ncnet_tpu.utils import faults

        reset = ops.reset_fused_tier_demotions
    else:
        from ncnet_tpu_torch import serving
        from ncnet_tpu_torch.observability import MetricsRegistry, export
        from ncnet_tpu_torch.observability.metrics import Histogram
        from ncnet_tpu_torch.serving import health, introspect
        from ncnet_tpu_torch.utils import faults

        def reset():
            pass
    return types.SimpleNamespace(
        name=name, serving=serving, export=export, Histogram=Histogram,
        MetricsRegistry=MetricsRegistry, health=health,
        introspect=introspect, faults=faults, reset=reset)


@pytest.fixture(params=PKGS)
def pkg(request):
    p = load(request.param)
    p.faults.clear()
    p.reset()
    yield p
    p.faults.clear()
    p.reset()


def u8(side=32, seed=0):
    return np.random.default_rng(seed).integers(
        0, 255, (side, side, 3), dtype=np.uint8)


def make_fake(p):
    class FakeEngine:
        """Device stand-in; ``latency_s`` is read at every poll."""

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


def plane_service(p, n=2, latency_s=0.01, **over):
    cfg = dict(bucket_multiple=32, max_image_side=64, max_batch=2,
               max_queue=128, max_in_flight_per_client=128,
               introspect_port=0)
    cfg.update(over)
    engines = [make_fake(p)(latency_s=latency_s) for _ in range(n)]
    return p.serving.MatchService(
        engine=engines, serving=p.serving.ServingConfig(**cfg)), engines


def wait_until(pred, timeout=30.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def get(url, timeout=10.0):
    """(status, body) — 503 is a valid healthz answer, not an error."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode("utf-8")
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode("utf-8")


def series(fams, family, suffix="", **labels):
    hits = [v for name, lb, v in fams[family]["samples"]
            if name == family + suffix
            and all(lb.get(k) == v2 for k, v2 in labels.items())]
    assert len(hits) == 1, (family, suffix, labels, hits)
    return hits[0]


# ---------------------------------------------------------------------------
# exposition units
# ---------------------------------------------------------------------------


def test_prometheus_label_escaping_and_name_sanitizing(pkg):
    E = pkg.export
    fam = E.Family("m_x", "gauge", help='has "quotes" and \\slashes\\')
    fam.add(1.5, path='a"b\\c\nd', plain="ok")
    text = E.render([fam])
    assert 'path="a\\"b\\\\c\\nd"' in text
    assert "# HELP m_x has \"quotes\" and \\\\slashes\\\\" in text
    assert "# TYPE m_x gauge" in text
    fams = E.parse_prometheus(text)
    (_, labels, value), = fams["m_x"]["samples"]
    assert labels == {"path": 'a"b\\c\nd', "plain": "ok"}
    assert value == 1.5
    assert E.sanitize_metric_name("serve_wall_ms_64x64-96x64") == \
        "serve_wall_ms_64x64_96x64"
    assert E.sanitize_metric_name("9lives") == "_9lives"


def test_histogram_family_is_cumulative_and_consistent(pkg):
    E = pkg.export
    h = pkg.Histogram(0.0, 10.0, bins=5)
    h.add([0.5, 1.5, 1.7, 9.9, 25.0])
    fams = E.parse_prometheus(E.render(
        [E.Family("lat", "histogram").add_histogram(h, bucket="b")]))
    buckets = [(lb["le"], v) for name, lb, v in fams["lat"]["samples"]
               if name == "lat_bucket"]
    values = [v for _, v in buckets]
    assert values == sorted(values)
    assert buckets[-1][0] == "+Inf" and buckets[-1][1] == h.count == 5
    assert series(fams, "lat", "_count", bucket="b") == h.count
    assert series(fams, "lat", "_sum", bucket="b") == pytest.approx(h.sum)
    cum = 0
    for (le, v), n in zip(buckets[:-1], h.counts):
        cum += n
        assert v == cum
    bsamples = [s for s in fams["lat"]["samples"]
                if s[0].endswith("_bucket")]
    assert E.histogram_percentile(bsamples, 50) == pytest.approx(
        h.percentile(50), abs=2.0 * (10.0 / 5))


def test_registry_families_generic_dump(pkg):
    E = pkg.export
    reg = pkg.MetricsRegistry(scope="t")
    reg.counter("hits").inc(3)
    reg.gauge("depth").set(7)
    t = reg.timer("wall")
    for s in (0.1, 0.2, 0.3):
        t.observe(s)
    reg.histogram("q_score", 0.0, 1.0, 4).add([0.1, 0.6, 0.9])
    fams = E.parse_prometheus(E.render(E.registry_families(reg, prefix="p")))
    assert series(fams, "p_hits_total") == 3
    assert fams["p_hits_total"]["type"] == "counter"
    assert series(fams, "p_depth") == 7
    assert series(fams, "p_wall_seconds", "_count") == 3
    assert series(fams, "p_wall_seconds", "_sum") == pytest.approx(0.6)
    assert series(fams, "p_wall_seconds", quantile="0.5") == \
        pytest.approx(0.2)
    assert series(fams, "p_q_score", "_count") == 3


def test_parser_rejects_malformed_lines(pkg):
    with pytest.raises(ValueError):
        pkg.export.parse_prometheus("not a metric line at all!\n")
    with pytest.raises(ValueError):
        pkg.export.parse_prometheus('m{unterminated="} 1\n')


def fill_registry(p):
    reg = p.MetricsRegistry(scope="t")
    reg.counter("hits").inc(3)
    reg.counter("serve_wall_ms_64x64-96x64").inc(2)
    reg.gauge("depth").set(7)
    reg.gauge("ratio").set(0.1 + 0.2)
    reg.histogram("q_score", 0.0, 1.0, 4).add([0.1, 0.6, 0.9, 2.0])
    reg.histogram("lat", 0.0, 4000.0, 32).add(
        np.random.default_rng(0).uniform(0, 5000, 50))
    return reg


def test_render_is_identical_across_packages():
    """The same registry contents and families render to the same text."""
    texts = []
    for name in PKGS:
        p = load(name)
        E = p.export
        fam = E.Family("ncnet_x", "gauge", help='a "b"').add(
            1.25, path='a"b\\c\nd').add(float("inf"), path="inf")
        texts.append(E.render(
            E.registry_families(fill_registry(p), prefix="ncnet") + [fam]))
    assert texts[0] == texts[1]
    assert "ncnet_serve_wall_ms_64x64_96x64_total 2" in texts[0]


# ---------------------------------------------------------------------------
# the live endpoints
# ---------------------------------------------------------------------------


def test_metrics_scrape_parses_and_counters_monotonic_under_load(pkg):
    E = pkg.export
    svc, _ = plane_service(pkg, n=2)
    svc.start()
    try:
        url = svc.introspect_url
        assert url is not None
        img = u8()
        futs = [svc.submit(img, img) for _ in range(10)]
        code1, text1 = get(url + "/metrics")
        assert code1 == 200
        f1 = E.parse_prometheus(text1)
        for f in futs:
            f.result(timeout=60)
        for f in [svc.submit(img, img) for _ in range(6)]:
            f.result(timeout=60)
        assert wait_until(
            lambda: svc.health()["counters"]["results"] == 16)
        code2, text2 = get(url + "/metrics")
        assert code2 == 200
        f2 = E.parse_prometheus(text2)
        for fam_name, fam in f1.items():
            if fam["type"] != "counter":
                continue
            later = {(n, tuple(sorted(lb.items()))): v
                     for n, lb, v in f2[fam_name]["samples"]}
            for n, lb, v in fam["samples"]:
                key = (n, tuple(sorted(lb.items())))
                assert later.get(key, v) >= v, (key, v, later.get(key))
        assert series(f2, "ncnet_serve_requests_total",
                      outcome="results") == 16
        assert series(f2, "ncnet_serve_scrapes_total") == 2
        bucket = "32x32-32x32"
        h = svc._registry.histogram(f"serve_wall_ms_{bucket}", 0.0,
                                    svc.cfg.latency_hist_ms)
        bsamples = [s for s in f2["ncnet_serve_latency_ms"]["samples"]
                    if s[0].endswith("_bucket")
                    and s[1].get("bucket") == bucket]
        values = [v for _, _, v in bsamples]
        assert values == sorted(values)
        assert series(f2, "ncnet_serve_latency_ms", "_count",
                      bucket=bucket) == h.count == 16
        assert series(f2, "ncnet_serve_latency_ms", "_sum",
                      bucket=bucket) == pytest.approx(h.sum)
        assert [v for _, lb, v in bsamples if lb["le"] == "+Inf"] == [h.count]
        assert series(f2, "ncnet_serve_quality", "_count",
                      signal="score") == 16
        # the per-replica and per-version families the service writes
        assert sum(v for n, _, v in
                   f2["ncnet_serve_replica_batches_total"]["samples"]) >= 8
        assert series(f2, "ncnet_serve_version_latency_ms", "_count",
                      model_version="v0") == 16
        assert series(f2, "ncnet_serve_model_version",
                      model_version="v0") == 1
        assert pkg.introspect.scrape_wall_ms(url, n=2) > 0
    finally:
        svc.stop()


def drive_health(p):
    """One service per package driven alike: 4 results, then a drain held
    open by the fake engine; ``(keys, code, drain_code, drain_state)``."""
    svc, engines = plane_service(p, n=2, slo_ms=500.0)
    svc.start()
    try:
        url = svc.introspect_url
        img = u8()
        for f in [svc.submit(img, img) for _ in range(4)]:
            f.result(timeout=60)
        code, body = get(url + "/healthz")
        doc = json.loads(body)
        assert doc["schema"] == p.health.HEALTH_DOC_SCHEMA
        assert doc["state"] in ("STARTING", "READY")
        assert doc["pool"]["ready"] == doc["pool"]["total"] == 2
        assert {r["id"] for r in doc["pool"]["replicas"]} == {"rep0", "rep1"}
        assert doc["queue"]["buckets"] == ["32x32-32x32"]
        assert doc["counters"]["results"] == 4
        assert doc["slo"]["objectives"]["default_ms"] == 500.0
        assert doc["service"]["history"][0]["state"] == "STARTING"
        assert isinstance(doc["activity"]["age_s"], float)
        assert set(doc) == set(svc.health())
        for e in engines:
            e.latency_s = 120.0
        held = svc.submit(img, img)
        assert wait_until(lambda: svc.health()["queue"]["inflight_batches"])
        svc.request_drain("test")
        dcode, dbody = get(url + "/healthz")
        dstate = json.loads(dbody)["state"]
        for e in engines:
            e.latency_s = 0.0
        held.result(timeout=60)
        return (sorted(doc), sorted(doc["pool"]["replicas"][0]),
                sorted(doc["queue"]), code, dcode, dstate)
    finally:
        for e in engines:
            e.latency_s = 0.0
        svc.stop()


def test_healthz_document_and_status_codes(pkg):
    _, _, _, code, dcode, dstate = drive_health(pkg)
    assert (code, dcode, dstate) == (200, 503, "DRAINING")


def test_healthz_documents_match_across_packages():
    """Keys (top level, a replica row, the queue section) and status codes
    are the same in both packages."""
    assert drive_health(load("jax")) == drive_health(load("torch"))


def test_statusz_rollout_root_and_404(pkg):
    svc, _ = plane_service(pkg, n=2, slo_ms=500.0)
    svc.start()
    try:
        url = svc.introspect_url
        img = u8()
        for f in [svc.submit(img, img) for _ in range(4)]:
            f.result(timeout=60)
        code, body = get(url + "/statusz")
        assert code == 200
        assert "replicas (2/2 ready)" in body
        assert "rep0" in body and "rep1" in body
        assert "bucket ladder: 32x32-32x32" in body
        assert "recent health timeline:" in body
        code, body = get(url + "/rollout")
        assert code == 200
        assert json.loads(body) == {"phase": "IDLE", "model_version": "v0"}
        assert get(url + "/")[0] == 200
        assert get(url + "/nope")[0] == 404
    finally:
        svc.stop()


def test_endpoint_death_leaves_serving_untouched(pkg):
    svc, _ = plane_service(pkg, n=2)
    svc.start()
    try:
        url = svc.introspect_url
        img = u8()
        stop_scraping = threading.Event()
        scrapes = []

        def hammer():
            while not stop_scraping.is_set():
                try:
                    scrapes.append(get(url + "/metrics", timeout=2.0)[0])
                except Exception as e:  # noqa: BLE001 — expected once dead
                    scrapes.append(type(e).__name__)
                time.sleep(0.002)

        t = threading.Thread(target=hammer, daemon=True)
        t.start()
        assert wait_until(lambda: 200 in scrapes)
        futs = [svc.submit(img, img) for _ in range(8)]
        svc._introspect.stop()  # mid-stream, mid-scrape
        futs += [svc.submit(img, img) for _ in range(8)]
        for f in futs:
            assert f.result(timeout=60).request_id
        stop_scraping.set()
        t.join(5.0)
        assert svc.health()["counters"]["results"] == 16
        assert svc.state in ("READY", "STARTING")
    finally:
        svc.stop()


def test_handler_renderer_bug_answers_500_not_crash(pkg, monkeypatch):
    svc, _ = plane_service(pkg, n=1)
    svc.start()
    try:
        url = svc.introspect_url
        monkeypatch.setattr(
            svc._introspect, "metrics_text",
            lambda: (_ for _ in ()).throw(RuntimeError("boom")))
        code, body = get(url + "/metrics")
        assert code == 500 and "boom" in body
        img = u8()
        assert svc.submit(img, img).result(timeout=60).request_id
    finally:
        svc.stop()


def test_bind_failure_is_fail_open(pkg):
    svc1, _ = plane_service(pkg, n=1)
    svc1.start()
    try:
        port = svc1._introspect.port
        svc2, _ = plane_service(pkg, n=1, introspect_port=port)
        svc2.start()  # same port: bind fails, serving continues
        try:
            assert svc2.introspect_url is None
            img = u8()
            assert svc2.submit(img, img).result(timeout=60).request_id
        finally:
            svc2.stop()
    finally:
        svc1.stop()


def test_retrieve_is_answered_404_by_a_host_without_retrieval(pkg):
    svc, _ = plane_service(pkg, n=1)
    svc.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(urllib.request.Request(
                svc.introspect_url + "/retrieve", data=b"x", method="POST"),
                timeout=10)
        assert e.value.code == 404
        assert e.value.read() == b"this host serves no /retrieve\n"
    finally:
        svc.stop()
