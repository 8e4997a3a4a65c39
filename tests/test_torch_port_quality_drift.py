"""The port's quality drift gate (``ncnet_tpu_torch/observability/
quality.py``: ``digests_from_events``, ``psi``, ``write_reference``,
``load_reference``, ``reference_binning``, ``check_drift``) against the
JAX package's.

``psi`` and ``check_drift`` give JAX's numbers on the same digests; a
reference file written by either package is read by the other; and a port
serving run is judged against a reference written from a JAX serving run
of the same weights and pairs made here, in the same session (never
against ``perf/quality_ref.jsonl``, whose own JAX drift tests fail on this
tree, ROADMAP §C): green as it is, red with the canary quality shift.
"""

import importlib

import numpy as np
import pytest

jq = importlib.import_module("ncnet_tpu.observability.quality")
tq = importlib.import_module("ncnet_tpu_torch.observability.quality")
from ncnet_tpu.observability.metrics import Histogram as JHist  # noqa: E402
from ncnet_tpu_torch.observability.metrics import Histogram as THist  # noqa: E402

KIND = "cpu-test"


def digests(H, mod, seed, centre, signals=("score", "margin")):
    rng = np.random.default_rng(seed)
    out = {}
    for tier in ("xla", "coarse2fine"):
        for s in signals:
            lo, hi = mod.SIGNAL_RANGE[s]
            h = H(lo, hi, mod.DIGEST_BINS)
            h.add(np.clip(rng.normal(centre, 0.08, 400), 0, 1))
            out[(tier, s)] = h
    return out


@pytest.mark.parametrize("centre", [0.62, 0.45, 0.2])
def test_psi_and_check_drift_agree(centre):
    jref, tref = (digests(H, m, 5, 0.62) for H, m in
                  ((JHist, jq), (THist, tq)))
    jcur, tcur = (digests(H, m, 6, centre) for H, m in
                  ((JHist, jq), (THist, tq)))
    for key in jref:
        assert tq.psi(tref[key], tcur[key]) == jq.psi(jref[key], jcur[key])
    jr = {(KIND, *k): h for k, h in jref.items()}
    tr = {(KIND, *k): h for k, h in tref.items()}
    extra = THist(0.0, 1.0, 32)
    extra.add([0.5] * 3)
    jextra = JHist(0.0, 1.0, 32)
    jextra.add([0.5] * 3)
    jcur[("xla", "entropy")], tcur[("xla", "entropy")] = jextra, extra
    fj = jq.check_drift(jr, jcur, device_kind=KIND)
    ft = tq.check_drift(tr, tcur, device_kind=KIND)
    assert ft == fj
    assert {f["status"] for f in ft} == (
        {"ok", "skipped"} if centre == 0.62 else {"drift", "skipped"})
    assert tq.DEFAULT_PSI_THRESHOLD == jq.DEFAULT_PSI_THRESHOLD
    with pytest.raises(ValueError, match="identically-binned"):
        tq.psi(THist(0, 1, 8), THist(0, 1, 16))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_reference_written_by_either_package_is_read_by_the_other(
        writer, tmp_path):
    path = str(tmp_path / "ref.jsonl")
    w, r = (jq, tq) if writer == "jax" else (tq, jq)
    H = JHist if writer == "jax" else THist
    d = digests(H, w, 7, 0.5)
    assert w.write_reference(path, d, device_kind="NVIDIA H100 80GB HBM3",
                             meta={"by": writer}) == len(d)
    ref = r.load_reference(path)
    assert set(ref) == {("NVIDIA H100 80GB HBM3", *k) for k in d}
    for k, h in d.items():
        got = ref[("NVIDIA H100 80GB HBM3", *k)]
        assert (got.lo, got.hi, got.bins, list(got.counts)) == \
            (h.lo, h.hi, h.bins, list(h.counts))
    assert r.reference_binning(ref) == w.reference_binning(w.load_reference(path))
    # the other writer gives the same bytes for the same digests
    path2 = str(tmp_path / "ref2.jsonl")
    r.write_reference(path2, {k: ref[("NVIDIA H100 80GB HBM3", *k)]
                              for k in d},
                      device_kind="NVIDIA H100 80GB HBM3", meta={"by": writer})
    with open(path, "rb") as f1, open(path2, "rb") as f2:
        assert f1.read() == f2.read()


def test_missing_device_kind_is_judged_as_jax_judges_it():
    """A reference without the card's series (``perf/quality_ref.jsonl``
    has none for the H100): every series skipped, with the same reasons."""
    path = tq.default_reference_path()
    assert path == jq.default_reference_path()
    jr, tr = jq.load_reference(path), tq.load_reference(path)
    assert set(jr) == set(tr) and jr
    cur = digests(THist, tq, 8, 0.5)
    jcur = digests(JHist, jq, 8, 0.5)
    kind = "NVIDIA H100 80GB HBM3"
    ft = tq.check_drift(tr, cur, device_kind=kind)
    assert ft == jq.check_drift(jr, jcur, device_kind=kind)
    assert {f["status"] for f in ft} == {"skipped"}


def test_digests_from_events_respects_reference_binning():
    events = [{"event": "quality", "tier": "xla",
               "signals": {"score": [0.1, 0.5, float("nan"), 0.9],
                           "score_gap": [-0.5, 0.5]}},
              {"event": "metrics"},
              {"event": "quality", "signals": {"score": 0.3}}]
    bins = {"score": {"lo": 0.0, "hi": 1.0, "counts": [0] * 8}}
    for kw in ({}, {"bins_like": bins}):
        dj = jq.digests_from_events(events, **kw)
        dt = tq.digests_from_events(events, **kw)
        assert set(dj) == set(dt)
        for k in dj:
            assert dt[k].snapshot() == dj[k].snapshot()


def serve_quality_events(name, cfg, params, path, shift=0.0):
    """A 2-replica service of ``name``'s package serving 8 pairs under an
    event log; ``shift`` arms the canary quality shift on every result."""
    from ncnet_tpu_torch.observability import events as tev

    if name == "jax":
        from ncnet_tpu import serving as S
        from ncnet_tpu.observability import events as ev
        from ncnet_tpu.utils import faults
    else:
        from ncnet_tpu_torch import serving as S
        from ncnet_tpu_torch.utils import faults

        ev = tev
    kw = dict(bucket_multiple=32, max_image_side=64, max_batch=2,
              replicas=2)
    with ev.bound(ev.EventLog(path)):
        if shift:
            faults.install(faults.FaultPlan(canary_quality_shift=shift,
                                            canary_shift_version="v0"))
        try:
            svc = (S.MatchService(cfg, params, S.ServingConfig(**kw))
                   if name == "jax" else
                   S.MatchService(cfg, params, S.ServingConfig(**kw),
                                  devices=["cpu"] * 2)).start()
            try:
                futs = []
                for i in range(8):
                    src = np.random.default_rng(300 + i).integers(
                        0, 256, (64, 64, 3), dtype=np.uint8)
                    futs.append(svc.submit(src, np.roll(src, 16, axis=1)))
                for f in futs:
                    f.result(timeout=300)
            finally:
                svc.stop(timeout=120)
        finally:
            faults.clear()
    return ev.replay_events(path)[1]


def test_port_serving_judged_against_a_jax_run_of_this_session(tmp_path):
    import jax

    from ncnet_tpu import config as jcfg
    from ncnet_tpu.models import ncnet as jnet
    from ncnet_tpu_torch import config as tcfg
    from ncnet_tpu_torch.models.convert import params_from_numpy

    kw = dict(backbone="tiny", ncons_kernel_sizes=(3,), ncons_channels=(1,))
    jp = jnet.init_ncnet(jcfg.ModelConfig(**kw), jax.random.key(11))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    jev = serve_quality_events("jax", jcfg.ModelConfig(**kw), jp,
                               str(tmp_path / "jax.jsonl"))
    ref_path = str(tmp_path / "ref.jsonl")
    n = jq.write_reference(ref_path, jq.digests_from_events(jev),
                           device_kind=KIND)
    assert n == 5  # one series a signal, one tier
    ref = tq.load_reference(ref_path)
    bins = tq.reference_binning(ref)
    tev = serve_quality_events("torch", tcfg.ModelConfig(**kw), tp,
                               str(tmp_path / "torch.jsonl"))
    cur = tq.digests_from_events(tev, bins_like=bins)
    assert set(cur) == {k[1:] for k in ref}  # the same tier tags
    findings = tq.check_drift(ref, cur, device_kind=KIND)
    assert [f["status"] for f in findings] == ["ok"] * 5, findings
    assert max(f["psi"] for f in findings) < 0.05
    bad = tq.digests_from_events(serve_quality_events(
        "torch", tcfg.ModelConfig(**kw), tp, str(tmp_path / "bad.jsonl"),
        shift=0.4), bins_like=bins)
    findings = tq.check_drift(ref, bad, device_kind=KIND)
    assert "drift" in {f["status"] for f in findings}
    assert findings == jq.check_drift(jq.load_reference(ref_path), bad,
                                      device_kind=KIND)
