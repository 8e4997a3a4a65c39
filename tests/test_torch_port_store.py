"""The port's persistent feature store (``ncnet_tpu_torch/store/``) against
the JAX package's.

The chaos cases of ``tests/test_store.py`` run once with each package's
store (``st`` is ``"jax"`` or ``"torch"``) and must end alike: a SIGKILL
between payload write and commit rename, a post-commit bit flip
(quarantined, recomputed bitwise), ENOSPC on write, read and journal
(fail-open, the DEGRADED → OK timeline), fingerprint skew with the
superseded-generation GC, and the LRU budget with its journal.

Then the keys: ``weights_digest`` of the same weights is the JAX package's
digest, in f32 and bf16; and ROADMAP D8, the fingerprint names the program
that extracted the features, so a generation one package wrote is a miss
for the other, both ways, while ``gc_superseded`` keeps the other
package's generation of the same weights.
"""

import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PKGS = ("jax", "torch")


def load(name):
    if name == "jax":
        from ncnet_tpu import store
        from ncnet_tpu.observability import events
        from ncnet_tpu.utils import faults
    else:
        from ncnet_tpu_torch import store
        from ncnet_tpu_torch.observability import events
        from ncnet_tpu_torch.utils import faults
    return types.SimpleNamespace(name=name, store=store, events=events,
                                 faults=faults,
                                 pkg="ncnet_tpu" if name == "jax"
                                 else "ncnet_tpu_torch")


@pytest.fixture(params=PKGS)
def st(request):
    p = load(request.param)
    p.faults.clear()
    p.events.set_global_sink(None)
    yield p
    p.faults.clear()
    p.events.set_global_sink(None)


@pytest.fixture
def arr(rng):
    return rng.standard_normal((3, 4, 8)).astype(np.float32)


def _store(st, tmp_path, fp="aaaa0000-s128-k2-bf16", **kw):
    return st.store.FeatureStore(str(tmp_path / "fstore"), fp, **kw)


def logged(st, tmp_path):
    path = str(tmp_path / "events.jsonl")
    return path, st.events.bound(st.events.EventLog(path))


def test_content_digest_is_the_jax_digest(st):
    from ncnet_tpu.store import content_digest as jdigest

    a = np.arange(24, dtype=np.uint8).reshape(2, 3, 4)
    d = st.store.content_digest
    assert d(a) == jdigest(a) == d(a.copy())
    assert d(a) != d(a.reshape(4, 3, 2)) and d(a) != d(a.astype(np.int16))


def test_roundtrip_persists_across_reopen(st, tmp_path, arr):
    s = _store(st, tmp_path)
    d = st.store.content_digest(arr)
    got, status = s.resolve(d, lambda: arr)
    assert status == "miss"
    np.testing.assert_array_equal(got, arr)
    got2, status2 = s.resolve(
        d, lambda: (_ for _ in ()).throw(AssertionError("must not compute")))
    assert status2 == "hit"
    np.testing.assert_array_equal(got2, arr)
    s.close()
    s2 = _store(st, tmp_path)
    assert s2.entries == 1
    np.testing.assert_array_equal(s2.get(d), arr)
    assert s2.counters["hits"] == 1 and s2.hit_pct() == 100.0
    s2.close()


def test_fingerprint_skew_is_miss_and_gc_superseded(st, tmp_path, arr):
    d = st.store.content_digest(arr)
    old = _store(st, tmp_path, fp="deadbeef00000000-s128-k2-bf16")
    old.put(d, arr)
    old.close()
    sibling = _store(st, tmp_path, fp="aaaa0000-s999-k1-f32")
    sibling.put(d, arr)
    sibling.close()
    s = _store(st, tmp_path, fp="aaaa0000-s128-k2-bf16")
    assert s.get(d) is None and s.counters["misses"] == 1
    assert s.gc_superseded() == 1
    root = str(tmp_path / "fstore")
    assert sorted(n for n in os.listdir(root) if not n.startswith("quar")) \
        == ["aaaa0000-s128-k2-bf16", "aaaa0000-s999-k1-f32"]
    s.close()


def test_sigkill_mid_commit_leaves_no_visible_entry(st, tmp_path):
    root = str(tmp_path / "fstore")
    worker = tmp_path / "worker.py"
    worker.write_text(f"""
import sys
sys.path.insert(0, {_REPO!r})
import numpy as np
from {st.pkg}.store import FeatureStore, content_digest

s = FeatureStore({root!r}, "aaaa0000-s128-k2-bf16")
a = np.arange(240, dtype=np.float32).reshape(3, 80)
s.put(content_digest(a), a)
raise SystemExit("unreachable: the commit kill hook must have fired")
""")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               NCNET_TPU_FAULTS=json.dumps({"kill_at_store_commit": 1}))
    proc = subprocess.run([sys.executable, str(worker)], env=env,
                          cwd=str(tmp_path), stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, timeout=300)
    assert proc.returncode == -9, proc.stdout[-3000:]
    gen = os.path.join(root, "aaaa0000-s128-k2-bf16")
    names = os.listdir(gen)
    assert not [n for n in names if n.endswith(".feat")], names
    assert [n for n in names if ".feat.tmp." in n], names
    s = st.store.FeatureStore(root, "aaaa0000-s128-k2-bf16")
    assert s.entries == 0
    a = np.arange(240, dtype=np.float32).reshape(3, 80)
    assert s.resolve(st.store.content_digest(a), lambda: a)[1] == "miss"
    np.testing.assert_array_equal(s.get(st.store.content_digest(a)), a)
    s.close()


def test_bitflip_detected_quarantined_recomputed_bitwise(st, tmp_path, arr):
    path, sink = logged(st, tmp_path)
    with sink:
        s = _store(st, tmp_path)
        d = st.store.content_digest(arr)
        with st.faults.injected(st.faults.FaultPlan(store_bitflip_paths=(d,))):
            s.put(d, arr)
        got, status = s.resolve(d, lambda: arr)
        assert status == "recompute"
        np.testing.assert_array_equal(got, arr)
        assert s.counters["corrupt"] == 1 and s.state == "OK"
        qdir = os.path.join(str(tmp_path / "fstore"), "quarantine")
        assert len(os.listdir(qdir)) == 1
        got2, status2 = s.resolve(
            d, lambda: (_ for _ in ()).throw(AssertionError("no compute")))
        assert status2 == "hit"
        np.testing.assert_array_equal(got2, arr)
        s.close()
    _, events = st.events.replay_events(path)
    corrupt = [e for e in events if e["event"] == "store_corrupt"]
    assert len(corrupt) == 1 and corrupt[0]["reason"] == "checksum mismatch"


def test_enospc_fails_open_with_degraded_recovered_timeline(st, tmp_path, arr):
    F = st.faults
    path, sink = logged(st, tmp_path)
    with sink:
        s = _store(st, tmp_path)
        d = st.store.content_digest(arr)
        with F.injected(F.FaultPlan(store_io_error_ops=("write",))):
            got, status = s.resolve(d, lambda: arr)
        assert status == "miss" and s.state == "DEGRADED"
        np.testing.assert_array_equal(got, arr)
        assert s.resolve(d, lambda: arr)[1] == "miss" and s.state == "OK"
        with F.injected(F.FaultPlan(store_io_error_ops=("read",))):
            got3, status3 = s.resolve(d, lambda: arr)
        assert status3 == "recompute" and s.state == "OK"
        np.testing.assert_array_equal(got3, arr)
        assert s.resolve(d, lambda: None)[1] == "hit"
        s.close()
    _, events = st.events.replay_events(path)
    assert [e["state"] for e in events if e["event"] == "store_health"] \
        == ["DEGRADED", "OK", "DEGRADED", "OK"]


def test_journal_failure_keeps_store_degraded(st, tmp_path, arr):
    F = st.faults
    s = _store(st, tmp_path)
    d = st.store.content_digest(arr)
    s.resolve(d, lambda: arr)
    with F.injected(F.FaultPlan(store_io_error_ops=("journal",))):
        np.testing.assert_array_equal(s.get(d), arr)
        assert s.state == "DEGRADED"
        np.testing.assert_array_equal(s.get(d), arr)
        assert s.state == "DEGRADED"
    np.testing.assert_array_equal(s.get(d), arr)
    assert s.state == "OK"
    s.close()


def test_lru_eviction_keeps_store_under_budget(st, tmp_path, rng):
    arrays = [rng.standard_normal((4, 64)).astype(np.float32)
              for _ in range(4)]
    one = 4 * 64 * 4 + 300
    s = _store(st, tmp_path, budget_bytes=2 * one)
    digests = [st.store.content_digest(a) for a in arrays]
    for d, a in zip(digests[:3], arrays[:3]):
        s.resolve(d, lambda a=a: a)
    assert s.entries == 2 and s.counters["evictions"] == 1
    assert s.bytes_used <= 2 * one and s.get(digests[0]) is None
    assert s.get(digests[1]) is not None
    s.resolve(digests[0], lambda: arrays[0])
    assert s.get(digests[2]) is None and s.get(digests[1]) is not None
    journal = os.path.join(str(tmp_path / "fstore"),
                           "aaaa0000-s128-k2-bf16", "journal.jsonl")
    ops = [json.loads(line)["op"] for line in open(journal)]
    assert ops.count("evict") == 2 and "put" in ops and "touch" in ops
    s.close()
    s2 = _store(st, tmp_path, budget_bytes=2 * one)
    assert s2.entries == 2
    s2.resolve(digests[3], lambda: arrays[3])
    assert s2.get(digests[0]) is None
    assert s2.contains(digests[1]) and s2.contains(digests[3])
    s2.close()


def test_one_package_reads_the_others_entries_under_one_fingerprint(tmp_path,
                                                                    arr):
    """The entry format is shared: under the same fingerprint name, what
    one package committed the other reads back verified."""
    J, T = load("jax").store, load("torch").store
    d = J.content_digest(arr)
    J.FeatureStore(str(tmp_path / "s"), "aaaa0000-s1-k1-f32").put(d, arr)
    t = T.FeatureStore(str(tmp_path / "s"), "aaaa0000-s1-k1-f32")
    np.testing.assert_array_equal(t.get(d), arr)
    t.close()


# ---------------------------------------------------------------------------
# keys: weights digest and the fingerprint (ROADMAP D8)
# ---------------------------------------------------------------------------


def shared_params(backbone, seed=0):
    from ncnet_tpu import config as jcfg
    from ncnet_tpu.models import ncnet as jnet
    from ncnet_tpu_torch.models.convert import params_from_numpy

    jc = jcfg.ModelConfig(backbone=backbone, ncons_kernel_sizes=(3,),
                          ncons_channels=(1,), backbone_last_layer=(
                              "layer1" if backbone == "resnet101" else ""))
    jp = jnet.init_ncnet(jc, jax.random.key(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("backbone", ["tiny", "resnet101"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_weights_digest_is_the_jax_digest(backbone, dtype):
    import torch

    from ncnet_tpu.store import weights_digest as jdigest
    from ncnet_tpu_torch.models.ncnet import params_to
    from ncnet_tpu_torch.store import weights_digest

    jp, tp = shared_params(backbone)
    if dtype == "bf16":
        jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp)
        tp = params_to(tp, torch.bfloat16)
    assert weights_digest(tp) == jdigest(jp)
    assert weights_digest(tp["backbone"]) == jdigest(jp["backbone"])
    # the NC filter is not part of the generation; the trunk is
    tp2 = {**tp, "nc": [{k: v + 1 for k, v in tp["nc"][0].items()}]}
    assert weights_digest(tp2) == weights_digest(tp)
    _, other = shared_params(backbone, seed=1)
    assert weights_digest(other) != weights_digest(shared_params(backbone)[1])


def test_fingerprints_miss_across_packages_both_ways(tmp_path, arr):
    """D8: the same weights and settings give fingerprints that share the
    weights segment but differ in the program segment; an entry committed
    by one package is a miss for the other, in both directions, and each
    package's GC keeps the other's same-weights generation."""
    J, T = load("jax").store, load("torch").store
    jp, tp = shared_params("tiny")
    kw = dict(image_size=128, k_size=2, dtype="f32")
    jfp = J.backbone_fingerprint(jp, **kw)
    tfp = T.backbone_fingerprint(tp, device="cpu", **kw)
    assert tfp == jfp + "-torch.cpu"
    assert T.backbone_fingerprint(tp, **kw) == jfp + "-torch.cuda"
    assert jfp.split("-", 1)[0] == tfp.split("-", 1)[0]
    root = str(tmp_path / "store")
    d = J.content_digest(arr)

    js = J.FeatureStore(root, jfp)
    js.put(d, arr)
    js.close()
    ts = T.FeatureStore(root, tfp)
    assert ts.get(d) is None and ts.counters["misses"] == 1
    ts.put(d, arr + 1)
    assert ts.gc_superseded() == 0
    ts.close()
    js = J.FeatureStore(root, jfp)
    np.testing.assert_array_equal(js.get(d), arr)  # its own entry, not ours
    assert js.gc_superseded() == 0
    js.close()

    root2 = str(tmp_path / "store2")
    ts = T.FeatureStore(root2, tfp)
    ts.put(d, arr)
    ts.close()
    js = J.FeatureStore(root2, jfp)
    assert js.get(d) is None and js.counters["misses"] == 1
    js.close()
    assert sorted(n for n in os.listdir(root) if n != "quarantine") \
        == sorted([jfp, tfp])
