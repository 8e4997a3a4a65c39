"""Retrieval pods of real shard processes, the port's against the JAX
package's, on the CPU.

The acceptance chain of ``tests/test_retrieval.py`` runs once with each
package (``pkg``): four shard hosts at R = 2 (``tools/serve_shard.py`` for
JAX, ``python -m ncnet_tpu_torch.tools.serve_shard`` for the port) behind a
coordinator of the same package; SIGKILL one under a stream of queries,
every answer at coverage 1.0 with the right top-1, the victim DEAD, a
restart at its port resurrected by the probes, and both packages'
``run_report`` replaying the outcome identity from the event log with zero
lost queries.

Mixed pods on one raw index (shared bytewise: the port's ``serve_probe.
build_coarse_fixture``): a JAX coordinator over port shards, a port
coordinator over JAX shards, and a port coordinator over shards of both;
every answer equals ``local_shortlist`` over the same store, scores bit for
bit.  Waits are on states (DEAD, READY), never on wall bounds.
"""

import json
import os
import subprocess
import sys
import time
import types

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_REPO, "tools"))


from ncnet_tpu_torch.tools import serve_probe as port_serve_probe  # noqa: E402

from torch_port_tool_twins import both, both_judge_url, both_main  # noqa: E402

PKGS = ("jax", "torch")
FACTOR = 4
GRID = 16


def load(name):
    if name == "jax":
        from ncnet_tpu import retrieval, store
        from ncnet_tpu.observability import EventLog
        from ncnet_tpu.observability import events
        from ncnet_tpu.utils import faults
    else:
        from ncnet_tpu_torch import retrieval, store
        from ncnet_tpu_torch.observability import EventLog
        from ncnet_tpu_torch.observability import events
        from ncnet_tpu_torch.utils import faults
    return types.SimpleNamespace(name=name, r=retrieval, store=store,
                                 events=events, EventLog=EventLog,
                                 faults=faults)


@pytest.fixture(autouse=True)
def _clean_state():
    for name in PKGS:
        p = load(name)
        p.faults.clear()
        p.events.set_global_sink(None)
    yield
    for name in PKGS:
        p = load(name)
        p.faults.clear()
        p.events.set_global_sink(None)


def wait_until(pred, timeout=60.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def descriptor(p, img):
    return p.r.pooled_descriptor(p.r.raw_coarse_volume(img, FACTOR, grid=GRID))


def shard_argv(name, sid, shard_ids, store_root, index_path, port=0):
    head = ([sys.executable, os.path.join(_REPO, "tools", "serve_shard.py")]
            if name == "jax" else
            [sys.executable, "-m", "ncnet_tpu_torch.tools.serve_shard"])
    return head + ["--shard-id", sid, "--shards", ",".join(shard_ids),
                   "--store", str(store_root), "--index", str(index_path),
                   "--replication", "2", "--port", str(port)]


def spawn_shards(kinds, shard_ids, store_root, index_path, ports=None):
    """One shard process a ``(package, shard id)``, all started before any
    startup line is read: ``{sid: (Popen, url)}``."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", NCNET_TPU_PERF_STORE="off",
               NCNET_TPU_TIER_CACHE="off",
               PYTHONPATH=_REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
    procs = {sid: subprocess.Popen(
        shard_argv(kind, sid, shard_ids, store_root, index_path,
                   (ports or {}).get(sid, 0)),
        stdout=subprocess.PIPE, text=True, env=env, cwd=_REPO)
        for kind, sid in kinds}
    out = {}
    for sid, proc in procs.items():
        line = proc.stdout.readline()
        doc = json.loads(line) if line.strip() else {}
        assert "url" in doc, f"shard {sid} failed to start: {doc}"
        out[sid] = (proc, doc["url"])
    return out


def stop_shards(procs):
    for p, _ in procs.values():
        if p.poll() is None:
            p.terminate()
    for p, _ in procs.values():
        try:
            p.wait(timeout=20)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        p.stdout.close()


@pytest.mark.parametrize("name", PKGS)
def test_acceptance_sigkill_full_coverage(name, tmp_path):
    """Four real shard processes of one package at R = 2 behind its
    coordinator: SIGKILL one mid-stream and every query still ends
    classified at coverage 1.0 with the right top-1; the victim goes DEAD
    and the pod DEGRADED; a restart at the same port is resurrected; the
    JAX ``run_report`` replays the identity with zero lost queries and
    ``stall_watchdog`` reads the coordinator's document."""
    p = load(name)
    index_path, images = port_serve_probe.build_coarse_fixture(
        str(tmp_path), 12, factor=FACTOR, grid=GRID)
    index = p.r.load_index_manifests(index_path)
    names = sorted(images)
    shard_ids = [f"s{i}" for i in range(4)]
    log_path = str(tmp_path / "retrieval_events.jsonl")
    procs = spawn_shards([(name, sid) for sid in shard_ids], shard_ids,
                         tmp_path, index_path)
    sink = p.EventLog(log_path)
    try:
        with p.events.bound(sink):
            coord = p.r.RetrievalCoordinator(
                {sid: url for sid, (_, url) in procs.items()},
                list(index["panos"]),
                p.r.RetrievalConfig(replication=2, topk=5,
                                    probe_period_s=0.2,
                                    resurrect_after_s=0.3, max_failures=2,
                                    introspect_port=0))
            coord.start()
            try:
                def query(i, tag):
                    return coord.retrieve(descriptor(p, images[names[i]]),
                                          budget_s=30.0,
                                          request_id=f"{tag}-{i}")

                for i in range(len(names)):
                    ans = query(i, "steady")
                    assert ans["coverage"] == 1.0
                    assert ans["degraded"] is False
                    assert ans["scores"][0][0] == names[i]

                p1, url1 = procs["s1"]
                p1.kill()
                for i in range(len(names)):
                    ans = query(i, "killed")
                    assert ans["coverage"] == 1.0
                    assert ans["scores"][0][0] == names[i]
                victim = coord._backends["s1"]
                assert wait_until(lambda: victim.state == "DEAD")
                assert coord.state == "DEGRADED"
                assert victim.deaths >= 1

                port = int(url1.rsplit(":", 1)[1])
                p1.wait(timeout=10)
                p1.stdout.close()
                procs.update(spawn_shards([(name, "s1")], shard_ids,
                                          tmp_path, index_path,
                                          ports={"s1": port}))
                assert wait_until(lambda: victim.state == "READY")
                assert wait_until(lambda: coord.state == "READY")
                ans = query(0, "revived")
                assert ans["coverage"] == 1.0

                v = both_judge_url(coord.introspect_url, factor=5,
                                   min_age=30.0)
                assert v["status"] == "alive" and v["role"] == "retrieval"
                assert v["retrieval"]["shards_total"] == 4
                assert set(v["backends"]) == set(shard_ids)
            finally:
                coord.stop()
    finally:
        sink.close()
        stop_shards(procs)

    report = both("run_report", "build_report", [log_path])
    r = report["retrieval"]
    o = r["outcomes"]
    assert o["admitted"] == 25
    assert o["results"] == o["admitted"]
    assert o["deadline_exceeded"] == 0 and o["shed"] == 0
    assert o["unresolved"] == 0 and not r["lost_requests"]
    assert r["coverage"]["min"] == 1.0 and r["coverage"]["below_full"] == 0
    assert r["shards"]["s1"]["deaths"] >= 1
    assert r["shards"]["s1"]["resurrections"] >= 1
    assert r["final_health_doc"] is not None
    assert both_main("run_report", [log_path, "--retrieval"]) == 0
    _, events = p.events.replay_events(log_path)
    assert any(e.get("event") == "retrieve_backend" and e.get("state") ==
               "DEAD" and e.get("shard") == "s1" for e in events)


@pytest.mark.parametrize("coord_pkg,shard_pkgs", [
    ("jax", ("torch",) * 3),
    ("torch", ("jax",) * 3),
    ("torch", ("jax", "torch", "torch")),
])
def test_mixed_pod_answers_equal_local_shortlist(coord_pkg, shard_pkgs,
                                                 tmp_path):
    """A coordinator of one package over shard hosts of the other (and of
    both): every answer, through ``retrieve`` and through the coordinator's
    own ``POST /retrieve``, equals ``local_shortlist`` of each package over
    the same store, scores bit for bit, at coverage 1.0 — and stays so
    with one shard dead."""
    c = load(coord_pkg)
    index_path, images = port_serve_probe.build_coarse_fixture(
        str(tmp_path), 16, factor=FACTOR, grid=GRID)
    index = c.r.load_index_manifests(index_path)
    shard_ids = [f"s{i}" for i in range(len(shard_pkgs))]
    procs = spawn_shards(list(zip(shard_pkgs, shard_ids)), shard_ids,
                         tmp_path, index_path)
    coord = c.r.RetrievalCoordinator(
        {sid: url for sid, (_, url) in procs.items()}, list(index["panos"]),
        c.r.RetrievalConfig(replication=2, topk=6, probe_period_s=0.2,
                            max_failures=1, introspect_port=0))
    coord.start()
    try:
        wants = {}
        for name in PKGS:
            p = load(name)
            st = p.store.FeatureStore(str(tmp_path), index["fingerprint"],
                                      scope=f"ref_{name}")
            try:
                for i, img_name in enumerate(sorted(images)):
                    desc = descriptor(p, images[img_name])
                    ref = p.r.local_shortlist(st, index, desc, topk=6)
                    assert ref["coverage"] == 1.0
                    wants.setdefault(i, []).append(
                        [[n, s] for n, s in ref["scores"]])
            finally:
                st.close()
        assert all(a == b for a, b in wants.values())
        client = c.r.RetrieveClient(coord.introspect_url)
        try:
            for tag in ("all", "one_dead"):
                for i, img_name in enumerate(sorted(images)):
                    desc = descriptor(c, images[img_name])
                    ans = coord.retrieve(desc, budget_s=30.0,
                                         request_id=f"{tag}-{i}")
                    assert ans["coverage"] == 1.0
                    assert [list(x) for x in ans["scores"]] == wants[i][0]
                    wire = client.retrieve(desc, budget_s=30.0,
                                           request_id=f"{tag}-w{i}")
                    assert wire["scores"] == wants[i][0]
                if tag == "all":
                    victim, _ = procs["s0"]
                    victim.kill()
                    victim.wait(timeout=10)
        finally:
            client.close()
        assert wait_until(lambda: coord._backends["s0"].state == "DEAD")
    finally:
        coord.stop()
        stop_shards(procs)
