"""The port's bulk feature-store builder
(``ncnet_tpu_torch/tools/build_feature_store.py``) against the JAX
package's root ``tools/build_feature_store.py``, on the CPU.

The tool's two cases of ``tests/test_store.py`` run once with each
package's tool (``pkg`` is ``"jax"`` or ``"torch"``), each tool loading one
set of weights from its own package's checkpoint of them (the tiny trunk,
bf16 as the tool runs it), over the rect tree of
``tests/test_torch_port_inloc.py``: two queries, two cutouts each, four
panos at depth 2.

* The build commits every pano; a rerun in a fresh process (``python -m
  ncnet_tpu_torch.tools.build_feature_store`` for the port, the root
  script for JAX) skips every pano through the stripe's manifest; then
  that package's ``run_inloc_eval`` with ``feature_store_dir`` is 100 %
  warm (four hits, no miss, under the tool's fingerprint) and writes a
  run without the store's tables bit for bit.
* A pano that cannot be decoded is quarantined into the manifest with
  exit 2 while the rest of the stripe builds; the rerun with the fault
  cleared completes it.

Then the two tools side by side: the same summary keys and counts, the
same manifests but for the fingerprint (the port's carries its program
token, ROADMAP D8), the same entry keys (content digests of the same
pixels), and entries of one shape and dtype within a bf16 rounding of
each other.
"""

import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from scipy.io import loadmat

from ncnet_tpu import config as jcfg
from ncnet_tpu.models import checkpoint as jckpt
from ncnet_tpu_torch import config as tcfg
from ncnet_tpu_torch.evaluation import inloc as tinloc
from ncnet_tpu_torch.models import checkpoint as tckpt
from ncnet_tpu_torch.observability import events as tevents
from ncnet_tpu_torch.tools import build_feature_store as ttool
from ncnet_tpu_torch.utils import faults as tfaults
from test_torch_port_inloc import SIDE, eval_kw, shared_params, write_rect_tree

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_REPO, "tools"))

import build_feature_store as jtool  # noqa: E402  (the root JAX tool)

jinloc = importlib.import_module("ncnet_tpu.evaluation.inloc")
jevents = importlib.import_module("ncnet_tpu.observability.events")
jfaults = importlib.import_module("ncnet_tpu.utils.faults")

PKGS = ("jax", "torch")
MANIFEST = "build_manifest.shard0_of_1.json"


@pytest.fixture(autouse=True)
def _clean_state():
    for f in (jfaults, tfaults):
        f.clear()
    yield
    for f in (jfaults, tfaults):
        f.clear()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("store_tool"))
    return root, write_rect_tree(root)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """One set of weights, saved by each package."""
    d = tmp_path_factory.mktemp("ckpt")
    jc, jp, tc, tp = shared_params(True)
    paths = {"jax": str(d / "jck"), "torch": str(d / "tck")}
    jckpt.save_params(paths["jax"], jc, jp)
    tckpt.save_params(paths["torch"], tc, tp)
    return paths


def tool_argv(pkg, tree, store, ckpt, *extra):
    root, shortlist = tree
    argv = ["--store_dir", store, "--inloc_shortlist", shortlist,
            "--pano_path", os.path.join(root, "pano"), "--checkpoint", ckpt,
            "--image_size", str(SIDE), "--k_size", "2", "--n_panos", "2",
            *extra]
    return argv + (["--device", "cpu"] if pkg == "torch" else [])


def run_tool(pkg, argv, capsys):
    """The tool in this process: ``(exit code, its summary line)``."""
    rc = (jtool if pkg == "jax" else ttool).main(argv)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    return rc, json.loads(line)


def manifest_of(store):
    with open(os.path.join(store, MANIFEST)) as f:
        return json.load(f)


def run_eval(pkg, tree, out, **kw):
    """That package's ``run_inloc_eval`` in bf16 (the tool's precision):
    ``(output dir, its events)``."""
    root, shortlist = tree
    jc, jp, tc, tp = shared_params(True)
    tel = out + "_tel"
    if pkg == "jax":
        d = jinloc.run_inloc_eval(
            jcfg.EvalInLocConfig(output_root=out, telemetry_dir=tel,
                                 **eval_kw(root, shortlist, **kw)),
            model_config=jc, params=jp, progress=False)
        _, ev = jevents.replay_events(os.path.join(tel, "events.jsonl"))
    else:
        d = tinloc.run_inloc_eval(
            tcfg.EvalInLocConfig(output_root=out, telemetry_dir=tel,
                                 **eval_kw(root, shortlist, **kw)),
            model_config=tc, params=tp, progress=False, device="cpu")
        _, ev = tevents.replay_events(os.path.join(tel, "events.jsonl"))
    return d, ev


def matches_of(out_dir):
    return {n: loadmat(os.path.join(out_dir, n))["matches"]
            for n in sorted(os.listdir(out_dir)) if n.endswith(".mat")}


@pytest.mark.parametrize("pkg", PKGS)
def test_build_feature_store_tool_resumable_and_eval_warm(
        pkg, tree, checkpoints, tmp_path, capsys):
    """The build commits the four panos; a rerun in a fresh process skips
    them all via the manifest; the package's eval over the built store is
    100 % warm and writes the tables of a run without the store."""
    store = str(tmp_path / "fstore")
    argv = tool_argv(pkg, tree, store, checkpoints[pkg])
    rc, doc = run_tool(pkg, argv, capsys)
    assert rc == 0
    assert (doc["built"], doc["skipped_completed"], doc["stripe_panos"]) == \
        (4, 0, 4)
    assert doc["statuses"]["miss"] == 4 and not doc["quarantined"]
    manifest = manifest_of(store)
    assert len(manifest["completed"]) == 4 and not manifest["quarantined"]

    cmd = ([sys.executable, "-m", "ncnet_tpu_torch.tools.build_feature_store"]
           if pkg == "torch" else
           [sys.executable, os.path.join(_REPO, "tools",
                                         "build_feature_store.py")])
    proc = subprocess.run(
        cmd + argv, cwd=_REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=_REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    again = json.loads(proc.stdout.strip().splitlines()[-1])
    assert (again["built"], again["skipped_completed"]) == (0, 4)
    assert again["fingerprint"] == doc["fingerprint"]

    plain, _ = run_eval(pkg, tree, str(tmp_path / "plain"))
    warm, ev = run_eval(pkg, tree, str(tmp_path / "warm"),
                        feature_store_dir=store)
    st = [e for e in ev if e["event"] == "eval_summary"][-1]["store"]
    assert st["counters"]["hits"] == 4 and st["counters"]["misses"] == 0
    assert st["fingerprint"] == doc["fingerprint"]
    want, got = matches_of(plain), matches_of(warm)
    assert sorted(got) == sorted(want) == ["1.mat", "2.mat"]
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])


@pytest.mark.parametrize("pkg", PKGS)
def test_build_tool_quarantines_bad_pano_and_exits_2(
        pkg, tree, checkpoints, tmp_path, capsys):
    """A pano that fails every decode attempt quarantines into the stripe's
    manifest (exit 2) while the other three build; the rerun with the
    fault cleared completes it and skips the three."""
    store = str(tmp_path / "fstore")
    argv = tool_argv(pkg, tree, store, checkpoints[pkg], "--retries", "1",
                     "--retry_backoff_s", "0")
    faults = jfaults if pkg == "jax" else tfaults
    with faults.injected(faults.FaultPlan(
            decode_fail_substring="cutout_000_30")):
        rc, doc = run_tool(pkg, argv, capsys)
    assert rc == 2
    assert doc["built"] == 3 and doc["quarantined"] == \
        ["DUC1/DUC_cutout_000_30_0.jpg"]
    manifest = manifest_of(store)
    assert list(manifest["quarantined"]) == doc["quarantined"]
    assert manifest["quarantined"][doc["quarantined"][0]]["attempts"] == 2
    assert len(manifest["completed"]) == 3
    rc, doc = run_tool(pkg, argv, capsys)
    assert rc == 0
    assert (doc["built"], doc["skipped_completed"]) == (1, 3)
    manifest = manifest_of(store)
    assert len(manifest["completed"]) == 4 and not manifest["quarantined"]


def test_the_two_tools_build_the_same_store(tree, checkpoints, tmp_path,
                                            capsys):
    """Each package's tool from its own checkpoint of one set of weights:
    the same summary and manifest but for the program token of the
    fingerprint, the same entry keys, and entries within a bf16 rounding
    of each other (each trunk computes in bf16)."""
    docs, stores = {}, {}
    for pkg in PKGS:
        stores[pkg] = str(tmp_path / pkg)
        rc, docs[pkg] = run_tool(
            pkg, tool_argv(pkg, tree, stores[pkg], checkpoints[pkg]), capsys)
        assert rc == 0
    jdoc, tdoc = docs["jax"], docs["torch"]
    assert tdoc["fingerprint"] == jdoc["fingerprint"] + "-torch.cpu"
    same = ("built", "skipped_completed", "statuses", "quarantined",
            "shard", "stripe_panos", "tool")
    assert {k: tdoc[k] for k in same} == {k: jdoc[k] for k in same}
    assert sorted(tdoc) == sorted(jdoc)
    jm, tm = manifest_of(stores["jax"]), manifest_of(stores["torch"])
    assert sorted(tm["completed"]) == sorted(jm["completed"])
    assert {k: v for k, v in tm["meta"].items() if k != "fingerprint"} == \
        {k: v for k, v in jm["meta"].items() if k != "fingerprint"}

    from ncnet_tpu.store import FeatureStore as JStore
    from ncnet_tpu_torch.store import FeatureStore as TStore

    gen = {pkg: os.path.join(stores[pkg], docs[pkg]["fingerprint"])
           for pkg in PKGS}
    keys = {pkg: sorted(n for n in os.listdir(gen[pkg])
                        if n.endswith(".feat")) for pkg in PKGS}
    assert keys["torch"] == keys["jax"] and len(keys["jax"]) == 4
    js = JStore(stores["jax"], jdoc["fingerprint"], scope="t")
    ts = TStore(stores["torch"], tdoc["fingerprint"], scope="t")
    try:
        for name in keys["jax"]:
            digest = name[:-len(".feat")]
            a, b = js.get(digest), ts.get(digest)
            assert a.shape == b.shape and a.dtype == b.dtype
            a32, b32 = a.astype(np.float32), b.astype(np.float32)
            scale = float(np.abs(a32).max())
            np.testing.assert_allclose(b32, a32, rtol=0,
                                       atol=2 ** -7 * scale)
    finally:
        js.close()
        ts.close()
