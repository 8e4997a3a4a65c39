"""The port's InLoc in-system shortlist (``run_inloc_eval`` with
``retrieval_index``, ``evaluation/inloc.py``) against the JAX package's on
the CPU, on the tiny trunk in fp32.

The tree: two portrait queries and eight landscape cutouts, the same
eight in both ``.mat`` rows in different orders; two cutouts are crops of
each query, half a feature cell off its texture, and sit at the row's
last two ranks, so the ``.mat`` order's top two hold none of them.  The
queries and the four distractors are structured (distinct hue levels and
stripe cadences) under a seeded texture: the raw extractor scores noise
images all alike.

A raw index (``build_coarse_index --raw``, the same bytes from either
package's tool) and a backbone index built by each package's tool from one
set of weights (each package's own checkpoint of them) drive both loops:
the same shortlist names a query, the same ``retrieval_coverage``, the
``.mat`` tables within the fp32 bound of ``tests/test_torch_port_inloc.py``
(the same matches row for row, scores within rtol 1e-5, atol 1e-6), and
the same ``retrieval_shortlist`` events.  Either package reads the index
the other's tool built (ROADMAP D10).  The coverage and error fallbacks
match the ``.mat`` order with the same ``retrieval_fallback`` events.
"""

import glob
import importlib
import json
import os

import numpy as np
import pytest
from scipy.io import loadmat, savemat

from ncnet_tpu import config as jcfg
from ncnet_tpu.models import checkpoint as jckpt
from ncnet_tpu_torch import config as tcfg
from ncnet_tpu_torch.data import synthetic as tsynth
from ncnet_tpu_torch.evaluation import inloc as tinloc
from ncnet_tpu_torch.models import checkpoint as tckpt
from ncnet_tpu_torch.observability import events as tevents
from ncnet_tpu_torch.tools import build_coarse_index as ttool
from ncnet_tpu_torch.utils import faults
from test_torch_port_inloc import (
    PANO_HW,
    PANO_SHIFTS,
    QUERY_HW,
    SIDE,
    assert_same_matches,
    shared_params,
    write_image,
)

jinloc = importlib.import_module("ncnet_tpu.evaluation.inloc")
jevents = importlib.import_module("ncnet_tpu.observability.events")

N_DISTRACTORS = 4
GRID = ((QUERY_HW[0] // 32, QUERY_HW[1] // 32, PANO_HW[0] // 32,
         PANO_HW[1] // 32), 2)


@pytest.fixture(autouse=True)
def _clean_state():
    faults.clear()
    yield
    faults.clear()


def structured(i, rng, h, w):
    """Hue levels and a stripe cadence of their own (``i``) under a seeded
    smooth texture."""
    base = np.zeros((h, w, 3), np.float64)
    base[..., 0] = (37 * i + 20) % 256
    base[..., 1] = (91 * i + 13) % 256
    base[:: (i % 5) + 2, :, 2] = 255
    tex = tsynth._textured_image(rng, h, w).astype(np.float64)
    return np.clip(0.6 * base + 0.4 * tex, 0, 255).astype(np.uint8)


def write_retrieval_tree(root):
    """``(shortlist path, {query: own crop names})``."""
    rng = np.random.default_rng(23)
    (qh, qw), (ph, pw) = QUERY_HW, PANO_HW
    own = {}
    for q in range(2):
        big = structured(q, rng, 320, 320)
        write_image(os.path.join(root, "query", "iphone7", f"query_{q}.jpg"),
                    big[:qh, :qw])
        own[q] = []
        for p, (oy, ox) in enumerate(PANO_SHIFTS):
            name = f"DUC1/DUC_cutout_{q:03d}_{p * 30}_0.jpg"
            write_image(os.path.join(root, "pano", name),
                        big[oy:oy + ph, ox:ox + pw])
            own[q].append(name)
    distractors = []
    for d in range(N_DISTRACTORS):
        name = f"DUC2/DUC_cutout_{d:03d}_0_0.jpg"
        write_image(os.path.join(root, "pano", name),
                    structured(2 + d, rng, ph, pw))
        distractors.append(name)
    rows = [distractors + own[1] + own[0],
            distractors[::-1] + own[0] + own[1]]
    entries = np.zeros((1, 2), dtype=np.dtype(
        [("queryname", object), ("topNname", object)]))
    for q in range(2):
        entries[0, q] = (np.array([f"query_{q}.jpg"]),
                         np.array(rows[q], dtype=object)[:, None])
    shortlist = os.path.join(root, "shortlist.mat")
    savemat(shortlist, {"ImgList": entries})
    return shortlist, own


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("inloc_retrieval"))
    shortlist, own = write_retrieval_tree(root)
    return root, shortlist, own


def eval_kw(root, shortlist, **kw):
    return {**dict(inloc_shortlist=shortlist, k_size=2, image_size=SIDE,
                   n_queries=2, n_panos=2, pano_path=os.path.join(root, "pano"),
                   query_path=os.path.join(root, "query", "iphone7")), **kw}


def run_both(root, shortlist, out, jindex, tindex=None, **kw):
    """Both packages' loops, fp32, each with its telemetry: ``(jax dir,
    port dir, jax events, port events)``."""
    jc, jp, tc, tp = shared_params(False)
    jdir = jinloc.run_inloc_eval(
        jcfg.EvalInLocConfig(output_root=os.path.join(out, "jax"),
                             telemetry_dir=os.path.join(out, "jtel"),
                             retrieval_index=jindex,
                             **eval_kw(root, shortlist, **kw)),
        model_config=jc, params=jp, progress=False)
    tdir = tinloc.run_inloc_eval(
        tcfg.EvalInLocConfig(output_root=os.path.join(out, "port"),
                             telemetry_dir=os.path.join(out, "ttel"),
                             retrieval_index=tindex or jindex,
                             **eval_kw(root, shortlist, **kw)),
        model_config=tc, params=tp, progress=False, device="cpu")
    _, jev = jevents.replay_events(os.path.join(out, "jtel", "events.jsonl"))
    _, tev = tevents.replay_events(os.path.join(out, "ttel", "events.jsonl"))
    return jdir, tdir, jev, tev


def retrieval_events(events):
    keep = ("query", "reason", "coverage", "consulted", "row", "topk",
            "unavailable", "error")
    return [{k: e[k] for k in keep if k in e} | {"event": e["event"]}
            for e in events
            if e.get("event") in ("retrieval_shortlist", "retrieval_fallback")]


def coverage_of(mat):
    return float(np.ravel(mat["retrieval_coverage"])[0])


def shortlist_of(mat):
    return ([tinloc._as_str(n) for n in mat["shortlist"].ravel()]
            if "shortlist" in mat else None)


def assert_same_runs(jdir, tdir, jev, tev):
    """The same shortlists, coverages, tables (the fp32 bound) and
    retrieval events; returns ``{query: shortlist}`` (None on a
    fallback)."""
    assert os.path.basename(tdir) == os.path.basename(jdir)
    out = {}
    for q in (1, 2):
        got = loadmat(os.path.join(tdir, f"{q}.mat"))
        want = loadmat(os.path.join(jdir, f"{q}.mat"))
        assert sorted(k for k in got if not k.startswith("__")) == \
            sorted(k for k in want if not k.startswith("__"))
        assert shortlist_of(got) == shortlist_of(want)
        if "retrieval_coverage" in want:
            assert coverage_of(got) == coverage_of(want)
        g, w = got["matches"], want["matches"]
        assert g.shape == w.shape and (g[..., 4] > 0).sum() > 0
        assert_same_matches(g[..., :4], w[..., :4], GRID)
        np.testing.assert_allclose(g[..., 4], w[..., 4], rtol=1e-5,
                                   atol=1e-6)
        out[q] = shortlist_of(got)
    assert retrieval_events(tev) == retrieval_events(jev)
    return out


def build_raw_index(root, shortlist, store):
    rc = ttool.main(["--store_dir", store, "--inloc_shortlist", shortlist,
                     "--pano_path", os.path.join(root, "pano"), "--raw",
                     "--factor", "4", "--n_panos", "100"])
    assert rc == 0
    return os.path.join(store, "coarse_index.*.json")


def test_raw_index_shortlist_matches_jax(tree, tmp_path, capsys):
    """On a raw index the two loops shortlist the same cutouts, each
    query's own two crops (from the row's last two ranks), at coverage
    1.0, and write the same tables and events."""
    root, shortlist, own = tree
    index = build_raw_index(root, shortlist, str(tmp_path / "raw"))
    capsys.readouterr()
    jdir, tdir, jev, tev = run_both(root, shortlist, str(tmp_path), index)
    names = assert_same_runs(jdir, tdir, jev, tev)
    for q in (1, 2):
        assert sorted(names[q]) == sorted(own[q - 1])
        mat = loadmat(os.path.join(tdir, f"{q}.mat"))
        assert coverage_of(mat) == 1.0
    assert [e["event"] for e in retrieval_events(tev)] == \
        ["retrieval_shortlist"] * 2
    summary = [e for e in tev if e.get("event") == "eval_summary"][-1]
    assert summary["retrieval_store"]["state"] == "OK"
    assert [e["query"] for e in tev if e.get("event") == "span"
            and e.get("name") == "retrieval_plan" and e["ph"] == "B"] == [1, 2]


def build_backbone_indexes(tmp_path, root, shortlist):
    """One set of weights saved by each package, and each package's tool
    building a backbone index from its own checkpoint: ``(jax index glob,
    port index glob)``."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "tools"))
    import build_coarse_index as jtool

    jc, jp, tc, tp = shared_params(False)
    jck, tck = str(tmp_path / "jck"), str(tmp_path / "tck")
    jckpt.save_params(jck, jc, jp)
    tckpt.save_params(tck, tc, tp)
    argv = ["--inloc_shortlist", shortlist, "--pano_path",
            os.path.join(root, "pano"), "--factor", "2", "--n_panos", "100",
            "--image_size", str(SIDE), "--k_size", "2"]
    assert jtool.main(["--store_dir", str(tmp_path / "jidx"),
                       "--checkpoint", jck] + argv) == 0
    assert ttool.main(["--store_dir", str(tmp_path / "tidx"),
                       "--checkpoint", tck, "--device", "cpu"] + argv) == 0
    return (str(tmp_path / "jidx" / "coarse_index.*.json"),
            str(tmp_path / "tidx" / "coarse_index.*.json"))


def test_backbone_index_shortlist_matches_jax(tree, tmp_path, capsys):
    """Each package's tool builds a backbone index from one set of
    weights: the indexes name the same panos (the port's fingerprint
    carries its program token, ROADMAP D8), their volumes agree within
    1e-5, and each package's loop on its own index shortlists what the
    other's does, with the same tables; the port's loop on the JAX
    package's index gives the same shortlists (ROADMAP D10)."""
    root, shortlist, _ = tree
    jindex, tindex = build_backbone_indexes(tmp_path, root, shortlist)
    docs = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()
            if line.startswith("{")]
    assert [d["built"] for d in docs] == [8, 8]
    jfp, tfp = docs[0]["fingerprint"], docs[1]["fingerprint"]
    assert tfp == jfp.replace("-bf16-c2", "-bf16-torch.cpu-c2")
    from ncnet_tpu_torch.retrieval import load_index_manifests
    from ncnet_tpu_torch.store import FeatureStore

    ji, ti = load_index_manifests(jindex), load_index_manifests(tindex)
    assert ji["panos"] == ti["panos"]  # content digests of the same pixels
    stores = [FeatureStore(str(tmp_path / d), fp, scope="t")
              for d, fp in (("jidx", jfp), ("tidx", tfp))]
    try:
        for digest in ji["panos"].values():
            a, b = (s.get(digest) for s in stores)
            assert a.shape == b.shape and a.shape[-1] == 32
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
    finally:
        for s in stores:
            s.close()
    jdir, tdir, jev, tev = run_both(root, shortlist, str(tmp_path / "own"),
                                    jindex, tindex)
    names = assert_same_runs(jdir, tdir, jev, tev)
    assert all(len(n) == 2 for n in names.values())
    _, tdir2, _, tev2 = run_both(root, shortlist, str(tmp_path / "cross"),
                                 jindex)
    for q in (1, 2):
        assert shortlist_of(loadmat(os.path.join(tdir2, f"{q}.mat"))) == \
            names[q]
    assert retrieval_events(tev2) == retrieval_events(tev)


def test_coverage_fallback_matches_jax(tree, tmp_path, capsys):
    """An index missing two of a row's eight panos: at min coverage 1.0
    each query falls back to the ``.mat`` order (no ``shortlist`` key),
    with the same ``retrieval_fallback`` events (reason ``coverage``,
    0.75); at 0.7 the shortlist stands with coverage 0.75."""
    root, shortlist, own = tree
    store = str(tmp_path / "raw")
    build_raw_index(root, shortlist, store)
    capsys.readouterr()
    full = json.load(open(glob.glob(os.path.join(store,
                                                 "coarse_index.*.json"))[0]))
    dropped = dict(full["panos"])
    for name in (own[0][0], own[1][0]):
        del dropped[name]
    part = os.path.join(store, "partial.json")
    from ncnet_tpu_torch.retrieval import write_index_manifest

    write_index_manifest(part, fingerprint=full["fingerprint"],
                         factor=full["factor"], extractor=full["extractor"],
                         panos=dropped)
    jdir, tdir, jev, tev = run_both(root, shortlist, str(tmp_path / "a"),
                                    part)
    names = assert_same_runs(jdir, tdir, jev, tev)
    assert names == {1: None, 2: None}
    assert retrieval_events(tev) == [
        {"event": "retrieval_fallback", "query": q, "reason": "coverage",
         "coverage": 0.75, "consulted": 6, "row": 8} for q in (1, 2)]
    jdir, tdir, jev, tev = run_both(root, shortlist, str(tmp_path / "b"),
                                    part, retrieval_min_coverage=0.7)
    names = assert_same_runs(jdir, tdir, jev, tev)
    for q in (1, 2):
        assert names[q] is not None
        assert coverage_of(loadmat(os.path.join(tdir, f"{q}.mat"))) == 0.75


def test_error_fallback_matches_jax(tree, tmp_path, capsys):
    """A raw index mislabelled ``backbone``: the query's trunk descriptor
    (32 channels) cannot score 8-channel volumes, so scoring raises and
    each query falls back to the ``.mat`` order with the same
    ``retrieval_fallback`` events (reason ``error``, the same message) and
    the same tables as a run without retrieval."""
    root, shortlist, _ = tree
    store = str(tmp_path / "raw")
    build_raw_index(root, shortlist, store)
    capsys.readouterr()
    full = json.load(open(glob.glob(os.path.join(store,
                                                 "coarse_index.*.json"))[0]))
    from ncnet_tpu_torch.retrieval import write_index_manifest

    bad = os.path.join(store, "mislabelled.json")
    write_index_manifest(bad, fingerprint=full["fingerprint"],
                         factor=full["factor"], extractor="backbone",
                         panos=full["panos"])
    jdir, tdir, jev, tev = run_both(root, shortlist, str(tmp_path / "e"), bad)
    names = assert_same_runs(jdir, tdir, jev, tev)
    assert names == {1: None, 2: None}
    evs = retrieval_events(tev)
    assert [(e["reason"], "descriptor dim 32" in e["error"]) for e in evs] \
        == [("error", True)] * 2
    plain = tinloc.run_inloc_eval(
        tcfg.EvalInLocConfig(output_root=str(tmp_path / "plain"),
                             **eval_kw(root, shortlist)),
        model_config=shared_params(False)[2], params=shared_params(False)[3],
        progress=False, device="cpu")
    for q in (1, 2):
        np.testing.assert_array_equal(
            loadmat(os.path.join(tdir, f"{q}.mat"))["matches"],
            loadmat(os.path.join(plain, f"{q}.mat"))["matches"])
