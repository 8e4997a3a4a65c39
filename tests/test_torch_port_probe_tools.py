"""The port's model-driving tools against the JAX package's: the probes
(``ncnet_tpu_torch/tools/{stream_probe,serve_probe}.py``), the point-
transfer demo (``cli/point_transfer_demo.py``) and the plot helpers
(``utils/plot.py``, ``localization/visualize.py``).

The probes run tiny on the CPU (``device="cpu"``) beside the JAX tiny
probes and give the same outcome identities and spy counts: the stream
probe on the same weights (``models/convert.py::params_from_numpy``), the
service probe's buckets, failure, burst, replica sweep, pod, rollout and
retrieval phases with zero lost requests.  ``build_coarse_fixture`` writes
the JAX tool's bytes.  The demo transfers the keypoints of one JAX-written
pair (converted to raw images, ROADMAP D1) within rtol 1e-5 / atol 1e-6 of
the JAX demo under the same weights, with the same PCK.  The plot helpers
give the JAX helpers' arrays and figures, and draw nothing, with a
warning, where matplotlib is missing.  Every model-driving tool refuses to
run without a GPU unless the CPU is named.
"""

import glob
import json
import os
import sys
import warnings

import numpy as np
import pytest

from torch_port_tool_twins import canon, jax_tool, port_tool

TOL = dict(rtol=1e-5, atol=1e-6)


def jax_params(cfg):
    import jax

    from ncnet_tpu import models

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return models.init_ncnet(cfg, jax.random.key(0))


def to_port(jp):
    import jax

    from ncnet_tpu_torch.models.convert import params_from_numpy

    return params_from_numpy(jax.tree.map(np.asarray, jp))


def port_config(jcfg):
    from ncnet_tpu_torch.config import ModelConfig

    return ModelConfig(**{k: getattr(jcfg, k)
                          for k in ModelConfig.__dataclass_fields__
                          if hasattr(jcfg, k)})


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("NCNET_TPU_PERF_STORE", "off")
    from ncnet_tpu.observability import events as je
    from ncnet_tpu.utils import faults as jf
    from ncnet_tpu_torch.observability import events as te
    from ncnet_tpu_torch.utils import faults as tf

    for m in (je, te):
        m.set_global_sink(None)
    for f in (jf, tf):
        f.clear()
    yield
    for m in (je, te):
        m.set_global_sink(None)
    for f in (jf, tf):
        f.clear()


# ---------------------------------------------------------------------------
# stream_probe
# ---------------------------------------------------------------------------


def test_stream_probe_tiny_matches_jax(monkeypatch):
    """The same tracked-stream outcomes on the same weights: frames =
    tracked + fallback + cold from the log, the same frame kinds, and the
    coarse passes of the steady segment those of its fallback frames."""
    from ncnet_tpu.config import ModelConfig as JConfig
    from ncnet_tpu_torch import models as tmodels

    js, ts = jax_tool("stream_probe"), port_tool("stream_probe")
    jcfg = JConfig(backbone="tiny", ncons_kernel_sizes=(3,),
                   ncons_channels=(1,), sparse_topk=4, sparse_factor=2)
    shared = to_port(jax_params(jcfg))
    monkeypatch.setattr(tmodels, "init_ncnet", lambda cfg, seed=0: shared)
    kw = dict(tiny=True, streams=2, frames=8, rate_hz=8.0)
    jd = js.probe(**kw)
    td = ts.probe(**kw, device="cpu")
    for key in ("tiny", "side", "streams", "frames_per_stream", "cut_at",
                "tracking_feasible", "streams_doc", "expected_coarse_passes",
                "coarse_passes_steady_delta", "replay_ordering_ok",
                "replay_outcome_identity_ok"):
        assert canon(td[key]) == canon(jd[key]), key
    assert td["replay_ordering_ok"] and td["replay_outcome_identity_ok"]
    assert td["coarse_passes_steady_delta"] == td["expected_coarse_passes"]
    assert td["coarse_passes_cold"] >= 1
    assert td["tracked_dispatches_steady"] >= 1
    doc = td["streams_doc"]
    assert doc["frames"] == (doc["tracked_frames"] + doc["fallback_frames"]
                             + doc["cold_frames"])
    # the CPU runs the plain twins: no kernel launch is counted
    assert set(td["launches_steady"].values()) == {0}
    assert td["launches_steady_expected"] == td["launches_steady"]
    assert td["device"] == "cpu"
    # the probe's log replays the same under both packages' run_report,
    # and holds one stream_frame event a frame
    from ncnet_tpu_torch.observability.events import replay_events

    log = [td["events_path"]]
    assert canon(port_tool("run_report").build_report(log)) == canon(
        jax_tool("run_report").build_report(log))
    kinds = [e.get("kind") for e in replay_events(log[0])[1]
             if e.get("event") == "stream_frame"]
    assert len(kinds) == doc["frames"]
    assert kinds.count("tracked") == doc["tracked_frames"]


# ---------------------------------------------------------------------------
# serve_probe
# ---------------------------------------------------------------------------


def run_probe(tool, argv, capsys):
    rc = tool.main(argv)
    assert rc == 0
    return json.loads(capsys.readouterr().out)


def test_serve_probe_service_phases_match_jax(capsys):
    """Buckets, the injected device failure, the burst and the replica
    sweep: the same outcome identities, zero lost."""
    js, ts = jax_tool("serve_probe"), port_tool("serve_probe")
    argv = ["--tiny", "--sides", "32", "--pairs", "4", "--burst-factor",
            "1.0", "--replicas", "1,2"]
    jd = run_probe(js, argv, capsys)
    td = run_probe(ts, argv + ["--device", "cpu"], capsys)
    assert set(td["buckets"]) == set(jd["buckets"]) == {"32x32"}
    assert td["buckets"]["32x32"]["latency_ms"]["n"] == \
        jd["buckets"]["32x32"]["latency_ms"]["n"] == 4
    for d in (jd, td):
        assert d["demotion"]["lost"] == 0
        assert d["demotion"]["outcomes"]["other"] == 0
        # JAX demotes a tier and stays READY; the port's replica took the
        # failure (D4) and the health machine may still read DEGRADED
        assert d["demotion"]["health"] in ("READY", "DEGRADED")
        assert d["burst"]["offered"] >= 32
        assert d["health"]["counters"]["results"] >= 4
    assert td["demotion"]["outcomes"] == jd["demotion"]["outcomes"]
    # no tier to demote on the port (D4): the replica absorbed the failure
    assert td["demotion"]["replica_failures"] >= 1
    assert set(td["replica_sweep"]) == set(jd["replica_sweep"]) == \
        {"r1", "r2"}
    for r in td["replica_sweep"].values():
        assert r["qps"] > 0 and r["latency_ms"]["n"] == 4
    # one CPU device: r2 puts both engines on it, and says so
    assert td["replica_sweep"]["r2"]["oversubscribed"] is True
    assert td["visible_devices"] == 1


def test_serve_probe_pod_rollout_and_shards_match_jax(capsys):
    js, ts = jax_tool("serve_probe"), port_tool("serve_probe")
    router = [run_probe(t, ["--router", "2", "--tiny", "--pairs", "4",
                            "--sides", "32"] + extra, capsys)["router"]
              for t, extra in ((js, []), (ts, ["--device", "cpu"]))]
    for d in router:
        assert d["failover"]["lost"] == 0
        assert d["latency_ms"]["n"] == 4
        assert sorted(d["failover"]["backend_states"].values()) == \
            ["DEAD", "READY"]
    rollout = [run_probe(t, ["--rollout", "--tiny", "--sides", "48",
                             "--pairs", "4"] + extra, capsys)["rollout"]
               for t, extra in ((js, []), (ts, ["--device", "cpu"]))]
    for d in rollout:
        assert d["phase"] == "COMPLETE" and d["lost"] == 0
        assert d["outcomes"]["other"] == 0
        assert d["pod_version"] == d["new_version"] == "step_000100"
    shards = [t.probe_shards(3, 12, 6) for t in (js, ts)]
    for phase in ("steady", "failover"):
        assert shards[1][phase]["outcomes"] == shards[0][phase]["outcomes"]
        assert shards[1][phase]["outcomes"]["result"] == 6
        assert shards[1][phase]["coverage_pct"] == 100.0


def test_build_coarse_fixture_writes_the_jax_bytes(tmp_path):
    from ncnet_tpu_torch.store import feature_store

    js, ts = jax_tool("serve_probe"), port_tool("serve_probe")
    out = {}
    for name, tool in (("jax", js), ("port", ts)):
        root = str(tmp_path / name)
        index_path, images = tool.build_coarse_fixture(root, 9)
        assert os.path.basename(index_path) == \
            "coarse_index.shard0_of_1.json"
        files = {}
        for path in glob.glob(os.path.join(root, "**", "*"), recursive=True):
            if not os.path.isfile(path):
                continue
            with open(path, "rb") as f:
                data = f.read()
            rel = os.path.relpath(path, root)
            if rel.endswith(feature_store._ENTRY_SUFFIX):
                head, payload = data.split(b"\n", 1)
                head = json.loads(head)
                assert isinstance(head.pop("t"), float)  # commit time
                data = (head, payload)
            elif not rel.startswith("coarse_index"):
                continue
            files[rel] = data
        out[name] = (files, {k: v.tobytes() for k, v in images.items()})
    assert out["port"][1] == out["jax"][1]
    assert set(out["port"][0]) == set(out["jax"][0])
    assert len(out["port"][0]) == 10
    for rel, data in out["jax"][0].items():
        assert out["port"][0][rel] == data, rel


# ---------------------------------------------------------------------------
# the point-transfer demo
# ---------------------------------------------------------------------------


def test_point_transfer_demo_matches_jax(tmp_path, monkeypatch, capsys):
    """Both demos on one JAX-written pair (the port reads it converted to
    raw images) under the same tiny weights: the transferred points within
    rtol 1e-5 / atol 1e-6, the same PCK."""
    import importlib.util

    from ncnet_tpu import models as jmodels
    from ncnet_tpu import ops as jops
    from ncnet_tpu.config import ModelConfig as JConfig
    from ncnet_tpu.data.synthetic import write_pf_pascal_like
    from ncnet_tpu_torch.cli import point_transfer_demo as tdemo
    from ncnet_tpu_torch.models.checkpoint import save_params
    from ncnet_tpu_torch.tools.convert_images import convert_tree

    side = 96
    root = str(tmp_path / "pair")
    write_pf_pascal_like(root, n_pairs=1, image_hw=(side, side),
                         shift=(side // 8,) * 2)
    convert_tree(root)
    jcfg = JConfig(backbone="tiny")
    jp = jax_params(jcfg)
    ckpt = str(tmp_path / "step_000001")
    save_params(ckpt, port_config(jcfg), to_port(jp))

    # the JAX demo, its net carrying the same weights and its transferred
    # points recorded where it converts them to pixels
    recorded = {}
    orig_net, orig_px = jmodels.NCNet, jops.points_to_pixel_coords

    def net(config):
        return orig_net(config, params=jp)

    def to_px(points, size):
        out = orig_px(points, size)
        recorded["warped"] = np.asarray(out)[0]
        return out

    monkeypatch.setattr(jmodels, "NCNet", net)
    monkeypatch.setattr(jops, "points_to_pixel_coords", to_px)
    spec = importlib.util.spec_from_file_location(
        "jax_point_transfer_demo",
        os.path.join(os.path.dirname(os.path.dirname(__file__)),
                     "point_transfer_demo.py"))
    jdemo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jdemo)
    base = ["--backbone", "tiny", "--image_size", str(side),
            "--eval_dataset_path", root]
    assert jdemo.main(base + ["--out", str(tmp_path / "jax.png")]) == 0
    out_json = str(tmp_path / "port.json")
    assert tdemo.main(base + ["--checkpoint", ckpt, "--device", "cpu",
                              "--out", str(tmp_path / "port.png"),
                              "--json", out_json]) == 0
    capsys.readouterr()
    with open(out_json) as f:
        doc = json.load(f)
    n = doc["n_valid"]
    assert n == 6
    np.testing.assert_allclose(np.asarray(doc["transferred_points"]),
                               recorded["warped"][:, :n], **TOL)

    from ncnet_tpu.data import PFPascalDataset

    import jax.numpy as jnp

    sample = PFPascalDataset(
        csv_file=os.path.join(root, "image_pairs", "test_pairs.csv"),
        dataset_path=root, output_size=(side, side),
        pck_procedure="pf", normalize=False)[0]
    jpck = importlib.import_module("ncnet_tpu.evaluation.pck").pck(
        jnp.asarray(sample["source_points"])[None],
        jnp.asarray(recorded["warped"])[None],
        jnp.asarray(sample["L_pck"])[None], 0.1)
    assert doc["pck"] == float(np.asarray(jpck)[0])
    assert os.path.getsize(str(tmp_path / "port.png")) > 0


def test_point_transfer_demo_synthetic_on_the_cpu(tmp_path, capsys):
    from ncnet_tpu_torch.cli import point_transfer_demo as tdemo

    out = str(tmp_path / "demo.png")
    assert tdemo.main(["--synthetic", "--backbone", "tiny", "--image_size",
                       "96", "--device", "cpu", "--out", out]) == 0
    assert "PCK@0.1" in capsys.readouterr().out
    with open(str(tmp_path / "demo.json")) as f:
        doc = json.load(f)
    assert doc["n_valid"] == 6 and doc["device"] == "cpu"
    pts = np.asarray(doc["transferred_points"])
    assert pts.shape == (2, 6) and np.isfinite(pts).all()
    assert 0.0 <= doc["pck"] <= 1.0


# ---------------------------------------------------------------------------
# plot helpers
# ---------------------------------------------------------------------------


def test_plot_helpers_match_jax(tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ncnet_tpu.localization import visualize as jvis
    from ncnet_tpu.utils import plot as jplot
    from ncnet_tpu_torch.localization import visualize as tvis
    from ncnet_tpu_torch.utils import plot as tplot

    rng = np.random.default_rng(4)
    img = rng.normal(0, 1.2, (1, 20, 24, 3)).astype(np.float32)
    want = jplot.denormalize_image(img)
    got = tplot.denormalize_image(img)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(tplot.plot_image(img[0], return_im=True),
                          jplot.plot_image(img[0], return_im=True))
    axes = []
    for mod in (jplot, tplot):
        fig, ax = plt.subplots()
        assert mod.plot_image(img, ax=ax) is ax
        axes.append(np.asarray(ax.images[0].get_array()))
        path = str(tmp_path / f"{mod.__name__}.png")
        mod.save_plot(path, fig)
        assert os.path.getsize(path) > 0
        plt.close(fig)
    assert np.array_equal(axes[0], axes[1])

    a = rng.integers(0, 255, (40, 60, 3), dtype=np.uint8)
    b = rng.integers(0, 255, (64, 50, 3), dtype=np.uint8)
    xy1 = rng.uniform(0, 40, (7, 2))
    xy2 = rng.uniform(0, 50, (7, 2))
    inl = np.array([1, 0, 1, 1, 0, 0, 1], bool)
    drawn = []
    for mod in (jvis, tvis):
        ax = mod.show_matches_horizontal(a, b, xy1, xy2, inliers=inl)
        drawn.append((np.asarray(ax.images[0].get_array()),
                      [np.asarray(c.get_offsets()) for c in ax.collections],
                      [np.asarray(ln.get_xydata()) for ln in ax.lines]))
        plt.close(ax.figure)
    assert np.array_equal(drawn[0][0], drawn[1][0])
    for x, y in zip(drawn[0][1] + drawn[0][2], drawn[1][1] + drawn[1][2]):
        assert np.array_equal(x, y)
    assert len(drawn[1][1]) == 4 and len(drawn[1][2]) == int(inl.sum())


def test_plot_helpers_without_matplotlib_warn_and_draw_nothing(
        tmp_path, monkeypatch, capsys):
    from ncnet_tpu_torch.cli import point_transfer_demo as tdemo
    from ncnet_tpu_torch.localization import visualize as tvis
    from ncnet_tpu_torch.utils import plot as tplot

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    img = np.zeros((8, 8, 3), np.float32)
    assert tplot.plot_image(img) is None
    tplot.save_plot(str(tmp_path / "x.png"))
    assert tvis.show_matches_horizontal(
        np.zeros((8, 8, 3)), np.zeros((8, 8, 3)), np.zeros((1, 2)),
        np.zeros((1, 2))) is None
    out = str(tmp_path / "demo.png")
    assert tdemo.main(["--synthetic", "--backbone", "tiny", "--image_size",
                       "96", "--device", "cpu", "--out", out]) == 0
    assert not os.path.exists(str(tmp_path / "x.png"))
    assert not os.path.exists(out)
    assert os.path.exists(str(tmp_path / "demo.json"))
    text = capsys.readouterr()
    said = text.out + text.err
    assert "matplotlib is not installed" in said and out in said


# ---------------------------------------------------------------------------
# no GPU: the model-driving tools refuse
# ---------------------------------------------------------------------------


def test_model_tools_refuse_without_a_gpu(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sp, vp = port_tool("stream_probe"), port_tool("serve_probe")
    qd = port_tool("quality_drift")
    from ncnet_tpu_torch.cli import point_transfer_demo as tdemo

    calls = [
        lambda: sp.probe(tiny=True, streams=1, frames=3),
        lambda: sp.main(["--tiny", "--frames", "3"]),
        lambda: vp.probe([32], 4, True, False, 1.0),
        lambda: vp.probe_rollout(48, 4, True),
        lambda: vp.main(["--tiny", "--sides", "32", "--pairs", "4"]),
        lambda: qd.synthetic_reference_run(str(tmp_path / "q")),
        lambda: qd.main(["--seed-ref", "--synthetic", "--ref",
                         str(tmp_path / "ref.jsonl")]),
        lambda: tdemo.main(["--synthetic", "--backbone", "tiny",
                            "--image_size", "96",
                            "--out", str(tmp_path / "d.png")]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert not os.path.exists(str(tmp_path / "ref.jsonl"))
