"""The port's model and serving slice against the JAX package on the CPU.

Both frameworks get the same weights: the JAX params pytree is made from a
seed, turned to numpy here, and carried into the port by
``models/convert.py::params_from_numpy``.  Images are seeded numpy arrays.

Tolerances:
  * trunk and fp32 forward: rtol/atol 2e-4, as tests/test_torch_parity.py
    holds its torch twin of the forward (float32 on both sides; summation
    order differs through ~100 convolutions);
  * bf16 forward: normalized atol 3e-2, the JAX bf16 kernel suite's own
    tolerance (both sides round the volume and the NC activations to bf16,
    at different points);
  * engine tables: coordinates exact, scores and the quality row rtol 1e-4,
    under the identity-peaked NC kernel so every match is unambiguous.

Also here: the port imports no JAX (an AST scan: a ``sys.modules`` check
cannot tell, the test process imports JAX), entry points refuse to run
without a GPU unless ``device="cpu"`` is passed, and unported options raise.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ncnet_tpu import config as jcfg
from ncnet_tpu.models import backbone as jbb
from ncnet_tpu.models import ncnet as jnet
from ncnet_tpu.serving.engine import BatchMatchEngine as JaxEngine
from ncnet_tpu_torch import config as tcfg
from ncnet_tpu_torch.models import backbone as tbb
from ncnet_tpu_torch.models import ncnet as tnet
from ncnet_tpu_torch.models.convert import params_from_numpy
from ncnet_tpu_torch.ops import nc_fused_lane
from ncnet_tpu_torch.serving.engine import BatchMatchEngine

REPO = pathlib.Path(__file__).resolve().parent.parent


def configs(**kw):
    return jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)


def shared_params(jc, seed=0, identity_nc=False):
    """JAX params from ``seed`` (``identity_nc``: one 3⁴ NC layer with a
    unit centre tap) and the same weights as port params."""
    jp = jnet.init_ncnet(jc, jax.random.key(seed))
    if identity_nc:
        w = np.zeros((3, 3, 3, 3, 1, 1), np.float32)
        w[1, 1, 1, 1, 0, 0] = 1.0
        jp["nc"] = [{"w": jnp.asarray(w), "b": jnp.zeros((1,), jnp.float32)}]
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def images(seed, shape):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def assert_normalized_close(got, want, atol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1e-6, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


# ---------------------------------------------------------------------------
# trunk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,hw", [("resnet101", (64, 64)), ("tiny", (64, 48))])
def test_trunk_matches_jax(name, hw):
    jp = jbb.backbone_init(name, jax.random.key(1))
    tp = params_from_numpy({"nc": [], "backbone": jax.tree.map(np.asarray, jp)})
    x = images(2, (2,) + hw + (3,))
    want = np.asarray(jbb.backbone_apply(name, jp, jnp.asarray(x)))
    with torch.no_grad():
        got = tbb.backbone_apply(name, tp["backbone"], torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4 * np.abs(want).max())


def test_params_from_numpy_layouts():
    jc, _ = configs(backbone="tiny", ncons_kernel_sizes=(3, 3), ncons_channels=(4, 1))
    jp, tp = shared_params(jc)
    w = np.asarray(jp["backbone"]["conv2"]["w"])                  # HWIO
    np.testing.assert_array_equal(tp["backbone"]["conv2"]["w"].numpy(),
                                  np.transpose(w, (3, 2, 0, 1)))  # OIHW
    np.testing.assert_array_equal(tp["nc"][0]["w"].numpy(), np.asarray(jp["nc"][0]["w"]))
    bf = params_from_numpy({"nc": [{"w": np.asarray(jp["nc"][1]["w"].astype(jnp.bfloat16)),
                                    "b": np.zeros(1, np.float32)}]})
    assert bf["nc"][0]["w"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

FORWARD_CASES = [
    # square volume (the symmetric stack batch-folds [x, xᵀ])
    dict(backbone="tiny", hw_a=(96, 96), hw_b=(96, 96),
         kernels=(3, 3), channels=(4, 1)),
    # rectangular volume (two passes), k=5
    dict(backbone="tiny", hw_a=(96, 80), hw_b=(64, 96),
         kernels=(5, 5), channels=(4, 1)),
    # the slice's trunk
    dict(backbone="resnet101", hw_a=(64, 64), hw_b=(64, 64),
         kernels=(3, 3), channels=(4, 1)),
]


def run_both(case, **cfg_kw):
    jc, tc = configs(backbone=case["backbone"], ncons_kernel_sizes=case["kernels"],
                     ncons_channels=case["channels"], **cfg_kw)
    jp, tp = shared_params(jc, seed=3)
    xa = images(4, (2,) + case["hw_a"] + (3,))
    xb = images(5, (2,) + case["hw_b"] + (3,))
    want = jnet.ncnet_forward(jc, jp, jnp.asarray(xa), jnp.asarray(xb)).corr
    with torch.no_grad():
        got = tnet.ncnet_forward(tc, tp, torch.from_numpy(xa), torch.from_numpy(xb)).corr
    return got, np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("case", FORWARD_CASES)
def test_fp32_forward_matches_jax(case):
    got, want = run_both(case)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("backbone_bf16", [False, True])
@pytest.mark.parametrize("case", FORWARD_CASES[:2])
def test_bf16_forward_matches_jax(case, backbone_bf16):
    before = nc_fused_lane.launches
    got, want = run_both(case, half_precision=True, backbone_bf16=backbone_bf16)
    assert got.dtype == torch.bfloat16
    assert nc_fused_lane.launches == before  # CPU tensors: the plain twin
    assert_normalized_close(got.float().numpy(), want, atol=3e-2)


def test_forward_from_features_matches_forward():
    case = FORWARD_CASES[0]
    jc, tc = configs(backbone="tiny", ncons_kernel_sizes=case["kernels"],
                     ncons_channels=case["channels"], half_precision=True)
    _, tp = shared_params(jc, seed=3)
    xa = torch.from_numpy(images(4, (2, 96, 96, 3)))
    xb = torch.from_numpy(images(5, (2, 96, 96, 3)))
    with torch.no_grad():
        full = tnet.ncnet_forward(tc, tp, xa, xb).corr
        fa = tnet.extract_features(tc, tp, xa)
        fb = tnet.extract_features(tc, tp, xb)
        assert fa.dtype == torch.float32  # the bf16 cast comes later
        one = tnet.ncnet_forward_from_features(tc, tp, fa, xb).corr
        two = tnet.ncnet_forward_from_feature_pair(tc, tp, fa, fb).corr
    torch.testing.assert_close(one, full, rtol=0, atol=0)
    torch.testing.assert_close(two, full, rtol=0, atol=0)


def test_neigh_consensus_symmetric_forms_agree():
    """Batch-folded [x, xᵀ] (square) equals the two-pass form NC(x) +
    NC(xᵀ)ᵀ, and both equal the JAX stack-level symmetric filter."""
    rng = np.random.default_rng(6)
    corr = rng.uniform(0, 1, (2, 5, 5, 5, 5)).astype(np.float32)
    nc = [{"w": rng.normal(0, 0.1, (3, 3, 3, 3, 1, 4)).astype(np.float32),
           "b": rng.normal(0, 0.1, (4,)).astype(np.float32)},
          {"w": rng.normal(0, 0.1, (3, 3, 3, 3, 4, 1)).astype(np.float32),
           "b": rng.normal(0, 0.1, (1,)).astype(np.float32)}]
    tp = params_from_numpy({"nc": nc})["nc"]
    got = tnet.neigh_consensus(tp, torch.from_numpy(corr))
    x = torch.from_numpy(corr)
    one = tnet.neigh_consensus(tp, x, symmetric=False)
    two = tnet.neigh_consensus(tp, x.permute(0, 3, 4, 1, 2).contiguous(), symmetric=False)
    torch.testing.assert_close(got, one + two.permute(0, 3, 4, 1, 2), rtol=1e-5, atol=1e-6)
    want = jnet.neigh_consensus([{k: jnp.asarray(v) for k, v in layer.items()} for layer in nc],
                                jnp.asarray(corr))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def serving_pairs():
    """Two uint8 pairs: an image against itself, and against its copy
    shifted by two feature cells (32 pixels, circular)."""
    rng = np.random.default_rng(8)
    src = rng.integers(0, 256, (2, 96, 96, 3), dtype=np.uint8)
    tgt = np.stack([src[0], np.roll(src[1], (32, 32), axis=(0, 1))])
    return src, tgt


def test_engine_table_matches_jax():
    jc, tc = configs(backbone="tiny", ncons_kernel_sizes=(3,), ncons_channels=(1,))
    jp, tp = shared_params(jc, seed=9, identity_nc=True)
    src, tgt = serving_pairs()
    jax_engine = JaxEngine(jc, jp)
    want = np.asarray(jax_engine.fetch(jax_engine.dispatch(src, tgt)))
    engine = BatchMatchEngine(tc, tp, device="cpu")
    got = engine.fetch(engine.dispatch(src, tgt))
    assert got.shape == want.shape == (2, 6, 36) and got.dtype == np.float32
    np.testing.assert_array_equal(got[:, :4], want[:, :4])       # coordinates
    np.testing.assert_allclose(got[:, 4:], want[:, 4:], rtol=1e-4, atol=1e-7)
    matches, quality = engine.split(got)
    assert matches.shape == (2, 5, 36) and len(quality) == 2
    # self-matching is the identity: every B cell's match is its own cell
    np.testing.assert_array_equal(matches[0, 0], matches[0, 2])
    np.testing.assert_array_equal(matches[0, 1], matches[0, 3])
    assert quality[0]["mnn_agreement"] == 1.0


def test_point_matcher_matches_jax():
    jc, tc = configs(backbone="tiny", ncons_kernel_sizes=(3,), ncons_channels=(1,))
    jp, tp = shared_params(jc, seed=9, identity_nc=True)
    src, tgt = serving_pairs()
    want, want_q = jnet.make_point_matcher(jc, jp).match_with_quality(src[1:], tgt[1:])
    matcher = tnet.make_point_matcher(tc, tp, device="cpu")
    got, got_q = matcher.match_with_quality(src[1:], tgt[1:])
    for g, w in zip(got[:4], want[:4]):
        assert g.shape == (1, 36)
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got.score, want.score, rtol=1e-4)
    np.testing.assert_allclose(list(got_q.values()), list(want_q.values()), rtol=1e-4, atol=1e-7)
    assert matcher.last_quality == got_q


def test_ncnet_wrapper_runs_on_cpu_when_asked():
    _, tc = configs(backbone="tiny", ncons_kernel_sizes=(3,), ncons_channels=(1,))
    net = tnet.NCNet(tc, seed=0, device="cpu")
    x = torch.from_numpy(images(10, (1, 64, 64, 3)))
    out = net(x, x)
    assert out.corr.shape == (1, 4, 4, 4, 4) and out.corr.device.type == "cpu"


@pytest.mark.parametrize("entry", ["engine", "ncnet", "matcher"])
def test_entry_points_refuse_to_run_without_a_gpu(entry, monkeypatch):
    """No GPU and no explicit CPU request: a RuntimeError naming CUDA, never
    a quiet CPU run (the availability is forced off so the test means the
    same on a machine with a card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tc = configs(backbone="tiny", ncons_kernel_sizes=(3,), ncons_channels=(1,))
    params = tnet.init_ncnet(tc, seed=0)
    make = {"engine": lambda: BatchMatchEngine(tc, params),
            "ncnet": lambda: tnet.NCNet(tc, params),
            "matcher": lambda: tnet.make_point_matcher(tc, params)}[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        make()


@pytest.mark.parametrize("option", [
    dict(backbone="vgg"), dict(backbone="densenet201"),
    # weights files load for the ResNet-101 trunk only
    dict(checkpoint="model.pth.tar", backbone="tiny"),
    dict(backbone_weights="resnet101.pth", backbone="tiny"),
])
def test_unported_options_raise(option):
    """The ``tiny`` trunk has no torchvision or reference weights file, and
    both importers refuse it.  ``vgg`` and ``densenet201``, refused until
    the trunk slice, now build an engine (their random init warns, as in
    the JAX package; their weights are held to JAX's in
    tests/test_torch_port_trunks.py)."""
    _, tc = configs(**option)
    name = next(iter(option))
    if name == "backbone":
        tc = tc.replace(ncons_kernel_sizes=(3,), ncons_channels=(1,))
        with pytest.warns(UserWarning, match="RANDOM weights"):
            params = tnet.init_ncnet(tc)
        engine = BatchMatchEngine(tc, params, device="cpu")
        x = torch.from_numpy(images(0, (1, 64, 64, 3)))
        with torch.no_grad():
            feats = tnet.extract_features(tc, params, x)
        assert feats.shape == (1, 4, 4, {"vgg": 512, "densenet201": 256}[option["backbone"]])
        assert engine is not None
        return
    with pytest.raises(NotImplementedError, match=name):
        BatchMatchEngine(tc, {"nc": [], "backbone": {}}, device="cpu")
    with pytest.raises(NotImplementedError, match=name):
        tnet.init_ncnet(tc)


def test_relocalization_builds_an_engine_and_a_matcher_on_cpu():
    """``relocalization_k_size=2``, unported until the main path's last
    slice, now builds the engine and the point matcher: 96² pairs give a
    6² grid pooled to 3², one match a pooled B cell."""
    _, tc = configs(backbone="tiny", ncons_kernel_sizes=(3,), ncons_channels=(1,),
                    relocalization_k_size=2)
    params = tnet.init_ncnet(tc, seed=0)
    src, tgt = serving_pairs()
    engine = BatchMatchEngine(tc, params, device="cpu")
    table = engine.fetch(engine.dispatch(src, tgt))
    assert table.shape == (2, 6, 9) and np.isfinite(table).all()
    m = tnet.make_point_matcher(tc, params, device="cpu")(src[:1], tgt[:1])
    assert all(v.shape == (1, 9) for v in m)


@pytest.mark.parametrize("tier", ["fft", "cp"])
def test_nc_tier_runs(tier):
    """``ModelConfig.nc_tier`` forces the arithmetic tier through the whole
    forward, as the JAX package does, on params that carry CP factors
    (``params_from_numpy`` keeps them); fp32 forward tolerance."""
    from ncnet_tpu.ops.cp_als import decompose_stack as jdecompose
    from ncnet_tpu_torch.ops.nc_fused_lane import last_selected_tier

    case = FORWARD_CASES[0]
    jc, tc = configs(backbone="tiny", ncons_kernel_sizes=case["kernels"],
                     ncons_channels=case["channels"], nc_tier=tier)
    jp = jnet.init_ncnet(jc, jax.random.key(3))
    jp["nc"] = jdecompose(jax.tree.map(np.asarray, jp["nc"]), 2, iters=5)[0]
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    assert all("cp" in layer for layer in tp["nc"])
    xa, xb = images(4, (2, 96, 96, 3)), images(5, (2, 96, 96, 3))
    want = jnet.ncnet_forward(jc, jp, jnp.asarray(xa), jnp.asarray(xb)).corr
    with torch.no_grad():
        got = tnet.ncnet_forward(tc, tp, torch.from_numpy(xa),
                                 torch.from_numpy(xb)).corr
    assert last_selected_tier("forward") == tier
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("option", [dict(sparse_topk=4), dict(track_radius=2)])
def test_sparse_options_build_an_engine_and_run_on_cpu(option):
    """The coarse-to-fine and tracking options, unported until their slice,
    now build an engine and serve a CPU request (and a tracked frame)."""
    _, tc = configs(backbone="tiny", ncons_kernel_sizes=(3,), ncons_channels=(1,),
                    **option)
    engine = BatchMatchEngine(tc, tnet.init_ncnet(tc, seed=0), device="cpu")
    src, tgt = serving_pairs()
    table = engine.fetch(engine.dispatch(src, tgt))
    assert table.shape == (2, 6, 36) and np.isfinite(table).all()
    prior = np.zeros((2, 9), np.int32)
    tracked = engine.fetch(engine.dispatch_tracked(src, tgt, prior, prior))
    assert tracked.shape == (2, 6, 36) and np.isfinite(tracked).all()
    assert engine.coarse_passes == 1 and engine.tracked_dispatches == 1


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------


def _imported_modules(path):
    """Every module name ``path`` imports: import statements, and string
    arguments of ``importlib.import_module`` / ``__import__`` calls."""
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            names.append(node.args[0].value)
    return names


def _edits_sys_path(path):
    """Lines of ``path`` that change ``sys.path`` (how the JAX tools reach
    ``tools/_timing.py``)."""
    hits = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        target = None
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            target = node.func.value
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            target = (node.targets[0] if isinstance(node, ast.Assign)
                      else node.target)
        if (isinstance(target, ast.Attribute) and target.attr == "path"
                and isinstance(target.value, ast.Name)
                and target.value.id == "sys"):
            hits.append(node.lineno)
    return hits


def test_port_imports_no_jax():
    files = sorted((REPO / "ncnet_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    names = {p.relative_to(REPO).as_posix() for p in files}
    assert {f"ncnet_tpu_torch/ops/{m}.py" for m in (
        "conv4d", "conv4d_pallas", "conv4d_fft", "conv4d_cp", "cp_als",
        "nc_fused_lane")} <= names
    assert {f"ncnet_tpu_torch/tools/{m}.py" for m in (
        "_timing", "pallas_l2_probe", "mosaic_probes", "convert_images")} <= names
    # the eval loop's modules (the card has no JAX, pandas or PIL)
    assert {f"ncnet_tpu_torch/{m}.py" for m in (
        "data/datasets", "data/loader", "data/synthetic",
        "evaluation/pipeline", "evaluation/resilience", "evaluation/pf_pascal",
        "models/checkpoint", "observability/device", "observability/memory",
        "utils/faults", "utils/profiling", "cli/common",
        "cli/eval_pf_pascal", "evaluation/inloc", "cli/eval_inloc",
        "cli/compute_localization")} <= names
    # the network plane (host code: http.server, urllib, numpy)
    assert {f"ncnet_tpu_torch/{m}.py" for m in (
        "observability/export", "observability/quality", "serving/wire",
        "serving/introspect", "serving/router", "serving/rollout",
        "serving/replica", "serving/engine", "serving/service",
        "tools/serve_backend")} <= names
    # the multi-device layer (torch.distributed only)
    assert {f"ncnet_tpu_torch/parallel/{m}.py" for m in (
        "__init__", "mesh", "distributed", "spatial")} <= names
    # the localization stage (numpy and torch only)
    assert {f"ncnet_tpu_torch/localization/{m}.py" for m in (
        "__init__", "geometry", "scan", "render", "p3p", "pnp", "dsift",
        "verification", "curves", "driver")} <= names
    # the operator tools, the demo and the plot helpers (A14)
    assert {f"ncnet_tpu_torch/{m}.py" for m in (
        "tools/run_report", "tools/trace_export", "tools/stall_watchdog",
        "tools/perf_regress", "tools/quality_drift", "tools/serve_top",
        "tools/rollout", "tools/stream_probe", "tools/serve_probe",
        "utils/plot", "localization/visualize",
        "cli/point_transfer_demo")} <= names
    # the root tools without a counterpart before A15: the tier and stage
    # probes, the goldens, the parity kit and its reference twin, the print
    # checker
    assert {f"ncnet_tpu_torch/tools/{m}.py" for m in (
        "nc_resident_probe", "nc_fused_lane_probe", "nc_vjp_resident_probe",
        "sparse_corr_probe", "eval_faults_probe", "train_probe",
        "inloc_stage_probe", "filter_stage_probe", "filter_combo_probe",
        "xla_layer_probe", "xla_conv_probe", "inloc_filter_probe",
        "sharded_variant_probe", "vjp_probe", "vjp_sweep_probe",
        "nc_grad_split_probe", "train_attr_probe", "cp_fft_probe",
        "check_no_bare_print", "make_goldens", "parity_kit",
        "reference_twin", "_probe")} <= names
    # the bench (A13), the roofline arithmetic it shares with chip_smoke,
    # and its executed count
    assert {"ncnet_tpu_torch/tools/bench.py",
            "ncnet_tpu_torch/observability/roofline.py",
            "ncnet_tpu_torch/tools/_work.py"} <= names
    bad = []
    for path in files:
        # matplotlib (not on the card) only inside the functions that draw
        for node in ast.parse(path.read_text(), str(path)).body:
            if isinstance(node, (ast.Import, ast.ImportFrom)) and any(
                    (getattr(node, "module", None) or a.name).split(".")[0]
                    == "matplotlib" for a in node.names):
                bad.append(f"{path.relative_to(REPO)}: matplotlib at import")
        for name in _imported_modules(path):
            root = name.split(".")[0]
            if (root in ("jax", "jaxlib", "ncnet_tpu", "tools", "_timing",
                         "pandas", "tests", "conftest")
                    or root.startswith(("jax_", "test_", "torch_port_"))):
                bad.append(f"{path.relative_to(REPO)}: {name}")
            # PIL only in the JPEG converter, which imports it when it runs
            if root == "PIL" and path.name != "convert_images.py":
                bad.append(f"{path.relative_to(REPO)}: {name}")
        if path.name != "chip_smoke.py":  # it puts its checkout on the path
            bad += [f"{path.relative_to(REPO)}:{line}: edits sys.path"
                    for line in _edits_sys_path(path)]
    assert not bad, bad
    # the checks see what they look for
    jax_tool = REPO / "tools" / "pallas_l2_probe.py"
    assert "_timing" in _imported_modules(jax_tool)
    assert _edits_sys_path(jax_tool)
