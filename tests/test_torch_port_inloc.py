"""The port's InLoc slice against the JAX package on the CPU: the tap-swap
form of the rectangular symmetric NC pass (``models/ncnet.py``), the InLoc
helpers, the pair matcher, ``run_inloc_eval`` and its fault tolerance, the
CLI and the fixture writer (``evaluation/inloc.py``, ``cli/eval_inloc.py``,
``data/synthetic.py::write_inloc_like``).

Both packages read the same pixels: the test trees hold PNG bytes under
each ``.jpg`` name (PIL opens them by content, losslessly) and the raw
``.jpg.npy`` beside them.  Weights go from the JAX package to the port
through ``params_from_numpy``.  Queries are portrait and cutouts
landscape, so every volume is rectangular and the tap-swap runs; each
cutout is its query's texture moved by half a feature cell (whole-cell
shifts tie exact copies inside a relocalization box, ROADMAP §C).

Tolerances: the tap-swap helpers bitwise; ``neigh_consensus`` in fp32
normalized 1e-4 (the tier tests' fp32 bound), in bf16 3e-2 (the JAX bf16
suite's: both sides round the volume between layers at the same points
but sum in different orders); the fp32 ``.mat`` tables with the coordinate
columns the same matches row for row (each row's fine cells equal, its
recentred coordinates within one float32 ulp: XLA fuses the recentring
into an FMA) and the scores within rtol 1e-5, atol 1e-6; the bf16 tables
sharing at least 0.9 of the JAX table's matches (0.957 to 0.986 measured
per cutout: a one-ulp flip of a near-flat random-init NC output moves a
match) with the shared matches' scores within 2e-2 (0.015 measured); the
host helpers exactly equal, the device resize within 1e-5.
"""

import importlib
import io
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from scipy.io import loadmat, savemat

from ncnet_tpu import config as jcfg
from ncnet_tpu.cli import eval_inloc as jcli
from ncnet_tpu.data import synthetic as jsynth
from ncnet_tpu.models import ncnet as jnet
from ncnet_tpu_torch import config as tcfg
from ncnet_tpu_torch.cli import eval_inloc as tcli
from ncnet_tpu_torch.data import synthetic as tsynth
from ncnet_tpu_torch.evaluation import inloc as tinloc
from ncnet_tpu_torch.evaluation import resilience as tres
from ncnet_tpu_torch.models import ncnet as tnet
from ncnet_tpu_torch.models.convert import params_from_numpy
from ncnet_tpu_torch.ops import nc_fused_lane as tlane
from ncnet_tpu_torch.utils import faults

jinloc = importlib.import_module("ncnet_tpu.evaluation.inloc")
jlane = importlib.import_module("ncnet_tpu.ops.nc_fused_lane")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IVD = dict(backbone="tiny", ncons_kernel_sizes=(3, 3), ncons_channels=(16, 1),
           relocalization_k_size=2)
SIDE = 256                 # image_size: the longest side
QUERY_HW = (256, 192)      # portrait
PANO_HW = (192, 256)       # landscape
# each cutout's origin in the query's texture: half a 16-px cell off the
# query's in both axes
PANO_SHIFTS = ((8, 24), (40, 8))


@pytest.fixture(autouse=True)
def _clean_state():
    faults.clear()
    for lane in (tlane, jlane):
        lane._last_selected.clear()
    yield
    faults.clear()


def normed_close(got, want, atol):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    scale = max(1e-6, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


def make_stack(seed, kernels, channels, scale=0.3):
    r = np.random.default_rng(seed)
    layers, c_in = [], 1
    for k, c_out in zip(kernels, channels):
        layers.append({
            "w": (r.normal(size=(k,) * 4 + (c_in, c_out)) * scale
                  / np.sqrt(c_in)).astype(np.float32),
            "b": (r.normal(size=(c_out,)) * 0.1).astype(np.float32)})
        c_in = c_out
    return layers


def as_jax(layers, dtype=jnp.float32):
    return [jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), layer)
            for layer in layers]


def as_torch(layers, dtype=torch.float32):
    return [tnet.tree_map(lambda t: t.to(dtype), layer)
            for layer in params_from_numpy({"nc": layers})["nc"]]


# ---------------------------------------------------------------------------
# the tap-swap (ROADMAP A7)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernels,channels", [
    ((3, 3), (16, 1)), ((5, 5), (4, 2)), ((3, 3), (2, 1))])
def test_tap_swap_helpers_bitwise_equal_jax(kernels, channels):
    layers = make_stack(1, kernels, channels)
    jl, tl = as_jax(layers), as_torch(layers)
    pairs = [(tnet.swap_ab_taps(tl[i]), jnet.swap_ab_taps(jl[i]))
             for i in range(2)]
    pairs += list(zip(tnet.tap_swap_fused_layers(tl),
                      jnet.tap_swap_fused_layers(jl)))
    pairs += list(zip(tnet.tap_swap_chain(tl), jnet.tap_swap_chain(jl)))
    for got, want in pairs:
        for key in ("w", "b"):
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))
    w_bd = tnet.tap_swap_chain(tl)[1]["w"]
    assert tuple(w_bd.shape) == (kernels[1],) * 4 + (2 * channels[0],
                                                   2 * channels[1])


@pytest.mark.parametrize("shapes,fusable", [
    ([(3, 3, 3, 3, 1, 16), (3, 3, 3, 3, 16, 1)], True),
    ([(5, 5, 5, 5, 1, 4), (5, 5, 5, 5, 4, 2)], True),
    ([(3, 3, 3, 3, 1, 4), (3, 3, 3, 3, 4, 4), (3, 3, 3, 3, 4, 1)], False),
    ([(3, 3, 3, 3, 2, 16), (3, 3, 3, 3, 16, 1)], False),
    ([(3, 3, 5, 5, 1, 16), (3, 3, 5, 5, 16, 1)], False),
    ([(3, 3, 3, 3, 1, 1)], False),
])
def test_tap_swap_fusable_matches_jax(shapes, fusable):
    tl = [{"w": torch.zeros(s), "b": torch.zeros(s[-1])} for s in shapes]
    jl = [{"w": jnp.zeros(s), "b": jnp.zeros(s[-1])} for s in shapes]
    assert tnet.tap_swap_fusable(tl) == jnet.tap_swap_fusable(jl) == fusable


def spy_forms(monkeypatch):
    """Record which form of the symmetric pass ran: ``chain`` (the fused
    chain on the kernel tier), ``unfused`` (the fused first layer and the
    two second layers) or ``two_pass`` (the stack on the transposed
    volume)."""
    calls = []
    for name, tag in (("tap_swap_chain", "chain"),
                      ("tap_swap_fused_layers", "unfused"),
                      ("_swap_ab", "two_pass")):
        fn = getattr(tnet, name)
        monkeypatch.setattr(tnet, name, lambda *a, _fn=fn, _t=tag: (
            calls.append(_t), _fn(*a))[1])
    return calls


@pytest.mark.parametrize("shape", [(1, 6, 5, 5, 6), (2, 5, 4, 6, 7)],
                         ids=["transposed_planes", "planes_differ"])
@pytest.mark.parametrize("dtype,kernels,channels,require_vjp,form,tol", [
    ("float32", (3, 3), (16, 1), False, "unfused", 1e-4),
    ("bfloat16", (3, 3), (16, 1), False, "chain", 3e-2),
    ("bfloat16", (3, 3), (16, 1), True, "two_pass", 3e-2),
    ("float32", (3, 3, 3), (4, 4, 1), False, "two_pass", 1e-4),
    ("bfloat16", (3, 3, 3), (16, 16, 1), False, "two_pass", 3e-2),
], ids=["fp32_unfused", "bf16_chain", "bf16_training_gate", "fp32_three_layer",
        "bf16_three_layer"])
def test_neigh_consensus_rectangular_matches_jax(monkeypatch, shape, dtype,
                                                 kernels, channels,
                                                 require_vjp, form, tol):
    """A rectangular volume through ``neigh_consensus`` against the JAX
    function (whose CPU route is the unfused tap-swap in both precisions,
    its Pallas tiers being off there): the port's bf16 serving route is
    the chain on the kernel tier (its twin here), its training gate the
    two passes on the kernel tier with the B3 backward (the chain's layers
    have no backward), and a 3-layer stack the two passes."""
    calls = spy_forms(monkeypatch)
    layers = make_stack(3, kernels, channels)
    corr = np.random.default_rng(4).uniform(0, 1, shape).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jnet.neigh_consensus(as_jax(layers, jd), jnp.asarray(corr).astype(jd),
                                require_vjp=require_vjp)
    tl = as_torch(layers, td)
    if require_vjp:
        tl = [{k: v.clone().requires_grad_() for k, v in p.items()} for p in tl]
    got = tnet.neigh_consensus(tl, torch.from_numpy(corr).to(td),
                               require_vjp=require_vjp)
    assert got.dtype == td and tuple(got.shape) == shape
    normed_close(got, want, tol)
    assert form in calls
    assert set(calls) - {form} <= ({"unfused"} if form == "chain" else set())
    if form == "chain":
        assert tlane.last_selected_tier() == "resident"
    if require_vjp:
        assert tlane.last_selected_tier() == "resident"
        got.float().sum().backward()
        assert all(p["w"].grad is not None for p in tl)


def test_chain_runs_one_stack_call_of_the_chain(monkeypatch):
    """The bf16 chain is one kernel-tier call on the tap-swap chain's
    weights (1 → 32 → 2 channels), and its two output channels summed
    equal the two-pass form's value through the same twins."""
    seen = []
    real = tlane.nc_stack_resident
    monkeypatch.setattr(tlane, "nc_stack_resident", lambda p, x: (
        seen.append(tuple(int(l["w"].shape[5]) for l in p)), real(p, x))[1])
    layers = as_torch(make_stack(5, (3, 3), (16, 1)), torch.bfloat16)
    corr = torch.from_numpy(np.random.default_rng(6).uniform(
        0, 1, (1, 7, 5, 5, 7)).astype(np.float32)).to(torch.bfloat16)
    got = tnet.neigh_consensus(layers, corr)
    assert seen == [(32, 2)]
    x = corr[..., None]
    two = (tlane.nc_stack_reference(layers, x).float()
           + tlane.nc_stack_reference(layers, x.permute(0, 3, 4, 1, 2, 5)
                                      .contiguous()).permute(0, 3, 4, 1, 2, 5)
           .float())[..., 0]
    scale = float(two.abs().max())
    assert float((got.float() - two).abs().max()) / scale <= 1e-2


# ---------------------------------------------------------------------------
# the InLoc helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w,image_size,k", [
    (3024, 4032, 3200, 2), (4032, 3024, 3200, 2), (480, 640, 3200, 1),
    (96, 128, 128, 2), (1000, 1500, 1600, 2), (1200, 1600, 3200, 2)])
def test_quantized_resize_shape_matches_jax(h, w, image_size, k):
    got = tinloc.quantized_resize_shape(h, w, image_size, k)
    assert got == jinloc.quantized_resize_shape(h, w, image_size, k)


def test_capacity_and_recenter_match_jax():
    for args in ((3200, 2, True), (3200, 2, False), (3200, 1, True), (256, 2, True)):
        assert tinloc.match_capacity(*args) == jinloc.match_capacity(*args)
    x = np.linspace(0, 1, 11, dtype=np.float32)
    np.testing.assert_array_equal(
        tinloc.recenter(torch.from_numpy(x), 8).numpy(),
        np.asarray(jax.jit(jinloc.recenter, static_argnums=1)(jnp.asarray(x), 8)))


def test_sort_and_dedup_matches_jax():
    r = np.random.default_rng(8)
    cols = [r.integers(0, 4, 60).astype(np.float32) / 4 for _ in range(4)]
    score = r.uniform(0, 1, 60).astype(np.float32)
    got = tinloc.sort_and_dedup(*cols, score)
    want = jinloc.sort_and_dedup(*cols, score)
    assert len(got[0]) < 60
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [
    {},
    dict(inloc_shortlist="x/shortlist.mat", image_size=1600, k_size=1,
         softmax=False, matching_both_directions=False,
         flip_matching_direction=True, checkpoint="m/best.pth.tar"),
    dict(matching_both_directions=False, sparse_topk=4, k_size=1),
    dict(sparse_topk=4),
    dict(checkpoint="runs/fit_root/", retrieval_index="idx.json",
         retrieval_topk=5),
])
def test_output_folder_name_matches_jax(kw):
    assert tinloc.output_folder_name(tcfg.EvalInLocConfig(**kw)) == \
        jinloc.output_folder_name(jcfg.EvalInLocConfig(**kw))


def test_config_fields_are_the_jax_configs():
    import dataclasses

    tf = [(f.name, f.default) for f in dataclasses.fields(tcfg.EvalInLocConfig)]
    jf = [(f.name, f.default) for f in dataclasses.fields(jcfg.EvalInLocConfig)]
    assert tf == jf


@pytest.mark.parametrize("index,count", [(0, 1), (1, 2), (3, 4)])
def test_manifest_name_matches_jax(index, count):
    assert tinloc.manifest_name(index, count) == jinloc.manifest_name(index, count)


@pytest.mark.parametrize("kw", [
    {}, dict(host_index=1, host_count=3), dict(host_count=2),
    dict(host_index=1), dict(host_index=3, host_count=2),
    dict(host_index=-1, host_count=1)])
def test_resolve_host_stripe_matches_jax(kw):
    """One process: -1 / 0 resolve to the one stripe in both packages (the
    port from ``torch.distributed``, uninitialised here); incoherent
    explicit stripes raise the same error."""
    def outcome(mod, cfg):
        try:
            return mod.resolve_host_stripe(cfg)
        except ValueError as e:
            return str(e)

    got = outcome(tinloc, tcfg.EvalInLocConfig(**kw))
    assert got == outcome(jinloc, jcfg.EvalInLocConfig(**kw))
    if "host_index" in kw and kw["host_index"] >= 0 and "host_count" not in kw:
        assert got == "host_index given without host_count"


def test_validate_matches_mat_matches_jax(tmp_path):
    cases = {}
    good = {"matches": np.zeros((1, 2, 7, 5)), "query_fn": "q.jpg",
            "pano_fn": np.array([["a.jpg"], ["b.jpg"]], dtype=object)}
    for name, payload in (
            ("good", good),
            ("wrong_shape", {**good, "matches": np.zeros((1, 2, 6, 5))}),
            ("no_query_fn", {k: v for k, v in good.items() if k != "query_fn"}),
            ("empty", {**good, "matches": np.zeros((1, 0, 7, 5))})):
        path = str(tmp_path / f"{name}.mat")
        savemat(path, payload, do_compression=True)
        cases[name] = path
    garbage = tmp_path / "garbage.mat"
    garbage.write_bytes(b"not a mat file")
    cases["garbage"] = str(garbage)
    cases["missing"] = str(tmp_path / "missing.mat")
    for name, path in cases.items():
        for n_panos in (0, 2):
            got = tinloc.validate_matches_mat(path, n_panos, 7)
            assert got == jinloc.validate_matches_mat(path, n_panos, 7), name
    assert tinloc.validate_matches_mat(cases["good"], 2, 7)
    assert not tinloc.validate_matches_mat(cases["garbage"], 2, 7)


def test_write_inloc_like_draws_the_jax_writers_images(tmp_path, monkeypatch):
    """The same tree, names and shortlist as the JAX writer, each image
    the array the JAX writer encoded as JPEG."""
    encoded = {}
    real_save = Image.Image.save

    def save(self, fp, *a, **kw):
        encoded[os.path.relpath(fp, str(tmp_path / "jax"))] = np.asarray(self)
        return real_save(self, fp, *a, **kw)

    monkeypatch.setattr(Image.Image, "save", save)
    jlist = jsynth.write_inloc_like(str(tmp_path / "jax"), n_queries=2,
                                    n_panos=3, image_hw=(40, 56), seed=5)
    tlist = tsynth.write_inloc_like(str(tmp_path / "port"), n_queries=2,
                                    n_panos=3, image_hw=(40, 56), seed=5)
    assert os.path.relpath(tlist, str(tmp_path / "port")) == \
        os.path.relpath(jlist, str(tmp_path / "jax")) == "shortlist.mat"
    assert len(encoded) == 8
    for rel, arr in encoded.items():
        got = np.load(os.path.join(str(tmp_path / "port"), rel + ".npy"))
        np.testing.assert_array_equal(got, arr, err_msg=rel)
    tq, tp = tinloc.load_shortlist(tlist)
    jq, jp = jinloc.load_shortlist(jlist)
    assert tq == jq == ["query_0.jpg", "query_1.jpg"]
    assert [list(map(tinloc._as_str, p)) for p in tp] == \
        [list(map(jinloc._as_str, p)) for p in jp]
    assert tinloc._as_str(tp[1][2]) == "DUC1/DUC_cutout_001_60_0.jpg"


def test_device_preprocess_matches_jax():
    """uint8 → normalize → quantized align-corners resize, portrait and
    landscape, against the JAX jitted stage (the same device rounding of
    the grid), and the host path (``load_and_preprocess``) beside it."""
    r = np.random.default_rng(9)
    for hw in ((100, 75), (75, 100)):
        img = r.integers(0, 256, (1,) + hw + (3,), dtype=np.uint8)
        got = tinloc.device_preprocess(torch.from_numpy(img), 128, 2)
        want = jax.jit(jinloc.device_preprocess, static_argnums=(1, 2))(
            jnp.asarray(img), 128, 2)
        assert tuple(got.shape) == tuple(want.shape) == \
            (1,) + tinloc.quantized_resize_shape(*hw, 128, 2) + (3,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)


def test_load_and_preprocess_matches_jax(tmp_path):
    img = np.random.default_rng(10).integers(0, 256, (60, 45, 3), dtype=np.uint8)
    path = str(tmp_path / "im.jpg")
    Image.fromarray(img).save(path, format="PNG")
    np.save(path + ".npy", img)
    np.testing.assert_allclose(tinloc.load_and_preprocess(path, 96, 2),
                               jinloc.load_and_preprocess(path, 96, 2),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tinloc.load_raw(path), jinloc.load_raw(path))


# ---------------------------------------------------------------------------
# the matcher and the loop against the JAX package
# ---------------------------------------------------------------------------


def peaked(jp):
    """Centre-peaked NC kernels with biases off zero (crisp matches)."""
    for layer in jp["nc"]:
        w = np.array(layer["w"])
        d = w.shape[0] // 2
        w[d, d, d, d] += 1.0 / w.shape[4]
        layer["w"] = w
        layer["b"] = np.asarray(layer["b"]) + 0.05
    return jp


def shared_params(half_precision, seed=0):
    kw = dict(IVD, half_precision=half_precision)
    jc = jcfg.ModelConfig(**kw)
    jp = peaked(jax.tree.map(np.asarray, jnet.init_ncnet(jc, jax.random.key(seed))))
    return (jc, jax.tree.map(jnp.asarray, jp), tcfg.ModelConfig(**kw),
            params_from_numpy(jp))


def write_image(path, arr):
    """PNG bytes under the ``.jpg`` name and the raw array beside it."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    with open(path, "wb") as f:
        f.write(buf.getvalue())
    np.save(path + ".npy", arr)


def write_rect_tree(root, n_queries=2, n_panos=2):
    """Portrait queries, landscape cutouts cut from each query's texture
    half a cell off, and the shortlist (the ``write_inloc_like`` layout)."""
    rng = np.random.default_rng(11)
    entries = np.zeros((1, n_queries), dtype=np.dtype(
        [("queryname", object), ("topNname", object)]))
    (qh, qw), (ph, pw) = QUERY_HW, PANO_HW
    for q in range(n_queries):
        big = tsynth._textured_image(rng, 320, 320)
        qfn = f"query_{q}.jpg"
        write_image(os.path.join(root, "query", "iphone7", qfn), big[:qh, :qw])
        panos = []
        for p in range(n_panos):
            oy, ox = PANO_SHIFTS[p % len(PANO_SHIFTS)]
            pfn = f"DUC1/DUC_cutout_{q:03d}_{p * 30}_0.jpg"
            write_image(os.path.join(root, "pano", pfn),
                        big[oy:oy + ph, ox:ox + pw])
            panos.append(pfn)
        entries[0, q] = (np.array([qfn]), np.array(panos, dtype=object)[:, None])
    shortlist = os.path.join(root, "shortlist.mat")
    savemat(shortlist, {"ImgList": entries})
    return shortlist


@pytest.fixture(scope="module")
def rect_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("inloc"))
    return root, write_rect_tree(root)


def eval_kw(root, shortlist, **kw):
    return {**dict(inloc_shortlist=shortlist, k_size=2, image_size=SIDE,
                   n_queries=2, n_panos=2, pano_path=os.path.join(root, "pano"),
                   query_path=os.path.join(root, "query", "iphone7")), **kw}


def run_port(root, shortlist, out, half_precision=False, params=None, **kw):
    _, _, tc, tp = shared_params(half_precision)
    cfg = tcfg.EvalInLocConfig(output_root=out, **eval_kw(root, shortlist, **kw))
    return tinloc.run_inloc_eval(cfg, model_config=tc, params=params or tp,
                                 progress=False, device="cpu")


def assert_same_matches(got, want, grid):
    """The same matches row for row: the fine cells of the (xA, yA, xB, yB)
    columns equal exactly, and the recentred coordinates within one float32
    ulp (XLA fuses the recentring into an FMA, ROADMAP §C)."""
    (ha, wa, hb, wb), k = grid
    sizes = np.asarray([wa, ha, wb, hb], dtype=np.float64) * k

    def cells(c):
        return np.rint(c.astype(np.float64) * sizes - 0.5).astype(np.int64)

    got, want = got.astype(np.float32), np.asarray(want, np.float32)
    np.testing.assert_array_equal(cells(got), cells(want))
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_pair_matcher_table_matches_jax(rect_tree):
    """One portrait/landscape pair through both packages' matchers (raw
    uint8 in, the query's trunk once): the ``(5, N)`` table's matches the
    same (:func:`assert_same_matches`), the scores within rtol 1e-5, in
    both directions and one."""
    root, _ = rect_tree
    jc, jp, tc, tp = shared_params(False)
    q = tinloc.load_raw(os.path.join(root, "query", "iphone7", "query_0.jpg"))
    p = tinloc.load_raw(os.path.join(root, "pano", "DUC1", "DUC_cutout_000_30_0.jpg"))
    for both, flip in ((True, False), (False, True)):
        kw = dict(do_softmax=True, both_directions=both, flip_direction=flip,
                  preprocess_image_size=SIDE)
        jm = jinloc.make_pair_matcher(jc, jp, **kw)
        tm = tinloc.make_pair_matcher(tc, tp, device="cpu", **kw)
        want = jm(jm.preprocess(q), p)
        got = tm(tm.preprocess(q), p)
        assert tm.feature_extractions == 1
        assert len(got[0]) == tinloc.match_capacity(SIDE, 2, both)
        assert_same_matches(np.stack(got[:4], -1), np.stack(want[:4], -1),
                            ((8, 6, 6, 8), 2))
        np.testing.assert_allclose(got[4], want[4], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("half_precision", [False, True], ids=["fp32", "bf16"])
def test_run_inloc_eval_matches_jax(rect_tree, tmp_path, monkeypatch,
                                    half_precision):
    """The portrait/landscape tree through both packages' loops: the same
    ``.mat`` files and keys, ``query_fn`` and ``pano_fn`` equal; fp32: the
    coordinate columns the same matches row for row
    (:func:`assert_same_matches`), the scores within rtol 1e-5, atol 1e-6;
    bf16 (the port's chain on the kernel tier, its twin here, against
    JAX's unfused XLA form): each cutout's table holding at least 0.9 of
    the JAX table's matches, their scores within 2e-2.  The tap-swap ran
    in the port (the spy)."""
    root, shortlist = rect_tree
    calls = spy_forms(monkeypatch)
    jc, jp, _, _ = shared_params(half_precision)
    jdir = jinloc.run_inloc_eval(
        jcfg.EvalInLocConfig(output_root=str(tmp_path / "jax"),
                             **eval_kw(root, shortlist)),
        model_config=jc, params=jp, progress=False)
    tdir = run_port(root, shortlist, str(tmp_path / "port"), half_precision)
    assert os.path.basename(tdir) == os.path.basename(jdir)
    form = "chain" if half_precision else "unfused"
    # the chain is built from the fused layers: each chain call makes one
    assert calls.count(form) == 2 * 2 and "two_pass" not in calls
    assert calls.count("unfused") == calls.count(form)
    names = sorted(n for n in os.listdir(tdir) if n.endswith(".mat"))
    assert names == sorted(n for n in os.listdir(jdir) if n.endswith(".mat")) \
        == ["1.mat", "2.mat"]
    shares = []
    for n in names:
        got, want = loadmat(os.path.join(tdir, n)), loadmat(os.path.join(jdir, n))
        assert sorted(k for k in got if not k.startswith("__")) == \
            sorted(k for k in want if not k.startswith("__")) == \
            ["matches", "pano_fn", "query_fn"]
        assert tinloc._as_str(got["query_fn"]) == tinloc._as_str(want["query_fn"])
        np.testing.assert_array_equal(
            [tinloc._as_str(x) for x in got["pano_fn"].ravel()],
            [tinloc._as_str(x) for x in want["pano_fn"].ravel()])
        g, w = got["matches"], want["matches"]
        assert g.shape == w.shape == (1, 2, tinloc.match_capacity(SIDE, 2, True), 5)
        assert (g[..., 4] > 0).sum() > 0
        grid = ((QUERY_HW[0] // 32, QUERY_HW[1] // 32, PANO_HW[0] // 32,
                 PANO_HW[1] // 32), 2)
        if not half_precision:
            assert_same_matches(g[..., :4], w[..., :4], grid)
            np.testing.assert_allclose(g[..., 4], w[..., 4], rtol=1e-5, atol=1e-6)
        else:
            sizes = np.asarray([grid[0][1], grid[0][0], grid[0][3],
                                grid[0][2]], dtype=np.float64) * 2
            for p in range(g.shape[1]):
                # one bf16 flip moves a match and shifts the lexicographic
                # rows after it: compare the tables as sets of matches
                tabs = []
                for t in (g[0, p], w[0, p]):
                    t = t[t[:, 4] > 0]
                    cells = np.rint(t[:, :4].astype(np.float32).astype(np.float64)
                                    * sizes - 0.5).astype(np.int64)
                    tabs.append({tuple(c): float(sc) for c, sc in zip(cells, t[:, 4])})
                common = tabs[0].keys() & tabs[1].keys()
                shares.append(len(common) / len(tabs[1]))
                np.testing.assert_allclose([tabs[0][c] for c in common],
                                           [tabs[1][c] for c in common],
                                           rtol=0, atol=2e-2)
    if half_precision:
        assert min(shares) >= 0.9, shares


# ---------------------------------------------------------------------------
# the loop's behaviour (tests/test_eval_inloc.py's cases, in the port)
# ---------------------------------------------------------------------------


def test_skip_existing_resumes_by_artifact(rect_tree, tmp_path):
    """A rerun leaves the finished artifacts untouched; a foreign artifact
    (no manifest vouching for it, failing validation) is recomputed."""
    root, shortlist = rect_tree
    out = str(tmp_path / "m")
    out_dir = run_port(root, shortlist, out)
    path = os.path.join(out_dir, "1.mat")
    want = loadmat(path)["matches"]
    mtime = os.path.getmtime(path)
    run_port(root, shortlist, out)
    assert os.path.getmtime(path) == mtime
    os.remove(os.path.join(out_dir, "manifest.json"))
    savemat(path, {"matches": np.zeros((1, 1, 3, 5)), "query_fn": "x",
                   "pano_fn": "y"})
    run_port(root, shortlist, out)
    np.testing.assert_array_equal(loadmat(path)["matches"], want)


def test_host_striping_matches_a_single_host(rect_tree, tmp_path):
    root, shortlist = rect_tree
    single = run_port(root, shortlist, str(tmp_path / "single"))
    for host in (0, 1):
        striped = run_port(root, shortlist, str(tmp_path / "striped"),
                           host_index=host, host_count=2)
        assert os.path.exists(os.path.join(striped, f"manifest.host{host}_of_2.json"))

    def mats(d):
        return sorted(n for n in os.listdir(d) if n.endswith(".mat"))

    assert mats(striped) == mats(single) == ["1.mat", "2.mat"]
    for n in mats(single):
        np.testing.assert_array_equal(loadmat(os.path.join(single, n))["matches"],
                                      loadmat(os.path.join(striped, n))["matches"])


@pytest.mark.parametrize("bad", [dict(host_index=1), dict(host_index=3, host_count=2)])
def test_host_striping_validation(rect_tree, tmp_path, bad):
    root, shortlist = rect_tree
    with pytest.raises(ValueError):
        run_port(root, shortlist, str(tmp_path / "m"), **bad)


def test_zero_panos_writes_empty_table(rect_tree, tmp_path):
    root, shortlist = rect_tree
    out_dir = run_port(root, shortlist, str(tmp_path / "m"), n_panos=0)
    for q in (1, 2):
        mat = loadmat(os.path.join(out_dir, f"{q}.mat"))
        assert mat["matches"].size == 0
        assert tinloc.validate_matches_mat(os.path.join(out_dir, f"{q}.mat"), 0, 1)


def test_single_direction_half_capacity(rect_tree, tmp_path):
    root, shortlist = rect_tree
    out_dir = run_port(root, shortlist, str(tmp_path / "m"),
                       matching_both_directions=False,
                       flip_matching_direction=True)
    assert os.path.basename(out_dir).endswith("_AtoB_SOFTMAX")
    mat = loadmat(os.path.join(out_dir, "1.mat"))
    assert mat["matches"].shape == (1, 2, tinloc.match_capacity(SIDE, 2, False), 5)


def test_device_error_is_retried_then_quarantined(rect_tree, tmp_path):
    """An injected ``inloc_pair`` device error: within the retry budget
    the query reruns the same program and its table equals a clean run's;
    past it the query is quarantined into the manifest (no artifact) and
    the other query completes."""
    root, shortlist = rect_tree
    clean = run_port(root, shortlist, str(tmp_path / "clean"))
    faults.install(faults.FaultPlan(device_fail_calls=(2,)))
    retried = run_port(root, shortlist, str(tmp_path / "retried"),
                       retry_backoff_s=0.0)
    for n in ("1.mat", "2.mat"):
        np.testing.assert_array_equal(
            loadmat(os.path.join(retried, n))["matches"],
            loadmat(os.path.join(clean, n))["matches"])
    faults.install(faults.FaultPlan(device_fail_calls=(1, 2, 3)))
    out_dir = run_port(root, shortlist, str(tmp_path / "degraded"),
                       query_retries=2, retry_backoff_s=0.0)
    manifest = os.path.join(out_dir, "manifest.json")
    assert tres.manifest_has_quarantined(manifest)
    m = tres.RunManifest(manifest)
    assert m.quarantined_ids == ("query_1",)
    assert m.data["quarantined"]["query_1"]["kind"] == "device"
    assert m.data["quarantined"]["query_1"]["attempts"] == 3
    assert not os.path.exists(os.path.join(out_dir, "1.mat"))
    assert m.is_completed("query_2")


@pytest.mark.parametrize("kw", [dict(spatial_shards=2),
                                dict(feature_store_dir="store"),
                                dict(retrieval_index="index.json")])
def test_unported_options_are_refused(rect_tree, tmp_path, kw, monkeypatch):
    """The feature store and the retrieval shortlist (A12) are refused.
    ``spatial_shards=2``, refused until the multi-GPU slice, now runs: on a
    CPU mesh (the CPU named once a shard) the fp32 ``.mat`` tables hold the
    JAX unsharded run's matches row for row, the scores within rtol 1e-5,
    atol 1e-6 (the fp32 bound above), every pair through the sharded
    forward; on CUDA with one card visible it raises, naming the devices
    it needs."""
    root, shortlist = rect_tree
    name = next(iter(kw))
    if name != "spatial_shards":
        with pytest.raises(NotImplementedError, match=name):
            run_port(root, shortlist, str(tmp_path / "m"), **kw)
        return
    from ncnet_tpu_torch.parallel import spatial as tspatial

    calls = []
    real = tspatial.spatial_forward
    monkeypatch.setattr(tspatial, "spatial_forward",
                        lambda *a, **k: calls.append(a[4].shape) or real(*a, **k))
    jc, jp, _, _ = shared_params(False)
    jdir = jinloc.run_inloc_eval(
        jcfg.EvalInLocConfig(output_root=str(tmp_path / "jax"),
                             **eval_kw(root, shortlist)),
        model_config=jc, params=jp, progress=False)
    tdir = run_port(root, shortlist, str(tmp_path / "port"), **kw)
    assert calls == [{"data": 1, "spatial": 2}] * 4  # 2 queries × 2 cutouts
    assert os.path.basename(tdir) == os.path.basename(jdir)
    grid = ((QUERY_HW[0] // 32, QUERY_HW[1] // 32, PANO_HW[0] // 32,
             PANO_HW[1] // 32), 2)
    for n in ("1.mat", "2.mat"):
        g = loadmat(os.path.join(tdir, n))["matches"]
        w = loadmat(os.path.join(jdir, n))["matches"]
        assert g.shape == w.shape and (g[..., 4] > 0).sum() > 0
        assert_same_matches(g[..., :4], w[..., :4], grid)
        np.testing.assert_allclose(g[..., 4], w[..., 4], rtol=1e-5, atol=1e-6)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    _, _, tc, tp = shared_params(False)
    cfg = tcfg.EvalInLocConfig(output_root=str(tmp_path / "gpu"),
                               **eval_kw(root, shortlist, **kw))
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        tinloc.run_inloc_eval(cfg, model_config=tc, params=tp, progress=False)


def test_entry_points_need_cuda(rect_tree, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, shortlist = rect_tree
    _, _, tc, tp = shared_params(False)
    cfg = tcfg.EvalInLocConfig(output_root=str(tmp_path / "m"),
                               **eval_kw(root, shortlist))
    with pytest.raises(RuntimeError, match="CUDA"):
        tinloc.run_inloc_eval(cfg, model_config=tc, params=tp, progress=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tinloc.make_pair_matcher(tc, tp, do_softmax=True, both_directions=True,
                                 flip_direction=False)


def test_telemetry_log_holds_the_run(rect_tree, tmp_path):
    from ncnet_tpu_torch.observability.events import replay_events

    root, shortlist = rect_tree
    tel = str(tmp_path / "tel")
    run_port(root, shortlist, str(tmp_path / "m"), telemetry_dir=tel)
    _, events = replay_events(os.path.join(tel, "events.jsonl"))
    kinds = [e["event"] for e in events]
    assert kinds[0] == "run_start"
    assert kinds.count("eval_query") == 2 and kinds.count("quality") == 4
    assert "eval_summary" in kinds
    spans = {e.get("name") for e in events if e["event"] == "span"}
    assert {"inloc_query", "decode", "dispatch", "fetch"} <= spans


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_flags_are_the_jax_clis():
    jflags = {a.dest: a.default for a in jcli.build_parser()._actions}
    tflags = {a.dest: a.default for a in tcli.build_parser()._actions}
    assert tflags.pop("device") == "cuda"
    assert tflags == jflags


def test_cli_runs_and_exits_2_when_degraded(rect_tree, tmp_path, monkeypatch,
                                            capsys):
    """The CLI on the CPU writes the tables (exit 0); with a query
    quarantined in this host's manifest it exits 2."""
    root, shortlist = rect_tree
    _, _, tc, tp = shared_params(False)
    real = tinloc.run_inloc_eval
    monkeypatch.setattr(tinloc, "run_inloc_eval", lambda cfg, **kw: real(
        cfg, model_config=tc, params=tp, **kw))
    argv = ["--inloc_shortlist", shortlist, "--image_size", str(SIDE),
            "--n_queries", "2", "--n_panos", "2",
            "--pano_path", os.path.join(root, "pano"),
            "--query_path", os.path.join(root, "query", "iphone7"),
            "--retry_backoff_s", "0", "--device", "cpu"]
    assert tcli.main(argv + ["--output_root", str(tmp_path / "ok")]) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "NCNet evaluation script - InLoc dataset"
    assert "Output matches folder: shortlist_SZ_NEW_256_K_2_BOTHDIRS_SOFTMAX" in out
    faults.install(faults.FaultPlan(device_fail_calls=(1, 2, 3)))
    assert tcli.main(argv + ["--output_root", str(tmp_path / "bad")]) == 2


def test_cli_runs_as_a_module():
    proc = subprocess.run([sys.executable, "-m", "ncnet_tpu_torch.cli.eval_inloc",
                           "--help"], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and "--device" in proc.stdout
