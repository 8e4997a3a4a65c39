"""The port's main-path tail against the JAX package on the CPU:
relocalization (``maxpool4d_with_argmax`` and the ``delta4d`` readout), the
point transforms, PCK and the PF-Pascal eval step, the InLoc match table,
the align-corners resize, and the goldens.

Both sides get the same seeded numpy inputs (and the same weights, through
``models/convert.py::params_from_numpy``).  Tolerances, stated per test:

  * pooling, match coordinates, deltas, PCK: exact (the same float32 ops in
    the same order; the grids are held against the *jitted* JAX functions,
    whose ``jnp.linspace`` rounds as the port's ``_grid`` does);
  * softmax scores and quality signals: rtol 1e-5 (the exponentials and
    sums of two libraries), as ``test_torch_port_model.py`` holds the
    engine's scores at 1e-4 and the point warps at 1e-5 relative;
  * the device resize: rtol 1e-6 of the image's largest value (two f32
    products summed in another order); the numpy resize and ``quantize_u8``
    bit-equal (the same numpy code);
  * the goldens: rtol 1e-5, atol 1e-6 and the deltas equal, the JAX
    golden test's bounds for ``tiny_*`` (it holds ``resnet_feat_*`` at
    rtol 1e-4, atol 1e-5; the port is held at the tighter pair there too).
"""

import functools
import importlib
import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ncnet_tpu import config as jcfg
from ncnet_tpu.evaluation import inloc as jinloc
from ncnet_tpu.evaluation.pf_pascal import make_eval_step as jax_eval_step
from ncnet_tpu.models import ncnet as jnet
from ncnet_tpu.ops import image as jimage
from ncnet_tpu.ops import matching as jmatch
from ncnet_tpu.ops.pooling import maxpool4d_with_argmax as jax_pool
from ncnet_tpu.serving.engine import BatchMatchEngine as JaxEngine
from ncnet_tpu_torch import config as tcfg
from ncnet_tpu_torch.evaluation import inloc as tinloc
from ncnet_tpu_torch.evaluation.pf_pascal import RESULT_COLUMNS, make_eval_step
from ncnet_tpu_torch.models import ncnet as tnet
from ncnet_tpu_torch.models.convert import params_from_numpy
from ncnet_tpu_torch.ops import image as timage
from ncnet_tpu_torch.ops import matching as tmatch
from ncnet_tpu_torch.ops.pooling import maxpool4d_with_argmax
from ncnet_tpu_torch.serving.engine import BatchMatchEngine

# the packages' evaluation/__init__ re-exports the function pck under the
# module's name
jpck = importlib.import_module("ncnet_tpu.evaluation.pck")
tpck = importlib.import_module("ncnet_tpu_torch.evaluation.pck")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "goldens", "activations.npz")


def configs(**kw):
    return jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)


def identity_params(jc, seed=0):
    """JAX params from ``seed`` with one 3⁴ identity NC layer, and the same
    weights as port params."""
    jp = jnet.init_ncnet(jc, jax.random.key(seed))
    w = np.zeros((3, 3, 3, 3, 1, 1), np.float32)
    w[1, 1, 1, 1, 0, 0] = 1.0
    jp["nc"] = [{"w": jnp.asarray(w), "b": jnp.zeros((1,), jnp.float32)}]
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def tied_volume(rng, shape, dtype):
    """An integer-valued volume: each k⁴ box holds many exact ties."""
    v = rng.integers(0, 4, shape).astype(np.float32)
    return v if dtype == "float32" else v.astype(jnp.bfloat16)


# ---------------------------------------------------------------------------
# relocalization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [2, 3])
def test_maxpool4d_with_argmax_matches_jax_with_ties(k, dtype):
    """Exact: the pooled values and the first maximal offset in every box."""
    vol = tied_volume(np.random.default_rng(k), (2, 2 * k, 3 * k, 2 * k, k), dtype)
    want, want_d = jax_pool(jnp.asarray(vol), k)
    x = torch.from_numpy(np.asarray(vol, np.float32))
    if dtype == "bfloat16":
        x = x.to(torch.bfloat16)
    got, got_d = maxpool4d_with_argmax(x, k)
    assert got.dtype == x.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    for g, w in zip(got_d, want_d):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the ties are really there, and the offsets are not all zero
    assert sum(int(d.abs().sum()) for d in got_d) > 0


def test_maxpool4d_rejects_an_indivisible_volume():
    with pytest.raises(ValueError, match="divisible"):
        maxpool4d_with_argmax(torch.zeros(1, 4, 4, 4, 5), 2)


@pytest.mark.parametrize("scale", ["centered", "positive"])
@pytest.mark.parametrize("invert", [False, True])
def test_corr_to_matches_with_delta4d_matches_jax(invert, scale):
    """The relocalized readout with softmax, both directions and scales:
    coordinates and indices exact, scores rtol 1e-5 (against the jitted JAX
    function)."""
    rng = np.random.default_rng(4)
    fine = rng.uniform(0, 1, (2, 8, 6, 6, 8)).astype(np.float32)
    pooled, deltas = jax_pool(jnp.asarray(fine), 2)
    fn = jax.jit(functools.partial(
        jmatch.corr_to_matches, k_size=2, do_softmax=True, scale=scale,
        invert_matching_direction=invert, return_indices=True))
    want, want_idx = fn(pooled, deltas)
    got, got_idx = tmatch.corr_to_matches(
        torch.from_numpy(np.asarray(pooled)),
        delta4d=tuple(torch.from_numpy(np.asarray(d)) for d in deltas),
        k_size=2, do_softmax=True, scale=scale,
        invert_matching_direction=invert, return_indices=True)
    for g, w in zip(got_idx, want_idx):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got.score.numpy(), np.asarray(want.score), rtol=1e-5)
    # the fine grid: indices past the pooled grid are reached
    assert int(got_idx[0].max()) > pooled.shape[1] - 1 or \
        int(got_idx[2].max()) > pooled.shape[3] - 1


# ---------------------------------------------------------------------------
# point transforms
# ---------------------------------------------------------------------------


def match_pair(rng, shape_b, shape_a=(5, 6)):
    """Matches of a random ``(2, hA, wA, hB, wB)`` volume in the B→A
    direction from both packages, and seeded target points in [-1, 1]."""
    corr = rng.uniform(0, 1, (2,) + tuple(shape_a) + tuple(shape_b)).astype(np.float32)
    want = jax.jit(functools.partial(jmatch.corr_to_matches, do_softmax=True))(
        jnp.asarray(corr))
    got = tmatch.corr_to_matches(torch.from_numpy(corr), do_softmax=True)
    pts = rng.uniform(-1.1, 1.1, (2, 2, 25)).astype(np.float32)
    return want, got, pts


@pytest.mark.parametrize("grid_b", [(6, 6), (4, 7)])
def test_bilinear_interp_point_tnf_matches_jax(grid_b):
    """Square (inferred) and rectangular (``grid_hw``) B grids: rtol 1e-5
    of the warp (float32 on both sides; the quotient rounds in either)."""
    want_m, got_m, pts = match_pair(np.random.default_rng(5), grid_b)
    grid_hw = None if grid_b[0] == grid_b[1] else grid_b
    want = jax.jit(functools.partial(jmatch.bilinear_interp_point_tnf,
                                     grid_hw=grid_hw))(want_m, jnp.asarray(pts))
    got = tmatch.bilinear_interp_point_tnf(got_m, torch.from_numpy(pts), grid_hw=grid_hw)
    assert got.shape == (2, 2, 25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_bilinear_interp_point_tnf_rejects_a_grid_that_does_not_tile():
    _, got_m, pts = match_pair(np.random.default_rng(6), (4, 7))
    with pytest.raises(ValueError, match="does not tile"):
        tmatch.bilinear_interp_point_tnf(got_m, torch.from_numpy(pts))  # 28: no square
    with pytest.raises(ValueError, match="does not tile"):
        tmatch.bilinear_interp_point_tnf(got_m, torch.from_numpy(pts), grid_hw=(5, 5))


def test_nearest_neighbor_point_tnf_matches_jax():
    """Exact: the same argmin over the same float32 distances."""
    want_m, got_m, pts = match_pair(np.random.default_rng(7), (5, 5))
    want = jax.jit(jmatch.nearest_neighbor_point_tnf)(want_m, jnp.asarray(pts))
    got = tmatch.nearest_neighbor_point_tnf(got_m, torch.from_numpy(pts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_point_coordinate_transforms_match_jax():
    """Pixel ↔ unit coordinates on rectangular sizes: exact, and the round
    trip returns the points within float32 round-off."""
    rng = np.random.default_rng(8)
    pts = rng.uniform(1, 300, (3, 2, 20)).astype(np.float32)
    size = np.float32([[240, 320, 3], [400, 400, 3], [333, 500, 3]])
    unit_w = jmatch.points_to_unit_coords(jnp.asarray(pts), jnp.asarray(size))
    unit = tmatch.points_to_unit_coords(torch.from_numpy(pts), torch.from_numpy(size))
    np.testing.assert_array_equal(unit.numpy(), np.asarray(unit_w))
    back_w = jmatch.points_to_pixel_coords(unit_w, jnp.asarray(size))
    back = tmatch.points_to_pixel_coords(unit, torch.from_numpy(size))
    np.testing.assert_array_equal(back.numpy(), np.asarray(back_w))
    np.testing.assert_allclose(back.numpy(), pts, rtol=1e-5)


# ---------------------------------------------------------------------------
# PCK
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["padding", "all_padded"])
def test_pck_matches_jax(case):
    """The JAX package's own PCK cases (tests/test_eval.py): 2 of 3 valid
    points within alpha·L with one padded slot, and NaN with no valid
    point."""
    if case == "padding":
        src = np.float32([[[10, 20, 30, -1], [10, 20, 30, -1]]])
        warped = np.float32([[[10.5, 20, 99, 0], [10, 20.5, 99, 0]]])
        l_pck = np.float32([[10.0]])
    else:
        src = -np.ones((1, 2, 4), np.float32)
        warped, l_pck = src, np.float32([[5.0]])
    want = np.asarray(jpck.pck(jnp.asarray(src), jnp.asarray(warped),
                               jnp.asarray(l_pck), alpha=0.1))
    got = tpck.pck(torch.from_numpy(src), torch.from_numpy(warped),
                   torch.from_numpy(l_pck), alpha=0.1)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "padding":
        np.testing.assert_allclose(got.numpy(), [2.0 / 3.0])
    else:
        assert np.isnan(got.numpy()[0])


def keypoint_batch(rng, b, src_hw, tgt_hw, n_valid, shift=(0.0, 0.0)):
    """PF-Pascal-style keypoints: 20 slots, −1 suffix padding, ``n_valid``
    valid points a sample (0 allowed), targets the sources plus ``shift``
    (x, y) pixels plus noise; ``L_pck`` the longer side of the valid
    source points' bounding box (the 'pf' procedure)."""
    src = np.full((b, 2, 20), -1, np.float32)
    tgt = np.full((b, 2, 20), -1, np.float32)
    l_pck = np.ones((b, 1), np.float32)
    for i, n in enumerate(n_valid):
        xy = rng.uniform(4, np.float32(min(src_hw)) - 4, (2, n)).astype(np.float32)
        src[i, :, :n] = xy
        tgt[i, :, :n] = xy + np.float32(shift)[:, None] + rng.normal(0, 2, (2, n))
        if n:
            l_pck[i, 0] = max(np.ptp(xy[0]), np.ptp(xy[1]))
    return {"source_points": src, "target_points": tgt, "L_pck": l_pck,
            "source_im_size": np.tile(np.float32([*src_hw, 3]), (b, 1)),
            "target_im_size": np.tile(np.float32([*tgt_hw, 3]), (b, 1))}


@pytest.mark.parametrize("sizes", [((240, 320), (300, 200)), ((400, 400), (400, 400))])
def test_pck_metric_matches_jax(sizes):
    """Per-sample PCK through the bilinear warp, with padding, an empty
    sample (NaN) and rectangular image sizes: exact."""
    rng = np.random.default_rng(9)
    want_m, got_m, _ = match_pair(rng, (6, 6))
    batch = keypoint_batch(rng, 2, *sizes, n_valid=(12, 0))
    want = np.asarray(jax.jit(jpck.pck_metric)(
        {k: jnp.asarray(v) for k, v in batch.items()}, want_m, 0.3))
    got = tpck.pck_metric({k: torch.from_numpy(v) for k, v in batch.items()},
                          got_m, 0.3)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.isnan(got[1]) and 0.0 <= float(got[0]) <= 1.0


# ---------------------------------------------------------------------------
# the InLoc match table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reloc", [False, True])
@pytest.mark.parametrize("direction", ["one", "both", "flip"])
def test_extract_match_table_matches_jax(direction, reloc):
    """One direction, both, and the flipped one, with and without
    relocalization offsets, from a bf16 volume (read in f32), against the
    jitted JAX function: coordinates within one float32 ulp, scores rtol
    1e-5."""
    rng = np.random.default_rng(10)
    fine = rng.uniform(0, 1, (1, 6, 8, 8, 4)).astype(jnp.bfloat16)
    corr, delta = (jax_pool(jnp.asarray(fine), 2) if reloc
                   else (jnp.asarray(fine), None))
    kw = dict(k_size=2 if reloc else 0, do_softmax=True,
              both_directions=direction == "both",
              flip_direction=direction == "flip")
    want = np.asarray(jax.jit(functools.partial(jinloc.extract_match_table, **kw))(
        jnet.NCNetOutput(corr, delta)))
    t_corr = torch.from_numpy(np.asarray(corr, np.float32)).to(torch.bfloat16)
    t_delta = (None if delta is None
               else tuple(torch.from_numpy(np.asarray(d)) for d in delta))
    got = tinloc.extract_match_table(tnet.NCNetOutput(t_corr, t_delta), **kw).numpy()
    n_a, n_b = corr.shape[1] * corr.shape[2], corr.shape[3] * corr.shape[4]
    n = {"one": n_b, "flip": n_a, "both": n_b + n_a}[direction]
    assert got.shape == want.shape == (5, n)
    # the grids exact; the recentring x·(n−1)/n + 0.5/n within one float32
    # ulp: XLA's CPU backend fuses its multiply-add into one FMA under jit,
    # the port rounds the product and the sum (as eager JAX does)
    np.testing.assert_array_max_ulp(got[:4], want[:4], maxulp=1)
    np.testing.assert_allclose(got[4], want[4], rtol=1e-5)
    assert tinloc.match_capacity(3200, 2, True) == jinloc.match_capacity(3200, 2, True)


# ---------------------------------------------------------------------------
# resize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,out", [((13, 17), (7, 5)), ((5, 6), (10, 12)),
                                       ((8, 8), (8, 8)), ((97, 61), (64, 64))])
def test_resize_forms_match_jax(shape, out):
    """The device form against the jitted JAX one (f32 and uint8 in, f32
    out): rtol 1e-6 of the image's largest value; the numpy form and
    ``quantize_u8`` bit-equal to the JAX package's."""
    rng = np.random.default_rng(11)
    img = rng.uniform(0, 255, (2,) + shape + (3,)).astype(np.float32)
    fn = jax.jit(jimage.resize_bilinear_align_corners, static_argnums=(1, 2))
    for x in (img, img.astype(np.uint8)):
        want = np.asarray(fn(jnp.asarray(x), *out))
        got = timage.resize_bilinear_align_corners(torch.from_numpy(x), *out)
        assert got.dtype == torch.float32 and got.shape == (2,) + out + (3,)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    got3 = timage.resize_bilinear_align_corners(torch.from_numpy(img[0]), *out)
    assert got3.shape == out + (3,)
    want_np = jimage.resize_bilinear_align_corners_np(img[0], *out)
    got_np = timage.resize_bilinear_align_corners_np(img[0], *out)
    np.testing.assert_array_equal(got_np, want_np)
    np.testing.assert_array_equal(timage.quantize_u8(got_np),
                                  jimage.quantize_u8(want_np))


# ---------------------------------------------------------------------------
# the eval step, the engine and the matcher with relocalization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("device_normalize", [False, True])
def test_eval_step_matches_jax(device_normalize):
    """The ``(B, 6)`` table of the tiny config with the identity NC kernel
    on shifted pairs: PCK exact, the quality columns rtol 1e-5 (softmax
    of two libraries)."""
    jc, tc = configs(backbone="tiny", ncons_kernel_sizes=(3,), ncons_channels=(1,))
    jp, tp = identity_params(jc)
    jnet_ = jnet.NCNet(jc, jp)
    tnet_ = tnet.NCNet(tc, tp, device="cpu")
    rng = np.random.default_rng(12)
    side, b = 96, 3
    src = rng.integers(0, 256, (b, side, side, 3), dtype=np.uint8)
    tgt = np.roll(src, (16, 32), axis=(1, 2))
    batch = keypoint_batch(rng, b, (side, side), (side, side),
                           n_valid=(8, 20, 0), shift=(32.0, 16.0))
    if device_normalize:
        batch.update(source_image=src, target_image=tgt)
    else:
        norm = lambda x: np.asarray(jimage.normalize_imagenet(x.astype(np.float32)),  # noqa: E731
                                    np.float32)
        batch.update(source_image=norm(src), target_image=norm(tgt))
    want = np.asarray(jax_eval_step(jnet_, 0.1, device_normalize)(
        jnet_.params, {k: jnp.asarray(v) for k, v in batch.items()}))
    step = make_eval_step(tnet_, 0.1, device_normalize)
    got = step(tnet_.params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == (b, len(RESULT_COLUMNS)) and got.dtype == torch.float32
    assert not got.requires_grad
    np.testing.assert_array_equal(got[:, 0].numpy(), want[:, 0])
    np.testing.assert_allclose(got[:, 1:].numpy(), want[:, 1:], rtol=1e-5, atol=1e-7)
    assert torch.isnan(got[2, 0]) and float(got[1, 0]) > 0


def reloc_pairs(side=192):
    """Two uint8 pairs at ``side``, each target its source shifted by half
    a fine feature cell and more (8 and 24 px).  Not by whole cells: an
    exact copy of a cell's content gives a correlation of 1 at every
    copy, and a k⁴ box or a pooled column then holds several of them,
    tied up to the last bit of the correlation's sums, which the two
    libraries order differently."""
    rng = np.random.default_rng(13)
    src = rng.integers(0, 256, (2, side, side, 3), dtype=np.uint8)
    tgt = np.stack([np.roll(src[0], (8, 24), axis=(0, 1)),
                    np.roll(src[1], (24, 8), axis=(0, 1))])
    return src, tgt


def test_relocalized_engine_and_matcher_match_jax():
    """``relocalization_k_size=2`` through the engine and the point matcher
    (tiny trunk at 192²: a 12² grid pooled to 6²): one match a pooled B
    cell, on the 12-point fine grid; coordinates exact, scores and quality
    rtol 1e-4 (as ``test_torch_port_model.py`` holds the unpooled
    engine)."""
    jc, tc = configs(backbone="tiny", ncons_kernel_sizes=(3,), ncons_channels=(1,),
                     relocalization_k_size=2)
    jp, tp = identity_params(jc, seed=9)
    src, tgt = reloc_pairs()
    jax_engine = JaxEngine(jc, jp)
    want = np.asarray(jax_engine.fetch(jax_engine.dispatch(src, tgt)))
    engine = BatchMatchEngine(tc, tp, device="cpu")
    got = engine.fetch(engine.dispatch(src, tgt))
    assert got.shape == want.shape == (2, 6, 36)
    np.testing.assert_array_equal(got[:, :4], want[:, :4])
    np.testing.assert_allclose(got[:, 4:], want[:, 4:], rtol=1e-4, atol=1e-7)
    fine = np.asarray(jax.jit(lambda: jnp.linspace(-1.0, 1.0, 12))())
    assert np.isin(got[:, :4], fine).all()
    assert len(np.unique(got[:, 2])) > 6  # more columns than the pooled grid

    want_m, want_q = jnet.make_point_matcher(jc, jp).match_with_quality(src[1:], tgt[1:])
    got_m, got_q = tnet.make_point_matcher(tc, tp, device="cpu").match_with_quality(
        src[1:], tgt[1:])
    for g, w in zip(got_m[:4], want_m[:4]):
        assert g.shape == (1, 36)
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got_m.score, want_m.score, rtol=1e-4)
    np.testing.assert_allclose(list(got_q.values()), list(want_q.values()),
                               rtol=1e-4, atol=1e-7)
    # the matcher's pair is the engine's second row
    np.testing.assert_array_equal(np.concatenate(got_m[:4]), got[1, :4])


# ---------------------------------------------------------------------------
# the goldens
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def golden():
    g = np.load(GOLDEN)
    bad = [k for k in g.files if not np.isfinite(g[k]).all()]
    assert not bad, f"golden arrays contain non-finite values: {bad}"
    return g


def golden_params(jc):
    """The goldens' deterministic weights (``tools/make_goldens.py``) as
    port params."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        from make_goldens import deterministic_params
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # a deliberately random trunk
        return params_from_numpy(jax.tree.map(np.asarray, deterministic_params(jc)))


def test_tiny_forward_matches_golden(golden):
    """The relocalized tiny forward and its matches against ``tiny_*``:
    rtol 1e-5, atol 1e-6, the deltas equal (the JAX golden test's
    bounds)."""
    jc, tc = configs(backbone="tiny", ncons_kernel_sizes=(3, 3),
                     ncons_channels=(8, 1), relocalization_k_size=2)
    tp = golden_params(jc)
    with torch.no_grad():
        out = tnet.ncnet_forward(tc, tp, torch.from_numpy(golden["tiny_src"]),
                                 torch.from_numpy(golden["tiny_tgt"]))
    np.testing.assert_allclose(out.corr.numpy(), golden["tiny_corr"], rtol=1e-5, atol=1e-6)
    for i, d in enumerate(out.delta4d):
        np.testing.assert_array_equal(d.numpy(), golden[f"tiny_delta{i}"])
    m = tmatch.corr_to_matches(out.corr, delta4d=out.delta4d, k_size=2,
                               do_softmax=True, scale="positive")
    got = np.stack([v.numpy() for v in m])
    np.testing.assert_allclose(got, golden["tiny_matches"], rtol=1e-5, atol=1e-6)


def test_resnet_features_match_golden(golden):
    """The ResNet-101 trunk's features against ``resnet_feat_*``: rtol
    1e-5, atol 1e-6 (the JAX golden test's ``tiny_*`` bounds)."""
    jc, tc = configs(backbone="resnet101", ncons_kernel_sizes=(3,), ncons_channels=(1,))
    tp = golden_params(jc)
    with torch.no_grad():
        feats = tnet.extract_features(tc, tp, torch.from_numpy(golden["resnet_img"])).numpy()
    np.testing.assert_allclose(feats.mean(axis=-1), golden["resnet_feat_mean"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(feats[0, :, :, :8], golden["resnet_feat_slice"],
                               rtol=1e-5, atol=1e-6)
