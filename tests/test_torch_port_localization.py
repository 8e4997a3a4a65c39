"""The port's InLoc localization stage against the JAX package on the CPU:
``ncnet_tpu_torch/localization/`` and ``cli/compute_localization.py``
against ``ncnet_tpu/localization/`` and its CLI, on the same seeded numpy
inputs.

Tolerances and what is held:

- the numpy copies (geometry, scan, render, curves, P3P, the LO refinement,
  the back-projection, the artifact names, the verification helpers, the
  ImgList ``.mat`` round trip) bit-equal: they are the same float64 numpy;
- ``p3p_solve`` on the goldens at ``tests/test_goldens.py``'s tolerances;
- the hypothesis scorer: the port computes ``R X + t`` and the cosine as
  explicit f32 products and sums, XLA as einsums that may sum in another
  order, so a point whose cosine lies within a few f32 ulps of the
  threshold can count in one package and not in the other.  That is a
  rounding ambiguity, not a defect.  The rule: every point whose float64
  cosine lies more than 16 f32 ulps from the threshold gets the same
  decision in both packages, so a hypothesis without such a point has equal
  counts, and one with some differs by at most their number; the test
  prints how many points lie in the band.  Ties go to the first maximum in
  both (a chunk's ``argmax``, a strict ``>`` across chunks);
- the LO-RANSAC, ``estimate_pose_from_matches``, ``run_pair_pnp`` and the
  whole stage run on scenes whose correspondences are exact, or noisy with
  every residual at least 0.05° from the 0.2° threshold; there the masks
  agree, and everything downstream of a mask is the same float64 numpy, so
  the poses are bit-equal;
- ``dense_sift`` within 1e-5 of JAX's jitted one (both f32; the pooling
  sums in another order), and at the goldens' tolerances;
  ``pose_verification_score`` within 1e-5 relative;
- ``run_localization``'s ImgLists, error files and curves equal to JAX's,
  with 0 and 2 workers, and on a rerun reloaded from the artifacts; the
  pose-verification scores in the ImgList (1 / a median of descriptor
  distances) within 1e-5 relative, as the dense SIFT.

Queries are written twice from one array: PNG for JAX's PIL (lossless) and
the raw ``<name>.npy`` the port reads (ROADMAP D1).  Everything here runs
with ``device="cpu"``; ``tests/test_torch_port_cuda.py`` holds the card.
"""

import contextlib
import importlib
import io
import os
import sys

import jax  # noqa: F401  (the JAX package runs on the CPU here)
import numpy as np
import pytest
import torch
from PIL import Image
from scipy.io import loadmat, savemat

from ncnet_tpu import config as jcfg
from ncnet_tpu.cli import compute_localization as jcli
from ncnet_tpu_torch import config as tcfg
from ncnet_tpu_torch.cli import compute_localization as tcli
from ncnet_tpu_torch.data.datasets import raw_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = ("geometry", "scan", "render", "curves", "p3p", "pnp", "dsift",
           "verification", "driver")
J = {m: importlib.import_module(f"ncnet_tpu.localization.{m}")
     for m in MODULES}
T = {m: importlib.import_module(f"ncnet_tpu_torch.localization.{m}")
     for m in MODULES}
THR = np.deg2rad(0.2)
CPU = "cpu"


def assert_same(a, b):
    """Equal values of equal types, recursively; NaN equals NaN."""
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (a, b)


def random_pose(rng, depth=4.0):
    Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    t = rng.normal(size=3) * 0.3 + np.array([0.0, 0.0, depth])
    return np.concatenate([Q, t[:, None]], axis=1)


def rays_for(P, X):
    xc = X @ P[:, :3].T + P[:, 3]
    return xc / np.linalg.norm(xc, axis=1, keepdims=True)


def rot_y(ang):
    return np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                     [-np.sin(ang), 0, np.cos(ang)]])


def perturb(rng, rays, sigma_deg, margin_deg=0.05):
    """Rays turned by random angles drawn around ``sigma_deg`` that stay
    at least ``margin_deg`` from the 0.2° threshold (exact directions)."""
    ang = np.abs(rng.normal(0, sigma_deg, len(rays)))
    near = np.abs(ang - 0.2) < margin_deg
    ang[near] = 0.2 - margin_deg - 0.05 * rng.random(near.sum())
    axis = np.cross(rays, rng.normal(size=rays.shape))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    a = np.deg2rad(ang)[:, None]
    out = rays * np.cos(a) + np.cross(axis, rays) * np.sin(a)
    return out / np.linalg.norm(out, axis=1, keepdims=True)


# ---------------------------------------------------------------------------
# the numpy copies, bit-equal
# ---------------------------------------------------------------------------


def _geometry(m, rng, tmp):
    P1, P2 = random_pose(rng), random_pose(rng)
    K = m.intrinsics(300.0, 240, 320)
    X = rng.normal(size=(50, 3)) + np.array([0, 0, 6.0])
    return (m.camera_center(P1), m.pose_distance(P1, P2), K,
            m.iphone7_focal(4032, 3024), m.pixel_rays(K, rng.random((40, 2))
                                                      * 300),
            m.project_points(P1, K, X), m.cap_longest_side_shape(3024, 4032),
            m.cap_longest_side_shape(900, 700))


def _scan(m, rng, tmp):
    path = os.path.join(tmp, "trans.txt")
    with open(path, "w") as f:
        f.write("header words\n")
        for blk in range(2):
            for row in rng.normal(size=(4, 4)):
                f.write(" ".join(f"{v:.12f}" for v in row) + "\n")
            f.write("next block\n")
    xyz = rng.normal(size=(12, 16, 3))
    xyz[3, 4] = np.nan
    savemat(os.path.join(tmp, "cut.mat"), {"XYZcut": xyz})
    A = np.empty((1, 7), dtype=object)
    for i in range(7):
        A[0, i] = (rng.random((30, 1)) * 300 if i >= 4
                   else rng.normal(size=(30, 1)))
    savemat(os.path.join(tmp, "scan.ptx.mat"), {"A": A})
    T4 = np.eye(4)
    T4[:3] = random_pose(rng)
    T4[3] = [1e-3, -2e-3, 0, 1]
    name = "DUC2/DUC_cutout_024_30_0.jpg"
    return (tuple(m.parse_cutout_name(name)),
            m.transformation_path("/t", name), m.scan_path("/s", name),
            m.load_transformation(path), m.load_xyzcut(os.path.join(
                tmp, "cut.mat")),
            m.load_scan_pointcloud(os.path.join(tmp, "scan.ptx.mat")),
            m.transform_points(T4, rng.normal(size=(20, 3))),
            m.backproject_matches(xyz, rng.random((60, 2)) * 1.1 - 0.05, T4))


def _render(m, rng, tmp):
    xyz = rng.normal(size=(4000, 3)) + np.array([0, 0, 5.0])
    rgb = (rng.random((4000, 3)) * 255).astype(np.uint8)
    K = np.array([[40.0, 0, 24], [0, 40.0, 18], [0, 0, 1]])
    return m.render_points_perspective(rgb, xyz, K @ random_pose(rng, 0.5),
                                       36, 48)


def _curves(m, rng, tmp):
    ref = np.empty((3,), dtype=[("queryname", object), ("P", object)])
    poses = [random_pose(rng) for _ in range(3)]
    for i in range(3):
        ref["queryname"][i] = f"q{i}.jpg"
        ref["P"][i] = poses[i]
    path = os.path.join(tmp, "ref.mat")
    savemat(path, {"DUC1_RefList": ref[:2].reshape(1, -1),
                   "DUC2_RefList": ref[2:].reshape(1, -1)})
    refposes = m.load_reference_poses(path)
    P0 = poses[0].copy()
    P0[:, 3] += 0.1
    method = m.MethodResult("x", {
        "q0.jpg": ("DUC1/a.jpg", P0),
        "q1.jpg": ("DUC2/b.jpg", poses[1]),          # wrong floor
        "q2.jpg": ("DUC2/c.jpg", np.full((3, 4), np.nan))})
    poserr, orierr, names = m.pose_errors(method, refposes)
    txt = os.path.join(tmp, "err.txt")
    m.write_error_txt(txt, names, poserr, orierr)
    return (refposes, (poserr, orierr, names),
            m.localized_rate_curve(poserr, orierr), open(txt).read(),
            m.ERROR_THRESHOLDS)


def _p3p(m, rng, tmp):
    Ps = [random_pose(rng) for _ in range(6)]
    Xs = [rng.normal(size=(3, 3)) + np.array([0, 0, 4.0]) for _ in Ps]
    rays = np.stack([rays_for(P, X) for P, X in zip(Ps, Xs)])
    X = rng.normal(size=(80, 3)) + np.array([0, 0, 5.0])
    P = random_pose(rng)
    r = perturb(rng, rays_for(P, X), 0.05)
    P0 = P.copy()
    P0[:, 3] += 0.05
    coeffs = rng.normal(size=(10, 5))
    coeffs[2, 0] = 0.0
    return (m.p3p_solve(rays, np.stack(Xs)), m.refine_pose_object_space(
        r, X, P0), m._quartic_roots(coeffs),
        m._kabsch(rng.normal(size=(4, 5, 3)), rng.normal(size=(4, 5, 3))))


def _pnp(m, rng, tmp):
    names = ["DUC1/DUC_cutout_024_30_0.jpg", "a__b/c.jpg", "_x/y_.png",
             "DUC2\\DUC_cutout_1_0_0.jpg"]
    return ([m.artifact_stem(n) for n in names],
            [m.pnp_artifact_path("/o", "q.jpg", n) for n in names])


def _dsift_numpy(m, rng, tmp):
    img = rng.random((20, 24, 3)) * 255
    holes = img[..., 0].copy()
    holes[rng.random(holes.shape) < 0.3] = np.nan
    mask = rng.random((20, 24)) < 0.6
    return (m.rootsift(rng.random((5, 128)).astype(np.float32)),
            m.rgb_to_gray(img), m.rgb_to_gray(img[..., 0]),
            m.normalize_image_masked(img[..., 1], mask),
            m.normalize_image_masked(img[..., 1], np.zeros_like(mask)),
            m.inpaint_nans(holes, iters=7), m.descriptor_grid(60, 50, 8, 4))


def _verification(m, rng, tmp):
    P = np.zeros((3, 4))
    items = [m.PVItem("q1", "DUC1/DUC_cutout_001_0_0.jpg", P),
             m.PVItem("q2", "DUC1/DUC_cutout_001_30_0.jpg", P),
             m.PVItem("q1", "DUC2/DUC_cutout_002_0_0.jpg", P)]
    groups = {k: [tuple(i) for i in v]
              for k, v in m.group_items_by_scan(items).items()}
    return (m.downsample_image(rng.random((35, 41, 3))),
            m.downsample_image(rng.random((35, 41))), groups,
            m.rerank_by_scores(["a", "b", "c", "d"], [1, 2, 3, 4],
                               [0.5, 2.0, 0.5, np.inf]))


def _driver(m, rng, tmp):
    cfg_cls = jcfg.LocalizationConfig if m is J["driver"] else \
        tcfg.LocalizationConfig
    imglist = [{"queryname": "q1.jpg", "topNname": ["DUC1/a.jpg", "DUC2/b.jpg"],
                "topNscore": [2.0, 1.0],
                "P": [random_pose(rng), np.full((3, 4), np.nan)]},
               {"queryname": "q2.jpg", "topNname": ["DUC1/c.jpg"],
                "topNscore": [], "P": [random_pose(rng)]}]
    path = os.path.join(tmp, "imglist.mat")
    m._save_imglist(path, imglist)
    cfgs = [cfg_cls(), cfg_cls(n_queries=3, seed=2, ransac_iters=50,
                               max_tentatives=7, pnp_topN=4,
                               match_score_thr=0.5, pnp_inlier_thr_deg=1.0),
            cfg_cls(query_focal_length=123.0)]
    return (m._load_imglist(path),
            [(m._pnp_dirname(c), m._pnp_matname(c), m._pv_dirname(c),
              m._pv_matname(c), m.query_focal(c, 4032, 3024)) for c in cfgs])


NUMPY_CASES = {"geometry": _geometry, "scan": _scan, "render": _render,
               "curves": _curves, "p3p": _p3p, "pnp": _pnp,
               "dsift": _dsift_numpy, "verification": _verification,
               "driver": _driver}


@pytest.mark.parametrize("module", sorted(NUMPY_CASES))
def test_numpy_copies_bit_equal(module, tmp_path):
    out = []
    for pkg in (J, T):
        d = tmp_path / ("j" if pkg is J else "t")
        d.mkdir()
        out.append(NUMPY_CASES[module](pkg[module], np.random.default_rng(7),
                                       str(d)))
    assert_same(out[0], out[1])


def test_p3p_solve_matches_goldens():
    golden = np.load(os.path.join(REPO, "tests", "goldens", "activations.npz"))
    tools = os.path.join(REPO, "tools")
    sys.path.insert(0, tools)
    try:
        from make_goldens import canonical_p3p_order
    finally:
        sys.path.remove(tools)
    sols = T["p3p"].p3p_solve(golden["p3p_rays"], golden["p3p_pts"])
    np.testing.assert_allclose(canonical_p3p_order(sols),
                               golden["p3p_solutions"], rtol=1e-6, atol=1e-8)


# ---------------------------------------------------------------------------
# the scorer: torch against XLA
# ---------------------------------------------------------------------------


def scorer_case(rng, n=700, h=300):
    """Hypotheses near one true pose, with residuals spread around the
    threshold: many points near the boundary of many hypotheses."""
    P = random_pose(rng)
    X = rng.normal(size=(n, 3)) + np.array([0, 0, 5.0])
    rays = perturb(rng, rays_for(P, X), 0.15, margin_deg=0.0)
    poses = []
    for _ in range(h):
        w = rng.normal(size=3) * np.deg2rad(0.1)
        th = np.linalg.norm(w)
        k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        dR = np.eye(3) + np.sin(th) / th * k + (1 - np.cos(th)) / th**2 * k @ k
        poses.append(np.concatenate(
            [dR @ P[:, :3], (P[:, 3] + rng.normal(size=3) * 0.003)[:, None]],
            axis=1))
    return np.stack(poses), rays, X


def f64_margin(P, rays, X):
    """``(h, n)``: float64 cosine minus the f32 threshold, in f32 ulps of
    the threshold."""
    xc = np.einsum("hij,nj->hni", P[:, :, :3], X) + P[:, None, :, 3]
    cos = np.einsum("hni,ni->hn", xc, rays) / np.linalg.norm(xc, axis=-1)
    thr = np.float32(np.cos(THR))
    ulp = np.spacing(thr)
    return (cos - np.float64(thr)) / np.float64(ulp)


def jax_counts(P, rays, X, chunk):
    """Per-hypothesis counts from the JAX package's jitted scorer."""
    N = len(rays)
    n_pad = 1 << max(6, int(np.ceil(np.log2(N))))
    rp = np.zeros((n_pad, 3), np.float32)
    xp = np.zeros((n_pad, 3), np.float32)
    valid = np.zeros((n_pad,), bool)
    rp[:N], xp[:N], valid[:N] = rays, X, True
    Pf = np.nan_to_num(P.astype(np.float32))
    score = J["p3p"]._scoring_fn(chunk, n_pad)
    out = []
    for lo in range(0, len(P), chunk):
        blk = Pf[lo:lo + chunk]
        blk = np.concatenate([blk, np.zeros((chunk - len(blk), 3, 4),
                                            np.float32)])
        out.append(np.asarray(score(blk[:, :, :3], blk[:, :, 3], rp, xp,
                                    valid, np.float32(np.cos(THR)))[0]))
    return np.concatenate(out)[:len(P)]


def torch_mask(P, rays, X):
    pt = torch.from_numpy(np.nan_to_num(P.astype(np.float32)))
    n = len(rays)
    return T["p3p"]._inlier_mask(
        pt[:, :, :3], pt[:, :, 3], torch.from_numpy(rays.astype(np.float32)),
        torch.from_numpy(X.astype(np.float32)), torch.ones(n, dtype=torch.bool),
        torch.tensor(np.float32(np.cos(THR)))).numpy()


def test_scorer_counts_outside_the_band(capsys):
    P, rays, X = scorer_case(np.random.default_rng(11))
    mask = torch_mask(P, rays, X)
    counts_j = jax_counts(P, rays, X, chunk=128)
    margin = f64_margin(P, rays, X)
    band = np.abs(margin) <= 16
    in_band = band.sum(axis=1)
    # the port's decision is the float64 one outside the band
    np.testing.assert_array_equal(mask[~band], (margin > 0)[~band])
    counts_t = mask.sum(axis=1)
    np.testing.assert_array_equal(counts_t[in_band == 0],
                                  counts_j[in_band == 0])
    assert np.all(np.abs(counts_t - counts_j) <= in_band)
    # a meaningful case: counts spread, the band populated but thin
    assert counts_t.min() < 0.5 * len(rays) < counts_t.max()
    with capsys.disabled():
        print(f"\nscorer: {band.sum()} of {band.size} hypothesis-point cosines "
              f"within 16 f32 ulps of the threshold ({(in_band > 0).sum()} of "
              f"{len(P)} hypotheses hold one); counts differing from XLA's: "
              f"{(counts_t != counts_j).sum()}")
    # the whole call: the first maximum of the counts, and its mask; equal
    # to JAX's where the counts agree, its mask outside the band
    bi, bc, bm = T["p3p"]._score_hypotheses(P, rays, X, THR, chunk=128,
                                            device=CPU)
    ji, jc, jm = J["p3p"]._score_hypotheses(P, rays, X, THR, chunk=128)
    assert (bi, bc) == (int(np.argmax(counts_t)), counts_t.max())
    np.testing.assert_array_equal(bm, mask[bi])
    if (counts_t == counts_j).all():
        assert (bi, bc) == (ji, jc)
        np.testing.assert_array_equal(bm[~band[bi]], jm[~band[bi]])


@pytest.mark.parametrize("where", ["in_chunk", "across_chunks", "nan_rows"])
def test_scorer_ties_go_to_the_first(where):
    rng = np.random.default_rng(5)
    P_true = random_pose(rng)
    X = rng.normal(size=(90, 3)) + np.array([0, 0, 5.0])
    rays = rays_for(P_true, X)
    poses = np.stack([random_pose(rng) for _ in range(40)])
    best = {"in_chunk": [3, 9, 12], "across_chunks": [17, 18, 33],
            "nan_rows": [25, 39]}[where]
    for i in best:
        poses[i] = P_true
    if where == "nan_rows":
        poses[:20] = np.nan
    for chunk in (16, 2048):
        got = T["p3p"]._score_hypotheses(poses, rays, X, THR, chunk=chunk,
                                         device=CPU)
        want = J["p3p"]._score_hypotheses(poses, rays, X, THR, chunk=chunk)
        assert got[:2] == want[:2] == (best[0], 90)
        np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("case", ["outliers", "noise"])
def test_lo_ransac_matches_jax(case):
    rng = np.random.default_rng(3)
    P = random_pose(rng)
    X = rng.normal(size=(150, 3)) + np.array([0, 0, 5.0])
    rays = rays_for(P, X)
    if case == "outliers":
        bad = rng.random(150) < 0.3
        rays[bad] = rays_for(random_pose(rng), X[bad])
    else:
        rays = perturb(rng, rays, 0.08)
    got = T["p3p"].lo_ransac_p3p(rays, X, THR, iters=300, seed=4, device=CPU)
    want = J["p3p"].lo_ransac_p3p(rays, X, THR, iters=300, seed=4)
    np.testing.assert_array_equal(got.inliers, want.inliers)
    np.testing.assert_array_equal(got.P, want.P)
    assert got.num_inliers == want.num_inliers > 100
    dp, do = T["geometry"].pose_distance(P, got.P)
    assert dp < 0.02 and np.rad2deg(do) < 0.2
    # degenerate input: a NaN pose, as in JAX
    deg = T["p3p"].lo_ransac_p3p(rays[:2], X[:2], THR, device=CPU)
    assert np.isnan(deg.P).all() and deg.num_inliers == 0


# ---------------------------------------------------------------------------
# dense SIFT
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,bin_size,step", [
    ((64, 80), 8, 4), ((47, 61), 8, 4), ((50, 50), 4, 3), ((20, 20), 8, 4)])
def test_dense_sift_matches_jax(shape, bin_size, step):
    rng = np.random.default_rng(1)
    img = (rng.random(shape) * 255).astype(np.float32)
    img[5:15, 10:30] = 17.0  # flat patch: zero gradients
    got = T["dsift"].dense_sift(img, bin_size, step, device=CPU)
    want = J["dsift"].dense_sift(img, bin_size, step)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_dense_sift_matches_goldens():
    golden = np.load(os.path.join(REPO, "tests", "goldens", "activations.npz"))
    m = T["dsift"]
    desc = m.rootsift(m.dense_sift(golden["dsift_img"], device=CPU))
    np.testing.assert_allclose(desc[::3, ::3, :16], golden["dsift_desc_sample"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(desc.mean(axis=-1), golden["dsift_desc_mean"],
                               rtol=1e-4, atol=1e-5)


def test_pose_verification_score_matches_jax():
    rng = np.random.default_rng(2)
    q = rng.random((90, 120)) * 255
    s = q + rng.normal(0, 20, q.shape)
    mask = np.ones(q.shape, bool)
    mask[:, :30] = False
    mask[rng.random(q.shape) < 0.05] = False
    got = T["dsift"].pose_verification_score(q, s, mask, device=CPU)
    want = J["dsift"].pose_verification_score(q, s, mask)
    assert got == pytest.approx(want, rel=1e-5)
    assert T["dsift"].pose_verification_score(q, s, ~np.ones_like(mask),
                                              device=CPU) == 0.0


# ---------------------------------------------------------------------------
# the synthetic scene (tests/test_localization.py::TestDriver's)
# ---------------------------------------------------------------------------


def plane_scene(rng, n=320, m=400):
    """A textured plane z=5 (global coords): grid points + smooth colors."""
    from ncnet_tpu_torch.ops.image import resize_bilinear_align_corners_np

    xs = np.linspace(-2.4, 2.4, m)
    ys = np.linspace(-1.8, 1.8, n)
    gx, gy = np.meshgrid(xs, ys, indexing="xy")
    pts = np.stack([gx, gy, np.full_like(gx, 5.0)], axis=2).reshape(-1, 3)
    base = rng.random((n // 8 + 2, m // 8 + 2, 3))
    tex = resize_bilinear_align_corners_np(base.astype(np.float32), n, m)
    return pts, np.clip(tex.reshape(-1, 3) * 255, 0, 255).astype(np.uint8)


def save_query(path, img):
    """The query as PNG for JAX's PIL and as the port's raw array."""
    Image.fromarray(img).save(path, format="PNG")
    np.save(raw_path(path), img)


def write_scene(root, rng, noise_deg=0.0):
    """Scan, transformation, two cutouts (decoy first in the shortlist),
    a query rendered from the true pose, matches and reference poses.
    Returns the config's keyword arguments and the true pose."""
    g = T["geometry"]
    pts, rgb = plane_scene(rng)
    Tr = np.eye(4)
    Tr[:3, :3] = np.array([[np.cos(0.4), -np.sin(0.4), 0],
                           [np.sin(0.4), np.cos(0.4), 0], [0, 0, 1]])
    Tr[:3, 3] = [0.3, -0.2, 0.1]
    T_inv = np.linalg.inv(Tr)
    pts_local = pts @ T_inv[:3, :3].T + T_inv[:3, 3]
    os.makedirs(os.path.join(root, "DUC1", "transformations"))
    with open(os.path.join(root, "DUC1", "transformations",
                           "DUC_trans_001.txt"), "w") as f:
        f.write("synthetic WUSTL transformation\n")
        for row in Tr:
            f.write(" ".join(f"{v:.10f}" for v in row) + "\n")
    A = np.empty((1, 7), dtype=object)
    for i, col in enumerate([pts_local[:, 0], pts_local[:, 1],
                             pts_local[:, 2], np.ones(len(pts_local)),
                             rgb[:, 0], rgb[:, 1], rgb[:, 2]]):
        A[0, i] = col.reshape(-1, 1)
    os.makedirs(os.path.join(root, "scans", "DUC1"))
    savemat(os.path.join(root, "scans", "DUC1", "DUC_scan_001.ptx.mat"),
            {"A": A})
    Hdb, Wdb = 60, 80
    inv = np.linalg.inv(g.intrinsics(70.0, Hdb, Wdb))
    cols, rows = np.meshgrid(np.arange(Wdb), np.arange(Hdb), indexing="xy")
    pix = np.stack([cols, rows, np.ones_like(cols)], 2).astype(float)
    xyz_global = (pix @ inv.T) * 5.0
    xyz_local = (xyz_global.reshape(-1, 3) @ T_inv[:3, :3].T
                 + T_inv[:3, 3]).reshape(Hdb, Wdb, 3)
    os.makedirs(os.path.join(root, "cutouts", "DUC1"))
    good = "DUC1/DUC_cutout_001_0_0.jpg"
    decoy = "DUC1/DUC_cutout_001_30_0.jpg"
    for name in (good, decoy):
        savemat(os.path.join(root, "cutouts", name + ".mat"),
                {"XYZcut": xyz_local})
    P_q = np.concatenate([np.eye(3), np.array([[0.15], [0.1], [0.2]])], 1)
    qh, qw, focal = 256, 320, 300.0
    Kq = g.intrinsics(focal, qh, qw)
    query, _ = T["render"].render_points_perspective(rgb, pts, Kq @ P_q, qh,
                                                     qw)
    os.makedirs(os.path.join(root, "query"))
    save_query(os.path.join(root, "query", "q1.png"), query)
    entry = np.empty((1,), dtype=[("queryname", object), ("topNname", object)])
    entry["queryname"][0] = "q1.png"
    entry["topNname"][0] = np.array([decoy, good], dtype=object)
    savemat(os.path.join(root, "shortlist.mat"),
            {"ImgList": entry.reshape(1, -1)})
    sel = rng.choice(Hdb * Wdb, size=150, replace=False)
    r_sel, c_sel = sel // Wdb, sel % Wdb
    X = xyz_global[r_sel, c_sel]
    xy_q, depth = g.project_points(P_q, Kq, X)
    ok = ((depth > 0) & (xy_q[:, 0] > 0) & (xy_q[:, 0] < qw)
          & (xy_q[:, 1] > 0) & (xy_q[:, 1] < qh))
    X, xy_q, r_sel, c_sel = X[ok], xy_q[ok], r_sel[ok], c_sel[ok]
    if noise_deg:
        # turn each viewing ray, then move the query pixel onto it
        ray = perturb(rng, g.pixel_rays(Kq, xy_q), noise_deg)
        uvw = ray @ Kq.T
        xy_q = uvw[:, :2] / uvw[:, 2:]
    good_rows = np.zeros((len(X), 5))
    good_rows[:, 0] = xy_q[:, 0] / qw
    good_rows[:, 1] = xy_q[:, 1] / qh
    good_rows[:, 2] = (c_sel + 1.2) / Wdb
    good_rows[:, 3] = (r_sel + 1.2) / Hdb
    good_rows[:, 4] = 0.9
    junk = rng.random((len(X), 5))
    junk[:, 4] = 0.9
    table = np.zeros((1, 2, len(X), 5))
    table[0, 0] = junk
    table[0, 1] = good_rows
    os.makedirs(os.path.join(root, "matches"))
    savemat(os.path.join(root, "matches", "1.mat"), {"matches": table})
    ref = np.empty((1,), dtype=[("queryname", object), ("P", object)])
    ref["queryname"][0] = "q1.png"
    ref["P"][0] = P_q
    savemat(os.path.join(root, "refposes.mat"),
            {"DUC1_RefList": ref.reshape(1, -1),
             "DUC2_RefList": ref[:0].reshape(1, -1)})
    kw = dict(matches_dir=os.path.join(root, "matches"),
              shortlist=os.path.join(root, "shortlist.mat"),
              query_path=os.path.join(root, "query"),
              cutout_path=os.path.join(root, "cutouts"),
              scan_path=os.path.join(root, "scans"), transformation_path=root,
              refposes=os.path.join(root, "refposes.mat"),
              output_dir=os.path.join(root, "out"), pnp_topN=2,
              ransac_iters=300, query_focal_length=focal, progress=False)
    return kw, P_q


def assert_same_files(got, want):
    """Stage files equal, but for the pose-verification scores: 1 / a
    median of descriptor distances, within 1e-5 relative (the dense SIFT's
    tolerance)."""
    assert got.keys() == want.keys()
    for f in got:
        if f.endswith("_densePV.mat"):
            for g, w in zip(got[f], want[f]):
                np.testing.assert_allclose(g.pop("topNscore"),
                                           w["topNscore"], rtol=1e-5)
                assert_same(g, {k: v for k, v in w.items()
                                if k != "topNscore"})
        else:
            assert_same(got[f], want[f])


def stage_files(out_dir):
    """The run's outputs a rerun must reproduce: the stage ImgLists and the
    error files."""
    names = sorted(f for f in os.listdir(out_dir)
                   if f.endswith(".mat") or f.startswith("error_"))
    out = {}
    for f in names:
        p = os.path.join(out_dir, f)
        out[f] = (T["driver"]._load_imglist(p) if f.endswith(".mat")
                  else open(p).read())
    return out


@pytest.fixture(scope="module")
def jax_scene(tmp_path_factory):
    """The scene and the JAX package's run on it (workers 0)."""
    root = str(tmp_path_factory.mktemp("jax_scene"))
    kw, P_q = write_scene(root, np.random.default_rng(0), noise_deg=0.05)
    curves = J["driver"].run_localization(jcfg.LocalizationConfig(**kw))
    return root, kw, P_q, curves, stage_files(kw["output_dir"])


@pytest.mark.parametrize("num_workers", [0, 2])
def test_run_localization_matches_jax(jax_scene, num_workers, tmp_path):
    root, kw, P_q, j_curves, j_files = jax_scene
    kw = dict(kw, output_dir=str(tmp_path / "out"), num_workers=num_workers)
    config = tcfg.LocalizationConfig(**kw)
    curves = T["driver"].run_localization(config, device=CPU)
    assert_same(curves, j_curves)
    files = stage_files(kw["output_dir"])
    assert_same_files(stage_files(kw["output_dir"]), j_files)
    assert sorted(files) == ["error_DensePE + NCNet.txt",
                             "error_InLoc + NCNet.txt",
                             "top_2_thr075_rthr020_it300.mat",
                             "top_2_thr075_rthr020_it300_densePV.mat"]
    # densePV reranks the good cutout first; its pose is the truth's
    pv = files["top_2_thr075_rthr020_it300_densePV.mat"][0]
    assert pv["topNname"][0] == "DUC1/DUC_cutout_001_0_0.jpg"
    dp, do = T["geometry"].pose_distance(P_q, pv["P"][0])
    assert dp < 0.02 and np.rad2deg(do) < 0.2
    i_half = np.abs(T["curves"].ERROR_THRESHOLDS - 0.5).argmin()
    assert curves["DensePE + NCNet"][i_half] == 0.0
    assert curves["InLoc + NCNet"][i_half] == 1.0
    # the per-pair artifacts: keys and values JAX's
    j_pnp = os.path.join(root, "out", "top_2_PnP_thr075_rthr020_it300", "q1.png")
    t_pnp = os.path.join(kw["output_dir"], "top_2_PnP_thr075_rthr020_it300",
                         "q1.png")
    assert sorted(os.listdir(t_pnp)) == sorted(os.listdir(j_pnp))
    for f in os.listdir(t_pnp):
        a, b = loadmat(os.path.join(j_pnp, f)), loadmat(os.path.join(t_pnp, f))
        assert_same({k: v for k, v in a.items() if not k.startswith("__")},
                    {k: v for k, v in b.items() if not k.startswith("__")})
    # a rerun reloads the stage artifacts
    mtimes = {f: os.path.getmtime(os.path.join(kw["output_dir"], f))
              for f in files if f.endswith(".mat")}
    assert_same(T["driver"].run_localization(config, device=CPU), curves)
    assert mtimes == {f: os.path.getmtime(os.path.join(kw["output_dir"], f))
                      for f in mtimes}
    assert_same(stage_files(kw["output_dir"]), files)


def test_estimate_pose_and_pair_artifacts_match_jax(jax_scene, tmp_path):
    root, kw, P_q, _, _ = jax_scene
    table = loadmat(os.path.join(kw["matches_dir"], "1.mat"))["matches"]
    name = "DUC1/DUC_cutout_001_0_0.jpg"
    xyz = T["scan"].load_xyzcut(os.path.join(kw["cutout_path"], name + ".mat"))
    Tr = T["scan"].load_transformation(T["scan"].transformation_path(root,
                                                                     name))
    args = (table[0, 1], (256, 320), xyz, Tr, 300.0)
    opts = dict(ransac_iters=200, seed=5, max_tentatives=100)
    got = T["pnp"].estimate_pose_from_matches(*args, device=CPU, **opts)
    want = J["pnp"].estimate_pose_from_matches(*args, **opts)
    assert_same(tuple(got), tuple(want))
    dp, do = T["geometry"].pose_distance(P_q, got.P)
    assert dp < 0.05 and np.rad2deg(do) < 0.5
    for pkg, d in ((T, "t"), (J, "j")):
        extra = {"device": CPU} if pkg is T else {}
        P, inl = pkg["pnp"].run_pair_pnp(str(tmp_path / d), "q1.png", name,
                                         *args, **opts, **extra)
        np.testing.assert_array_equal(P, got.P)
        np.testing.assert_array_equal(inl, got.inliers)
    path = T["pnp"].pnp_artifact_path(str(tmp_path / "t"), "q1.png", name)
    a = loadmat(path)
    b = loadmat(J["pnp"].pnp_artifact_path(str(tmp_path / "j"), "q1.png",
                                           name))
    assert sorted(k for k in a if not k.startswith("__")) == [
        "P", "idx_3d", "inls", "tentatives_2d", "tentatives_3d"]
    assert_same({k: v for k, v in a.items() if not k.startswith("__")},
                {k: v for k, v in b.items() if not k.startswith("__")})
    # the artifact is reloaded, not recomputed
    mtime = os.path.getmtime(path)
    P2, _ = T["pnp"].run_pair_pnp(str(tmp_path / "t"), "q1.png", name, *args,
                                  device=CPU, **opts)
    assert os.path.getmtime(path) == mtime
    np.testing.assert_array_equal(P2, got.P)


def test_run_pose_verification_matches_jax(jax_scene, tmp_path):
    root, kw, P_q, _, _ = jax_scene
    query = np.load(raw_path(os.path.join(kw["query_path"], "q1.png")))
    wrong = np.concatenate([rot_y(np.deg2rad(10)), [[0.6], [0.0], [0.0]]], 1)
    items = [("q1.png", "DUC1/DUC_cutout_001_30_0.jpg", wrong),
             ("q1.png", "DUC1/DUC_cutout_001_0_0.jpg", P_q),
             ("q1.png", "DUC1/DUC_cutout_001_60_0.jpg", np.full((3, 4), np.nan))]
    scores = []
    for pkg, d in ((T, "t"), (J, "j")):
        extra = {"device": CPU} if pkg is T else {}
        scores.append(pkg["verification"].run_pose_verification(
            [pkg["verification"].PVItem(*it) for it in items],
            lambda fn: query, kw["scan_path"], root,
            lambda fn, img: 300.0, out_dir=str(tmp_path / d), progress=False,
            **extra))
    assert scores[0].keys() == scores[1].keys()
    for k in scores[0]:
        assert scores[0][k] == pytest.approx(scores[1][k], rel=1e-5)
    s = [scores[0][(q, d)] for q, d, _ in items]
    assert s[1] > s[0] > 0 and s[2] == 0.0
    names, _, ranked = T["verification"].rerank_by_scores(
        [d for _, d, _ in items], [P for _, _, P in items], s)
    assert names[0] == "DUC1/DUC_cutout_001_0_0.jpg"
    assert ranked == sorted(ranked, reverse=True)


# ---------------------------------------------------------------------------
# composition with the port's InLoc matcher, the CLI, the device rule
# ---------------------------------------------------------------------------


def test_inloc_eval_feeds_localization(tmp_path):
    """The port's ``run_inloc_eval`` tables go straight into the port's
    ``run_localization`` (schema, folder naming, shortlist format,
    cutout-name parsing), and the JAX stage reads the same tables to the
    same ImgLists.  Pose quality is not asserted: the matcher is a random
    tiny trunk."""
    from ncnet_tpu_torch.config import EvalInLocConfig, ModelConfig
    from ncnet_tpu_torch.data.synthetic import write_inloc_like
    from ncnet_tpu_torch.evaluation.inloc import run_inloc_eval
    from ncnet_tpu_torch.models.ncnet import init_ncnet

    root = str(tmp_path)
    shortlist = write_inloc_like(root, n_queries=1, n_panos=2,
                                 image_hw=(96, 128))
    # the query also as PNG bytes for JAX's PIL, from the same array
    qpath = os.path.join(root, "query", "iphone7", "query_0.jpg")
    Image.fromarray(np.load(raw_path(qpath))).save(qpath, format="PNG")
    model_config = ModelConfig(backbone="tiny", ncons_kernel_sizes=(3,),
                               ncons_channels=(1,), half_precision=True,
                               relocalization_k_size=2)
    matches_dir = run_inloc_eval(
        EvalInLocConfig(inloc_shortlist=shortlist, k_size=2, image_size=128,
                        n_queries=1, n_panos=2,
                        pano_path=os.path.join(root, "pano"),
                        query_path=os.path.join(root, "query", "iphone7"),
                        output_root=os.path.join(root, "matches")),
        model_config=model_config, params=init_ncnet(model_config, seed=0),
        progress=False, device=CPU)
    H, W = 96, 128
    gx, gy = np.meshgrid(np.arange(W), np.arange(H), indexing="xy")
    xyzcut = np.stack([gx / 40.0, gy / 40.0, np.full((H, W), 5.0)], axis=2)
    for p in (0, 30):
        savemat(os.path.join(root, "pano", "DUC1",
                             f"DUC_cutout_000_{p}_0.jpg.mat"),
                {"XYZcut": xyzcut})
    os.makedirs(os.path.join(root, "DUC1", "transformations"))
    with open(os.path.join(root, "DUC1", "transformations",
                           "DUC_trans_000.txt"), "w") as f:
        f.write("synthetic\n")
        for row in np.eye(4):
            f.write(" ".join(str(v) for v in row) + "\n")
    pts = xyzcut.reshape(-1, 3)
    A = np.empty((1, 7), dtype=object)
    for i, col in enumerate([pts[:, 0], pts[:, 1], pts[:, 2],
                             np.ones(len(pts)), np.full(len(pts), 100.0),
                             np.full(len(pts), 120.0),
                             np.full(len(pts), 140.0)]):
        A[0, i] = col.reshape(-1, 1)
    os.makedirs(os.path.join(root, "scans", "DUC1"))
    savemat(os.path.join(root, "scans", "DUC1", "DUC_scan_000.ptx.mat"),
            {"A": A})
    ref = np.empty((1,), dtype=[("queryname", object), ("P", object)])
    ref["queryname"][0] = "query_0.jpg"
    ref["P"][0] = np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)
    savemat(os.path.join(root, "refposes.mat"),
            {"DUC1_RefList": ref.reshape(1, -1),
             "DUC2_RefList": ref[:0].reshape(1, -1)})
    kw = dict(matches_dir=matches_dir, shortlist=shortlist,
              query_path=os.path.join(root, "query", "iphone7"),
              cutout_path=os.path.join(root, "pano"),
              scan_path=os.path.join(root, "scans"), transformation_path=root,
              refposes=os.path.join(root, "refposes.mat"), pnp_topN=2,
              ransac_iters=200, query_focal_length=100.0,
              match_score_thr=0.0, progress=False)
    curves = T["driver"].run_localization(tcfg.LocalizationConfig(
        output_dir=os.path.join(root, "out_t"), **kw), device=CPU)
    assert set(curves) == {"DensePE + NCNet", "InLoc + NCNet"}
    lines = open(os.path.join(root, "out_t", "error_DensePE + NCNet.txt")
                 ).read().splitlines()
    assert len(lines) == 1 and lines[0].startswith("query_0.jpg ")
    j_curves = J["driver"].run_localization(jcfg.LocalizationConfig(
        output_dir=os.path.join(root, "out_j"), **kw))
    assert_same(curves, j_curves)
    assert_same_files(stage_files(os.path.join(root, "out_t")),
                      stage_files(os.path.join(root, "out_j")))


def test_retrieval_ordered_mat_pairs_rows_with_their_cutouts(tmp_path):
    """ROADMAP C4: a ``.mat`` written under the retrieval shortlist holds
    its ``matches`` rows in retrieval order and records it as
    ``shortlist``.  Here the true cutout's rows come first, retrieval
    having moved it ahead of the decoy that leads the DensePE row, and the
    decoy's ``XYZcut`` is the scene moved 0.5 m.  The port reads the
    names from ``shortlist``: the true cutout's rows go through its own
    ``XYZcut`` and its pose is the truth.  The JAX driver pairs row 0 with
    the DensePE row's first name, the decoy: the same rows lift through
    the decoy's points to a pose 0.5 m off, and the true cutout gets the
    junk rows.  The difference is the reference's fault; it stays
    visible here."""
    root = str(tmp_path)
    kw, P_q = write_scene(root, np.random.default_rng(0))
    good = "DUC1/DUC_cutout_001_0_0.jpg"
    decoy = "DUC1/DUC_cutout_001_30_0.jpg"
    cut = os.path.join(root, "cutouts")
    xyz = loadmat(os.path.join(cut, good + ".mat"))["XYZcut"]
    savemat(os.path.join(cut, decoy + ".mat"),
            {"XYZcut": xyz + np.array([0.5, 0.0, 0.0])})
    mat = loadmat(os.path.join(root, "matches", "1.mat"))
    table = mat["matches"][:, ::-1]  # the good rows first, then the junk
    savemat(os.path.join(root, "matches", "1.mat"),
            {"matches": table, "shortlist": np.asarray(
                [[good], [decoy]], dtype=object),
             "retrieval_coverage": 1.0})
    t_list = T["driver"].run_pnp_stage(
        tcfg.LocalizationConfig(**dict(kw, output_dir=str(tmp_path / "t"))),
        device=CPU)
    j_list = J["driver"].run_pnp_stage(
        jcfg.LocalizationConfig(**dict(kw, output_dir=str(tmp_path / "j"))))
    assert t_list[0]["topNname"] == [good, decoy]
    dp, do = T["geometry"].pose_distance(P_q, t_list[0]["P"][0])
    assert dp < 0.02 and np.rad2deg(do) < 0.2
    # the JAX driver: the DensePE order, the good rows under the decoy
    assert list(j_list[0]["topNname"]) == [decoy, good]
    dp_j, _ = T["geometry"].pose_distance(P_q, j_list[0]["P"][0])
    assert dp_j > 0.3
    assert not np.all(np.isfinite(j_list[0]["P"][1])) or \
        T["geometry"].pose_distance(P_q, j_list[0]["P"][1])[0] > 0.3


def test_curves_without_matplotlib(jax_scene, tmp_path, monkeypatch, capsys):
    """Without matplotlib the curves and the error files are written as
    JAX writes them, and a warning names the figure not drawn."""
    root, kw, P_q, _, _ = jax_scene
    refposes = T["curves"].load_reference_poses(kw["refposes"])
    P = P_q.copy()
    P[:, 3] += 0.3
    args = ([T["curves"].MethodResult("m", {"q1.png": ("DUC1/a.jpg", P)})],
            refposes)
    want = J["curves"].plot_localization_curves(
        [J["curves"].MethodResult("m", {"q1.png": ("DUC1/a.jpg", P)})],
        refposes, str(tmp_path / "j"))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    got = T["curves"].plot_localization_curves(*args, str(tmp_path / "t"))
    assert_same(got, want)
    assert sorted(os.listdir(tmp_path / "t")) == ["error_m.txt"]
    assert (tmp_path / "t" / "error_m.txt").read_text() == \
        (tmp_path / "j" / "error_m.txt").read_text()
    out = capsys.readouterr().out
    assert "matplotlib is not installed" in out and "athr10.0000_1.png" in out


def test_cli_flags_match_jax():
    def actions(parser):
        return {a.dest: (a.option_strings, a.default, a.type, a.required,
                         a.help) for a in parser._actions}

    got, want = actions(tcli.build_parser()), actions(jcli.build_parser())
    device = got.pop("device")
    assert device[:4] == (["--device"], "cuda", str, False)
    # the boolean parser is the port's copy of the JAX one
    for d in ("do_densePV", "quarantine"):
        assert got[d][2].__module__ == "ncnet_tpu_torch.cli.common"
        assert want[d][2].__module__ == "ncnet_tpu.cli.common"
        got[d] = got[d][:2] + got[d][3:]
        want[d] = want[d][:2] + want[d][3:]
    assert got == want


def test_cli_runs_and_exits_2_when_degraded(jax_scene, tmp_path):
    root, kw, _, _, j_files = jax_scene
    argv = ["--matches_dir", kw["matches_dir"], "--shortlist", kw["shortlist"],
            "--query_path", kw["query_path"], "--cutout_path",
            kw["cutout_path"], "--scan_path", kw["scan_path"],
            "--transformation_path", root, "--refposes", kw["refposes"],
            "--pnp_topN", "2", "--ransac_iters", "300",
            "--query_focal_length", "300", "--device", "cpu",
            "--retry_backoff_s", "0"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tcli.main(argv + ["--output_dir", str(tmp_path / "ok")])
    assert rc == 0
    assert "InLoc + NCNet: localized @0.5m 100.0%" in out.getvalue()
    assert_same_files(stage_files(str(tmp_path / "ok")), j_files)
    # a corrupted matches .mat: the query is quarantined, the CLI exits 2
    bad = tmp_path / "bad_matches"
    bad.mkdir()
    (bad / "1.mat").write_bytes(b"not a mat file")
    argv[1] = str(bad)
    with contextlib.redirect_stdout(io.StringIO()):
        rc = tcli.main(argv + ["--output_dir", str(tmp_path / "bad")])
    assert rc == 2
    manifest = tmp_path / "bad" / "top_2_PnP_thr075_rthr020_it300" / \
        "manifest.json"
    from ncnet_tpu_torch.evaluation.resilience import RunManifest

    assert RunManifest(str(manifest)).quarantined_ids == ("q1.png",)
    assert not (tmp_path / "bad" / "top_2_thr075_rthr020_it300.mat").exists()


def test_entry_points_need_the_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the card is here: the default device is CUDA")
    rng = np.random.default_rng(0)
    X = rng.normal(size=(10, 3)) + np.array([0, 0, 5.0])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T["p3p"].lo_ransac_p3p(rays_for(random_pose(rng), X), X, THR)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T["dsift"].dense_sift(rng.random((40, 40)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T["driver"].run_localization(tcfg.LocalizationConfig(
            output_dir=str(tmp_path)))
    assert tcli.build_parser().parse_args(["--matches_dir", "m"]).device == \
        "cuda"
