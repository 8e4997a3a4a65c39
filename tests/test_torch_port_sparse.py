"""The port's coarse-to-fine pipeline against the JAX package on the CPU.

Selection (``ops/sparse_topk.py``), the dense readout
(``ops/matching.py::scatter_sparse_scores``), the gathered tiles and their
B4 twin (``ops/sparse_corr.py``) and the pipeline through
``ncnet_match_volume``, on the same seeded numpy inputs and weights.

Tolerances:
  * selection, indices, masks and scatters: equal;
  * f32 tiles: rtol 1e-5 with an absolute floor of 1e-5 of the largest
    output (f32 sums of C terms in another order; a near-cancelling sum
    keeps the terms' absolute rounding, not its own relative one);
  * bf16 tiles: within one bf16 ulp of the largest output (both sides sum
    in f32 and round once; a sum near a rounding boundary may land one ulp
    apart);
  * f32 filtered volumes: atol 1e-5, rtol 1e-4, the JAX suite's own
    (tests/test_sparse_corr.py);
  * bf16 filtered volumes: normalized atol 3e-2, the tolerance of
    test_torch_port_model.py::test_bf16_forward_matches_jax.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ncnet_tpu import config as jcfg
from ncnet_tpu.models import ncnet as jnet
from ncnet_tpu.ops import matching as jm
from ncnet_tpu_torch import config as tcfg
from ncnet_tpu_torch.models import ncnet as tnet
from ncnet_tpu_torch.models.convert import params_from_numpy
from ncnet_tpu_torch.ops import matching as tm
from ncnet_tpu_torch.ops import nc_fused_lane
from ncnet_tpu_torch.ops import sparse_corr as tsc
from ncnet_tpu_torch.ops import sparse_topk as tst

jsc = importlib.import_module("ncnet_tpu.ops.sparse_corr")
jst = importlib.import_module("ncnet_tpu.ops.sparse_topk")

VOLUME = dict(atol=1e-5, rtol=1e-4)


def normal_features(seed, b, h, w, c):
    """L2-normalized random features, float32 numpy."""
    f = np.random.default_rng(seed).normal(size=(b, h, w, c)).astype(np.float32)
    return f / np.sqrt((f * f).sum(-1, keepdims=True) + 1e-6)


def nc_weights(kernels, channels, seed=1):
    """Numpy NC weights with the reference Conv4d init's scale."""
    rng = np.random.default_rng(seed)
    nc, c_in = [], 1
    for k, c_out in zip(kernels, channels):
        bound = 1.0 / np.sqrt(c_in * k ** 4)
        nc.append({"w": rng.uniform(-bound, bound, (k,) * 4 + (c_in, c_out)
                                    ).astype(np.float32),
                   "b": rng.uniform(-bound, bound, (c_out,)).astype(np.float32)})
        c_in = c_out
    return nc


def both_params(nc):
    jp = {"nc": [{k: jnp.asarray(v) for k, v in layer.items()} for layer in nc]}
    return jp, params_from_numpy({"nc": nc})


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_f32_tiles_close(got, want):
    got, want = to_np(got), to_np(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def bf16_ulp(x):
    """One bf16 ulp at magnitude ``x`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def assert_within_one_ulp(got, want):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= bf16_ulp(np.abs(want).max())


def assert_normalized_close(got, want, atol):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape
    scale = max(1e-6, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


# ---------------------------------------------------------------------------
# selection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("renormalize", [True, False])
def test_pool_features_matches_jax(dtype, renormalize):
    f = np.random.default_rng(0).normal(size=(2, 8, 6, 5)).astype(np.float32)
    want = jst.pool_features(jnp.asarray(f).astype(dtype), 2, renormalize)
    got = tst.pool_features(torch.from_numpy(f).to(getattr(torch, dtype)), 2,
                            renormalize)
    assert str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_array_equal(to_np(got), to_np(want)) if dtype == "bfloat16" \
        else np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-6, atol=1e-7)


def _tied_volume():
    """A filtered-coarse-like volume: mostly exact zeros (ties), a few
    distinct positives and repeated positives."""
    rng = np.random.default_rng(3)
    v = np.zeros((2, 3, 3, 3, 4), np.float32)
    mask = rng.uniform(size=v.shape) < 0.3
    v[mask] = rng.integers(1, 4, mask.sum()).astype(np.float32) * 0.25
    return v


@pytest.mark.parametrize("volume,k", [
    (np.random.default_rng(1).normal(size=(1, 3, 3, 2, 2)).astype(np.float32), 3),
    (np.random.default_rng(1).normal(size=(1, 3, 3, 2, 2)).astype(np.float32), 7),
    (_tied_volume(), 5),
    (_tied_volume(), 12),
    (np.zeros((1, 2, 2, 2, 2), np.float32), 3),
])
def test_topk_candidates_matches_jax(volume, k):
    """Best first, ties (exact zeros, repeated values) in index order as
    ``lax.top_k`` gives them, k beyond the grid padded with the top-1."""
    want = np.asarray(jst.topk_candidates(jnp.asarray(volume), k))
    got = tst.topk_candidates(torch.from_numpy(volume), k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    bf = tst.topk_candidates(torch.from_numpy(volume).to(torch.bfloat16), k)
    np.testing.assert_array_equal(
        bf.numpy(), np.asarray(jst.topk_candidates(
            jnp.asarray(volume).astype(jnp.bfloat16), k)))


@pytest.mark.parametrize("n_coarse,factor,patch,length", [
    (6, 2, 6, 12), (4, 2, 8, 8), (5, 3, 7, 15), (3, 2, 2, 6)])
def test_origins_match_jax(n_coarse, factor, patch, length):
    np.testing.assert_array_equal(
        tst.block_origins(n_coarse, factor, patch, length),
        jst.block_origins(n_coarse, factor, patch, length))
    cand = np.random.default_rng(2).integers(
        0, n_coarse * n_coarse, (2, 5, 3)).astype(np.int32)
    want = jst.candidate_origins(jnp.asarray(cand), n_coarse, factor, patch,
                                 length, length)
    got = tst.candidate_origins(torch.from_numpy(cand), n_coarse, factor,
                                patch, length, length)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("ha,wa,factor,halo", [(8, 8, 2, 2), (8, 6, 2, 2),
                                               (12, 10, 2, 3)])
def test_source_index_and_core_mask_match_jax(ha, wa, factor, halo):
    patch = tst.patch_side(factor, halo)
    want = jsc.source_patch_index(ha, wa, factor, patch)
    got = tsc.source_patch_index(ha, wa, factor, patch)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    hb, wb = wa, ha
    wc = wb // factor
    n = (ha // factor) * (wa // factor)
    cand = np.random.default_rng(4).integers(
        0, (hb // factor) * wc, (2, n, 3)).astype(np.int32)
    oi, oj = jst.candidate_origins(jnp.asarray(cand), wc, factor, patch, hb, wb)
    rngp = jnp.arange(patch, dtype=jnp.int32)
    jt = jsc.SparseTiles(None, jnp.asarray(want[0]), jnp.asarray(want[1]),
                         oi[..., None] + rngp, oj[..., None] + rngp)
    tt = tsc.SparseTiles(None, *(torch.from_numpy(np.array(x))
                                 for x in jt[1:]))
    np.testing.assert_array_equal(
        tsc.core_mask(tt, torch.from_numpy(cand), wc, wa // factor, factor).numpy(),
        np.asarray(jsc.core_mask(jt, jnp.asarray(cand), wc, wa // factor, factor)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scatter_sparse_scores_matches_jax(dtype):
    rng = np.random.default_rng(5)
    b, s, factor, halo, k = 2, 8, 2, 2, 3
    patch = tst.patch_side(factor, halo)
    ia, ja = tsc.source_patch_index(s, s, factor, patch)
    n = ia.shape[0]
    cand = rng.integers(0, (s // factor) ** 2, (b, n, k)).astype(np.int32)
    oi, oj = (np.asarray(x) for x in jst.candidate_origins(
        jnp.asarray(cand), s // factor, factor, patch, s, s))
    ib, jb = oi[..., None] + np.arange(patch), oj[..., None] + np.arange(patch)
    values = np.maximum(rng.normal(size=(b, n, k) + (patch,) * 4), 0).astype(np.float32)
    want = jm.scatter_sparse_scores(jnp.asarray(values).astype(dtype), ia, ja,
                                    jnp.asarray(ib), jnp.asarray(jb), (s,) * 4)
    got = tm.scatter_sparse_scores(
        torch.from_numpy(values).to(getattr(torch, dtype)), torch.from_numpy(ia),
        torch.from_numpy(ja), torch.from_numpy(ib), torch.from_numpy(jb), (s,) * 4)
    assert str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_array_equal(to_np(got), to_np(want))


def test_scatter_sparse_scores_duplicates_resolve_by_max():
    """The semantics of tests/test_sparse_corr.py:263: two tiles on one
    cell keep the larger value, untouched cells stay zero."""
    values = torch.tensor([1.0, 3.0]).reshape(1, 1, 2, 1, 1, 1, 1)
    ia, ja = torch.tensor([[2]]), torch.tensor([[1]])
    ib = torch.tensor([[[[0], [0]]]])
    jb = torch.tensor([[[[3], [3]]]])
    out = tm.scatter_sparse_scores(values, ia, ja, ib, jb, (4, 4, 4, 4))
    assert out.shape == (1, 4, 4, 4, 4)
    assert out[0, 2, 1, 0, 3] == 3.0
    assert int(torch.count_nonzero(out)) == 1


# ---------------------------------------------------------------------------
# B4 and its twin
# ---------------------------------------------------------------------------

# (batch, fine side, channels, factor, halo, candidates)
GATHER_CASES = [(2, 8, 16, 2, 2, 3), (1, 10, 12, 2, 2, 2), (2, 12, 24, 2, 2, 4)]


def _gather_inputs(b, s, c, factor, halo, k, dtype, seed=6):
    rng = np.random.default_rng(seed)
    fa = rng.normal(size=(b, s, s, c)).astype(np.float32)
    fb = rng.normal(size=(b, s, s, c)).astype(np.float32)
    cand = rng.integers(0, (s // factor) ** 2, (b, (s // factor) ** 2, k)
                        ).astype(np.int32)
    return ((jnp.asarray(fa).astype(dtype), jnp.asarray(fb).astype(dtype)),
            (torch.from_numpy(fa).to(getattr(torch, dtype)),
             torch.from_numpy(fb).to(getattr(torch, dtype))), cand)


def _pallas_args(fa, fb, cand, factor, halo, lib):
    """(fa_p2, fb, row_blocks, col_starts, patch) as sparse_fine_corr
    builds them, in ``lib``'s arrays."""
    b, s, _, c = fa.shape
    patch = tst.patch_side(factor, halo)
    ia, ja = tsc.source_patch_index(s, s, factor, patch)
    n = ia.shape[0]
    if lib is torch:
        oi, oj = tst.candidate_origins(torch.from_numpy(cand), s // factor,
                                       factor, patch, s, s)
        fa_p2 = tsc.gather_source_patches(fa, ia, ja).reshape(b, n, patch * patch, c)
        return fa_p2, fb, torch.div(oi, factor, rounding_mode="floor"), oj, patch
    oi, oj = jst.candidate_origins(jnp.asarray(cand), s // factor, factor,
                                   patch, s, s)
    fa_p2 = jsc.gather_source_patches(fa, ia, ja).reshape(b, n, patch * patch, c)
    return fa_p2, fb, oi // factor, oj, patch


@pytest.mark.parametrize("case", GATHER_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_b4_twin_matches_jax_kernel_and_xla_tier(case, dtype):
    """The twin against the JAX Pallas kernel in interpret mode and against
    the XLA tier, on the kernel's own arguments; the CPU call launches
    nothing."""
    b, s, c, factor, halo, k = case
    (jfa, jfb), (tfa, tfb), cand = _gather_inputs(*case, dtype)
    *jargs, patch = _pallas_args(jfa, jfb, cand, factor, halo, jnp)
    *targs, _ = _pallas_args(tfa, tfb, cand, factor, halo, torch)
    before = tsc.launches
    got = tsc.gather_tile_corr_pallas(*targs, patch=patch, factor=factor)
    assert tsc.launches == before
    assert got.shape == (b, (s // factor) ** 2, k, patch * patch, patch * patch)
    assert str(got.dtype) == f"torch.{dtype}"
    want_kernel = jsc.gather_tile_corr_pallas(*jargs, patch=patch, factor=factor,
                                              interpret=True)
    want_xla = jsc.sparse_fine_corr(jfa, jfb, jnp.asarray(cand), factor=factor,
                                    halo=halo).values
    for want in (want_kernel, np.asarray(want_xla.astype(jnp.float32)).reshape(got.shape)):
        if dtype == "float32":
            assert_f32_tiles_close(got, want)
        else:
            assert_within_one_ulp(got, want)


@pytest.mark.parametrize("row, col", [(-1, 0), (0, -1), (4, 0), (0, 5)])
def test_b4_rejects_a_window_outside_fb(row, col):
    """A candidate window that leaves fb is a caller's bug: the wrapper
    raises on the CPU instead of gathering from elsewhere."""
    (_, _), (tfa, tfb), cand = _gather_inputs(1, 8, 8, 2, 2, 2, "float32")
    fa_p2, fb, rows, cols, patch = _pallas_args(tfa, tfb, cand, 2, 2, torch)
    rows, cols = rows.clone(), cols.clone()
    rows[0, 0, 0], cols[0, 0, 0] = row, col  # a 6 x 6 window of 8 x 8
    with pytest.raises(ValueError, match="outside fb"):
        tsc.gather_tile_corr_pallas(fa_p2, fb, rows, cols, patch=patch, factor=2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_halo3_tiles_match_jax_xla_tier(dtype):
    """Halo 3 with factor 2 (patch 8, origins off the factor's grid): the
    JAX package runs its XLA tier there, the port's bf16 path its kernel
    (the twin here) with the origin rows themselves."""
    factor, halo = 2, 3
    (jfa, jfb), (tfa, tfb), cand = _gather_inputs(2, 12, 12, factor, halo, 3,
                                                  dtype, seed=7)
    want = jsc.sparse_fine_corr(jfa, jfb, jnp.asarray(cand), factor=factor,
                                halo=halo)
    got = tsc.sparse_fine_corr(tfa, tfb, torch.from_numpy(cand), factor=factor,
                               halo=halo)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if dtype == "float32":
        assert_f32_tiles_close(got.values, want.values)
    else:
        assert_within_one_ulp(got.values, want.values)


def test_sparse_mutual_matching_and_refine_match_jax():
    b, s, c, factor, halo, k = 2, 8, 16, 2, 2, 3
    fa, fb = normal_features(8, b, s, s, c), normal_features(9, b, s, s, c)
    cand = np.random.default_rng(10).integers(0, 16, (b, 16, k)).astype(np.int32)
    jt = jsc.sparse_fine_corr(jnp.asarray(fa), jnp.asarray(fb), jnp.asarray(cand),
                              factor=factor, halo=halo)
    tt = tsc.sparse_fine_corr(torch.from_numpy(fa), torch.from_numpy(fb),
                              torch.from_numpy(cand), factor=factor, halo=halo)
    jg = jsc.sparse_mutual_matching(jt, grid_a=(s, s), grid_b=(s, s))
    tg = tsc.sparse_mutual_matching(tt, grid_a=(s, s), grid_b=(s, s))
    assert_f32_tiles_close(tg.values, jg.values)

    nc = nc_weights((3, 3), (4, 1))
    jp, tp = both_params(nc)
    want = jsc.sparse_refine(
        jnp.asarray(fa), jnp.asarray(fb), jnp.asarray(cand), factor=factor,
        halo=halo, stack_fn=lambda v: jnet.neigh_consensus(jp["nc"], v))
    got = tsc.sparse_refine(
        torch.from_numpy(fa), torch.from_numpy(fb), torch.from_numpy(cand),
        factor=factor, halo=halo,
        stack_fn=lambda v: tnet.neigh_consensus(tp["nc"], v))
    np.testing.assert_allclose(to_np(got), to_np(want), **VOLUME)


# ---------------------------------------------------------------------------
# the pipeline through ncnet_match_volume
# ---------------------------------------------------------------------------


def configs(**kw):
    return jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)


def match_volumes(cfg_kw, sparse_kw, fa, fb, nc, dtype=None):
    """(port sparse, port dense, JAX sparse) volumes of one fixture."""
    jc, tc = configs(backbone="tiny", **cfg_kw)
    jp, tp = both_params(nc)
    jfa, jfb = jnp.asarray(fa), jnp.asarray(fb)
    tfa, tfb = torch.from_numpy(fa), torch.from_numpy(fb)
    if dtype is not None:
        jfa, jfb = jfa.astype(dtype), jfb.astype(dtype)
        tfa, tfb = tfa.to(getattr(torch, dtype)), tfb.to(getattr(torch, dtype))
    with torch.no_grad():
        sparse = tnet.ncnet_match_volume(tc.replace(**sparse_kw), tp, tfa, tfb).corr
        dense = tnet.ncnet_match_volume(tc, tp, tfa, tfb).corr
    want = jnet.ncnet_match_volume(jc.replace(**sparse_kw), jp, jfa, jfb).corr
    return sparse, dense, want


def test_k_full_reproduces_dense_and_jax():
    fa, fb = normal_features(11, 2, 8, 8, 16), normal_features(12, 2, 8, 8, 16)
    before = (tsc.launches, nc_fused_lane.launches)
    sparse, dense, want = match_volumes(
        dict(ncons_kernel_sizes=(3, 3), ncons_channels=(4, 1)),
        dict(sparse_topk=16, sparse_factor=2, sparse_halo=2),
        fa, fb, nc_weights((3, 3), (4, 1)))
    assert (tsc.launches, nc_fused_lane.launches) == before
    assert sparse.shape == dense.shape == (2, 8, 8, 8, 8)
    np.testing.assert_allclose(to_np(sparse), to_np(dense), **VOLUME)
    np.testing.assert_allclose(to_np(sparse), to_np(want), **VOLUME)


def test_k_full_rectangular_and_asymmetric():
    """Rectangular grids and symmetric_mode=False: the role-swapped family's
    conjugated stack."""
    fa, fb = normal_features(13, 1, 8, 6, 12), normal_features(14, 1, 6, 8, 12)
    sparse, dense, want = match_volumes(
        dict(ncons_kernel_sizes=(3,), ncons_channels=(1,), symmetric_mode=False),
        dict(sparse_topk=12, sparse_factor=2, sparse_halo=2),
        fa, fb, nc_weights((3,), (1,)))
    np.testing.assert_allclose(to_np(sparse), to_np(dense), **VOLUME)
    np.testing.assert_allclose(to_np(sparse), to_np(want), **VOLUME)


def _delta_fixture():
    s = 8
    eye = np.eye(s * s, dtype=np.float32).reshape(1, s, s, s * s)
    w = np.zeros((3, 3, 3, 3, 1, 1), np.float32)
    w[1, 1, 1, 1, 0, 0] = 0.7
    return eye, [{"w": w, "b": np.zeros((1,), np.float32)}]


def _tables(corr):
    """Both directions' match tables of a volume, numpy."""
    corr = corr.to(torch.float32)
    rows = []
    for inv in (False, True):
        m = tm.corr_to_matches(corr, invert_matching_direction=inv)
        rows.append(np.stack([v.to(torch.float32).numpy() for v in m], axis=1))
    return np.concatenate(rows, axis=2)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_delta_fixture_tables_row_for_row(dtype):
    """One-hot features and a centre-tap stack at k = 2 (coverage provably
    holds): the port's sparse tables equal its dense tables row for row,
    and its volume equals the JAX sparse volume."""
    eye, nc = _delta_fixture()
    sparse, dense, want = match_volumes(
        dict(ncons_kernel_sizes=(3,), ncons_channels=(1,),
             half_precision=dtype is not None),
        dict(sparse_topk=2, sparse_factor=2, sparse_halo=2), eye, eye, nc, dtype)
    td, ts = _tables(dense), _tables(sparse)
    np.testing.assert_array_equal(ts[:, :4], td[:, :4])
    np.testing.assert_allclose(ts[:, 4], td[:, 4], atol=1e-6)
    np.testing.assert_array_equal(to_np(sparse), to_np(want))


def test_k1_support_bound():
    b, s, factor = 1, 8, 2
    fa, fb = normal_features(15, b, s, s, 8), normal_features(16, b, s, s, 8)
    sparse, dense, want = match_volumes(
        dict(ncons_kernel_sizes=(3,), ncons_channels=(1,)),
        dict(sparse_topk=1, sparse_factor=factor, sparse_halo=2),
        fa, fb, nc_weights((3,), (1,)))
    assert sparse.shape == dense.shape == (b, s, s, s, s)
    bound = 2 * (s // factor) ** 2 * factor ** 4
    assert int(torch.count_nonzero(sparse)) <= bound
    np.testing.assert_allclose(to_np(sparse), to_np(want), **VOLUME)


def test_bf16_k_full_matches_jax():
    fa, fb = normal_features(17, 2, 8, 8, 16), normal_features(18, 2, 8, 8, 16)
    before = (tsc.launches, nc_fused_lane.launches)
    sparse, dense, want = match_volumes(
        dict(ncons_kernel_sizes=(3, 3), ncons_channels=(4, 1), half_precision=True),
        dict(sparse_topk=16, sparse_factor=2, sparse_halo=2),
        fa, fb, nc_weights((3, 3), (4, 1)), "bfloat16")
    assert (tsc.launches, nc_fused_lane.launches) == before  # twins on the CPU
    assert sparse.dtype == torch.bfloat16
    assert_normalized_close(sparse, want, atol=3e-2)
    assert_normalized_close(sparse, dense, atol=3e-2)


def test_pipeline_choice_matches_jax():
    cases = [(8, 8, 8, 8, 2, 2, 2, 0), (8, 8, 8, 8, 0, 2, 2, 0),
             (8, 8, 8, 8, 2, 2, 2, 2), (9, 8, 8, 8, 2, 2, 2, 0),
             (4, 4, 4, 4, 2, 2, 2, 0), (6, 6, 6, 6, 1, 2, 3, 0),
             (8, 8, 8, 8, 3, 1, 2, 0)]
    for ha, wa, hb, wb, k, factor, halo, reloc in cases:
        kw = dict(factor=factor, halo=halo, reloc_k=reloc)
        assert (tsc.coarse2fine_feasible(ha, wa, hb, wb, sparse_topk=k, **kw)
                == jsc.coarse2fine_feasible(ha, wa, hb, wb, sparse_topk=k, **kw))
        want = "coarse2fine" if jsc.coarse2fine_feasible(
            ha, wa, hb, wb, sparse_topk=k, **kw) else None
        assert tsc.choose_match_pipeline(ha, wa, hb, wb, sparse_topk=k, **kw) == want
        for radius in (-1, 0, 2):
            assert (tsc.tracking_feasible(ha, wa, hb, wb, radius=radius, **kw)
                    == jsc.tracking_feasible(ha, wa, hb, wb, radius=radius, **kw))


def test_candidate_recall_matches_jax():
    fa, fb = normal_features(19, 1, 8, 8, 24), normal_features(20, 1, 8, 8, 24)
    raw = np.einsum("bijc,bklc->bijkl", fa, fb)
    for k in (1, 4, 16):
        cand = tst.topk_candidates(torch.from_numpy(
            raw.reshape(1, 4, 2, 4, 2, 4, 2, 4, 2).mean(axis=(2, 4, 6, 8))), k)
        assert tst.candidate_recall(cand, torch.from_numpy(raw), 2) == \
            jst.candidate_recall(cand.numpy(), raw, 2)


@pytest.mark.parametrize("entry", ["matcher", "ncnet"])
def test_sparse_entry_points_match_jax(entry):
    """``make_point_matcher`` and ``NCNet`` with ``sparse_topk=4`` on the
    CPU against the JAX package's, same weights (identity-peaked NC
    kernel; the target is its source rolled by one coarse cell)."""
    kw = dict(backbone="tiny", ncons_kernel_sizes=(3,), ncons_channels=(1,),
              sparse_topk=4)
    jc, tc = configs(**kw)
    jp = jnet.init_ncnet(jc, jax.random.key(3))
    w = np.zeros((3, 3, 3, 3, 1, 1), np.float32)
    w[1, 1, 1, 1, 0, 0] = 1.0
    jp["nc"] = [{"w": jnp.asarray(w), "b": jnp.zeros((1,), jnp.float32)}]
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    src = np.random.default_rng(4).integers(0, 256, (1, 96, 96, 3), dtype=np.uint8)
    tgt = np.roll(src, (32, 32), axis=(1, 2))
    if entry == "matcher":
        want, want_q = jnet.make_point_matcher(jc, jp).match_with_quality(src, tgt)
        got, got_q = tnet.make_point_matcher(tc, tp, device="cpu").match_with_quality(src, tgt)
        for g, wv in zip(got[:4], want[:4]):
            assert g.shape == (1, 36)
            np.testing.assert_array_equal(g, wv)
        np.testing.assert_allclose(got.score, want.score, rtol=1e-4)
        np.testing.assert_allclose(list(got_q.values()), list(want_q.values()),
                                   rtol=1e-4, atol=1e-7)
    else:
        x = [np.random.default_rng(s).normal(size=(1, 96, 96, 3)).astype(np.float32)
             for s in (5, 6)]
        want = jnet.ncnet_forward(jc, jp, jnp.asarray(x[0]), jnp.asarray(x[1])).corr
        got = tnet.NCNet(tc, tp, device="cpu")(torch.from_numpy(x[0]),
                                                torch.from_numpy(x[1])).corr
        assert got.shape == (1, 6, 6, 6, 6)
        np.testing.assert_allclose(to_np(got), to_np(want), **VOLUME)
