"""The port's tracked (streaming) pipeline against the JAX package on the CPU.

``ops/temporal.py`` op by op on the same numpy inputs (equal: integer
outputs and host-side numpy), the full-window tracked volume against the
coarse-to-fine one within the port (bitwise, as tests/test_temporal.py:211
pins for JAX), and the engine's pair and tracked tables against the JAX
engine's with the same weights (coordinates equal, scores and the quality
row rtol 1e-4, as test_torch_port_model.py holds the dense engine).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ncnet_tpu import config as jcfg
from ncnet_tpu.models import ncnet as jnet
from ncnet_tpu.serving.engine import BatchMatchEngine as JaxEngine
from ncnet_tpu_torch import config as tcfg
from ncnet_tpu_torch.models import ncnet as tnet
from ncnet_tpu_torch.models.convert import params_from_numpy
from ncnet_tpu_torch.ops import sparse_corr as tsc
from ncnet_tpu_torch.ops import temporal as ttm
from ncnet_tpu_torch.ops.image import normalize_imagenet
from ncnet_tpu_torch.serving.engine import BatchMatchEngine
from ncnet_tpu_torch.store import content_digest

jtm = importlib.import_module("ncnet_tpu.ops.temporal")
jsc = importlib.import_module("ncnet_tpu.ops.sparse_corr")

# 96 px → a 6x6 fine grid, factor 2 → a 3x3 coarse grid
TRACK = dict(backbone="tiny", ncons_kernel_sizes=(3,), ncons_channels=(1,),
             sparse_topk=4, sparse_factor=2)


def shared(seed=0, identity_nc=False, **kw):
    """JAX and port configs and the same weights for both."""
    kw = {**TRACK, **kw}
    jc, tc = jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)
    jp = jnet.init_ncnet(jc, jax.random.key(seed))
    if identity_nc:
        w = np.zeros((3, 3, 3, 3, 1, 1), np.float32)
        w[1, 1, 1, 1, 0, 0] = 1.0
        jp["nc"] = [{"w": jnp.asarray(w), "b": jnp.zeros((1,), jnp.float32)}]
    return jc, tc, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def u8(seed, side=96, n=1):
    return np.random.default_rng(seed).integers(0, 256, (n, side, side, 3),
                                                dtype=np.uint8)


def grid_table(h, w, rng):
    """A ``(6, h·w)`` served-table-like array: random cells of an ``h×w``
    source grid on the jitted linspace coordinates, one entry per target
    cell, random scores."""
    n = h * w
    lin = lambda m: (-1.0 + 2.0 * np.arange(m) / (m - 1)).astype(np.float32)  # noqa: E731
    ia, ja = rng.integers(0, h, n), rng.integers(0, w, n)
    jj, ii = np.meshgrid(np.arange(w), np.arange(h))
    return np.stack([lin(w)[ja], lin(h)[ia], lin(w)[jj.ravel()],
                     lin(h)[ii.ravel()], rng.uniform(0, 1, n).astype(np.float32),
                     np.zeros(n, np.float32)])


# ---------------------------------------------------------------------------
# ops/temporal.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("radius", [0, 1, 3])
@pytest.mark.parametrize("prior_kind", ["identity", "random", "stale"])
def test_temporal_candidates_match_jax(radius, prior_kind):
    hc, wc = 4, 5
    rng = np.random.default_rng(radius)
    prior = {"identity": ttm.identity_prior(hc * wc, wc, hc, wc)[None],
             "random": rng.integers(0, hc * wc, (2, 7)).astype(np.int32),
             "stale": np.array([[999, -7, 3]], np.int32)}[prior_kind]
    want = np.asarray(jtm.temporal_candidates(jnp.asarray(prior), hc, wc, radius))
    got = ttm.temporal_candidates(torch.from_numpy(prior), hc, wc, radius)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert ttm.window_size(radius) == jtm.window_size(radius) == want.shape[-1]
    with pytest.raises(ValueError):
        ttm.window_size(-1)


@pytest.mark.parametrize("n,wc_src,hc,wc", [(9, 3, 3, 3), (12, 4, 2, 5), (6, 2, 4, 4)])
def test_identity_prior_matches_jax(n, wc_src, hc, wc):
    np.testing.assert_array_equal(ttm.identity_prior(n, wc_src, hc, wc),
                                  jtm.identity_prior(n, wc_src, hc, wc))


@pytest.mark.parametrize("grid_a,grid_b,factor", [
    ((6, 6), (6, 6), 2), ((8, 4), (6, 8), 2), ((9, 6), (6, 9), 3)])
def test_prior_from_table_and_recall_proxy_match_jax(grid_a, grid_b, factor):
    rng = np.random.default_rng(sum(grid_a) + factor)
    table = grid_table(*grid_b, rng)
    # the table's source coordinates span the A grid
    table[0] = (-1.0 + 2.0 * rng.integers(0, grid_a[1], table.shape[1])
                / (grid_a[1] - 1)).astype(np.float32)
    table[1] = (-1.0 + 2.0 * rng.integers(0, grid_a[0], table.shape[1])
                / (grid_a[0] - 1)).astype(np.float32)
    got = ttm.prior_from_table(table, grid_a, grid_b, factor)
    want = jtm.prior_from_table(table, grid_a, grid_b, factor)
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    for radius in (0, 1):
        assert (ttm.tracking_recall_proxy(got[0], table, grid_a, grid_b, factor, radius)
                == jtm.tracking_recall_proxy(want[0], table, grid_a, grid_b,
                                             factor, radius))
    with pytest.raises(ValueError):
        ttm.prior_from_table(table[:4], grid_a, grid_b, factor)
    with pytest.raises(ValueError):
        ttm.prior_from_table(table, grid_a, (grid_b[0] + 1, grid_b[1]), factor)


def test_content_digest_matches_jax():
    from ncnet_tpu.store import content_digest as jax_digest

    for a in (u8(1)[0], np.arange(12, dtype=np.float32).reshape(3, 4)):
        assert content_digest(a) == jax_digest(a)


# ---------------------------------------------------------------------------
# the tracked pipeline
# ---------------------------------------------------------------------------


def features(tc, tp, seed):
    img = normalize_imagenet(torch.from_numpy(u8(seed)))
    return tnet.extract_features(tc, tp, img)


def test_full_coverage_tracked_equals_coarse2fine_bitwise():
    """On the 3x3 coarse grid radius 2 dilates any prior to all 9 cells
    and sparse_topk=9 selects all 9: the same candidate sets through the
    shared _sparse_dual_refine give bitwise equal volumes."""
    _, tc, _, tp = shared(sparse_topk=9, track_radius=2)
    fa, fb = features(tc, tp, 1), features(tc, tp, 2)
    ident = ttm.identity_prior(9, 3, 3, 3)[None]
    with torch.no_grad():
        ref = tnet.coarse2fine_filter(tc, tp, fa, fb).corr
        trk = tnet.coarse2fine_tracked_filter(tc, tp, fa, fb, ident, ident).corr
        perm = np.roll(ident, 4, axis=1)
        trk2 = tnet.coarse2fine_tracked_filter(tc, tp, fa, fb, perm, perm).corr
    assert torch.equal(ref, trk)
    assert torch.equal(ref, trk2)


def test_engine_tracked_dispatch_skips_coarse_pass():
    """A tracked dispatch leaves coarse_passes flat and extracts the
    reference features once per stream (tests/test_temporal.py:238)."""
    _, tc, _, tp = shared()
    eng = BatchMatchEngine(tc, tp, device="cpu")
    assert eng.tracking_feasible((96, 96), (96, 96))
    assert not eng.tracking_feasible((48, 48), (48, 48))
    assert eng.feature_stride == 16
    src, tgt = u8(1), u8(2)
    table = eng.fetch(eng.dispatch(src, tgt))
    assert eng.coarse_passes == 1
    pab, pba = ttm.prior_from_table(table[0], (6, 6), (6, 6), 2)
    cp, fe = eng.coarse_passes, eng.feature_extractions
    t1 = eng.fetch(eng.dispatch_tracked(src, u8(3), pab[None], pba[None]))
    assert eng.coarse_passes == cp
    assert eng.tracked_dispatches == 1
    assert eng.feature_extractions == fe + 1
    assert t1.shape == table.shape and np.isfinite(t1).all()
    eng.fetch(eng.dispatch_tracked(src, u8(4), pab[None], pba[None],
                                   src_digests=[content_digest(src[0])]))
    assert eng.feature_extractions == fe + 1
    assert (eng.coarse_passes, eng.tracked_dispatches) == (cp, 2)


def test_engine_feature_store_is_not_ported(tmp_path):
    """Refused until the serving slice; the engine now takes a feature
    store, and the tracked path resolves its reference features through
    it: a second engine on the same store extracts nothing and serves the
    first one's table bit for bit."""
    from ncnet_tpu_torch.store import FeatureStore

    _, tc, _, tp = shared()
    store = FeatureStore(str(tmp_path / "s"), "x-s0-k1-f32-torch.cpu")
    src, tgt = u8(1), u8(2)
    plain = BatchMatchEngine(tc, tp, device="cpu")
    pab, pba = ttm.prior_from_table(plain.fetch(plain.dispatch(src, tgt))[0],
                                    (6, 6), (6, 6), 2)
    tables = []
    for _ in range(2):
        eng = BatchMatchEngine(tc, tp, device="cpu", store=store)
        tables.append(eng.fetch(eng.dispatch_tracked(src, u8(3), pab[None],
                                                     pba[None])))
        assert eng.coarse_passes == 0
    assert eng.feature_extractions == 0
    assert (store.counters["misses"], store.counters["hits"]) == (1, 1)
    np.testing.assert_array_equal(tables[0], tables[1])


@pytest.mark.parametrize("track_radius", [0, 1])
def test_engine_sparse_and_tracked_tables_match_jax(track_radius):
    """The coarse-to-fine pair tables and a tracked frame's tables of the
    port's engine against the JAX engine's: identity-peaked NC kernel,
    targets their sources rolled by one coarse cell."""
    jc, tc, jp, tp = shared(seed=9, identity_nc=True, track_radius=track_radius)
    src = u8(5, n=2)
    tgt = np.roll(src, (32, 32), axis=(1, 2))
    jeng, eng = JaxEngine(jc, jp), BatchMatchEngine(tc, tp, device="cpu")
    before = tsc.launches
    want = np.asarray(jeng.fetch(jeng.dispatch(src, tgt)))
    got = eng.fetch(eng.dispatch(src, tgt))
    assert got.shape == want.shape == (2, 6, 36)
    np.testing.assert_array_equal(got[:, :4], want[:, :4])
    np.testing.assert_allclose(got[:, 4:], want[:, 4:], rtol=1e-4, atol=1e-7)

    priors = [ttm.prior_from_table(t, (6, 6), (6, 6), 2) for t in got]
    pab = np.stack([p[0] for p in priors])
    pba = np.stack([p[1] for p in priors])
    frame = np.roll(src, (16, 16), axis=(1, 2))
    want_t = np.asarray(jeng.fetch(jeng.dispatch_tracked(src, frame, pab, pba)))
    got_t = eng.fetch(eng.dispatch_tracked(src, frame, pab, pba))
    np.testing.assert_array_equal(got_t[:, :4], want_t[:, :4])
    np.testing.assert_allclose(got_t[:, 4:], want_t[:, 4:], rtol=1e-4, atol=1e-7)
    assert tsc.launches == before  # the twins on the CPU
    assert (eng.coarse_passes, jeng.coarse_passes) == (1, 1)


def test_tracked_pipeline_choice_matches_jax():
    for dims in [(6, 6, 6, 6), (5, 6, 6, 6), (4, 4, 4, 4), (8, 6, 6, 8)]:
        for radius in (-1, 0, 2):
            kw = dict(factor=2, halo=2, radius=radius)
            want = jsc.tracking_feasible(*dims, **kw)
            assert tsc.tracking_feasible(*dims, **kw) == want
            assert tsc.choose_tracked_pipeline(*dims, **kw) == (
                "tracked" if want else None)
