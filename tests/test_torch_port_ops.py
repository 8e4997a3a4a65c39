"""Port vs JAX package, op by op: ``ncnet_tpu_torch.ops`` and the in-graph
quality signals against ``ncnet_tpu`` on the same seeded numpy inputs.

fp32 ops agree to rtol/atol 1e-5 (both sides compute in float32 on the
CPU; only the summation order differs).  Argmax-derived outputs (match
coordinates, indices, agreement) must be exact: inputs are continuous
random draws, so they carry no ties.
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ncnet_tpu import config as jcfg
from ncnet_tpu.observability import quality as jq
from ncnet_tpu.ops import correlation as jcorr
from ncnet_tpu.ops import image as jimage
from ncnet_tpu.ops import matching as jm
from ncnet_tpu.ops import norm as jnorm
from ncnet_tpu_torch import config as tcfg
from ncnet_tpu_torch.observability import quality as tq
from ncnet_tpu_torch.ops import conv4d as tconv
from ncnet_tpu_torch.ops import correlation as tcorr
from ncnet_tpu_torch.ops import image as timage
from ncnet_tpu_torch.ops import matching as tm
from ncnet_tpu_torch.ops import norm as tnorm

# ncnet_tpu.ops re-exports the conv4d FUNCTION under the submodule's name
jconv = importlib.import_module("ncnet_tpu.ops.conv4d")

TOL = dict(rtol=1e-5, atol=1e-5)


def rng(seed=0):
    return np.random.default_rng(seed)


def both(a):
    """The same numpy array as a JAX and a torch input."""
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def close(t, j, **tol):
    np.testing.assert_allclose(t.numpy() if isinstance(t, torch.Tensor) else t,
                               np.asarray(j), **(tol or TOL))


def test_model_config_fields_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(jcfg.ModelConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tcfg.ModelConfig)]
    assert tf == jf
    assert tcfg.ModelConfig().replace(half_precision=True).half_precision


def test_feature_l2_norm():
    x = rng().normal(size=(2, 5, 6, 16)).astype(np.float32)
    x[0, 0, 0] = 1e-4  # near-zero feature: the eps inside the sqrt matters
    jx, tx = both(x)
    close(tnorm.feature_l2_norm(tx), jnorm.feature_l2_norm(jx))
    close(tnorm.feature_l2_norm(tx, axis=1), jnorm.feature_l2_norm(jx, axis=1))


def test_normalize_imagenet():
    img = rng().integers(0, 256, (2, 7, 5, 3)).astype(np.float32)
    jx, tx = both(img)
    close(timage.normalize_imagenet(tx), jimage.normalize_imagenet(jx))
    close(timage.normalize_imagenet(tx / 255.0, scale_255=False),
          jimage.normalize_imagenet(jx / 255.0, scale_255=False))
    u8 = torch.from_numpy(img.astype(np.uint8))
    got = timage.normalize_imagenet(u8)
    assert got.dtype == torch.float32
    close(got, jimage.normalize_imagenet(jx))


@pytest.mark.parametrize("shapes", [((2, 4, 5, 16), (2, 3, 6, 16)),
                                    ((1, 6, 6, 32), (1, 6, 6, 32))])
def test_correlation_4d_fp32(shapes):
    a = rng(1).normal(size=shapes[0]).astype(np.float32)
    b = rng(2).normal(size=shapes[1]).astype(np.float32)
    (ja, ta), (jb, tb) = both(a), both(b)
    got = tcorr.correlation_4d(ta, tb)
    assert got.dtype == torch.float32
    close(got, jcorr.correlation_4d(ja, jb))


def test_correlation_4d_bf16_accumulates_f32():
    a = rng(1).normal(size=(2, 4, 5, 64)).astype(np.float32)
    b = rng(2).normal(size=(2, 3, 6, 64)).astype(np.float32)
    got = tcorr.correlation_4d(torch.from_numpy(a).to(torch.bfloat16),
                               torch.from_numpy(b).to(torch.bfloat16))
    want = jcorr.correlation_4d(jnp.asarray(a).astype(jnp.bfloat16),
                                jnp.asarray(b).astype(jnp.bfloat16))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    # the f32 sums agree; the one bf16 rounding of the result may differ by
    # an ulp where the two sums straddle a rounding boundary
    close(got.float(), np.asarray(want, np.float32), rtol=8e-3, atol=1e-2)


def test_mutual_matching():
    corr = rng(3).uniform(0, 1, (2, 4, 5, 3, 6)).astype(np.float32)
    jx, tx = both(corr)
    close(tm.mutual_matching(tx), jm.mutual_matching(jx))


def test_mutual_argmax_agreement():
    corr = rng(4).normal(size=(3, 4, 4, 4, 4)).astype(np.float32)
    # pair 1: an identity-peaked volume (agreement exactly 1)
    corr[1] = np.eye(16).reshape(4, 4, 4, 4) + 0.01 * corr[1]
    jx, tx = both(corr)
    got = tm.mutual_argmax_agreement(tx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jm.mutual_argmax_agreement(jx)))
    assert float(got[1]) == 1.0


@pytest.mark.parametrize("invert", [False, True])
@pytest.mark.parametrize("softmax", [False, True])
@pytest.mark.parametrize("scale", ["centered", "positive"])
def test_corr_to_matches(invert, softmax, scale):
    corr = rng(5).normal(size=(2, 3, 5, 4, 6)).astype(np.float32)
    jx, tx = both(corr)
    got, tidx = tm.corr_to_matches(tx, do_softmax=softmax, scale=scale,
                                   invert_matching_direction=invert,
                                   return_indices=True)
    # jitted, as every JAX program runs it (XLA rounds the coordinate grid
    # differently inside a program than in an eager jnp.linspace call)
    want, jidx = jax.jit(functools.partial(
        jm.corr_to_matches, do_softmax=softmax, scale=scale,
        invert_matching_direction=invert, return_indices=True))(jx)
    for t, j in zip(tidx, jidx):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for field in ("xA", "yA", "xB", "yB"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))
    close(got.score, want.score)


def test_corr_to_matches_rejects_unported_and_bad_args():
    """``delta4d``, refused until the relocalization slice, now reads the
    k× finer grid (zero offsets: fine = coarse·k; the offsets themselves
    are held to JAX in ``test_torch_port_eval.py``); a bad scale raises."""
    corr = torch.zeros(1, 2, 2, 2, 2)
    corr[0, 1, 0, 0, 1] = 1.0
    zeros = tuple(torch.zeros(1, 2, 2, 2, 2, dtype=torch.int32) for _ in range(4))
    m, fine = tm.corr_to_matches(corr, delta4d=zeros, k_size=2, return_indices=True)
    _, coarse = tm.corr_to_matches(corr, return_indices=True)
    for f, c in zip(fine, coarse):
        assert torch.equal(f, 2 * c)
    assert m.xA.shape == (1, 4) and float(m.yA[0, 1]) == tm._grid(-1.0, 4, "cpu")[2]
    with pytest.raises(ValueError, match="scale"):
        tm.corr_to_matches(corr, scale="pixels")


@pytest.mark.parametrize("lo", [-1.0, 0.0])
def test_match_grid_is_bitwise_jitted_linspace(lo):
    sizes = list(range(1, 33)) + [50, 64, 75, 100, 150, 200]
    for n in sizes:
        want = jax.jit(lambda i, n=n: jnp.linspace(lo, 1.0, n)[i])(jnp.arange(n))
        np.testing.assert_array_equal(tm._grid(lo, n, "cpu").numpy(), np.asarray(want))


def test_axis_normalization():
    x = rng(6).uniform(1, 400, (3, 7)).astype(np.float32)
    jx, tx = both(x)
    close(tm.normalize_axis(tx, 400.0), jm.normalize_axis(jx, 400.0))
    close(tm.unnormalize_axis(tm.normalize_axis(tx, 400.0), 400.0), x, rtol=1e-5,
          atol=1e-3)
    close(tm.unnormalize_axis(tx / 400.0, 320.0), jm.unnormalize_axis(jx / 400.0, 320.0))


@pytest.mark.parametrize("k,c_in,c_out,bias", [(3, 1, 4, True), (3, 3, 2, False),
                                               (5, 2, 3, True)])
def test_conv4d_same(k, c_in, c_out, bias):
    x = rng(7).normal(size=(2, 5, 4, 6, 5, c_in)).astype(np.float32)
    w = rng(8).normal(size=(k,) * 4 + (c_in, c_out)).astype(np.float32) * 0.2
    b = rng(9).normal(size=(c_out,)).astype(np.float32) if bias else None
    (jx, tx), (jw, tw) = both(x), both(w)
    jb, tb = both(b) if bias else (None, None)
    got = tconv.conv4d(tx, tw, tb)
    assert got.shape == (2, 5, 4, 6, 5, c_out) and got.is_contiguous()
    close(got, jconv.conv4d(jx, jw, jb))


def test_conv4d_rejects_even_kernels():
    with pytest.raises(ValueError, match="odd"):
        tconv.conv4d(torch.zeros(1, 4, 4, 4, 4, 1), torch.zeros(2, 2, 2, 2, 1, 1))


def test_conv4d_init_bounds():
    g = torch.Generator().manual_seed(0)
    w, b = tconv.conv4d_init(g, 5, 16, 16)
    bound = 1.0 / np.sqrt(16 * 5 ** 4)
    assert w.shape == (5, 5, 5, 5, 16, 16) and b.shape == (16,)
    assert float(w.abs().max()) <= bound and float(b.abs().max()) <= bound
    jw, _ = jconv.conv4d_init(jax.random.key(0), 5, 16, 16)
    assert jw.shape == tuple(w.shape)


def _volume(seed, shape=(2, 4, 5, 4, 5)):
    return rng(seed).normal(size=shape).astype(np.float32) * 3.0


@pytest.mark.parametrize("shape", [(2, 4, 5, 4, 5), (1, 3, 4, 5, 2), (2, 4, 4, 1, 1)])
def test_quality_signals(shape):
    jx, tx = both(_volume(10, shape))
    got, want = tq.quality_signals(tx), jq.quality_signals(jx)
    assert list(got) == list(want) == list(tq.QUALITY_SIGNALS)
    for name in tq.QUALITY_SIGNALS:
        close(got[name], want[name])
    close(tq.quality_table(tx), jq.quality_table(jx))


def test_quality_rows_round_trip_matches_jax():
    corr = _volume(11)
    table = rng(12).normal(size=(2, 5, 20)).astype(np.float32)
    (jc, tc), (jt, tt) = both(corr), both(table)
    got = tq.append_quality_rows(tt, tc)
    want = jq.append_quality_rows(jt, jc)
    assert got.shape == (2, 6, 20)
    close(got, want)
    t_rows, t_q = tq.split_quality_rows(got.numpy())
    j_rows, j_q = jq.split_quality_rows(np.asarray(want))
    np.testing.assert_array_equal(t_rows, j_rows)
    for a, b in zip(t_q, j_q):
        assert a.keys() == b.keys()
        np.testing.assert_allclose(list(a.values()), list(b.values()), **TOL)
    # a grid too narrow for the row leaves the table unchanged
    narrow = torch.zeros(2, 5, 3)
    assert tq.append_quality_rows(narrow, tc).shape == (2, 5, 3)
    assert tq.split_quality_rows(narrow.numpy())[1] is None
    with pytest.raises(ValueError):
        tq.split_quality_rows(np.zeros((5, 3), np.float32))


def test_quality_row_single_pair_matches_jax():
    corr = _volume(13, (1, 4, 5, 4, 5))
    table = rng(14).normal(size=(5, 20)).astype(np.float32)
    (jc, tc), (jt, tt) = both(corr), both(table)
    got = tq.append_quality_row(tt, tc)
    close(got, jq.append_quality_row(jt, jc))
    rows, sig = tq.split_quality_row(got.numpy())
    j_rows, j_sig = jq.split_quality_row(np.asarray(jq.append_quality_row(jt, jc)))
    np.testing.assert_array_equal(rows, j_rows)
    np.testing.assert_allclose(list(sig.values()), list(j_sig.values()), **TOL)
    assert tq.split_quality_row(table)[1] is None
