"""The port's conv4d formulations, their chooser, ``conv4d_same`` and the B5
twin (``ncnet_tpu_torch/ops/conv4d.py``, ``ops/conv4d_pallas.py``) against
the JAX package on the CPU, on the same seeded numpy inputs.

Tolerances:
  * fp32 formulations and ``conv4d_same`` gradients: rtol/atol 1e-5, as
    tests/test_torch_port_ops.py::test_conv4d_same (float32 on both sides;
    only the summation order differs);
  * B5's twin against the Pallas kernel in interpret mode: 2e-4 in f32, the
    JAX suite's own tolerance (tests/test_ops_basic.py:262-278); in bf16,
    2⁻⁷ of the largest output: both sum bf16 products in f32 and round
    once, so an output lands at most one bf16 ulp apart.
The chooser's decisions must be equal, with the JAX TPU gates
(``_pallas_available``, ``pallas_compiles``, ``pallas_feasible``) set to
True: the port drops them, so its decisions are the JAX package's on a TPU
that accepts the kernel.
"""

import importlib
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ncnet_tpu_torch.ops import conv4d as tconv
from ncnet_tpu_torch.ops import conv4d_pallas as tpallas

# ncnet_tpu.ops re-exports the conv4d FUNCTION under the submodule's name
jconv = importlib.import_module("ncnet_tpu.ops.conv4d")
jpallas = importlib.import_module("ncnet_tpu.ops.conv4d_pallas")

TOL = dict(rtol=1e-5, atol=1e-5)
VARIANTS = ("unroll", "tapfold", "coutfold", "afold", "toeplitz_b")
# (pad_ha, pad_hb, pad_wa, pad_wb): the same-padded form and the valid-dim
# forms the sharded paths use (afold and toeplitz_b take padded w dims only)
PADS = [(True, True, True, True), (False, True, True, True),
        (False, False, True, True), (True, True, False, False)]


def rng(seed=0):
    return np.random.default_rng(seed)


def both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **(tol or TOL))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("pads", PADS, ids=lambda p: "".join("P" if x else "v" for x in p))
@pytest.mark.parametrize("k,c_in,c_out", [(3, 5, 2), (5, 2, 3)])
def test_formulation_matches_jax(variant, pads, k, c_in, c_out):
    kw = dict(zip(("pad_ha", "pad_hb", "pad_wa", "pad_wb"), pads))
    x = rng(1).normal(size=(2, 7, 6, 8, 7, c_in)).astype(np.float32)
    w = rng(2).normal(size=(k,) * 4 + (c_in, c_out)).astype(np.float32) * 0.2
    b = rng(3).normal(size=(c_out,)).astype(np.float32)
    (jx, tx), (jw, tw), (jb, tb) = both(x), both(w), both(b)
    if variant in ("afold", "toeplitz_b") and not (kw["pad_wa"] and kw["pad_wb"]):
        with pytest.raises(ValueError, match="valid"):
            tconv.conv4d(tx, tw, tb, variant=variant, **kw)
        return
    got = tconv.conv4d(tx, tw, tb, variant=variant, **kw)
    want = jconv.conv4d(jx, jw, jb, variant=variant, **kw)
    assert tuple(got.shape) == want.shape and got.is_contiguous()
    close(got, want)


@pytest.fixture
def jax_tpu_gates(monkeypatch):
    """The JAX chooser as on a TPU that compiles B5 and has the VMEM."""
    monkeypatch.setattr(jconv, "_pallas_available", lambda: True)
    monkeypatch.setattr(jpallas, "pallas_compiles", lambda *a, **k: True)
    monkeypatch.setattr(jpallas, "pallas_feasible", lambda *a, **k: True)


def test_choose_conv4d_variant_matches_jax(jax_tpu_gates):
    dtypes = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16), (None, None)]
    n = 0
    for c_in, c_out, side, k, batch, (jd, td), same, a_known in itertools.product(
            (1, 4, 5, 16), (1, 2, 4, 5, 16), (6, 25, 50, 100), (3, 5, (3, 5, 3, 3), 4),
            (1, 8, None), dtypes, (True, False), (True, False)):
        kernel = (k,) * 4 if isinstance(k, int) else k
        kw = dict(shape_a=(side, side) if a_known else None, kernel=kernel,
                  same_pad=same, batch=batch)
        want = jconv.choose_conv4d_variant(c_in, c_out, side, side, dtype=jd, **kw)
        got = tconv.choose_conv4d_variant(c_in, c_out, side, side, dtype=td, **kw)
        assert got == want, (c_in, c_out, side, k, batch, jd, same, a_known)
        n += got == "pallas"
    assert n > 0  # the grid reaches B5's branch


def test_fold_fits_matches_jax():
    for batch, side, k, ch, (jd, td) in itertools.product(
            (1, 4, 8), (25, 50, 60), (3, 5), (1, 16),
            [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]):
        assert tconv.conv4d_fold_fits(batch, side, side, side, side, k, ch, td) \
            == bool(jconv.conv4d_fold_fits(batch, side, side, side, side, k, ch, jd))


@pytest.mark.parametrize("c_in,c_out", [(1, 4), (16, 1), (16, 16), (8, 2)])
def test_conv4d_auto_matches_jax(c_in, c_out):
    """``auto`` (the port takes B5's twin for a small-C_out layer, the JAX
    CPU path ``coutfold``) gives the same values."""
    x = rng(4).normal(size=(2, 5, 4, 6, 5, c_in)).astype(np.float32)
    w = rng(5).normal(size=(3,) * 4 + (c_in, c_out)).astype(np.float32) * 0.2
    (jx, tx), (jw, tw) = both(x), both(w)
    close(tconv.conv4d(tx, tw), jconv.conv4d(jx, jw))


def test_conv4d_transpose_weights_matches_jax():
    w = rng(6).normal(size=(3, 3, 5, 3, 2, 4)).astype(np.float32)
    jw, tw = both(w)
    np.testing.assert_array_equal(tconv.conv4d_transpose_weights(tw).numpy(),
                                  np.asarray(jconv.conv4d_transpose_weights(jw)))


@pytest.mark.parametrize("routing", [("auto", "coutfold"), ("unroll", "afold")])
@pytest.mark.parametrize("c_in,c_out", [(1, 4), (6, 1)])
def test_conv4d_same_grads_match_jax(routing, c_in, c_out):
    x = rng(7).normal(size=(2, 5, 4, 6, 5, c_in)).astype(np.float32)
    w = rng(8).normal(size=(3,) * 4 + (c_in, c_out)).astype(np.float32) * 0.2
    b = rng(9).normal(size=(c_out,)).astype(np.float32)
    g = rng(10).normal(size=(2, 5, 4, 6, 5, c_out)).astype(np.float32)
    jfn = jconv.make_conv4d_same(*routing)
    want_y, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (x, w, b)))
    want = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    got_y = tconv.make_conv4d_same(*routing)(*ts)
    got_y.backward(torch.from_numpy(g))
    close(got_y, want_y)
    for t, wnt in zip(ts, want):
        close(t.grad, wnt, rtol=1e-5, atol=1e-4)
    assert tconv.conv4d_same is tconv.make_conv4d_same()


def test_conv4d_same_rejects_even_kernels():
    x = torch.zeros(1, 4, 4, 4, 4, 1)
    with pytest.raises(ValueError, match="odd"):
        tconv.conv4d_same(x, torch.zeros(2, 2, 2, 2, 1, 1), torch.zeros(1))


# ---------------------------------------------------------------------------
# B5: conv4d_small_cout
# ---------------------------------------------------------------------------

# tests/test_ops_basic.py:262-266, (b, ha, wa, hb, wb, cin, cout, k)
B5_SHAPES = [(1, 5, 5, 5, 5, 16, 1, 5), (2, 4, 6, 5, 3, 8, 1, 3),
             (1, 6, 4, 4, 6, 16, 2, 3)]


def b5_inputs(shape, seed=11):
    b, ha, wa, hb, wb, cin, cout, k = shape
    r = rng(seed)
    x = r.standard_normal((b, ha, wa, hb, wb, cin)).astype(np.float32)
    w = (r.standard_normal((k,) * 4 + (cin, cout)) * 0.1).astype(np.float32)
    return x, w


@pytest.mark.parametrize("shape", B5_SHAPES)
def test_b5_twin_matches_jax_kernel_f32(shape):
    x, w = b5_inputs(shape)
    want = jpallas._fwd_impl(jnp.asarray(x), jnp.asarray(w), interpret=True)
    before = tpallas.launches
    got = tpallas.conv4d_small_cout(torch.from_numpy(x), torch.from_numpy(w))
    assert tpallas.launches == before  # a CPU tensor: the twin, no launch
    assert got.dtype == torch.float32
    close(got, want, rtol=2e-4, atol=2e-4)


def test_b5_twin_matches_jax_kernel_bf16():
    """bf16 volume, f32 weights cast to bf16 by both (``:183``), 2 outputs."""
    x, w = b5_inputs((1, 5, 4, 6, 5, 12, 2, 3), seed=12)
    want = jpallas._fwd_impl(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w),
                             interpret=True)
    got = tpallas.conv4d_small_cout(torch.from_numpy(x).to(torch.bfloat16),
                                    torch.from_numpy(w))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy() / scale, want / scale,
                               rtol=0, atol=2.0 ** -7)


def test_b5_backward_matches_jax_bwd_rule():
    x, w = b5_inputs((1, 4, 4, 4, 4, 8, 1, 3), seed=13)
    g = rng(14).standard_normal((1, 4, 4, 4, 4, 1)).astype(np.float32)
    want_gx, want_gw = jpallas._bwd_rule((jnp.asarray(x), jnp.asarray(w)),
                                         jnp.asarray(g))
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    tpallas.conv4d_small_cout(tx, tw).backward(torch.from_numpy(g))
    close(tx.grad, want_gx, rtol=1e-5, atol=1e-5)
    close(tw.grad, want_gw, rtol=1e-5, atol=1e-4)


def test_b5_is_conv4d_pallas_variant_and_auto_route(monkeypatch):
    """``conv4d(variant="pallas")`` and ``auto`` on a small-C_out layer go
    through B5 (here its twin); a valid-dim form refuses the variant."""
    calls = []
    real = tpallas.conv4d_small_cout_reference
    monkeypatch.setattr(tpallas, "conv4d_small_cout_reference",
                        lambda x, w: calls.append(x.shape) or real(x, w))
    x, w = b5_inputs(B5_SHAPES[1])
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    a = tconv.conv4d(tx, tw, variant="pallas")
    b = tconv.conv4d(tx, tw)
    assert len(calls) == 2
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="same-padded"):
        tconv.conv4d(tx, tw, variant="pallas", pad_hb=False)


def test_b5_rejects_bad_kernels_and_cpu_launches():
    x = torch.zeros(1, 4, 4, 4, 4, 8)
    with pytest.raises(ValueError, match="cubic"):
        tpallas.conv4d_small_cout(x, torch.zeros(3, 3, 5, 3, 8, 1))
    with pytest.raises(ValueError, match="odd"):
        tpallas.conv4d_small_cout(x, torch.zeros(2, 2, 2, 2, 8, 1))
    # the kernel's wrapper never falls back to the twin
    with pytest.raises(RuntimeError, match="CUDA"):
        tpallas.conv4d_small_cout_cuda(x, torch.zeros(3, 3, 3, 3, 8, 1))


def test_b5_chooser_gate_is_the_kernel_max_k(monkeypatch):
    """The kernel takes any C_in (it stages channels in chunks) and odd
    kernel sizes up to ``MAX_K``; the chooser sends B5 nothing above that
    and falls through as the JAX chooser does when its VMEM gate refuses
    the kernel; the Function refuses it on either device."""
    k_max = tpallas.MAX_K
    kw = dict(shape_a=(50, 50), dtype=torch.float32, batch=4)
    for c_in in (16, 64, 1024):
        assert tconv.choose_conv4d_variant(
            c_in, 1, 50, 50, kernel=(k_max,) * 4, **kw) == "pallas"
    monkeypatch.setattr(jconv, "_pallas_available", lambda: True)
    monkeypatch.setattr(jpallas, "pallas_compiles", lambda *a, **k: True)
    monkeypatch.setattr(jpallas, "pallas_feasible", lambda *a, **k: False)
    for c_out, batch in ((1, 1), (4, 4)):
        want = jconv.choose_conv4d_variant(
            16, c_out, 6, 6, shape_a=(6, 6), kernel=(k_max + 2,) * 4,
            dtype=jnp.float32, batch=batch)
        got = tconv.choose_conv4d_variant(
            16, c_out, 6, 6, shape_a=(6, 6), kernel=(k_max + 2,) * 4,
            dtype=torch.float32, batch=batch)
        assert got == want == "coutfold"
    x = torch.zeros(1, 1, 1, 2, 2, 5)
    with pytest.raises(NotImplementedError, match=str(k_max)):
        tpallas.conv4d_small_cout(x, torch.zeros((k_max + 2,) * 4 + (5, 1)))
    assert tconv.conv4d(x, torch.zeros((k_max + 2,) * 4 + (5, 1))).shape == (
        1, 1, 1, 2, 2, 1)


def test_b5_twin_takes_any_cout_and_f64():
    """Any C_out (the kernel runs chunks of 4) and an f64 volume (summed in
    f64) on the twin, against the f64 ``unroll`` formulation."""
    x, w = b5_inputs((1, 4, 5, 4, 3, 6, 6, 3), seed=15)
    tx, tw = torch.from_numpy(x).double(), torch.from_numpy(w).double()
    got = tpallas.conv4d_small_cout(tx, tw)
    want = tconv.conv4d(tx, tw, variant="unroll")
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# B5's tensor-core kernel: f32 as three bf16 products, emulated on the CPU
# ---------------------------------------------------------------------------

# (b, ha, wa, hb, wb, cin, cout, k): k 3 and 5, C_in 10 (a partial
# 16-channel chunk) and 16, C_out 1 and 3
SPLIT_SHAPES = [(1, 5, 4, 6, 5, 10, 1, 3), (1, 5, 5, 4, 6, 16, 1, 5),
                (2, 4, 5, 5, 4, 16, 3, 3), (1, 4, 6, 5, 5, 10, 3, 5)]


def split_inputs(shape, kind, seed=21):
    """``randn``: x standard normal, w 0.1 x standard normal.  ``positive``:
    every x and w just above a bf16 rounding midpoint
    (``near_bf16_midpoints``): bf16 rounds every one up, to a different
    grid point, so one bf16 product per term misses the f32 sum by ~2e-3 of
    it (the control below) while the f32 sums' own round-off stays
    random."""
    b, ha, wa, hb, wb, cin, cout, k = shape
    if kind == "randn":
        return b5_inputs(shape, seed)
    r = rng(seed)
    return (tpallas.near_bf16_midpoints(r, (b, ha, wa, hb, wb, cin), 0),
            tpallas.near_bf16_midpoints(r, (k,) * 4 + (cin, cout), -4))


def normalized(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("kind", ["randn", "positive"])
@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_split_products_match_f64(shape, kind):
    """The three products (x_hi w_hi + x_hi w_lo + x_lo w_hi) are within
    2e-5 of the f64 conv4d: each term's relative error is at most ~2^-15
    (the dropped x_lo w_lo under 2^-16, the lo roundings ~2^-18), whatever
    the terms' signs."""
    x, w = split_inputs(shape, kind)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    got = tpallas.split_products_reference(tx, tw)
    want = tconv.conv4d(tx.double(), tw.double(), variant="unroll")
    assert got.dtype == torch.float32
    assert normalized(got.numpy(), want.numpy()) <= 2e-5


@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_one_bf16_product_misses_positive_inputs(shape):
    """The control of the positive inputs: a single bf16 product a term (x
    and w rounded to bf16, f32 sums) misses the f32 bound of 2e-4 there,
    so a kernel that dropped the lo products would fail the card's check."""
    x, w = split_inputs(shape, "positive")
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    one = tconv.conv4d(tx.to(torch.bfloat16).float(),
                       tw.to(torch.bfloat16).float(), variant="unroll")
    want = tconv.conv4d(tx.double(), tw.double(), variant="unroll")
    assert normalized(one.numpy(), want.numpy()) > 2e-4


@pytest.mark.parametrize("kind", ["randn", "positive"])
@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_split_products_match_jax_kernel(shape, kind):
    """The emulation against the Pallas kernel in interpret mode, at the
    JAX suite's f32 tolerance (2e-4 normalized)."""
    x, w = split_inputs(shape, kind)
    want = jpallas._fwd_impl(jnp.asarray(x), jnp.asarray(w), interpret=True)
    got = tpallas.split_products_reference(torch.from_numpy(x), torch.from_numpy(w))
    assert normalized(got.numpy(), np.asarray(want)) <= 2e-4


def test_split_products_of_a_bf16_volume_is_the_twin():
    """A bf16 volume is one product: the emulation is the twin, bit for bit."""
    x, w = b5_inputs((1, 4, 5, 4, 6, 16, 2, 3), seed=22)
    tx, tw = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w)
    got = tpallas.split_products_reference(tx, tw)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, tpallas.conv4d_small_cout_reference(tx, tw))
