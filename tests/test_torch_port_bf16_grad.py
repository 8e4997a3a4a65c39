"""The port's bf16 conv4d weight gradients on the CPU (ROADMAP C3).

The CPU library's bf16 ``F.conv3d`` returns a wrong, nondeterministic
weight gradient whenever the kernel is wider than an input side; the port's
``ops/conv4d._conv3d`` computes a CPU bf16 product in f32 and rounds it
once, as XLA:CPU does.  Every formulation that reaches ``_conv3d``
(``unroll``, ``tapfold``, ``coutfold``) and the B5 twin's backward (the
``coutfold`` autograd) are held here at k = 3, 5, 7 on 4-D sides 2-7: the
weight gradient is the same from one call to the next, and equals
``jax.grad`` of the JAX package's ``conv4d`` in bf16 (same formulation;
B5 against ``coutfold``).

Tolerance: both sides sum bf16 products in f32 and round each gradient
once to bf16, in different orders, so an entry lands at most a few bf16
ulps apart: 2⁻⁶ of the largest |dW| (two ulps at the scale).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ncnet_tpu_torch.ops import conv4d as tconv
from ncnet_tpu_torch.ops import conv4d_pallas as tpallas

jconv = importlib.import_module("ncnet_tpu.ops.conv4d")

ROUTES = ("unroll", "tapfold", "coutfold", "b5")
TOL = 2.0 ** -6


def inputs(k, side, c_in, c_out, seed):
    r = np.random.default_rng(seed)
    x = r.uniform(0, 1, (2,) + (side,) * 4 + (c_in,)).astype(np.float32)
    w = (r.normal(size=(k,) * 4 + (c_in, c_out)) * 0.2).astype(np.float32)
    g = r.normal(size=(2,) + (side,) * 4 + (c_out,)).astype(np.float32)
    as_bf16 = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    return as_bf16(x).copy(), as_bf16(w).copy(), as_bf16(g).copy()


def port_dw(route, x, w, g):
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tw = torch.from_numpy(w).to(torch.bfloat16).requires_grad_()
    tg = torch.from_numpy(g).to(torch.bfloat16)
    if route == "b5":
        y = tpallas.conv4d_small_cout(tx, tw)
    else:
        y = tconv.conv4d(tx, tw, variant=route)
    (dw,) = torch.autograd.grad(y, tw, tg)
    assert dw.dtype == torch.bfloat16
    return dw.float().numpy()


def jax_dw(route, x, w, g):
    variant = "coutfold" if route == "b5" else route

    def f(ww):
        y = jconv.conv4d(jnp.asarray(x, jnp.bfloat16), ww, variant=variant)
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(g, jnp.bfloat16)
                       .astype(jnp.float32))

    return np.asarray(jax.grad(f)(jnp.asarray(w, jnp.bfloat16)), np.float32)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("k", (3, 5, 7))
@pytest.mark.parametrize("side", (2, 3, 4, 5, 6, 7))
def test_bf16_weight_gradient_is_deterministic_and_matches_jax(route, k, side):
    c_in, c_out = (3, 2) if route == "b5" else (4, 3)
    x, w, g = inputs(k, side, c_in, c_out, seed=100 * k + side)
    first = port_dw(route, x, w, g)
    second = port_dw(route, x, w, g)
    np.testing.assert_array_equal(first, second)
    want = jax_dw(route, x, w, g)
    scale = float(np.abs(want).max())
    assert scale > 0
    assert float(np.abs(first - want).max()) <= TOL * scale


def test_cuda_bf16_conv_is_left_to_the_library(monkeypatch):
    """Only a CPU bf16 product is widened: an f32 one runs the library's
    conv as given (a CUDA tensor takes the same branch, tested on the card
    in tests/test_torch_port_cuda.py)."""
    seen = []
    real = tconv.F.conv3d

    def spy(x, w, **kw):
        seen.append((x.dtype, w.dtype))
        return real(x, w, **kw)

    monkeypatch.setattr(tconv.F, "conv3d", spy)
    x = torch.rand(1, 3, 3, 3, 3, 2)
    w = torch.rand(3, 3, 3, 3, 2, 2)
    tconv.conv4d(x, w, variant="tapfold")
    tconv.conv4d(x.to(torch.bfloat16), w.to(torch.bfloat16), variant="tapfold")
    assert seen == [(torch.float32, torch.float32)] * 2
