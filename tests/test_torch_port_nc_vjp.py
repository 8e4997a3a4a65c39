"""The port's NC-stack backward (``ncnet_tpu_torch/ops/nc_fused_lane_vjp.py``
and the ``nc_stack_fused`` autograd Function) against the JAX package on
the CPU.

On CPU tensors both run the plain twin (bf16 operands and ``gz``, f32 sums
for dW, db and each ``Γ``, bf16 ``Γ``); the CUDA kernels themselves run
only on a card (tests/test_torch_port_cuda.py holds them to this twin).

References:
  * on the four shape classes where the JAX kernel is sound, the JAX
    kernel itself, ``nc_stack_fused_vjp(…, interpret=True)``, as
    tests/test_nc_vjp.py runs it;
  * on the k = 1 and 2-channel-final classes, where that kernel disagrees
    with autodiff in interpret mode (the two ``test_grad_parity`` failures
    of tests/test_nc_vjp.py), ``jax.vjp`` of the XLA stack over the same
    bf16 values upcast to f32 (``ref_vjp_f32`` there); so is a plane
    wider than 40 cells (images past ~640 px).

Tolerance: normalized atol 3e-2 per gradient tensor (divided by the
reference's max), the JAX suite's own bound (tests/test_nc_vjp.py:107-114):
both sides keep f32 sums, and the JAX kernel rounds each per-tap dot of its
forward replay to bf16 where the twin does not.  Weights carry the JAX
suite's ReLU-margin construction (reimplemented here on numpy draws), so no
cell's mask sits within bf16 drift of the boundary: a flipped mask would
flip a whole cotangent cell.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ncnet_tpu.ops.conv4d import conv4d as jconv4d
from ncnet_tpu.ops.nc_fused_lane_vjp import nc_stack_fused_vjp as jax_vjp
from ncnet_tpu_torch.ops import nc_fused_lane, nc_fused_lane_vjp as vjp
from ncnet_tpu_torch.ops.conv4d import conv4d

ATOL = 3e-2

# where the JAX kernel is sound (tests/test_nc_vjp.py passes there)
SOUND = [
    ((2, 4, 4, 4, 4), (3, 3), (4, 1)),        # 2-layer k=3, batch 2
    ((1, 5, 5, 5, 5), (5, 5, 5), (4, 4, 1)),  # the PF-Pascal k=5 class
    ((1, 4, 3, 5, 4), (3, 3, 3), (4, 4, 1)),  # rectangular 3-layer
    ((1, 5, 5, 5, 5), (3,), (1,)),            # single layer
]
# where it is not: held against f32 autodiff instead (seed, least margin).
# With k = 1 each first-layer pre-activation is an affine function of one
# input value, and the bf16 rounding of the shifted bias puts the boundary
# nearer the data: 1e-3 is the widest margin its seeds reach, still over
# the ~2^-9 relative (~4e-4 here) the twin's bf16 activations add.
AUTODIFF = [
    ((1, 5, 5, 5, 5), (1, 1), (3, 1), 5, 1e-3),   # k = 1
    ((2, 5, 6, 4, 7), (3, 3), (4, 2), 2, 2e-3),   # 2-channel final, rectangular
    # a plane wider than 40 cells (images past ~640 px), against the XLA
    # replay that ``_fused_bwd`` runs wherever no resident VJP is chosen;
    # this holds the twin, the CUDA kernel at a 50 x 50 plane is held to
    # the twin in test_torch_port_cuda.py
    ((1, 2, 3, 42, 41), (3, 3), (4, 1), 22, 2e-3),
]


def bf16(a):
    """float32 numpy array of the bf16-rounded values."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def margin_stack(seed, shape, kernels, channels, min_margin=2e-3):
    """Seeded bf16 input (normal, 0.5) and stack (normal, 0.1) as float32
    numpy arrays of bf16 values, each layer's bias shifted per channel so
    that the widest gap of its pre-activations near zero straddles the
    ReLU boundary (tests/test_nc_vjp.py:72-104)."""
    rng = np.random.default_rng(seed)
    x = bf16(rng.normal(0, 0.5, shape + (1,)))
    layers, c_in, cur = [], 1, torch.from_numpy(x)
    for k, c_out in zip(kernels, channels):
        w = bf16(rng.normal(0, 0.1, (k,) * 4 + (c_in, c_out)))
        b = bf16(rng.normal(0, 0.1, (c_out,)))
        z = conv4d(cur.double(), torch.from_numpy(w).double()).numpy() + b
        for c in range(c_out):
            zs = np.sort(z[..., c].ravel())
            win = zs[(zs > -0.8) & (zs < 0.8)]
            i = int(np.argmax(np.diff(win)))
            b[c] -= (win[i] + win[i + 1]) / 2
        b = bf16(b)
        z = conv4d(cur, torch.from_numpy(w), torch.from_numpy(b))
        margin = float(z.abs().min())
        assert margin > min_margin, f"margin construction failed ({margin:.2e})"
        cur = torch.relu(z).to(torch.bfloat16).float()
        layers.append({"w": w, "b": b})
        c_in = c_out
    g = bf16(rng.normal(0, 0.5, shape + (channels[-1],)))
    return layers, x, g


def as_torch(layers, x, g, grad=False):
    params = [{k: torch.from_numpy(v).to(torch.bfloat16).requires_grad_(grad)
               for k, v in layer.items()} for layer in layers]
    return (params, torch.from_numpy(x).to(torch.bfloat16).requires_grad_(grad),
            torch.from_numpy(g).to(torch.bfloat16))


def as_jax(layers, x, g):
    return ([{k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in layer.items()}
             for layer in layers], jnp.asarray(x).astype(jnp.bfloat16),
            jnp.asarray(g).astype(jnp.bfloat16))


def ref_vjp_f32(layers, x, g):
    """jax.vjp of the XLA stack over the bf16 values in f32."""
    def stack(params, v):
        for layer in params:
            v = jax.nn.relu(jconv4d(v, layer["w"], layer["b"]))
        return v

    p32 = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in layers]
    _, fn = jax.vjp(stack, p32, jnp.asarray(x))
    return fn(jnp.asarray(g))


def flat(d_params, dx):
    return [np.asarray(t, np.float32) for layer in d_params
            for t in (layer["w"], layer["b"])] + [np.asarray(dx, np.float32)]


def torch_flat(d_params, dx):
    return flat([{k: v.float().numpy() for k, v in layer.items()}
                 for layer in d_params], dx.float().numpy())


def assert_grads_close(got, want, atol=ATOL):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        scale = max(1e-6, float(np.max(np.abs(b))))
        np.testing.assert_allclose(a / scale, b / scale, atol=atol)


def function_grads(layers, x, g):
    """Gradients through ``nc_stack_fused`` under autograd."""
    params, xt, gt = as_torch(layers, x, g, grad=True)
    nc_fused_lane.nc_stack_fused(params, xt).backward(gt)
    for layer in params:
        assert all(t.grad.dtype == torch.bfloat16 for t in layer.values())
    return torch_flat([{k: t.grad for k, t in layer.items()} for layer in params],
                      xt.grad)


@pytest.fixture(scope="module", params=SOUND, ids=lambda c: f"{c[1]}-{c[2]}")
def sound_case(request):
    shape, kernels, channels = request.param
    layers, x, g = margin_stack(1, shape, kernels, channels)
    d_params, dx = jax_vjp(*as_jax(layers, x, g), interpret=True)
    return layers, x, g, flat(d_params, dx)


@pytest.fixture(scope="module", params=AUTODIFF, ids=lambda c: f"{c[1]}-{c[2]}")
def autodiff_case(request):
    shape, kernels, channels, seed, min_margin = request.param
    layers, x, g = margin_stack(seed, shape, kernels, channels, min_margin)
    return layers, x, g, flat(*ref_vjp_f32(layers, x, g))


def test_twin_matches_jax_kernel(sound_case):
    layers, x, g, want = sound_case
    before = dict(vjp.launches)
    d_params, dx = vjp.nc_stack_vjp_reference(*as_torch(layers, x, g))
    assert dx.dtype == torch.bfloat16
    assert vjp.launches == before
    assert_grads_close(torch_flat(d_params, dx), want)


def test_function_matches_jax_kernel(sound_case):
    """The autograd Function on CPU tensors: the twin both ways, no kernel
    launched, the same gradients as the JAX kernel."""
    layers, x, g, want = sound_case
    before = (nc_fused_lane.launches, dict(vjp.launches))
    got = function_grads(layers, x, g)
    assert (nc_fused_lane.launches, vjp.launches) == before
    assert_grads_close(got, want)


def test_twin_matches_f32_autodiff(autodiff_case):
    layers, x, g, want = autodiff_case
    assert_grads_close(torch_flat(*vjp.nc_stack_vjp_reference(*as_torch(layers, x, g))),
                       want)


def test_function_matches_f32_autodiff(autodiff_case):
    layers, x, g, want = autodiff_case
    assert_grads_close(function_grads(layers, x, g), want)


def test_public_vjp_on_cpu_is_the_twin():
    """``nc_stack_fused_vjp`` on CPU tensors runs the twin, bit for bit."""
    layers, x, g = margin_stack(3, (1, 4, 4, 4, 4), (3, 3), (2, 1))
    got = torch_flat(*vjp.nc_stack_fused_vjp(*as_torch(layers, x, g)))
    want = torch_flat(*vjp.nc_stack_vjp_reference(*as_torch(layers, x, g)))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("x_grad", [False, True])
def test_input_gradient_only_when_needed(monkeypatch, x_grad):
    """Layer 0's ``Γ`` (``dx``) is computed only when the input needs a
    gradient, as in training, where the volume is detached."""
    calls = []
    real = vjp.layer_vjp_reference

    def spy(x, y, g, w, need_dx=True):
        calls.append(need_dx)
        return real(x, y, g, w, need_dx)

    monkeypatch.setattr(vjp, "layer_vjp_reference", spy)
    layers, x, g = margin_stack(4, (1, 4, 4, 4, 4), (3, 3), (2, 1))
    params, xt, gt = as_torch(layers, x, g, grad=True)
    xt.requires_grad_(x_grad)
    nc_fused_lane.nc_stack_fused(params, xt).backward(gt)
    assert calls == [True, x_grad]
    assert (xt.grad is not None) == x_grad
    assert all(t.grad is not None for layer in params for t in layer.values())


def test_cuda_wrappers_refuse_cpu_tensors():
    """Each kernel wrapper launches or raises: it never computes on the CPU."""
    layers, x, g = margin_stack(5, (1, 4, 4, 4, 4), (3,), (1,))
    (layer,), xt, gt = as_torch(layers, x, g)
    before = dict(vjp.launches)
    with pytest.raises(RuntimeError, match="CUDA"):
        vjp.nc_vjp_dw(xt, gt, gt, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        vjp.nc_vjp_reduce(torch.zeros((2, 3)))
    with pytest.raises(RuntimeError, match="CUDA"):
        vjp.nc_conv4d_transpose(gt, layer["w"])
    assert vjp.launches == before


def test_flip_transpose_is_the_adjoint():
    """⟨conv4d(x, w), y⟩ = ⟨x, conv4d(y, flip_transpose(w))⟩ in float64:
    the transposed conv the input gradient runs is the exact adjoint."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(1, 4, 5, 3, 4, 2)))
    y = torch.from_numpy(rng.normal(size=(1, 4, 5, 3, 4, 3)))
    w = torch.from_numpy(rng.normal(size=(3, 3, 3, 3, 2, 3)))
    lhs = float((conv4d(x, w) * y).sum())
    rhs = float((x * conv4d(y, vjp.flip_transpose(w))).sum())
    assert abs(lhs - rhs) <= 1e-9 * abs(lhs)
