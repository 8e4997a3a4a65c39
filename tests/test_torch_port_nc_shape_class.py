"""The NC kernels over the JAX kernels' whole shape class, on the CPU.

The JAX resident kernels serve any stack of one odd kernel size with a
final layer of at most 4 channels (``ncnet_tpu/ops/nc_fused_lane.py::
_resident_shape_class``); the port's kernels serve the same class within
their limits (odd k <= 7, widths <= 32: ``nc_fused_lane.kernels_hold``).
Here, on the new classes (8-channel layers at k = 5, 32-channel layers,
k = 1, k = 7, the tap-swap chain), the port's twins are held against the
JAX kernels run as the JAX suite runs them on the CPU (``interpret=True``),
the routes are held to the gate, and the rectangular IVD training step to
its chain.  The CUDA kernels themselves run only on a card
(tests/test_torch_port_cuda.py and ``chip_smoke.py`` phase W hold them to
these twins).
"""

import numpy as np
import pytest
import torch

from ncnet_tpu.ops import nc_fused_lane as jlane
from ncnet_tpu.ops.nc_fused_lane_vjp import nc_stack_fused_vjp as jax_vjp
from ncnet_tpu_torch.models import ncnet as tnet
from ncnet_tpu_torch.ops import nc_fused_lane as tlane
from ncnet_tpu_torch.ops import nc_fused_lane_vjp as tvjp
from test_torch_port_nc_stack import (
    as_jax as stack_as_jax,
    as_torch as stack_as_torch,
    assert_normalized_close,
    make_stack,
)
from test_torch_port_nc_vjp import (
    as_jax,
    as_torch,
    flat,
    margin_stack,
    ref_vjp_f32,
    torch_flat,
)

# the forward twin against the JAX resident kernel (tests/test_torch_port_
# nc_stack.py's bound: normalized atol 3e-2)
FORWARD_CLASSES = [
    ((1, 6, 6, 6, 6), (5, 5, 5), (8, 8, 1)),       # 8 channels at k = 5
    ((1, 5, 5, 5, 5), (3, 3, 3), (32, 32, 1)),     # 32 -> 32 at k = 3
    ((1, 5, 5, 5, 5), (1, 1), (3, 1)),             # k = 1
    ((1, 4, 5, 4, 5), (7, 7), (4, 1)),             # k = 7
]
# the backward twin against the JAX kernel where it is sound, at 1e-2
# relative L2 a gradient.  The JAX reference compiles each stage anew
# (about 4 s a layer on the CPU), so this test takes about 12 s.
VJP_JAX = [
    ((1, 4, 4, 4, 4), (5, 5, 5), (8, 8, 1), 1),
]
# ... and against f32 autodiff where the interpret-mode JAX VJP is wrong:
# k = 1 and a 2-channel final layer (the seed's test_grad_parity[shape3/4]),
# and 32-channel layers, where it misses autodiff by 0.11-0.28 relative L2
# a gradient while the twin is within 0.004 (16 and 20 channels: both
# within 0.006; ROADMAP C7)
VJP_AUTODIFF = [
    ((1, 4, 4, 4, 4), (3, 3, 3), (32, 32, 1), 1, 2e-3),
    ((1, 5, 5, 5, 5), (1, 1), (3, 1), 5, 1e-3),
    ((1, 4, 5, 5, 4), (3, 3), (32, 2), 2, 1e-3),   # the IVD tap-swap chain
]
REL_L2 = 1e-2


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


@pytest.mark.parametrize("shape,kernels,channels", FORWARD_CLASSES)
def test_forward_twin_matches_jax_resident(shape, kernels, channels):
    """Each new class inside the gate; the twin within the JAX suite's
    normalized tolerance of the JAX resident kernel."""
    assert tlane.kernels_hold(kernels, channels)
    assert jlane._resident_shape_class(kernels, channels)
    layers, x = make_stack(11, shape, kernels, channels)
    want = jlane.nc_stack_resident(*stack_as_jax(layers, x), interpret=True)
    got = tlane.nc_stack_resident(*stack_as_torch(layers, x))
    assert got.shape == shape + (channels[-1],) and got.dtype == torch.bfloat16
    assert_normalized_close(got.float().numpy(), want, atol=3e-2)


@pytest.mark.parametrize("shape,kernels,channels,seed", VJP_JAX)
def test_stack_vjp_twin_matches_jax_kernel(shape, kernels, channels, seed):
    layers, x, g = margin_stack(seed, shape, kernels, channels)
    want = flat(*jax_vjp(*as_jax(layers, x, g), interpret=True))
    params, xt, gt = as_torch(layers, x, g)
    got = torch_flat(*tvjp.nc_stack_vjp_reference(params, xt, gt))
    for a, b in zip(got, want):
        assert rel_l2(a, b) <= REL_L2


@pytest.mark.parametrize("shape,kernels,channels,seed,margin", VJP_AUTODIFF)
def test_stack_vjp_twin_matches_f32_autodiff(shape, kernels, channels, seed,
                                             margin):
    assert tlane.kernels_hold(kernels, channels)
    layers, x, g = margin_stack(seed, shape, kernels, channels, margin)
    want = flat(*ref_vjp_f32(layers, x, g))
    params, xt, gt = as_torch(layers, x, g)
    got = torch_flat(*tvjp.nc_stack_vjp_reference(params, xt, gt))
    for a, b in zip(got, want):
        assert rel_l2(a, b) <= REL_L2


# (kernels, channels): inside the JAX shape class and the port's limits;
# inside the JAX class but past the limits; outside both
GATE_STACKS = {
    "inside": [((5, 5, 5), (16, 16, 1)), ((3, 3), (16, 1)), ((3, 3), (32, 2)),
               ((5, 5, 5), (8, 8, 1)), ((3, 3, 3), (32, 32, 1)),
               ((1, 1), (3, 1)), ((7, 7, 7), (16, 16, 1)), ((7,), (4,)),
               ((3, 3, 3), (10, 10, 1)), ((5, 5), (1, 1)), ((7, 7), (32, 3)),
               ((1, 1, 1), (2, 32, 4)), ((5, 5, 5, 5), (5, 17, 29, 2))],
    "past_limits": [((9, 9, 9), (16, 16, 1)), ((9,), (1,)),
                    ((5, 5, 5), (48, 48, 1)), ((3, 3), (33, 1)),
                    ((11, 11), (4, 1))],
    "outside": [((5, 5, 5), (16, 16, 8)), ((3, 5), (16, 1)),
                ((4, 4), (16, 1)), ((3, 3), (16, 5))],
}


@pytest.mark.parametrize("group", sorted(GATE_STACKS))
def test_gate_matches_jax_shape_class(group):
    """The gate is the JAX ``_resident_shape_class`` within the limits (odd
    k <= 7, widths <= 32): inside them the two agree stack for stack,
    past them only the JAX class holds, outside the class neither."""
    for kernels, channels in GATE_STACKS[group]:
        want_jax = group != "outside"
        want_port = group == "inside"
        assert jlane._resident_shape_class(kernels, channels) == want_jax
        assert tlane.kernels_hold(kernels, channels) == want_port, (
            kernels, channels)


@pytest.mark.parametrize("side,kernels,channels", [
    (6, (5, 5, 5), (8, 8, 1)),
    (6, (3, 3, 3), (32, 32, 1)),
    (25, (3, 3, 3), (32, 32, 1)),
    (6, (1, 1), (3, 1)),
])
def test_chooser_and_training_gate_take_the_kernels(side, kernels, channels,
                                                    monkeypatch):
    """``choose_fused_stack`` gives these bf16 stacks "resident" (the FFT
    gate refuses them), and the training gate (``require_vjp``) runs the
    fused stack, whose backward is B3, where before they ran per layer."""
    assert tlane.choose_fused_stack(side, side, side, side, kernels,
                                    channels) == "resident"
    assert tlane.last_selected_tier() == "resident"
    calls = []
    real = tlane.nc_stack_fused
    monkeypatch.setattr(tlane, "nc_stack_fused", lambda p, v: (
        calls.append(1), real(p, v))[1])
    layers, _ = make_stack(12, (1, 4, 4, 4, 4), kernels, channels)
    leaves = [{k: torch.from_numpy(v).to(torch.bfloat16).requires_grad_()
               for k, v in layer.items()} for layer in layers]
    corr = torch.from_numpy(np.random.default_rng(13).uniform(
        0, 1, (1, 4, 4, 4, 4)).astype(np.float32)).to(torch.bfloat16)
    tnet.neigh_consensus(leaves, corr, require_vjp=True).float().sum().backward()
    assert calls and all(p["w"].grad is not None for p in leaves)


def test_outside_the_gate_reads_xla_and_launches_nothing():
    """A bf16 stack past the limits reads "xla" before any launch."""
    before = (tlane.launches, dict(tvjp.launches))
    assert tlane.choose_fused_stack(50, 50, 50, 50, (9, 9, 9),
                                    (16, 16, 1)) is None
    assert tlane.last_selected_tier() == "xla"
    layers, x = make_stack(14, (1, 4, 4, 4, 4), (9, 9), (4, 1))
    params, xt = stack_as_torch(layers, x)
    out = tnet.neigh_consensus(params, xt[..., 0])
    assert tlane.last_selected_tier() == "xla"
    assert out.shape == (1, 4, 4, 4, 4)
    assert (tlane.launches, tvjp.launches) == before


def test_rectangular_ivd_training_takes_the_chain(monkeypatch):
    """The IVD stack (3, 3) / (16, 1) on a rectangular volume under the
    training gate: one fused call on its tap-swap chain ((3, 1, 32),
    (3, 32, 2)) whose backward is B3, as the JAX gate routes it; its
    gradients equal the two-pass route's (the stack on the volume and on
    its transpose) within 1e-2 relative L2."""
    calls = []
    real = tlane.nc_stack_fused
    monkeypatch.setattr(tlane, "nc_stack_fused", lambda p, v: (
        calls.append(tuple(int(q["w"].shape[5]) for q in p)), real(p, v))[1])
    layers, _ = make_stack(15, (1, 4, 5, 5, 4), (3, 3), (16, 1))
    corr = torch.from_numpy(np.random.default_rng(16).uniform(
        0, 1, (1, 4, 5, 5, 4)).astype(np.float32)).to(torch.bfloat16)

    def leaves():
        return [{k: torch.from_numpy(v).to(torch.bfloat16).requires_grad_()
                 for k, v in layer.items()} for layer in layers]

    chain = leaves()
    tnet.neigh_consensus(chain, corr, require_vjp=True).float().square(
    ).sum().backward()
    assert calls == [(32, 2)]
    assert tlane.last_selected_tier() == "resident"
    calls.clear()
    two = leaves()
    x = corr[..., None]
    xt = x.permute(0, 3, 4, 1, 2, 5).contiguous()
    out = (tlane.nc_stack_fused(two, x) + tlane.nc_stack_fused(two, xt)
           .permute(0, 3, 4, 1, 2, 5))[..., 0]
    out.float().square().sum().backward()
    assert calls == [(16, 1), (16, 1)]
    for a, b in zip(chain, two):
        for key in ("w", "b"):
            assert rel_l2(a[key].grad.float().numpy(),
                          b[key].grad.float().numpy()) <= REL_L2
