"""The port's CUDA kernels on a card, against their plain twins.

Every test here is marked ``cuda`` and skips without a CUDA device: the
kernels have no CPU mode.  This file imports neither JAX nor the JAX
package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

Tolerance: the gather kernel (B4) and its twin both sum in f32 and round
once to bf16, so they agree within one bf16 ulp of the largest output
(2^-7 normalized); so do B5 (the small-C_out conv4d) and its twin in bf16,
and in f32 they agree within 2e-4 normalized (the JAX suite's tolerance
for the TPU kernel); B5's tensor-core kernel computes f32 as three bf16
products, within 1e-5 of their emulation, which sums the same products
in another order.  The FFT tier against the plain direct stack: 1e-2
in bf16 (one-ulp flips of bf16 layer outputs), 1e-4 in f32 (round-off of
the transforms).  A kernel and its twin (``nc_stack_reference``,
``layer_vjp_reference``) share every bf16 rounding point and differ only in
the order of their f32 sums, so a few bf16 outputs (layer outputs, ``Γ``,
dW cast to bf16) round one ulp apart: normalized error within 1e-2.  The
backward kernels and the twin get the same saved activations, so their
ReLU masks are the same cells.  T1 (the L2 layer probe's kernel) against
its twin: 1e-2 normalized with bf16 Y terms (each rounded term may flip one
ulp where the f32 sums' order differs), 2^-7 with f32 Y (the output's one
rounding); the two Y dtypes' twins lie within both tolerances of each
other, so T1 also keeps at least 99 % of its nonzero interior outputs
bit-equal to the twin of its Y dtype, and fewer to the other's (sums in
another order flip about 0.05 % of them, the other Y dtype about 40 %).
Every T2 probe reports PASS: its kernel launched and matched its twin.
The relocalization pooling is exact, so the card's is bit-equal to the
CPU's; the device resize (two f32 contractions) stays within 1e-6 of the
image's largest value of the CPU's; the eval step's PCK may differ from the CPU readout of the same
volume by one keypoint a sample (softmax on two devices may round a
near-tie otherwise).  A bf16 stack the kernels are not compiled for runs
the conv4d formulations per layer, within 1e-2 normalized of the twin
(its layers round to bf16 at other points); ``run_eval`` on the card keeps
each pair's PCK within one keypoint of the same run on the CPU; the eval
step run under the sync debug mode equals its first run bit for bit.
B6 at the InLoc tap-swap chain's layer shapes ((3, 1, 32), (3, 32, 2)) and
the IVD stack's on rectangular volumes: within 1e-2 of the twin, as every
shape; the InLoc pair matcher on the card against the same matcher on the
CPU: each table holding at least 0.9 of the CPU table's matches, their
scores within 2e-2 (a one-ulp flip of a near-flat random-init NC output
moves a match, as between the port and the JAX package in
``tests/test_torch_port_inloc.py``).
"""

import time

import numpy as np
import pytest
import torch

from ncnet_tpu_torch.config import ModelConfig, TrainConfig
from ncnet_tpu_torch.models.ncnet import init_ncnet
from ncnet_tpu_torch.ops import (
    conv4d_pallas,
    nc_fused_lane,
    nc_fused_lane_vjp,
    sparse_corr,
)
from ncnet_tpu_torch.ops.conv4d import conv4d
from ncnet_tpu_torch.ops.conv4d_fft import nc_stack_fft
from ncnet_tpu_torch.ops.sparse_topk import candidate_origins, patch_side
from ncnet_tpu_torch.serving.engine import BatchMatchEngine
from ncnet_tpu_torch.tools import mosaic_probes, pallas_l2_probe
from ncnet_tpu_torch.training import create_train_state, make_train_step

SHAPES = [
    ((2, 7, 7, 7, 7), (3, 3), (4, 1)),
    ((1, 6, 5, 7, 6), (3, 3, 3), (4, 4, 1)),
    ((1, 9, 9, 9, 9), (5, 5, 5), (4, 4, 1)),
    ((2, 6, 7, 5, 8), (3, 3), (4, 2)),
    ((1, 7, 7, 7, 7), (3,), (1,)),
    ((1, 5, 5, 5, 5), (5, 5, 5), (2, 2, 1)),
    ((2, 9, 8, 7, 9), (5, 5, 5), (16, 16, 1)),   # the PF-Pascal layer shapes
]
# the forward kernel (B2) also at: every border class of a 6^4 tile at k = 5
# with 3 tiles, so that planes pack across tiles in one block; a 50^4 plane,
# wider than one block's band of rows; channels 10 (the default ModelConfig
# stack) and 4 -> 4
FORWARD_SHAPES = SHAPES + [
    ((3, 6, 6, 6, 6), (5, 5, 5), (16, 16, 1)),
    ((1, 50, 50, 50, 50), (5, 5, 5), (16, 16, 1)),
    ((2, 7, 6, 5, 8), (3, 3, 3), (10, 10, 1)),
    ((2, 5, 6, 7, 6), (5, 5, 5), (4, 4, 4)),
]
# the backward kernels (B7) also at: a plane wider than 40 cells with the
# PF-Pascal stack, more than one block's shared memory holds at 16 -> 16
# (images past ~640 px); every border class of a 6^4 tile at k = 5, 3
# tiles; a wB wider than one band's columns; channels 10 (the default
# ModelConfig stack) and 4 -> 4
BACKWARD_SHAPES = SHAPES + [
    ((1, 4, 5, 50, 50), (5, 5, 5), (16, 16, 1)),
    ((3, 6, 6, 6, 6), (5, 5, 5), (16, 16, 1)),
    ((1, 3, 2, 4, 300), (5, 5, 5), (16, 16, 1)),
    ((2, 7, 6, 5, 8), (3, 3, 3), (10, 10, 1)),
    ((2, 5, 6, 7, 6), (5, 5, 5), (4, 4, 4)),
]


@pytest.fixture
def cuda(monkeypatch):
    """The card, with TF32 off so that the plain f32 versions (cuDNN
    convolutions, cuBLAS products) are full f32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def normalized_err(got, want):
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-6))


def random_stack(rng, shape, kernels, channels, device):
    params, c_in = [], 1
    for k, c_out in zip(kernels, channels):
        params.append({
            "w": torch.from_numpy(rng.normal(0, 0.1, (k,) * 4 + (c_in, c_out))
                                  .astype(np.float32)).to(device, torch.bfloat16),
            "b": torch.from_numpy(rng.normal(0, 0.1, (c_out,)).astype(np.float32))
            .to(device, torch.bfloat16)})
        c_in = c_out
    x = torch.from_numpy(rng.normal(0, 0.5, shape + (1,)).astype(np.float32)
                         ).to(device, torch.bfloat16)
    return params, x


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kernels,channels", FORWARD_SHAPES)
def test_kernel_matches_twin(cuda, shape, kernels, channels):
    """The stack against its twin; one launch a layer; two launches
    bit-identical (no float atomics, no split contraction)."""
    params, x = random_stack(np.random.default_rng(0), shape, kernels,
                             channels, cuda)
    before = nc_fused_lane.launches
    got = nc_fused_lane.nc_stack_resident(params, x)
    again = nc_fused_lane.nc_stack_resident(params, x)
    torch.cuda.synchronize()
    assert nc_fused_lane.launches == before + 2 * len(kernels)
    assert got.shape == shape + (channels[-1],) and got.dtype == torch.bfloat16
    assert torch.equal(got, again)
    assert normalized_err(got, nc_fused_lane.nc_stack_reference(params, x)) <= 1e-2


@pytest.mark.cuda
def test_uncompiled_stack_runs_per_layer(cuda):
    """A bf16 (5, 5, 5) / (8, 8, 1) stack is not compiled into B6 or B3
    (ROADMAP §C, C1): on 40 coarse-to-fine 6⁴ tiles the route is 'xla'
    before any launch, the conv4d formulations run layer by layer with no
    B2 launch, and the symmetric filtered volume matches the twin's
    ``NC(x) + NC(xᵀ)ᵀ`` within 1e-2 normalized (each layer rounds to bf16
    at other points than the twin); in training the gradients come back
    through the formulations, with no B3 launch."""
    from ncnet_tpu_torch.models.ncnet import neigh_consensus

    kernels, channels = (5, 5, 5), (8, 8, 1)
    params, x = random_stack(np.random.default_rng(5), (40, 6, 6, 6, 6),
                             kernels, channels, cuda)
    swap = lambda v: v.permute(0, 3, 4, 1, 2, 5)  # noqa: E731
    before, vjp_before = nc_fused_lane.launches, dict(nc_fused_lane_vjp.launches)
    got = neigh_consensus(params, x[..., 0])
    torch.cuda.synchronize()
    assert nc_fused_lane.launches == before
    assert nc_fused_lane.last_selected_tier() == "xla"
    twin = (nc_fused_lane.nc_stack_reference(params, x)
            + swap(nc_fused_lane.nc_stack_reference(params, swap(x).contiguous())))
    assert got.shape == x.shape[:5] and got.dtype == torch.bfloat16
    assert normalized_err(got, twin[..., 0]) <= 1e-2
    leaves = [{k: v.clone().requires_grad_() for k, v in p.items()} for p in params]
    neigh_consensus(leaves, x[..., 0], require_vjp=True).float().square().sum().backward()
    torch.cuda.synchronize()
    assert nc_fused_lane.last_selected_tier() == "xla"
    assert nc_fused_lane.launches == before
    assert nc_fused_lane_vjp.launches == vjp_before
    assert all(torch.isfinite(p["w"].grad).all() and p["w"].grad.abs().max() > 0
               for p in leaves)


@pytest.mark.cuda
def test_engine_serves_through_the_kernel(cuda):
    cfg = ModelConfig(backbone="tiny", ncons_kernel_sizes=(3, 3), ncons_channels=(4, 1),
                      half_precision=True)
    engine = BatchMatchEngine(cfg, init_ncnet(cfg, seed=0))
    assert engine.device.type == "cuda"
    rng = np.random.default_rng(1)
    src = rng.integers(0, 256, (2, 96, 96, 3), dtype=np.uint8)
    before = nc_fused_lane.launches
    table = engine.fetch(engine.dispatch(src, src[::-1].copy()))
    assert nc_fused_lane.launches == before + 2  # one folded stack, 2 layers
    assert table.shape == (2, 6, 36) and np.isfinite(table).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kernels,channels", BACKWARD_SHAPES)
def test_backward_kernels_match_twin(cuda, shape, kernels, channels):
    """dW, db and every ``Γ`` (``dx`` included) of the B3 kernels against
    the twin on the same saved activations; one launch of each kernel per
    layer; two runs bit-identical (no float atomics)."""
    rng = np.random.default_rng(1)
    params, x = random_stack(rng, shape, kernels, channels, cuda)
    acts = nc_fused_lane.stack_activations(params, x)
    g = torch.from_numpy(rng.normal(0, 0.5, acts[-1].shape).astype(np.float32)
                         ).to(cuda, torch.bfloat16)
    before = dict(nc_fused_lane_vjp.launches)
    got = nc_fused_lane_vjp.stack_vjp(params, acts, g)
    again = nc_fused_lane_vjp.stack_vjp(params, acts, g)
    want = nc_fused_lane_vjp.stack_vjp(params, acts, g, twin=True)
    torch.cuda.synchronize()
    n = len(kernels)
    assert nc_fused_lane_vjp.launches == {
        k: v + 2 * n for k, v in before.items()}
    flat = [t for d in got[0] for t in (d["w"], d["b"])] + [got[1]]
    flat_again = [t for d in again[0] for t in (d["w"], d["b"])] + [again[1]]
    flat_want = [t for d in want[0] for t in (d["w"], d["b"])] + [want[1]]
    for a, a2, b in zip(flat, flat_again, flat_want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, a2)
        assert normalized_err(a, b) <= 1e-2


@pytest.mark.cuda
def test_train_step_runs_both_kernels(cuda):
    """One bf16 step of a tiny configuration: 2 chunks of 2 folded volume
    pairs, each chunk one forward (2 layers) and one backward through B3
    (dx of layer 0 skipped: the volume needs no gradient)."""
    cfg = TrainConfig(model=ModelConfig(
        backbone="tiny", ncons_kernel_sizes=(3, 3), ncons_channels=(4, 1),
        half_precision=True), batch_size=2)
    state, optimizer, mc, _ = create_train_state(cfg, seed=0)
    step = make_train_step(mc, optimizer, stop_backbone_grad=True,
                           accum_chunks=2, nan_guard=True)
    rng = np.random.default_rng(2)
    batch = {k: rng.uniform(-1, 1, (2, 96, 96, 3)).astype(np.float32)
             for k in ("source_image", "target_image")}
    fwd, bwd = nc_fused_lane.launches, dict(nc_fused_lane_vjp.launches)
    new_state, loss = step(state, batch)
    torch.cuda.synchronize()
    assert np.isfinite(float(loss)) and new_state.step == 1
    assert nc_fused_lane.launches == fwd + 2 * 2
    assert nc_fused_lane_vjp.launches == {
        "nc_vjp_dw": bwd["nc_vjp_dw"] + 4,
        "nc_vjp_reduce": bwd["nc_vjp_reduce"] + 4,
        "nc_conv4d_transpose": bwd["nc_conv4d_transpose"] + 2}
    changed = [not torch.equal(a["w"], b["w"]) for a, b in
               zip(state.params["nc"], new_state.params["nc"])]
    assert all(changed)


# (batch, fine side, channels, factor, halo, candidates): the serving
# shape's patch, odd C, and halo 3 (patch 8, origins off the factor's grid);
# patch 8 at C = 1024 (K p^2 = 256 columns: two blocks along N), odd C at
# halo 3, the tracked shape (K = 1, C = 1024), and halo 4 (patch 10: p^2 =
# 100 rows, two blocks along M)
GATHER_SHAPES = [(2, 12, 64, 2, 2, 4), (2, 10, 13, 2, 2, 3), (1, 16, 32, 2, 3, 2),
                 (2, 16, 1024, 2, 3, 4), (2, 10, 13, 2, 3, 2),
                 (2, 12, 1024, 2, 2, 1), (1, 20, 32, 2, 4, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,side,c,factor,halo,k", GATHER_SHAPES)
def test_gather_kernel_matches_twin(cuda, b, side, c, factor, halo, k):
    """B4 against its twin on the sparse path's own arguments; one launch
    each; two launches bit-identical."""
    g = torch.Generator().manual_seed(side + c)
    fa, fb = (torch.nn.functional.normalize(torch.randn((b, side, side, c), generator=g),
                                            dim=-1).to(cuda, torch.bfloat16)
              for _ in range(2))
    n = (side // factor) ** 2
    cand = torch.randint(0, n, (b, n, k), generator=g, dtype=torch.int32).to(cuda)
    patch = patch_side(factor, halo)
    ia, ja = sparse_corr.source_patch_index(side, side, factor, patch)
    oi, oj = candidate_origins(cand, side // factor, factor, patch, side, side)
    fa_p2 = sparse_corr.gather_source_patches(fa, ia, ja).reshape(b, n, patch * patch, c)
    rows, f = (oi // factor, factor) if halo % factor == 0 else (oi, 1)
    before = sparse_corr.launches
    got = sparse_corr.gather_tile_corr_pallas(fa_p2, fb, rows, oj, patch=patch, factor=f)
    again = sparse_corr.gather_tile_corr_pallas(fa_p2, fb, rows, oj, patch=patch, factor=f)
    want = sparse_corr.gather_tile_corr_reference(fa_p2, fb, rows, oj, patch=patch, factor=f)
    torch.cuda.synchronize()
    assert sparse_corr.launches == before + 2
    assert got.shape == (b, n, k, patch * patch, patch * patch)
    assert torch.equal(got, again)
    assert normalized_err(got, want) <= 2.0 ** -7
    tiles = sparse_corr.sparse_fine_corr(fa, fb, cand, factor=factor, halo=halo)
    assert torch.equal(tiles.values.reshape(got.shape), got)


@pytest.mark.cuda
def test_coarse_to_fine_engine_launches_both_kernels(cuda):
    """One coarse-to-fine request at a small width: the coarse stack (2
    layers), the two families' fine stacks (2 layers each) and 2 B4
    launches; then a tracked frame: no coarse pass, 4 NC and 2 B4."""
    cfg = ModelConfig(backbone="tiny", ncons_kernel_sizes=(3, 3), ncons_channels=(4, 1),
                      half_precision=True, sparse_topk=4)
    engine = BatchMatchEngine(cfg, init_ncnet(cfg, seed=0))
    rng = np.random.default_rng(3)
    src = rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    tgt = np.roll(src, (32, 32), axis=(1, 2))
    nc, b4 = nc_fused_lane.launches, sparse_corr.launches
    table = engine.fetch(engine.dispatch(src, tgt))
    assert (nc_fused_lane.launches - nc, sparse_corr.launches - b4) == (6, 2)
    assert table.shape == (2, 6, 64) and np.isfinite(table).all()
    prior = np.zeros((2, 16), np.int32)
    nc, b4, passes = nc_fused_lane.launches, sparse_corr.launches, engine.coarse_passes
    tracked = engine.fetch(engine.dispatch_tracked(src, tgt, prior, prior))
    assert (nc_fused_lane.launches - nc, sparse_corr.launches - b4) == (4, 2)
    assert engine.coarse_passes == passes
    assert tracked.shape == (2, 6, 64) and np.isfinite(tracked).all()


# (volume, k, C_in, C_out, dtype): odd sides, C_out 1-4 (and 6: two chunks
# of the kernels' 4 output channels), k 3 and 5 (the tensor-core kernel) in
# both dtypes, small planes and a wB the kernels tile; C_in wider than one
# chunk (64 and 66 at wB = 50, k = 5; 66 and 10 leave a partial 16-channel
# chunk), whole tiny planes packed several volumes a block (6^4 and 1 x 1),
# k = 9 (the CUDA-core kernel's uncompiled sizes) and k = MAX_K at its
# widest tile
B5_CASES = [
    ((2, 7, 5, 9, 11), 3, 16, 1, "float32"),
    ((1, 5, 7, 9, 5), 5, 16, 2, "bfloat16"),
    ((2, 9, 7, 5, 11), 3, 8, 3, "float32"),
    ((1, 7, 9, 5, 7), 5, 6, 4, "bfloat16"),
    ((1, 5, 5, 7, 9), 5, 16, 1, "bfloat16"),
    ((2, 5, 9, 7, 5), 3, 5, 4, "float32"),
    ((1, 5, 7, 5, 9), 3, 12, 6, "float32"),
    ((64, 6, 6, 6, 6), 5, 16, 1, "float32"),     # small planes, many blocks
    ((1, 3, 4, 9, 300), 3, 8, 1, "float32"),     # wB past one block's strips
    ((1, 3, 3, 50, 50), 5, 64, 4, "float32"),
    ((1, 3, 2, 50, 50), 5, 66, 1, "bfloat16"),
    ((1, 3, 5, 11, 13), 9, 8, 1, "float32"),
    ((1, 2, 2, 4, 256), conv4d_pallas.MAX_K, 4, 4, "float32"),
    ((24, 6, 6, 6, 6), 5, 16, 1, "bfloat16"),
    ((40, 3, 2, 1, 1), 5, 16, 1, "float32"),     # 1 x 1 planes
    ((33, 2, 3, 1, 1), 3, 10, 2, "bfloat16"),
    ((2, 7, 6, 12, 11), 3, 10, 1, "float32"),    # the default ModelConfig's
    ((2, 6, 7, 11, 12), 3, 10, 1, "bfloat16"),
    ((1, 4, 5, 50, 50), 5, 66, 3, "float32"),
    ((2, 5, 6, 7, 9), 5, 10, 3, "bfloat16"),
    ((1, 5, 6, 9, 8), 5, 16, 6, "float32"),
    ((1, 6, 5, 8, 9), 3, 16, 6, "bfloat16"),
    ((1, 2, 3, 5, 230), 5, 16, 1, "float32"),    # two column bands
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k,c_in,c_out,dtype", B5_CASES)
def test_b5_matches_twin(cuda, shape, k, c_in, c_out, dtype):
    """B5 against its twin, one launch per call, on the kernel its kernel
    size picks; two launches bit-identical."""
    g = torch.Generator().manual_seed(c_in * 10 + c_out)
    x = torch.randn(shape + (c_in,), generator=g).to(cuda, getattr(torch, dtype))
    w = (torch.randn((k,) * 4 + (c_in, c_out), generator=g) * 0.1).to(cuda)
    before = conv4d_pallas.launches
    kind = "tensor_core" if k in conv4d_pallas.TC_KERNEL_SIZES else "cuda_core"
    before_kind = conv4d_pallas.launches_by_kernel[kind]
    got = conv4d_pallas.conv4d_small_cout(x, w)
    again = conv4d_pallas.conv4d_small_cout(x, w)
    want = conv4d_pallas.conv4d_small_cout_reference(x, w)
    torch.cuda.synchronize()
    assert conv4d_pallas.launches == before + 2
    assert conv4d_pallas.launches_by_kernel[kind] == before_kind + 2
    assert got.shape == shape + (c_out,) and got.dtype == x.dtype
    assert torch.equal(got, again)
    tol = 2e-4 if dtype == "float32" else 2.0 ** -7
    assert normalized_err(got, want) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k,c_in,c_out", [
    ((2, 9, 8, 12, 10), 5, 16, 1), ((2, 7, 6, 9, 11), 3, 10, 3)])
def test_b5_all_positive_f32(cuda, shape, k, c_in, c_out):
    """The tensor-core kernel's three bf16 products on all-positive f32
    inputs: within 2e-4 of the f32 twin and 1e-5 of their emulation
    ``split_products_reference`` (the same products summed in f32 in
    another order)."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(
        conv4d_pallas.near_bf16_midpoints(rng, shape + (c_in,), 0)).to(cuda)
    w = torch.from_numpy(conv4d_pallas.near_bf16_midpoints(
        rng, (k,) * 4 + (c_in, c_out), -4)).to(cuda)
    got = conv4d_pallas.conv4d_small_cout(x, w)
    twin = conv4d_pallas.conv4d_small_cout_reference(x, w)
    split = conv4d_pallas.split_products_reference(x, w)
    torch.cuda.synchronize()
    assert normalized_err(got, twin) <= 2e-4
    assert normalized_err(got, split) <= 1e-5


@pytest.mark.cuda
def test_b5_backward_through_the_function(cuda, monkeypatch):
    """The Function's forward is the kernel, its backward the ``coutfold``
    formulation's autograd (as the JAX ``_bwd_rule``); cuDNN's
    deterministic algorithms make the two backward runs comparable bit for
    bit."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    g = torch.Generator().manual_seed(7)
    x = torch.randn((2, 5, 7, 5, 9, 16), generator=g).to(cuda).requires_grad_()
    w = (torch.randn((5, 5, 5, 5, 16, 1), generator=g) * 0.05).to(cuda).requires_grad_()
    cot = torch.randn((2, 5, 7, 5, 9, 1), generator=g).to(cuda)
    before = conv4d_pallas.launches
    conv4d_pallas.conv4d_small_cout(x, w).backward(cot)
    assert conv4d_pallas.launches == before + 1
    xx, ww = (t.detach().clone().requires_grad_() for t in (x, w))
    conv4d(xx, ww, variant="coutfold").backward(cot)
    torch.cuda.synchronize()
    assert torch.equal(x.grad, xx.grad) and torch.equal(w.grad, ww.grad)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fft_stack_matches_reference(cuda, dtype):
    """The FFT tier (cuFFT) at the PF-Pascal arch against the plain direct
    stack: B2's twin in bf16, the f32 ``unroll`` formulation in f32."""
    params, x = random_stack(np.random.default_rng(4), (1, 8, 7, 9, 8),
                             (5, 5, 5), (16, 16, 1), cuda)
    td = getattr(torch, dtype)
    params = [{k: v.to(td) for k, v in p.items()} for p in params]
    x = x.to(td)
    got = nc_stack_fft(params, x)
    if dtype == "bfloat16":
        want, tol = nc_fused_lane.nc_stack_reference(params, x), 1e-2
    else:
        want, tol = x, 1e-4
        for p in params:
            want = torch.relu(conv4d(want, p["w"], p["b"], variant="unroll"))
    torch.cuda.synchronize()
    assert got.dtype == td and normalized_err(got, want) <= tol


@pytest.mark.cuda
def test_fp32_engine_launches_b5(cuda):
    """An fp32 stack no tier takes runs per layer: one B5 launch on the
    batch-folded volume (the 8→1 layer), no B2 launch."""
    cfg = ModelConfig(backbone="tiny", ncons_kernel_sizes=(3, 3), ncons_channels=(8, 1))
    engine = BatchMatchEngine(cfg, init_ncnet(cfg, seed=0))
    rng = np.random.default_rng(5)
    src = rng.integers(0, 256, (2, 96, 96, 3), dtype=np.uint8)
    b2, b5 = nc_fused_lane.launches, conv4d_pallas.launches
    tc = conv4d_pallas.launches_by_kernel["tensor_core"]
    table = engine.fetch(engine.dispatch(src, src[::-1].copy()))
    assert (nc_fused_lane.launches - b2, conv4d_pallas.launches - b5) == (0, 1)
    assert conv4d_pallas.launches_by_kernel["tensor_core"] == tc + 1
    assert nc_fused_lane.last_selected_tier() == "xla"
    assert table.shape == (2, 6, 36) and np.isfinite(table).all()


@pytest.mark.cuda
@pytest.mark.parametrize("ydt_name", ["bf16", "f32"])
@pytest.mark.parametrize("batch", [1, 2])
def test_l2_probe_kernel_matches_twin(cuda, batch, ydt_name):
    """T1 on the card against its twin; one launch per call; the halo lanes
    zero; two launches bit-identical; at least 99 % of the nonzero interior
    outputs bit-equal to the twin of its Y dtype, and fewer to the other's."""
    l2 = pallas_l2_probe
    g = torch.Generator().manual_seed(batch)
    x = (torch.randn((batch,) + (l2.S,) * 4 + (l2.C,), generator=g) * 0.1
         ).to(cuda, torch.bfloat16)
    w = (torch.randn((l2.K,) * 4 + (l2.C, l2.C), generator=g) * 0.05
         ).to(cuda, torch.bfloat16)
    bias = (torch.randn((1, l2.C, 1), generator=g) * 0.1).to(cuda, torch.bfloat16)
    args = (l2.to_fused_layout(x), l2.pack_weight(w), bias, l2.make_mask(cuda))
    ydt = l2.YDTS[ydt_name]
    before = l2.launches
    got = l2.conv_l2_pallas(*args, ydt=ydt)
    again = l2.conv_l2_pallas(*args, ydt=ydt)
    torch.cuda.synchronize()
    assert l2.launches == before + 2
    assert got.shape == (batch, l2.S, l2.S, l2.C, l2.KL) and got.dtype == torch.bfloat16
    assert torch.equal(got, again)
    assert not got[..., :l2.LO].any() and not got[..., l2.LO + l2.NT:].any()
    tol = 1e-2 if ydt_name == "bf16" else 2.0 ** -7
    want = l2.conv_l2_reference(*args, ydt=ydt)
    assert normalized_err(got, want) <= tol
    other = l2.conv_l2_reference(
        *args, ydt=l2.YDTS["f32" if ydt_name == "bf16" else "bf16"])
    share = l2.bit_equal_share(got, want)
    assert share >= 0.99
    assert l2.bit_equal_share(got, other) < share


@pytest.mark.cuda
def test_every_probe_passes(cuda):
    """The T2 battery on the card: every probe builds, launches once and
    matches its twin."""
    before = mosaic_probes.launches
    results = mosaic_probes.run()
    assert results == {name: "PASS" for name in mosaic_probes.PROBES}
    kernels = [n for n, p in mosaic_probes.PROBES.items() if p is not None]
    assert mosaic_probes.launches == before + len(kernels)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 3])
def test_maxpool4d_on_cuda_equals_the_cpu(cuda, k):
    """The relocalization pooling of a bf16 volume full of exact ties: the
    pooled values and the first maximal offsets bit-equal to the CPU's."""
    from ncnet_tpu_torch.ops.pooling import maxpool4d_with_argmax

    rng = np.random.default_rng(k)
    vol = torch.from_numpy(rng.integers(0, 4, (2, 4 * k, 3 * k, 2 * k, 5 * k))
                           .astype(np.float32)).to(torch.bfloat16)
    got, got_d = maxpool4d_with_argmax(vol.to(cuda), k)
    want, want_d = maxpool4d_with_argmax(vol, k)
    assert torch.equal(got.cpu(), want)
    for g, w in zip(got_d, want_d):
        assert g.dtype == torch.int32 and torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("src_hw,out_hw", [((300, 500), (400, 400)),
                                           ((37, 53), (64, 29))])
def test_resize_on_cuda_equals_the_cpu(cuda, src_hw, out_hw):
    """The device resize's two contractions stay full f32 on the card:
    within 1e-6 of the image's largest value of the CPU's (a TF32 product
    keeps 10 mantissa bits and would be off by about 1e-3 of it)."""
    from ncnet_tpu_torch.ops.image import resize_bilinear_align_corners

    img = torch.from_numpy(np.random.default_rng(14).uniform(
        0, 255, (2,) + src_hw + (3,)).astype(np.float32))
    want = resize_bilinear_align_corners(img, *out_hw)
    got = resize_bilinear_align_corners(img.to(cuda), *out_hw).cpu()
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (got - want).abs().max() <= 1e-6 * img.abs().max()


@pytest.mark.cuda
def test_eval_step_on_cuda_matches_the_cpu_readout(cuda, monkeypatch):
    """The eval step's table on the card: the quality columns equal
    ``quality_table`` on the step's own volume, and the PCK column
    ``pck_metric`` run on the CPU on that volume, within one keypoint a
    sample (softmax on two devices may round a near-tie otherwise)."""
    from ncnet_tpu_torch.evaluation import pf_pascal
    from ncnet_tpu_torch.evaluation.pck import pck_metric
    from ncnet_tpu_torch.models.ncnet import NCNet
    from ncnet_tpu_torch.observability.quality import quality_table
    from ncnet_tpu_torch.ops.matching import corr_to_matches

    cfg = ModelConfig(backbone="tiny", ncons_kernel_sizes=(3, 3), ncons_channels=(4, 1),
                      half_precision=True)
    net = NCNet(cfg, seed=0)
    rng = np.random.default_rng(6)
    src = rng.integers(0, 256, (3, 128, 128, 3), dtype=np.uint8)
    points = np.full((2, 3, 2, 20), -1, np.float32)
    for i, n in enumerate((8, 20, 13)):
        xy = rng.uniform(1, 96, (2, n)).astype(np.float32)
        points[0, i, :, :n], points[1, i, :, :n] = xy, xy + 32
    size = np.tile(np.float32([128, 128, 3]), (3, 1))
    host = {"source_image": src, "target_image": np.roll(src, (32, 32), axis=(1, 2)),
            "source_points": points[0], "target_points": points[1],
            "source_im_size": size, "target_im_size": size,
            "L_pck": np.float32([[60], [80], [70]])}
    calls = []
    real = pf_pascal.ncnet_forward

    def recorded(*args):
        out = real(*args)
        calls.append(out)
        return out

    monkeypatch.setattr(pf_pascal, "ncnet_forward", recorded)
    step = pf_pascal.make_eval_step(net, 0.1, device_normalize=True)
    table = step(net.params, {k: torch.as_tensor(v).to(cuda) for k, v in host.items()}).cpu()
    assert table.shape == (3, 6) and torch.isfinite(table).all()
    corr = calls[0].corr
    assert torch.equal(table[:, 1:], quality_table(corr).cpu())
    cpu_batch = {k: torch.as_tensor(v) for k, v in host.items()}
    pck = pck_metric(cpu_batch, corr_to_matches(corr.cpu(), do_softmax=True), 0.1)
    n_valid = (cpu_batch["source_points"][:, 0] != -1).sum(dim=1)
    assert ((table[:, 0] - pck).abs() * n_valid).round().max() <= 1


@pytest.mark.cuda
def test_relocalized_engine_launches_the_kernel(cuda):
    """``relocalization_k_size=2`` at a small width: 192² pairs give a 12²
    grid pooled to 6², whose bf16 stack (k = 3) no arithmetic tier takes:
    one folded B2 call of 2 layers a request; the matches on the 12-point
    fine grid."""
    from ncnet_tpu_torch.ops.matching import _grid

    cfg = ModelConfig(backbone="tiny", ncons_kernel_sizes=(3, 3), ncons_channels=(4, 1),
                      half_precision=True, relocalization_k_size=2)
    engine = BatchMatchEngine(cfg, init_ncnet(cfg, seed=0))
    rng = np.random.default_rng(7)
    src = rng.integers(0, 256, (2, 192, 192, 3), dtype=np.uint8)
    before = nc_fused_lane.launches
    table = engine.fetch(engine.dispatch(src, np.roll(src, (8, 24), axis=(1, 2))))
    assert nc_fused_lane.launches == before + 2
    assert nc_fused_lane.last_selected_tier() == "resident"
    assert table.shape == (2, 6, 36) and np.isfinite(table).all()
    assert np.isin(table[:, :4], _grid(-1.0, 12, "cpu").numpy()).all()


@pytest.mark.cuda
def test_run_eval_on_the_card(cuda, tmp_path, monkeypatch):
    """The eval loop on the card: a raw fixture of 5 pairs through
    ``run_eval`` with a tiny bf16 stack ((3, 3) / (4, 1), centre-peaked),
    whose folded 6⁴ volume takes B2: 2 launches a batch of 2 (3 batches,
    the last padded), no quarantine, and per-pair PCK within one keypoint
    of the same run on the CPU (the kernel and its twin round a bf16
    output one ulp apart here and there)."""
    from ncnet_tpu_torch.config import EvalPFPascalConfig
    from ncnet_tpu_torch.data.synthetic import write_pf_pascal_like
    from ncnet_tpu_torch.evaluation import run_eval
    from ncnet_tpu_torch.models.ncnet import NCNet

    monkeypatch.setenv("NCNET_TPU_PERF_STORE", "off")  # not the repo's history
    root = str(tmp_path / "pf")
    write_pf_pascal_like(root, n_pairs=5, image_hw=(96, 96), shift=(16, 16), seed=3)
    cfg = ModelConfig(backbone="tiny", ncons_kernel_sizes=(3, 3), ncons_channels=(4, 1),
                      half_precision=True)
    params = init_ncnet(cfg, seed=0)
    for layer in params["nc"]:
        layer["w"][1, 1, 1, 1] += 1.0 / layer["w"].shape[4]
        layer["b"] += 0.05
    config = EvalPFPascalConfig(image_size=96, eval_dataset_path=root)
    before = nc_fused_lane.launches
    got = run_eval(config, net=NCNet(cfg, params), batch_size=2, num_workers=2,
                   progress=False)
    assert nc_fused_lane.launches == before + 6
    assert nc_fused_lane.last_selected_tier() == "resident"
    want = run_eval(config, net=NCNet(cfg, params, device="cpu"), batch_size=2,
                    num_workers=0, progress=False)
    assert got["quarantined_batches"] == [] and got["total"] == got["valid"] == 5
    assert np.abs(got["per_pair"] - want["per_pair"]).max() <= 1 / 6 + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("side,sparse_topk", [(96, 0), (192, 4)])
def test_eval_step_does_not_wait_for_the_card(cuda, side, sparse_topk):
    """After a first call, one eval step (dense on B2, or coarse-to-fine
    with B4) runs with ``torch.cuda.set_sync_debug_mode("error")``: no
    operation the debug mode sees makes the host wait for the card, so the
    loop's dispatch of batch i+1 queues behind batch i's compute."""
    from ncnet_tpu_torch.evaluation.pf_pascal import make_eval_step
    from ncnet_tpu_torch.models.ncnet import NCNet

    cfg = ModelConfig(backbone="tiny", ncons_kernel_sizes=(3, 3), ncons_channels=(4, 1),
                      half_precision=True, sparse_topk=sparse_topk)
    net = NCNet(cfg, init_ncnet(cfg, seed=0))
    rng = np.random.default_rng(6)
    src = rng.integers(0, 256, (2, side, side, 3), dtype=np.uint8)
    pts = np.full((2, 2, 20), -1, np.float32)
    pts[:, :, :6] = rng.uniform(10, side - 10, (2, 2, 6))
    batch = {"source_image": src, "target_image": np.roll(src, 16, axis=1),
             "source_points": pts, "target_points": pts + 8,
             "source_im_size": np.tile(np.float32([side, side, 3]), (2, 1)),
             "target_im_size": np.tile(np.float32([side, side, 3]), (2, 1)),
             "L_pck": np.full((2, 1), 50, np.float32)}
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()}
    step = make_eval_step(net, 0.1, device_normalize=True)
    want = step(net.params, batch).cpu()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = step(net.params, batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(out.cpu(), want)


def _tiny_fit_config(root, out, **kw):
    from ncnet_tpu_torch.config import TrainConfig

    return TrainConfig(
        model=ModelConfig(backbone="tiny", ncons_kernel_sizes=(3, 3),
                          ncons_channels=(4, 1), half_precision=True),
        image_size=112, dataset_image_path=root,
        dataset_csv_path=root + "/image_pairs", num_epochs=2, batch_size=2,
        lr=1e-3, result_model_dir=str(out), log_interval=100,
        checkpoint_steps=1, keep_checkpoints=2, **kw)


@pytest.mark.cuda
def test_fit_step_waits_for_the_card_once(cuda, tmp_path, monkeypatch):
    """A steady-state step of ``fit`` itself (telemetry on, no periodic
    checkpoint; step 3 of an epoch of 4: its dispatch, the staging of
    batch 4, the loss fetch, the step event and ``fit``'s ``on_step`` with
    the heartbeat, the device monitor, the NaN streak and the checkpoint
    decision) makes the host wait for the card once, the loss and
    grad-norm fetch: the NaN guard decides on the card.  Counted under
    ``torch.cuda.set_sync_debug_mode("warn")``, switched on and off by
    the step tracer ``fit`` feeds."""
    import dataclasses
    import warnings

    from ncnet_tpu_torch.data.synthetic import write_pair_dataset
    from ncnet_tpu_torch.training import fit
    from ncnet_tpu_torch.training import train as train_mod

    class SyncWindow:
        enabled = True

        def at_step(self, global_step):
            torch.cuda.set_sync_debug_mode("warn" if global_step == 3 else 0)

        def close(self):
            torch.cuda.set_sync_debug_mode(0)

    monkeypatch.setenv("NCNET_TPU_PERF_STORE", "off")
    monkeypatch.setattr(train_mod, "StepWindowTracer",
                        lambda *a, **k: SyncWindow())
    root = write_pair_dataset(str(tmp_path / "data"), n_pairs=8,
                              image_hw=(112, 112), shift=(16, 16), seed=1)
    cfg = _tiny_fit_config(root, tmp_path / "out")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            res = fit(dataclasses.replace(cfg, num_epochs=1,
                                          checkpoint_steps=0),
                      progress=False, device=cuda)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    waits = [str(w.message) for w in caught if "called a synchronizing" in str(w.message)]
    assert len(waits) == 1, waits
    assert res["state"].step == 4 and np.isfinite(res["train_loss"]).all()


@pytest.mark.cuda
def test_fit_on_the_card_resumes_bit_equal(cuda, tmp_path):
    """``fit`` on the card from a fixture of raw pairs: B3 launches, the
    checkpoint loads back bit-equal, and a run preempted by SIGTERM after
    step 3 and resumed ends bit-equal to the uninterrupted one."""
    import dataclasses

    from ncnet_tpu_torch.data.synthetic import write_pair_dataset
    from ncnet_tpu_torch.models import checkpoint as ckpt_io
    from ncnet_tpu_torch.models.ncnet import tree_leaves
    from ncnet_tpu_torch.training import fit
    from ncnet_tpu_torch.utils import faults

    root = write_pair_dataset(str(tmp_path / "data"), n_pairs=4,
                              image_hw=(112, 112), shift=(16, 16), seed=1)
    for key in nc_fused_lane_vjp.launches:
        nc_fused_lane_vjp.launches[key] = 0
    full = fit(_tiny_fit_config(root, tmp_path / "a", telemetry=False),
               progress=False, device=cuda)
    assert nc_fused_lane_vjp.launches["nc_vjp_dw"] > 0
    _, params = ckpt_io.load_params(full["checkpoint"])
    assert all(torch.equal(a, b.cpu()) for a, b in zip(
        tree_leaves(params), tree_leaves(full["state"].params)))
    with faults.injected(faults.FaultPlan(sigterm_at_step=3)):
        cut = fit(_tiny_fit_config(root, tmp_path / "b", telemetry=False),
                  progress=False, device=cuda)
    assert cut["preempted"]
    cfg = _tiny_fit_config(root, tmp_path / "c", telemetry=False)
    resumed = fit(dataclasses.replace(cfg, model=cfg.model.replace(
        checkpoint=cut["checkpoint"])), progress=False, device=cuda)
    assert resumed["state"].step == full["state"].step == 4
    for a, b in zip(tree_leaves((resumed["state"].params,
                                 resumed["state"].opt_state._asdict())),
                    tree_leaves((full["state"].params,
                                 full["state"].opt_state._asdict()))):
        assert torch.equal(a, b)


# the InLoc layer shapes: the tap-swap chain's (forward only) and the IVD
# stack's, on rectangular volumes: (hA, wA) the transpose of (hB, wB), and
# two planes of different sizes
RECT_VOLUMES = [(1, 6, 5, 5, 6), (2, 7, 5, 9, 11)]


@pytest.mark.cuda
@pytest.mark.parametrize("k,c_in,c_out", [(3, 1, 32), (3, 32, 2), (3, 1, 16),
                                          (3, 16, 1)])
@pytest.mark.parametrize("shape", RECT_VOLUMES)
def test_b6_matches_twin_on_rectangular_volumes(cuda, shape, k, c_in, c_out):
    rng = np.random.default_rng(12)
    x = torch.from_numpy(np.maximum(rng.normal(0, 0.5, shape + (c_in,)), 0)
                         .astype(np.float32)).to(cuda, torch.bfloat16)
    w = torch.from_numpy(rng.normal(0, 0.1, (k,) * 4 + (c_in, c_out))
                         .astype(np.float32)).to(cuda, torch.bfloat16)
    b = torch.from_numpy(rng.normal(0, 0.1, (c_out,)).astype(np.float32)
                         ).to(cuda, torch.bfloat16)
    before = nc_fused_lane.launches
    got = nc_fused_lane.nc_conv4d_layer(x, w, b)
    again = nc_fused_lane.nc_conv4d_layer(x, w, b)
    torch.cuda.synchronize()
    assert nc_fused_lane.launches == before + 2
    assert torch.equal(got, again)
    assert normalized_err(got, nc_fused_lane.layer_reference(x, w, b)) <= 1e-2


@pytest.mark.cuda
def test_chain_transposed_launch_is_not_compiled(cuda):
    """The chain's layers are forward only: B3's input gradient refuses
    them before any launch."""
    gz = torch.zeros((1, 3, 3, 3, 3, 2), dtype=torch.bfloat16, device=cuda)
    w = torch.zeros((3, 3, 3, 3, 32, 2), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(NotImplementedError, match="transposed"):
        nc_fused_lane_vjp.nc_conv4d_transpose(gz, w)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RECT_VOLUMES)
def test_tap_swap_chain_on_the_card(cuda, shape):
    """The IVD stack on a rectangular volume through ``neigh_consensus``:
    one chain call of 2 B6 launches, within 1e-2 of the same chain
    through the twins and of the two-pass form through the twins."""
    from ncnet_tpu_torch.models.ncnet import neigh_consensus, tap_swap_chain

    params, _ = random_stack(np.random.default_rng(13), shape, (3, 3), (16, 1),
                             cuda)
    corr = torch.from_numpy(np.random.default_rng(14).uniform(0, 1, shape)
                            .astype(np.float32)).to(cuda, torch.bfloat16)
    before = nc_fused_lane.launches
    got = neigh_consensus(params, corr)
    torch.cuda.synchronize()
    assert nc_fused_lane.launches == before + 2
    assert nc_fused_lane.last_selected_tier() == "resident"
    x = corr[..., None]
    y2 = nc_fused_lane.nc_stack_reference(tap_swap_chain(params), x)
    chain = (y2[..., :1] + y2[..., 1:])[..., 0]
    assert normalized_err(got, chain) <= 1e-2
    xt = x.permute(0, 3, 4, 1, 2, 5).contiguous()
    two = (nc_fused_lane.nc_stack_reference(params, x).float()
           + nc_fused_lane.nc_stack_reference(params, xt)
           .permute(0, 3, 4, 1, 2, 5).float())[..., 0]
    assert normalized_err(got, two) <= 1e-2


def shared_matches(got, want, grid):
    """The share of ``want``'s matches that ``got`` holds, and the largest
    score difference between their shared matches; tables are the
    matcher's five vectors, matches keyed by their fine cells."""
    (ha, wa, hb, wb), k = grid
    sizes = np.asarray([wa, ha, wb, hb], dtype=np.float64) * k
    tabs = []
    for t in (got, want):
        cells = np.rint(np.stack(t[:4], -1).astype(np.float64) * sizes - 0.5
                        ).astype(np.int64)
        tabs.append({tuple(c): float(s) for c, s in zip(cells, t[4])})
    common = tabs[0].keys() & tabs[1].keys()
    return (len(common) / len(tabs[1]),
            max(abs(tabs[0][c] - tabs[1][c]) for c in common))


@pytest.mark.cuda
def test_inloc_matcher_on_the_card_matches_the_cpu(cuda):
    """The InLoc pair matcher (IVD stack, bf16, k = 2, the tiny trunk) on a
    portrait query and a landscape cutout at 256 px: on the card the
    rectangular volume takes the chain, 2 B6 launches a pair, and the
    table matches the CPU run of the same weights (see the docstring)."""
    from ncnet_tpu_torch.data.synthetic import _textured_image
    from ncnet_tpu_torch.evaluation.inloc import make_pair_matcher

    cfg = ModelConfig(backbone="tiny", ncons_kernel_sizes=(3, 3),
                      ncons_channels=(16, 1), half_precision=True,
                      relocalization_k_size=2)
    params = init_ncnet(cfg, seed=0)
    for layer in params["nc"]:
        layer["w"][1, 1, 1, 1] += 1.0 / layer["w"].shape[4]
        layer["b"] += 0.05
    big = _textured_image(np.random.default_rng(15), 320, 320)
    query, pano = big[None, :256, :192], big[None, 8:200, 24:280]
    tables = {}
    for dev in (cuda, torch.device("cpu")):
        m = make_pair_matcher(cfg, params, do_softmax=True,
                              both_directions=True, flip_direction=False,
                              preprocess_image_size=256, device=dev)
        before = nc_fused_lane.launches
        tables[dev.type] = m(m.preprocess(query), pano)
        if dev.type == "cuda":
            assert nc_fused_lane.launches == before + 2
    share, score_err = shared_matches(tables["cuda"], tables["cpu"],
                                      ((8, 6, 6, 8), 2))
    assert share >= 0.9 and score_err <= 2e-2, (share, score_err)


# the localization stage's device parts: the RANSAC's hypothesis scorer and
# the dense SIFT (no kernel: plain torch on the card)


def scorer_inputs(rng, n=1000, h=5000):
    """Hypotheses near one pose, further and further from it, so that
    more and more angular residuals reach the 0.2 degree threshold; float64
    cosines minus the f32 threshold in f32 ulps of it."""
    Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    Q *= np.sign(np.linalg.det(Q))
    P = np.concatenate([Q, np.array([[0.1], [-0.2], [4.0]])], axis=1)
    X = rng.normal(size=(n, 3)) + np.array([0, 0, 5.0])
    xc = X @ P[:, :3].T + P[:, 3]
    rays = xc / np.linalg.norm(xc, axis=1, keepdims=True)
    rays += rng.normal(0, np.deg2rad(0.05), rays.shape)
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)
    poses = np.repeat(P[None], h, axis=0)
    poses[:, :, 3] += (rng.normal(0, 1, (h, 3))
                       * np.linspace(2e-4, 6e-3, h)[:, None])
    thr = np.float32(np.cos(np.deg2rad(0.2)))
    xc = np.einsum("hij,nj->hni", poses[:, :, :3], X) + poses[:, None, :, 3]
    cos = np.einsum("hni,ni->hn", xc, rays) / np.linalg.norm(xc, axis=-1)
    margin = (cos - np.float64(thr)) / np.float64(np.spacing(thr))
    return poses, rays, X, margin


def scorer_masks(poses, rays, X, device):
    from ncnet_tpu_torch.localization import p3p

    Pt = torch.from_numpy(poses.astype(np.float32)).to(device)
    return p3p._inlier_mask(
        Pt[:, :, :3], Pt[:, :, 3],
        torch.from_numpy(rays.astype(np.float32)).to(device),
        torch.from_numpy(X.astype(np.float32)).to(device),
        torch.ones(len(rays), dtype=torch.bool, device=device),
        torch.tensor(np.float32(np.cos(np.deg2rad(0.2))), device=device)
    ).cpu().numpy()


@pytest.mark.cuda
def test_localization_scorer_ignores_tf32(cuda, monkeypatch):
    """The scorer's decisions on the card do not move with TF32 forced on
    (explicit f32 products and sums, no matmul); against the CPU every
    decision whose float64 cosine lies more than 16 f32 ulps from the
    threshold is the same, and the best hypothesis (first maximum) too."""
    from ncnet_tpu_torch.localization import p3p

    poses, rays, X, margin = scorer_inputs(np.random.default_rng(0))
    thr = np.deg2rad(0.2)
    off = scorer_masks(poses, rays, X, cuda)
    best_off = p3p._score_hypotheses(poses, rays, X, thr, device=cuda)
    precision = torch.get_float32_matmul_precision()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    torch.set_float32_matmul_precision("high")
    try:
        on = scorer_masks(poses, rays, X, cuda)
        best_on = p3p._score_hypotheses(poses, rays, X, thr, device=cuda)
    finally:
        torch.set_float32_matmul_precision(precision)
    np.testing.assert_array_equal(on, off)
    assert best_on[:2] == best_off[:2]
    np.testing.assert_array_equal(best_on[2], best_off[2])
    band = np.abs(margin) <= 16
    clean = band.sum(axis=1) == 0
    assert band.any() and 0.1 < clean.mean() < 0.9
    cpu = scorer_masks(poses, rays, X, "cpu")
    np.testing.assert_array_equal(on[~band], cpu[~band])
    np.testing.assert_array_equal(on[~band], (margin > 0)[~band])
    np.testing.assert_array_equal(on.sum(1)[clean], cpu.sum(1)[clean])
    best_cpu = p3p._score_hypotheses(poses, rays, X, thr, device="cpu")
    assert best_on[:2] == best_cpu[:2]


@pytest.mark.cuda
def test_localization_dense_sift_matches_cpu(cuda, monkeypatch):
    """``dense_sift`` on the card with cuDNN's TF32 on (PyTorch's default)
    and matmul TF32 forced on: within 1e-5 of the CPU (no convolution or
    matmul on its path)."""
    from ncnet_tpu_torch.localization.dsift import dense_sift

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    rng = np.random.default_rng(3)
    img = rng.random((504, 378)).astype(np.float32) * 255
    img[100:160, 40:300] = 9.0
    got = dense_sift(img, device=cuda)
    want = dense_sift(img, device="cpu")
    assert got.shape == want.shape == (120, 89, 128)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_localization_run_on_the_card_matches_the_cpu(cuda, monkeypatch,
                                                       tmp_path):
    """``run_localization`` on ``chip_smoke``'s synthetic room at a small
    size, on the card and with ``device="cpu"``: the true pose recovered,
    verified first, and the poses bit-equal where the inlier masks agree
    (all pairs here); the pose-verification scores within 1e-5 relative."""
    import dataclasses

    import os

    from scipy.io import loadmat

    import chip_smoke
    from ncnet_tpu_torch.config import LocalizationConfig
    from ncnet_tpu_torch.localization import driver, geometry

    for name, value in (("INLOC_QUERY_HW", (400, 300)),
                        ("INLOC_PANO_HW", (120, 160)), ("LOC_ROWS", 1500),
                        ("LOC_GOOD_ROWS", 700), ("LOC_PAD_ROWS", 200),
                        ("LOC_SCAN_POINTS", 100_000), ("LOC_NOISE_PX", 0.2)):
        monkeypatch.setattr(chip_smoke, name, value)
    kw, P_true, _ = chip_smoke.write_localization_scene(str(tmp_path / "scene"))
    card = LocalizationConfig(output_dir=str(tmp_path / "card"),
                              ransac_iters=2000, **kw)
    cpu = dataclasses.replace(card, output_dir=str(tmp_path / "cpu"))
    driver.run_localization(card)
    driver.run_localization(cpu, device="cpu")
    (pe, pv), (cpe, cpv) = (chip_smoke.stage_imglists(c) for c in (card, cpu))
    pair_dirs = [os.path.join(c.output_dir, driver._pnp_dirname(c),
                              "query_0.jpg") for c in (card, cpu)]
    for f in os.listdir(pair_dirs[0]):
        a, b = (loadmat(os.path.join(d, f)) for d in pair_dirs)
        np.testing.assert_array_equal(a["inls"], b["inls"])
        np.testing.assert_array_equal(a["P"], b["P"])
    assert pe[0]["topNname"] == cpe[0]["topNname"]
    assert pv[0]["topNname"] == cpv[0]["topNname"]
    np.testing.assert_allclose(pv[0]["topNscore"], cpv[0]["topNscore"],
                               rtol=1e-5)
    assert pv[0]["topNname"][0] == "DUC1/DUC_cutout_001_0_0.jpg"
    dp, do = geometry.pose_distance(P_true, pv[0]["P"][0])
    assert dp < 0.05 and np.rad2deg(do) < 0.2


# the VGG-16 and DenseNet-201 trunks, and the hB-sharded forward on a
# one-card mesh


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["vgg", "densenet201"])
def test_trunk_on_the_card_matches_the_cpu(cuda, name):
    """Each trunk at full width on a 128² batch of 4 (cuDNN picks
    DenseNet's small convolutions by batch size), f32 with TF32 off:
    within 1e-4 normalized of the same weights on the CPU."""
    from ncnet_tpu_torch.models import backbone

    params = backbone.backbone_init(name, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (4, 128, 128, 3)).astype(np.float32))
    with torch.no_grad():
        cpu = backbone.backbone_apply(name, params, x)
        card = backbone.backbone_apply(name, _to(params, cuda), x.to(cuda))
    assert card.shape == cpu.shape == (4, 8, 8, backbone.OUTPUT_CHANNELS[name])
    assert normalized_err(card, cpu.to(cuda)) <= 1e-4


def _to(tree, dev):
    from ncnet_tpu_torch.models.ncnet import params_to

    return params_to(tree, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("half", [False, True], ids=["fp32", "bf16"])
def test_spatial_forward_on_one_card_matches_the_unsharded(cuda, half):
    """``spatial_forward`` on a mesh naming the card twice (k = 2, a
    target whose fine hB needs pad-and-mask) against the unsharded forward
    on the card: 1e-4 normalized in f32 (the valid-dim convolutions sum in
    another order), 7·2⁻⁷ in bf16 (the served phases' bound: the unsharded
    forward's NC stack takes B6); the offsets equal in f32; no B6 or B5
    launch on the sharded path."""
    from ncnet_tpu_torch.models.ncnet import ncnet_forward
    from ncnet_tpu_torch.parallel import make_mesh, spatial_forward

    cfg = ModelConfig(backbone="tiny", ncons_kernel_sizes=(3, 3),
                      ncons_channels=(16, 1), relocalization_k_size=2,
                      half_precision=half)
    params = _to(init_ncnet(cfg, seed=0), cuda)
    for layer in params["nc"]:
        layer["w"][1, 1, 1, 1] += 1.0 / layer["w"].shape[4]
        layer["b"] += 0.05
    rng = np.random.default_rng(2)
    src = torch.from_numpy(rng.uniform(-1, 1, (1, 256, 192, 3)).astype(
        np.float32)).to(cuda)
    # 288 px: 18 fine rows, padded to 20 to split over 2 shards of k = 2
    tgt = torch.from_numpy(rng.uniform(-1, 1, (1, 288, 256, 3)).astype(
        np.float32)).to(cuda)
    mesh = make_mesh(data=1, spatial=2, devices=[cuda, cuda])
    with torch.no_grad():
        before = (nc_fused_lane.launches, conv4d_pallas.launches)
        got = spatial_forward(cfg, params, src, tgt, mesh)
        assert (nc_fused_lane.launches, conv4d_pallas.launches) == before
        want = ncnet_forward(cfg, params, src, tgt)
    assert got.corr.shape == want.corr.shape == (1, 8, 6, 9, 8)
    assert normalized_err(got.corr, want.corr) <= (7 * 2.0 ** -7 if half else 1e-4)
    if not half:
        for g, w in zip(got.delta4d, want.delta4d):
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_bf16_weight_gradients_of_a_wide_kernel_on_the_card(cuda):
    """ROADMAP C3 on the card: the CPU library's bf16 conv3d gives a wrong,
    nondeterministic weight gradient when the kernel is wider than the
    volume, and the port's CPU path computes that product in f32, rounding
    once (XLA:CPU's rounding points).  On the card the bf16 conv runs as
    given (cuDNN): the k = 7 (16, 16, 1) stack on a 5⁴ volume, per layer
    through the formulations, gives the same gradients from one call to
    the next, and each leaf lies within max(2 d, 1e-2) normalized of the
    f32 autograd gradient of the same bf16-valued weights and input, where
    d is the repaired CPU path's distance from that f32 gradient on the
    same inputs (bf16 rounding amplified through the stack: d is about
    0.11 for the first layer's weights, the CPU fault 0.5 and more)."""
    from ncnet_tpu_torch.models.ncnet import neigh_consensus

    params, x = random_stack(np.random.default_rng(31), (1, 5, 5, 5, 5),
                             (7, 7, 7), (16, 16, 1), cuda)

    def grads(dtype, device):
        leaves = [{k: v.to(device, dtype).clone().requires_grad_()
                   for k, v in p.items()} for p in params]
        neigh_consensus(leaves, x[..., 0].to(device, dtype), allow_pallas=False,
                        require_vjp=True).float().square().sum().backward()
        if device.type == "cuda":
            torch.cuda.synchronize()
        return [g.grad.float().cpu() for p in leaves for g in (p["w"], p["b"])]

    cpu = torch.device("cpu")
    first, second = grads(torch.bfloat16, cuda), grads(torch.bfloat16, cuda)
    f32, cpu_bf16 = grads(torch.float32, cuda), grads(torch.bfloat16, cpu)
    for g1, g2, gf, gc in zip(first, second, f32, cpu_bf16):
        assert torch.equal(g1, g2)
        assert normalized_err(g1, gf) <= max(2 * normalized_err(gc, gf), 1e-2)


def _service_model():
    cfg = ModelConfig(backbone="tiny", ncons_kernel_sizes=(3, 3),
                      ncons_channels=(4, 1), half_precision=True,
                      sparse_topk=4)
    return cfg, init_ncnet(cfg, seed=0)


def _service_pairs(n, side=192):
    rng = np.random.default_rng(12)
    out = []
    for _ in range(n):
        src = rng.integers(0, 256, (side, side, 3), dtype=np.uint8)
        out.append((src, np.roll(src, 16, axis=1)))
    return out


@pytest.mark.cuda
def test_two_replica_service_answers_on_the_card(cuda, tmp_path, monkeypatch):
    """``MatchService`` with two replicas on one card and a feature store:
    groups of two pairs (each one batch) answer with tables bit-equal to
    the engine's direct dispatch of the same batch, the coarse-to-fine
    kernels launch (B8 and B6), a warm second pass is bitwise the cold
    one, and the warm-up measured one ledger row a batch size (ROADMAP
    D9) with temp bytes on the card."""
    from ncnet_tpu_torch.observability import memory as obs_memory
    from ncnet_tpu_torch.serving import MatchService, ServingConfig, pad_to_bucket

    monkeypatch.setenv("NCNET_TPU_MEMORY_LEDGER", str(tmp_path / "ledger.json"))
    obs_memory._reset_state()
    cfg, params = _service_model()
    svc = MatchService(cfg, params, ServingConfig(
        buckets=((192, 192),), warm_buckets=((192, 192),), max_batch=2,
        replicas=2, max_image_side=192,
        feature_store_dir=str(tmp_path / "store")),
        devices=["cuda:0", "cuda:0"]).start()
    pairs = _service_pairs(6)
    try:
        def one_pass():
            tables = []
            for g in range(0, len(pairs), 2):
                with svc._cond:  # the group enters the queue as one batch
                    futs = [svc.submit(s, t) for s, t in pairs[g:g + 2]]
                tables += [f.result(timeout=300).table for f in futs]
            return tables

        while svc.state == "STARTING":  # the warm-up launches too
            time.sleep(0.05)
        before = sparse_corr.launches, nc_fused_lane.launches
        cold = one_pass()
        launched = (sparse_corr.launches - before[0],
                    nc_fused_lane.launches - before[1])
        warm = one_pass()
        engine = svc._pool.replicas[1].engine
        src = pad_to_bucket([s for s, _ in pairs[:2]], (192, 192))
        tgt = pad_to_bucket([t for _, t in pairs[:2]], (192, 192))
        direct = engine.split(engine.fetch(engine.dispatch(src, tgt)))[0]
        health = svc.health()
    finally:
        svc.stop(timeout=120)
    assert launched[0] == 2 * 3 and launched[1] > 0
    for c, w in zip(cold, warm):
        assert np.array_equal(c, w)
    assert np.array_equal(direct[0], cold[0]) and np.array_equal(direct[1], cold[1])
    rows = obs_memory.ledger_rows(program=obs_memory.SERVE_PROGRAM)
    assert sorted(r["shape_class"] for r in rows) == [
        "192x192-192x192xb1", "192x192-192x192xb2"]
    assert all(r["temp_bytes"] > 0 and r["output_bytes"] > 0 for r in rows)
    assert health["memory"]["predicted_ladder_bytes"] == sum(
        r["temp_bytes"] + r["output_bytes"] for r in rows)
    assert health["store"]["counters"]["hits"] >= 6
    obs_memory._reset_state()


@pytest.mark.cuda
@pytest.mark.parametrize("with_store", [False, True])
def test_replica_dispatch_does_not_wait_for_the_card(cuda, tmp_path,
                                                     with_store):
    """After a first call, ``Replica.dispatch`` of a coarse-to-fine batch
    (with the feature store: its rows hits) runs under
    ``torch.cuda.set_sync_debug_mode("error")``: the upload is staged from
    pinned memory and nothing makes the host wait, so the service's
    dispatcher queues batch i+1 behind batch i.  Its table is the first
    call's bit for bit."""
    from ncnet_tpu_torch.serving import Replica
    from ncnet_tpu_torch.store import FeatureStore

    cfg, params = _service_model()
    store = (FeatureStore(str(tmp_path / "s"), "x-s0-k1-bf16-torch.cuda")
             if with_store else None)
    rep = Replica("rep0", BatchMatchEngine(cfg, params, store=store),
                  device=cuda)
    pairs = _service_pairs(2)
    src = np.stack([s for s, _ in pairs])
    tgt = np.stack([t for _, t in pairs])
    want = rep.fetch(rep.dispatch(src, tgt))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        handle = rep.dispatch(src, tgt)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert np.array_equal(rep.fetch(handle), want)


@pytest.mark.cuda
def test_swap_params_on_a_drained_replica_is_ordered_before_the_next_dispatch(
        cuda):
    """A weight swap on a drained CUDA replica, followed at once by a
    dispatch, gives the table a fresh engine built with the new weights
    gives, bit for bit (a copy not ordered with the dispatch's stream would
    read old or torn weights), and that dispatch runs under
    ``torch.cuda.set_sync_debug_mode("error")``: the swap leaves no host
    wait to the next dispatch.  The old tree is no longer referenced."""
    from ncnet_tpu_torch.serving import Replica

    cfg, old = _service_model()
    new = init_ncnet(cfg, seed=1)
    pairs = _service_pairs(2)
    src = np.stack([s for s, _ in pairs])
    tgt = np.stack([t for _, t in pairs])
    fresh = BatchMatchEngine(cfg, new)
    want = fresh.fetch(fresh.dispatch(src, tgt))
    del fresh
    engine = BatchMatchEngine(cfg, old)
    rep = Replica("rep0", engine, device=cuda)
    before = rep.fetch(rep.dispatch(src, tgt))
    stale = engine._params["nc"][0]["w"]
    # a large queue of work ahead of the swap: the copies must wait for it
    # on the stream, not race it
    busy = torch.randn(4096, 4096, device=cuda)
    for _ in range(8):
        busy = busy @ busy / 64.0
    engine.swap_params(new)
    torch.cuda.set_sync_debug_mode("error")
    try:
        handle = rep.dispatch(src, tgt)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = rep.fetch(handle)
    assert np.array_equal(got, want)
    assert not np.array_equal(got, before)
    assert engine.swap_fastpath_hits == 1
    import weakref

    gone = weakref.ref(stale)
    del stale
    assert gone() is None  # nothing else held the old weights


@pytest.mark.cuda
def test_router_over_a_real_model_cuda_service_answers_a_pair(cuda):
    """The port's router in front of one real-model service on the card
    (its introspection plane on an ephemeral port) answers a pair over
    HTTP with the table the service's engine gives in process."""
    from ncnet_tpu_torch.serving import (MatchClient, MatchRouter,
                                         MatchService, RouterConfig,
                                         ServingConfig, pad_to_bucket)

    cfg, params = _service_model()
    svc = MatchService(cfg, params, ServingConfig(
        buckets=((192, 192),), warm_buckets=((192, 192),), max_batch=1,
        max_image_side=192, introspect_port=0), devices=["cuda:0"]).start()
    router = None
    try:
        router = MatchRouter([svc.introspect_url], RouterConfig(
            introspect_port=0, probe_period_s=0.2)).start()
        src, tgt = _service_pairs(1)[0]
        with MatchClient(router.introspect_url) as client:
            res = client.match(src, tgt, budget_s=120.0)
        engine = svc._pool.replicas[0].engine
        direct = engine.split(engine.fetch(engine.dispatch(
            pad_to_bucket([src], (192, 192)),
            pad_to_bucket([tgt], (192, 192)))))[0][0]
    finally:
        if router is not None:
            router.stop()
        svc.stop(timeout=120)
    assert res.table.shape == direct.shape
    assert np.array_equal(res.table, direct)
    assert res.quality and set(res.quality) >= {"score", "entropy"}


def _retrieval_tree(root, n=4):
    """A shortlist row of ``n`` structured cutouts (raw arrays beside
    their ``.jpg`` names): ``(shortlist path, pano root)``."""
    import os

    from scipy.io import savemat

    pano_root = os.path.join(root, "pano")
    names = []
    for i in range(n):
        img = np.zeros((192, 256, 3), np.uint8)
        img[..., 0] = (37 * i + 20) % 256
        img[..., 1] = (91 * i + 13) % 256
        img[:: (i % 5) + 2, :, 2] = 255
        img[:, :: (i % 3) + 3, 0] //= 2
        name = f"DUC1/DUC_cutout_{i:03d}_0_0.jpg"
        os.makedirs(os.path.dirname(os.path.join(pano_root, name)),
                    exist_ok=True)
        np.save(os.path.join(pano_root, name) + ".npy", img)
        names.append(name)
    entries = np.zeros((1, 1), dtype=np.dtype(
        [("queryname", object), ("topNname", object)]))
    entries[0, 0] = (np.array(["q.jpg"]),
                     np.array(names, dtype=object)[:, None])
    shortlist = os.path.join(root, "shortlist.mat")
    savemat(shortlist, {"ImgList": entries})
    return shortlist, pano_root


@pytest.mark.cuda
def test_coarse_index_on_the_card_matches_the_cpu(cuda, tmp_path, capsys):
    """``build_coarse_index`` with the trunk on the card (TF32 off) writes
    every pano's coarse volume within 1e-4 of the same tool's on the CPU;
    the two indexes are two store generations (the program token)."""
    import json

    from ncnet_tpu_torch.retrieval import load_index_manifests
    from ncnet_tpu_torch.store import FeatureStore
    from ncnet_tpu_torch.tools import build_coarse_index

    shortlist, pano_root = _retrieval_tree(str(tmp_path))
    docs = {}
    for dev in ("cuda", "cpu"):
        assert build_coarse_index.main([
            "--store_dir", str(tmp_path / dev), "--inloc_shortlist",
            shortlist, "--pano_path", pano_root, "--backbone", "tiny",
            "--image_size", "256", "--factor", "2", "--device", dev]) == 0
        docs[dev] = json.loads(capsys.readouterr().out.strip()
                               .splitlines()[-1])
    assert docs["cuda"]["fingerprint"].endswith("-torch.cuda-c2")
    assert docs["cpu"]["fingerprint"] == docs["cuda"]["fingerprint"].replace(
        "torch.cuda", "torch.cpu")
    index = load_index_manifests(str(tmp_path / "cuda" / "coarse_index.*"))
    stores = {dev: FeatureStore(str(tmp_path / dev), docs[dev]["fingerprint"],
                                scope="t") for dev in docs}
    try:
        for digest in index["panos"].values():
            a, b = (stores[d].get(digest) for d in ("cuda", "cpu"))
            assert a.shape == b.shape and a.shape[-1] == 32
            assert float(np.abs(a - b).max()) <= 1e-4
    finally:
        for s in stores.values():
            s.close()


@pytest.mark.cuda
def test_serve_shard_holds_no_cuda_context(cuda, tmp_path, capsys):
    """A shard host does numpy work only: after it answered a retrieve, its
    process holds no open card device file (a context opens
    ``/dev/nvidia<N>``) and ``nvidia-smi`` lists no compute context for its
    pid.  The control: this process, which holds a context, holds such
    files, so the check can see one."""
    import json
    import os
    import subprocess
    import sys

    from ncnet_tpu_torch.retrieval import RetrieveClient
    from ncnet_tpu_torch.tools import build_coarse_index

    shortlist, pano_root = _retrieval_tree(str(tmp_path))
    store = str(tmp_path / "raw")
    assert build_coarse_index.main([
        "--store_dir", store, "--inloc_shortlist", shortlist, "--pano_path",
        pano_root, "--raw"]) == 0
    capsys.readouterr()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.Popen(
        [sys.executable, "-m", "ncnet_tpu_torch.tools.serve_shard",
         "--shard-id", "s0", "--shards", "s0", "--store", store, "--index",
         os.path.join(store, "coarse_index.*.json"), "--replication", "1"],
        stdout=subprocess.PIPE, text=True, env=env, cwd=repo)
    try:
        doc = json.loads(proc.stdout.readline())
        with RetrieveClient(doc["url"]) as client:
            ans = client.retrieve(np.full(8, 8 ** -0.5, np.float32),
                                  budget_s=30.0)
        assert len(ans["consulted"]) == 4

        def card_files(pid):
            fds = os.path.join("/proc", str(pid), "fd")
            opened = []
            for f in os.listdir(fds):
                try:  # the listing's own descriptor is gone by now
                    opened.append(os.readlink(os.path.join(fds, f)))
                except OSError:
                    continue
            return [f for f in opened
                    if f.startswith("/dev/nvidia") and f[11:].isdigit()]

        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        assert card_files(os.getpid())
        assert not card_files(doc["pid"])
        smi = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid",
             "--format=csv,noheader"], capture_output=True, text=True)
        assert str(doc["pid"]) not in smi.stdout.split()
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stdout.close()


@pytest.mark.cuda
def test_model_tools_refuse_without_a_visible_gpu(cuda, tmp_path):
    """With no card visible, each model-driving tool run as a user runs it
    exits non-zero naming CUDA: none carries on on the CPU."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               NCNET_TPU_PERF_STORE="off")
    for argv in (
            ["ncnet_tpu_torch.tools.stream_probe", "--tiny", "--frames", "3"],
            ["ncnet_tpu_torch.tools.serve_probe", "--tiny", "--sides", "32",
             "--pairs", "4"],
            ["ncnet_tpu_torch.tools.quality_drift", "--seed-ref",
             "--synthetic", "--ref", str(tmp_path / "ref.jsonl")],
            ["ncnet_tpu_torch.cli.point_transfer_demo", "--synthetic",
             "--backbone", "tiny", "--image_size", "96",
             "--out", str(tmp_path / "demo.png")]):
        r = subprocess.run([sys.executable, "-m", *argv], env=env, cwd=repo,
                           capture_output=True, text=True, timeout=600)
        assert r.returncode != 0, argv
        assert "CUDA is not available" in r.stderr, (argv, r.stderr[-2000:])
    assert not os.path.exists(str(tmp_path / "ref.jsonl"))
    assert not os.path.exists(str(tmp_path / "demo.json"))


@pytest.mark.cuda
def test_stream_probe_launches_b8_and_b6_in_its_steady_segment(cuda):
    """``stream_probe`` at full width on the card: its tracked frames run
    B8 and B6 (2 and 6 launches a tracked dispatch), its steady segment's
    coarse passes are its fallback frames' alone, and the frame identity
    holds in its log."""
    from ncnet_tpu_torch.tools import stream_probe

    d = stream_probe.probe(streams=2, frames=8, side=192, device=cuda)
    doc = d["streams_doc"]
    assert d["tracking_feasible"] and doc["tracked_frames"] > 0
    assert d["coarse_passes_steady_delta"] == d["expected_coarse_passes"]
    per_coarse = {k: v // max(1, d["coarse_passes_cold"])
                  for k, v in d["launches_cold"].items()}
    n_tracked = d["tracked_dispatches_steady"]
    n_coarse = d["coarse_passes_steady_delta"]
    assert d["launches_steady"] == d["launches_steady_expected"] == {
        "gather_tile_corr_bf16": 2 * n_tracked
        + per_coarse["gather_tile_corr_bf16"] * n_coarse,
        "nc_conv4d_bf16": 6 * n_tracked
        + per_coarse["nc_conv4d_bf16"] * n_coarse}
    assert all(d["launches_steady"].values())
    assert doc["frames"] == (doc["tracked_frames"] + doc["fallback_frames"]
                             + doc["cold_frames"])
    assert d["replay_outcome_identity_ok"] and d["replay_ordering_ok"]


@pytest.mark.cuda
def test_perf_regress_check_on_the_cards_store(cuda, tmp_path):
    """``perf_regress --check`` on a store of walls measured on the card,
    under its device kind: the findings ``check_regressions`` gives."""
    import contextlib
    import io
    import json

    from ncnet_tpu_torch.observability import perfstore
    from ncnet_tpu_torch.observability.events import local_device_kind
    from ncnet_tpu_torch.tools import perf_regress

    path = str(tmp_path / "history.jsonl")
    store = perfstore.PerfStore(path)
    x = torch.randn(2048, 2048, device=cuda)
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (x @ x).sum().item()
        store.append_many(
            {"matmul_wall_ms": (time.perf_counter() - t0) * 1e3,
             "matmul_tflops": 2 * 2048 ** 3 / 1e12},
            device_kind=local_device_kind(), source="card test")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = perf_regress.main(["--check", "--store", path, "--json"])
    direct = perfstore.check_regressions(store.records())
    assert json.loads(out.getvalue())["findings"] == json.loads(
        json.dumps(direct))
    assert rc == (1 if any(f["status"] == "regression" for f in direct)
                  else 0)
    assert direct and direct[0]["device_kind"] == torch.cuda.get_device_name(0)


@pytest.mark.cuda
def test_make_goldens_check_on_the_card(cuda, tmp_path, capsys):
    """The port's golden record made on the card (TF32 off) against the
    committed goldens at the JAX golden test's tolerances: every key
    within them, as on the CPU."""
    from ncnet_tpu_torch.tools import make_goldens

    out = str(tmp_path / "record.npz")
    assert make_goldens.main(["--out", out, "--check"]) == 0
    text = capsys.readouterr().out
    assert "17/17 keys within tolerance" in text
    assert torch.cuda.get_device_name(0) in text
    assert sorted(np.load(out).files) == sorted(
        np.load(make_goldens.GOLDEN).files)


@pytest.mark.cuda
def test_eval_faults_probe_retries_on_the_same_tier(cuda):
    """``eval_faults_probe`` at 25⁴ on the card: every tier within 0.1 of
    the plain stack, B6 launched, and the injected device failure's retry
    on the chooser's tier (FFT at 25⁴) bit-equal to the first call."""
    from ncnet_tpu_torch.tools import _probe, eval_faults_probe

    gen = torch.Generator(device=cuda).manual_seed(0)
    params = _probe.normal_stack(gen, eval_faults_probe.KERNELS,
                                 eval_faults_probe.CHANNELS, cuda)
    x = (torch.randn((1,) + (25,) * 4 + (1,), generator=gen, device=cuda)
         * eval_faults_probe.X_SCALE).to(torch.bfloat16)
    before = nc_fused_lane.launches
    res = eval_faults_probe.run_tiers(params, x)
    assert nc_fused_lane.launches - before == 6  # two B6 stacks of 3 layers
    assert all(e < eval_faults_probe.TOLERANCE for e in res["errors"].values())
    rc = eval_faults_probe.retry_check(params, x)
    assert rc["failure_kinds"] == ["device"]
    assert rc["start"] == rc["retry_tier"] == "fft"
    assert rc["bit_equal"]
    assert eval_faults_probe.main(["25"]) == 0
