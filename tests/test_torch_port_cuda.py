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
near-tie otherwise).
"""

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
