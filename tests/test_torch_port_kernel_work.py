"""The work the port's kernel bounds rest on, checked on the CPU.

``chip_smoke.py`` reads each kernel's time against a bound computed from
``stack_work`` (the NC stack, B2, and its backward, B3), ``dw_work`` (one
layer's dW/db, B7), ``gather_work`` (the tile correlation, B4),
``b5_work`` (the small-C_out conv4d, B5) and ``l2_work`` (the L2 layer
probe, T1: its 0.830 ms bound at B = 8); a
redesigned kernel must be read against the same work,
so these counts are pinned here to the numbers PERF.md's bounds use.  The
layer shapes compiled into ``csrc/nc_conv4d.cu`` are read from the source:
its forward list is the backward's (``csrc/nc_conv4d_vjp.cu``, and the
transposed launches of ``nc_conv4d.cu``) plus the InLoc stack's tap-swap
chain, and every stack a ``ModelConfig`` of the repository builds must be
in them.
"""

import re
from pathlib import Path

import pytest
import torch

import chip_smoke
from ncnet_tpu_torch.config import ModelConfig

CSRC = Path(__file__).resolve().parent.parent / "ncnet_tpu_torch" / "csrc"


def compiled_shapes(source, macro):
    """The (k, C_in, C_out) triples of the X-macro list ``macro``, in
    order, with the lists it names (``OTHER_LIST(X)``) expanded."""
    text = (CSRC / source).read_text()
    body = re.search(rf"#define {macro}\(X\)(.*?)\n\n", text, re.S).group(1)
    shapes = []
    for name, *triple in re.findall(
            r"(\w+)\(X\)|X\((\d+), (\d+), (\d+)\)", body):
        shapes += (compiled_shapes(source, name) if name
                   else [tuple(int(v) for v in triple)])
    return shapes


# the IVD stack's tap-swap chain (models/ncnet.py::tap_swap_chain), whose
# layers the forward alone is compiled for (serving only)
CHAIN_SHAPES = {(3, 1, 32), (3, 32, 2)}


def test_forward_and_backward_compile_the_same_shapes():
    """The backward (dW/db and the transposed launch) is compiled for the
    same shapes as the forward, but for the chain's two forward-only
    layers."""
    fwd = compiled_shapes("nc_conv4d.cu", "NC_CONV4D_SHAPES")
    bwd = compiled_shapes("nc_conv4d_vjp.cu", "NC_VJP_SHAPES")
    transposed = compiled_shapes("nc_conv4d.cu", "NC_CONV4D_TRANSPOSE_SHAPES")
    assert len(fwd) == len(set(fwd)) == 27
    assert len(bwd) == len(set(bwd)) == 25
    assert transposed == bwd
    assert set(fwd) == set(bwd) | CHAIN_SHAPES
    assert not CHAIN_SHAPES & set(bwd)


@pytest.mark.parametrize("name,cfg", [
    ("pf_pascal", ModelConfig(ncons_kernel_sizes=(5, 5, 5),
                              ncons_channels=(16, 16, 1))),
    # the InLoc (IVD) arch of bench.py:1616
    ("ivd", ModelConfig(ncons_kernel_sizes=(3, 3), ncons_channels=(16, 1))),
    ("default", ModelConfig()),
])
def test_model_stacks_are_compiled(name, cfg):
    shapes = set(compiled_shapes("nc_conv4d.cu", "NC_CONV4D_SHAPES"))
    transposed = set(compiled_shapes("nc_conv4d.cu",
                                     "NC_CONV4D_TRANSPOSE_SHAPES"))
    c_in = 1
    for k, c_out in zip(cfg.ncons_kernel_sizes, cfg.ncons_channels):
        # the forward launch, and the transposed one of the backward, which
        # the kernel serves under the same forward shape
        assert (k, c_in, c_out) in shapes, (name, k, c_in, c_out)
        assert (k, c_in, c_out) in transposed, (name, k, c_in, c_out)
        c_in = c_out
    if len(cfg.ncons_channels) == 2 and len(set(cfg.ncons_kernel_sizes)) == 1:
        # a two-layer stack of one kernel size is in the tap-swap class: its
        # chain [1 -> 2C, 2C -> 2] filters a rectangular volume
        k, c = cfg.ncons_kernel_sizes[0], cfg.ncons_channels[0]
        assert {(k, 1, 2 * c), (k, 2 * c, 2)} <= shapes, name


def taps_in_volume(n, k):
    """Multiply-adds a same-padded dim of n cells does at kernel k."""
    d = k // 2
    return sum(min(n - 1, x + d) - max(0, x - d) + 1 for x in range(n))


PF = ((5, 5, 5), (16, 16, 1))
WEIGHT_BYTES_PF = 2 * ((625 * 16 + 16) + (625 * 256 + 16) + (625 * 16 + 1))


@pytest.mark.parametrize("shape,flops,nbytes", [
    # B2's coarse-to-fine call: the figure PERF.md's 3.865 ms bound rests on
    ((20000, 6, 6, 6, 6), 2 * 20000 * 24 ** 4 * 288,
     2 * 2 * 20000 * 6 ** 4 + WEIGHT_BYTES_PF),
    # the tracked call, a quarter of the tiles
    ((5000, 6, 6, 6, 6), 2 * 5000 * 24 ** 4 * 288,
     2 * 2 * 5000 * 6 ** 4 + WEIGHT_BYTES_PF),
    # the dense 800² request's stack
    ((8, 50, 50, 50, 50), 2 * 8 * taps_in_volume(50, 5) ** 4 * 288,
     2 * 2 * 8 * 50 ** 4 + WEIGHT_BYTES_PF),
])
def test_stack_work(shape, flops, nbytes):
    assert chip_smoke.stack_work(shape, *PF) == (flops, nbytes)


def test_stack_work_pins_the_bound():
    flops, nbytes = chip_smoke.stack_work((20000, 6, 6, 6, 6), *PF)
    assert taps_in_volume(6, 5) == 24
    assert flops == pytest.approx(3.82e12, rel=1e-3)
    bound_ms = flops / chip_smoke.PEAK_BF16_FLOPS * 1e3
    assert bound_ms == pytest.approx(3.865, abs=1e-3)
    assert nbytes / chip_smoke.PEAK_HBM_BYTES_PER_S * 1e3 < bound_ms


def test_chain_work_counts_the_function_not_the_zero_blocks():
    """The InLoc tap-swap chain's bound: the fused 1 → 32 layer and two
    16 → 1 layers on (1, 100, 75, 75, 100), two thirds of the multiply-adds
    the chain's half-zero block-diagonal 32 → 2 layer makes the kernel
    compute; bound by operations, 0.572 ms."""
    shape = (1, 100, 75, 75, 100)
    flops, nbytes = chip_smoke.chain_work(shape, 3, 16)
    taps = taps_in_volume(100, 3) ** 2 * taps_in_volume(75, 3) ** 2
    assert flops == 2 * taps * 32 + 2 * (2 * taps * 16) == 565_265_166_848
    padded, padded_bytes = chip_smoke.stack_work(shape, (3, 3), (32, 2))
    assert 3 * flops == 2 * padded
    cells = 100 * 75 * 75 * 100
    assert nbytes == 2 * (3 * cells + 81 * 32 + 32 + 2 * (81 * 16 + 1))
    assert padded_bytes - nbytes == 2 * 81 * 32  # the zero blocks' weights
    bound_ms = flops / chip_smoke.PEAK_BF16_FLOPS * 1e3
    assert bound_ms == pytest.approx(0.572, abs=1e-3)
    assert nbytes / chip_smoke.PEAK_HBM_BYTES_PER_S * 1e3 < bound_ms


@pytest.mark.parametrize("li,flops", [
    # per layer on the coarse-to-fine tiles: 1 -> 16, 16 -> 16, 16 -> 1
    (0, 2 * 20000 * 24 ** 4 * 16),
    (1, 2 * 20000 * 24 ** 4 * 256),
    (2, 2 * 20000 * 24 ** 4 * 16),
])
def test_layer_work(li, flops):
    c_in = (1, 16, 16)[li]
    got, _ = chip_smoke.stack_work((20000, 6, 6, 6, 6), PF[0][li:li + 1],
                                   PF[1][li:li + 1], c_in=c_in)
    assert got == flops


@pytest.mark.parametrize("b,n,k,p,c,side,flops,nbytes", [
    # B4 at the serving shape: the 0.0689 ms bytes bound of PERF.md
    (4, 625, 4, 6, 1024, 50, 2.65e10, 2.30e8),
    # the tracked shape: one candidate
    (4, 625, 1, 6, 1024, 50, 6.64e9, 2.113e8),
])
def test_gather_work(b, n, k, p, c, side, flops, nbytes):
    fa_p2 = torch.empty((b, n, p * p, c), dtype=torch.bfloat16, device="meta")
    fb = torch.empty((b, side, side, c), dtype=torch.bfloat16, device="meta")
    rows = torch.empty((b, n, k), dtype=torch.int32, device="meta")
    got_flops, got_bytes = chip_smoke.gather_work(fa_p2, fb, rows, k)
    assert got_flops == 2 * b * n * k * p ** 4 * c
    assert got_bytes == (2 * b * n * p * p * c + 2 * b * side * side * c
                         + 2 * 4 * b * n * k + 2 * b * n * k * p ** 4)
    assert got_flops == pytest.approx(flops, rel=5e-3)
    assert got_bytes == pytest.approx(nbytes, rel=5e-3)
    if k == 4:
        bound_ms = got_bytes / chip_smoke.PEAK_HBM_BYTES_PER_S * 1e3
        assert bound_ms == pytest.approx(0.0689, abs=1e-4)


CHUNK = (8, 25, 25, 25, 25)  # a training chunk: 4 pairs folded with their transposes


@pytest.mark.parametrize("c_in,c_out,flops,nbytes,bound_by", [
    # B7's three layers on a training chunk: PERF.md's per-layer bounds;
    # bytes: x, y and g read once, gz written once (bf16), dW and db once
    # (f32)
    (1, 16, 5.1337e10, 306_290_064, "bytes"),
    (16, 16, 8.2137e11, 400_640_064, "operations"),
    (16, 1, 5.1337e10, 118_790_004, "operations"),
])
def test_dw_work(c_in, c_out, flops, nbytes, bound_by):
    got, got_bytes = chip_smoke.dw_work(CHUNK, 5, c_in, c_out)
    assert got == 2 * 8 * taps_in_volume(25, 5) ** 4 * c_in * c_out
    assert got == pytest.approx(flops, rel=1e-4)
    assert got_bytes == nbytes
    t_ops = got / chip_smoke.PEAK_BF16_FLOPS
    t_bytes = got_bytes / chip_smoke.PEAK_HBM_BYTES_PER_S
    assert ("operations" if t_ops >= t_bytes else "bytes") == bound_by


def test_backward_work_pins_the_bound():
    """The chunk's backward without dx: the three dW and the input
    gradients of layers 2 and 1 (the forward's count each)."""
    flops, _ = chip_smoke.stack_work(CHUNK, *PF, backward=True)
    dw = [chip_smoke.dw_work(CHUNK, 5, c_in, c_out)[0]
          for c_in, c_out in ((1, 16), (16, 16), (16, 1))]
    assert flops == sum(dw) + dw[1] + dw[2]
    assert flops == pytest.approx(1.797e12, rel=1e-3)
    assert flops / chip_smoke.PEAK_BF16_FLOPS * 1e3 == pytest.approx(1.817, abs=1e-3)


@pytest.mark.parametrize("shape,k,c_in,c_out,dtype,flops,nbytes,bound_ms,cuda_core_ms", [
    # the fp32 800² path's launch: f32 as three bf16 products on the tensor
    # cores (1.376 ms), beside the same FLOP at the CUDA cores' f32 peak
    ((4, 50, 50, 50, 50), 5, 16, 1, "float32", 4.5370e11, 1_700_040_000,
     1.3762, 6.7716),
    # a bf16 volume is one product
    ((2, 9, 7, 11, 13), 5, 16, 2, "bfloat16", 4.1852e8, 688_648, 4.232e-4,
     6.247e-3),
])
def test_b5_work(shape, k, c_in, c_out, dtype, flops, nbytes, bound_ms,
                 cuda_core_ms):
    """B5's work and bound (PERF.md): the in-volume taps' multiply-adds, the
    volume, weights and output once each, the tensor-core kernel's bf16
    products at the bf16 peak."""
    got, got_bytes, products = chip_smoke.b5_work(shape, k, c_in, c_out, dtype)
    b, *dims = shape
    taps = 1
    for n in dims:
        taps *= taps_in_volume(n, k)
    assert got == 2 * b * taps * c_in * c_out
    assert got == pytest.approx(flops, rel=1e-4)
    assert got_bytes == nbytes
    assert products == (3 if dtype == "float32" else 1)
    t_ops = products * got / chip_smoke.PEAK_BF16_FLOPS
    assert t_ops >= got_bytes / chip_smoke.PEAK_HBM_BYTES_PER_S
    assert t_ops * 1e3 == pytest.approx(bound_ms, rel=1e-3)
    assert got / chip_smoke.PEAK_F32_FLOPS * 1e3 == pytest.approx(cuda_core_ms, rel=1e-3)


def test_l2_work():
    """T1 at B = 8: the in-volume taps' multiply-adds of the 16 → 16, k = 5
    layer at 25⁴ (PERF.md's 0.830 ms bound), the padded frame in, the
    weights, bias and mask and the output once each, and, as context, the
    GEMM formulation's 400 × 400 product for each 841-lane row."""
    flops, nbytes, gemm = chip_smoke.l2_work(8)
    assert flops == 2 * 8 * taps_in_volume(25, 5) ** 4 * 16 * 16
    assert (flops, nbytes, gemm) == (821_386_940_416, 315_945_650,
                                     1_345_600_000_000)
    t_ops = flops / chip_smoke.PEAK_BF16_FLOPS
    assert t_ops > nbytes / chip_smoke.PEAK_HBM_BYTES_PER_S
    assert t_ops * 1e3 == pytest.approx(0.830, abs=1e-3)


def test_compiled_layer_shapes_constant_is_the_sources():
    """The routes' lists of compiled layer shapes are the sources' X-macro
    lists, shape for shape: the serving chooser's
    (``nc_fused_lane.FORWARD_LAYER_SHAPES``) the forward's, the training
    gate's (``nc_fused_lane.VJP_LAYER_SHAPES``) the backward's and the
    transposed launch's."""
    from ncnet_tpu_torch.ops.nc_fused_lane import (
        FORWARD_LAYER_SHAPES,
        VJP_LAYER_SHAPES,
    )

    fwd = compiled_shapes("nc_conv4d.cu", "NC_CONV4D_SHAPES")
    bwd = compiled_shapes("nc_conv4d_vjp.cu", "NC_VJP_SHAPES")
    transposed = compiled_shapes("nc_conv4d.cu", "NC_CONV4D_TRANSPOSE_SHAPES")
    assert FORWARD_LAYER_SHAPES == set(fwd)
    assert VJP_LAYER_SHAPES == set(bwd) == set(transposed)
