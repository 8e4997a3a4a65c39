"""The work the port's kernel bounds rest on, checked on the CPU.

``chip_smoke.py`` and ``tools/bench.py`` read each kernel's or filter's
time against a bound computed from ``observability/roofline.py``:
``stack_work`` (the NC stack, B2, and its backward, B3), ``dw_work`` (one
layer's dW/db, B7), ``gather_work`` (the tile correlation, B4),
``b5_work`` (the small-C_out conv4d, B5) and ``l2_work`` (the L2 layer
probe, T1: its 0.830 ms bound at B = 8); a
redesigned kernel must be read against the same work,
so these counts are pinned here to the numbers PERF.md's bounds use.  The
NC kernels' limits are read from their sources (``csrc/nc_conv4d.cuh``,
``csrc/nc_conv4d_vjp.cuh``): both serve the same shapes, the route's gate
(``nc_fused_lane.kernels_hold``) repeats their limits, and every stack a
``ModelConfig`` of the repository builds, and its tap-swap chain, lies
inside it.
"""

import re
from pathlib import Path

import pytest
import torch

import chip_smoke
from ncnet_tpu_torch.config import ModelConfig
from ncnet_tpu_torch.observability import roofline

CSRC = Path(__file__).resolve().parent.parent / "ncnet_tpu_torch" / "csrc"


def source_limits(source):
    """The ``constexpr`` limits of an NC kernel header: kMaxK, kMaxWidth
    and the shared-memory budget in bytes."""
    text = (CSRC / source).read_text()
    k = int(re.search(r"constexpr int kMaxK = (\d+);", text).group(1))
    width = int(re.search(r"constexpr int kMaxWidth = (\d+);", text).group(1))
    budget = re.search(r"constexpr size_t kSmemBudget = (\d+) \* (\d+);", text)
    return k, width, int(budget.group(1)) * int(budget.group(2))


def test_forward_and_backward_compile_the_same_shapes():
    """The forward (and its transposed launch) and the backward's dW/db
    serve the same layer shapes: the same kernel-size and width limits in
    both sources, and one library of each for every odd k up to the
    limit, all in the build's list."""
    from ncnet_tpu_torch.ops import kernel_build

    (fk, fw, _), (bk, bw, _) = (source_limits("nc_conv4d.cuh"),
                                source_limits("nc_conv4d_vjp.cuh"))
    assert (fk, fw) == (bk, bw) == (7, 32)
    for head in ("nc_conv4d", "nc_conv4d_vjp"):
        for k in range(1, fk + 1, 2):
            src = f"{head}_k{k}.cu"
            assert src in kernel_build.SOURCES
            assert f"#define NC_K {k}\n#include \"{head}.cuh\"" in (
                CSRC / src).read_text()
        assert not (CSRC / f"{head}_k{fk + 2}.cu").exists()


@pytest.mark.parametrize("name,cfg", [
    ("pf_pascal", ModelConfig(ncons_kernel_sizes=(5, 5, 5),
                              ncons_channels=(16, 16, 1))),
    # the InLoc (IVD) arch of bench.py:1616
    ("ivd", ModelConfig(ncons_kernel_sizes=(3, 3), ncons_channels=(16, 1))),
    ("default", ModelConfig()),
])
def test_model_stacks_are_compiled(name, cfg):
    from ncnet_tpu_torch.ops import nc_fused_lane

    kernels, channels = cfg.ncons_kernel_sizes, cfg.ncons_channels
    assert nc_fused_lane.kernels_hold(kernels, channels), name
    c_in = 1
    for k, c_out in zip(kernels, channels):
        # the forward launch, its transposed one and B7's dW/db
        assert nc_fused_lane.layer_held(k, c_in, c_out), (name, k, c_in, c_out)
        c_in = c_out
    if len(channels) == 2 and len(set(kernels)) == 1:
        # a two-layer stack of one kernel size is in the tap-swap class: its
        # chain [1 -> 2C, 2C -> 2] filters a rectangular volume
        c = channels[0]
        assert nc_fused_lane.kernels_hold(kernels, (2 * c, 2)), name


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
    assert roofline.stack_work(shape, *PF) == (flops, nbytes)


def test_stack_work_pins_the_bound():
    flops, nbytes = roofline.stack_work((20000, 6, 6, 6, 6), *PF)
    assert taps_in_volume(6, 5) == 24
    assert flops == pytest.approx(3.82e12, rel=1e-3)
    bound_ms = flops / roofline.PEAK_BF16_FLOPS * 1e3
    assert bound_ms == pytest.approx(3.865, abs=1e-3)
    assert nbytes / roofline.PEAK_HBM_BYTES_PER_S * 1e3 < bound_ms


def test_chain_work_counts_the_function_not_the_zero_blocks():
    """The InLoc tap-swap chain's bound: the fused 1 → 32 layer and two
    16 → 1 layers on (1, 100, 75, 75, 100), two thirds of the multiply-adds
    the chain's half-zero block-diagonal 32 → 2 layer makes the kernel
    compute; bound by operations, 0.572 ms."""
    shape = (1, 100, 75, 75, 100)
    flops, nbytes = roofline.chain_work(shape, 3, 16)
    taps = taps_in_volume(100, 3) ** 2 * taps_in_volume(75, 3) ** 2
    assert flops == 2 * taps * 32 + 2 * (2 * taps * 16) == 565_265_166_848
    padded, padded_bytes = roofline.stack_work(shape, (3, 3), (32, 2))
    assert 3 * flops == 2 * padded
    cells = 100 * 75 * 75 * 100
    assert nbytes == 2 * (3 * cells + 81 * 32 + 32 + 2 * (81 * 16 + 1))
    assert padded_bytes - nbytes == 2 * 81 * 32  # the zero blocks' weights
    bound_ms = flops / roofline.PEAK_BF16_FLOPS * 1e3
    assert bound_ms == pytest.approx(0.572, abs=1e-3)
    assert nbytes / roofline.PEAK_HBM_BYTES_PER_S * 1e3 < bound_ms


@pytest.mark.parametrize("li,flops", [
    # per layer on the coarse-to-fine tiles: 1 -> 16, 16 -> 16, 16 -> 1
    (0, 2 * 20000 * 24 ** 4 * 16),
    (1, 2 * 20000 * 24 ** 4 * 256),
    (2, 2 * 20000 * 24 ** 4 * 16),
])
def test_layer_work(li, flops):
    c_in = (1, 16, 16)[li]
    got, _ = roofline.stack_work((20000, 6, 6, 6, 6), PF[0][li:li + 1],
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
    got_flops, got_bytes = roofline.gather_work(fa_p2, fb, rows, k)
    assert got_flops == 2 * b * n * k * p ** 4 * c
    assert got_bytes == (2 * b * n * p * p * c + 2 * b * side * side * c
                         + 2 * 4 * b * n * k + 2 * b * n * k * p ** 4)
    assert got_flops == pytest.approx(flops, rel=5e-3)
    assert got_bytes == pytest.approx(nbytes, rel=5e-3)
    if k == 4:
        bound_ms = got_bytes / roofline.PEAK_HBM_BYTES_PER_S * 1e3
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
    got, got_bytes = roofline.dw_work(CHUNK, 5, c_in, c_out)
    assert got == 2 * 8 * taps_in_volume(25, 5) ** 4 * c_in * c_out
    assert got == pytest.approx(flops, rel=1e-4)
    assert got_bytes == nbytes
    t_ops = got / roofline.PEAK_BF16_FLOPS
    t_bytes = got_bytes / roofline.PEAK_HBM_BYTES_PER_S
    assert ("operations" if t_ops >= t_bytes else "bytes") == bound_by


def test_backward_work_pins_the_bound():
    """The chunk's backward without dx: the three dW and the input
    gradients of layers 2 and 1 (the forward's count each)."""
    flops, _ = roofline.stack_work(CHUNK, *PF, backward=True)
    dw = [roofline.dw_work(CHUNK, 5, c_in, c_out)[0]
          for c_in, c_out in ((1, 16), (16, 16), (16, 1))]
    assert flops == sum(dw) + dw[1] + dw[2]
    assert flops == pytest.approx(1.797e12, rel=1e-3)
    assert flops / roofline.PEAK_BF16_FLOPS * 1e3 == pytest.approx(1.817, abs=1e-3)


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
    got, got_bytes, products = roofline.b5_work(shape, k, c_in, c_out, dtype)
    b, *dims = shape
    taps = 1
    for n in dims:
        taps *= taps_in_volume(n, k)
    assert got == 2 * b * taps * c_in * c_out
    assert got == pytest.approx(flops, rel=1e-4)
    assert got_bytes == nbytes
    assert products == (3 if dtype == "float32" else 1)
    t_ops = products * got / roofline.PEAK_BF16_FLOPS
    assert t_ops >= got_bytes / roofline.PEAK_HBM_BYTES_PER_S
    assert t_ops * 1e3 == pytest.approx(bound_ms, rel=1e-3)
    assert got / roofline.PEAK_F32_FLOPS * 1e3 == pytest.approx(cuda_core_ms, rel=1e-3)


def test_l2_work():
    """T1 at B = 8: the in-volume taps' multiply-adds of the 16 → 16, k = 5
    layer at 25⁴ (PERF.md's 0.830 ms bound), the padded frame in, the
    weights, bias and mask and the output once each, and, as context, the
    GEMM formulation's 400 × 400 product for each 841-lane row."""
    flops, nbytes, gemm = roofline.l2_work(8)
    assert flops == 2 * 8 * taps_in_volume(25, 5) ** 4 * 16 * 16
    assert (flops, nbytes, gemm) == (821_386_940_416, 315_945_650,
                                     1_345_600_000_000)
    t_ops = flops / roofline.PEAK_BF16_FLOPS
    assert t_ops > nbytes / roofline.PEAK_HBM_BYTES_PER_S
    assert t_ops * 1e3 == pytest.approx(0.830, abs=1e-3)


def test_compiled_layer_shapes_constant_is_the_sources():
    """The route's gate (``nc_fused_lane.kernels_hold``) holds the sources'
    limits, constant for constant: the largest k and width of both
    kernels, each one's shared-memory budget, and the staging limits its
    smallest-block arithmetic repeats; inside the limits every layer shape
    fits its smallest block, so the gate is the limits themselves."""
    from ncnet_tpu_torch.ops import nc_fused_lane as lane

    fk, fw, fbudget = source_limits("nc_conv4d.cuh")
    bk, bw, bbudget = source_limits("nc_conv4d_vjp.cuh")
    assert (lane.MAX_K, lane.MAX_WIDTH) == (fk, fw) == (bk, bw)
    assert (lane.FORWARD_SMEM_BUDGET, lane.VJP_SMEM_BUDGET) == (fbudget,
                                                               bbudget)
    assert lane.KERNEL_SIZES == tuple(range(1, fk + 1, 2))
    text = (CSRC / "nc_conv4d.cuh").read_text()
    slab = re.search(r"constexpr int kSlabBudget = (\d+) \* (\d+);", text)
    assert lane._SLAB_BUDGET == int(slab.group(1)) * int(slab.group(2))
    assert lane._MAX_PARTIALS == int(re.search(
        r"constexpr int kMaxPartials = (\d+);", text).group(1))
    for k in lane.KERNEL_SIZES:
        for c_in in range(1, fw + 1):
            for c_out in range(1, fw + 1):
                assert lane.layer_held(k, c_in, c_out), (k, c_in, c_out)
    for k, c_in, c_out in [(9, 1, 16), (8, 1, 16), (3, 33, 1), (3, 1, 48),
                           (5, 0, 1)]:
        assert not lane.layer_held(k, c_in, c_out)


def test_b5_launch_count_is_never_shadowed():
    """B5's ``launches`` is a module ``__getattr__`` summing
    ``launches_by_kernel``: assigning the name would hide every later
    launch (a phase reading 0 B5 whatever ran).  ``chip_smoke.py`` resets
    the kernels' counts, never the name, and the sum follows them."""
    import ast

    from ncnet_tpu_torch.ops import conv4d_pallas

    tree = ast.parse(Path(chip_smoke.__file__).read_text())
    shadowing = [node.lineno for node in ast.walk(tree)
                 if isinstance(node, (ast.Assign, ast.AugAssign))
                 for t in (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                 for a in ast.walk(t)
                 if isinstance(a, ast.Attribute) and a.attr == "launches"
                 and isinstance(a.value, ast.Name)
                 and a.value.id == "conv4d_pallas"]
    assert shadowing == []
    saved = dict(conv4d_pallas.launches_by_kernel)
    try:
        conv4d_pallas.launches_by_kernel.update(tensor_core=2, cuda_core=1)
        assert "launches" not in vars(conv4d_pallas)
        assert conv4d_pallas.launches == 3
    finally:
        conv4d_pallas.launches_by_kernel.update(saved)


@pytest.mark.parametrize("flops,nbytes,products,want_by", [
    # B2's coarse-to-fine call: operations bind (PERF.md's 3.865 ms)
    (3.82e12, 6.0e8, 1, "operations"),
    # B4 at the serving shape: bytes bind (0.0689 ms)
    (2.65e10, 2.30e8, 1, "bytes"),
    # an f32 volume as three bf16 products triples the operations' time
    (1.0e9, 1.0e7, 3, "operations"),
    # a tie reads operations
    (989e9, 3350e6, 1, "operations"),
])
def test_bound_is_the_larger_time(flops, nbytes, products, want_by):
    """``roofline.bound``: the larger of FLOP over the bf16 peak (each
    counted ``products`` times) and bytes over the HBM rate, in ms, and
    which binds; other peaks when given."""
    ms, by = roofline.bound(flops, nbytes, products)
    t_ops = products * flops / roofline.PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / roofline.PEAK_HBM_BYTES_PER_S * 1e3
    assert ms == pytest.approx(max(t_ops, t_bytes)) and by == want_by
    ms32, _ = roofline.bound(flops, nbytes, peak_flops=roofline.PEAK_F32_FLOPS)
    assert ms32 == pytest.approx(max(flops / 67e12 * 1e3, t_bytes))
