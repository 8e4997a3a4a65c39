"""The work the port's kernels and filters must do, and the least time the
card could take for it: one copy of the roofline arithmetic, read by
``chip_smoke.py`` (each kernel's bound in its ``kernels`` line) and by
``tools/bench.py`` (the filter's roofline block).

Each ``*_work`` function counts what the FUNCTION needs, whatever
implements it: multiply-adds only at taps that lie inside the volume (a
same-padded convolution's border taps read zeros and are no work), and each
input, weight and output byte once.  :func:`bound` turns a count into the
larger of its two times, FLOP over the tensor cores' bf16 peak and bytes
over the HBM bandwidth, and says which one binds.  The peaks are the H100
SXM data sheet's (``observability/metrics.py``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

from ncnet_tpu_torch.observability.metrics import PEAK_BF16_TFLOPS, PEAK_HBM_GBPS

# published dense peaks of one H100 SXM (NVIDIA data sheet) at 700 W, from
# the port's peak tables
H100 = "NVIDIA H100 80GB HBM3"
PEAK_BF16_FLOPS = PEAK_BF16_TFLOPS[H100] * 1e12
PEAK_F32_FLOPS = 67e12    # float32 outside the tensor cores
PEAK_HBM_BYTES_PER_S = PEAK_HBM_GBPS[H100] * 1e9


def bound(flops: float, nbytes: float, products: int = 1,
          peak_flops: float = PEAK_BF16_FLOPS,
          peak_bytes_per_s: float = PEAK_HBM_BYTES_PER_S
          ) -> Tuple[float, str]:
    """``(ms, "operations" | "bytes")``: the least time for ``flops`` (each
    counted ``products`` times, as a kernel that computes an f32 product as
    several bf16 ones does) and ``nbytes``, and which of the two binds (a
    tie reads "operations")."""
    t_ops = products * flops / peak_flops
    t_bytes = nbytes / peak_bytes_per_s
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def stack_work(shape, kernels, channels, c_in=1, backward=False,
               need_dx=False):
    """(FLOP, bytes) a stack of layers on a ``c_in``-channel volume needs:
    multiply-adds only at taps inside the volume (same padding), each
    input, weight and output byte once (bf16).

    ``backward``: the stack's backward from its saved activations instead:
    per layer dW (the forward's count of multiply-adds) and the input
    gradient (the same count again), which layer 0 needs only with
    ``need_dx``; it reads every saved activation, the cotangent and the
    weights once and writes dW, db (and ``dx``) once."""
    b, *dims = shape
    cells = _prod(dims)
    flops, nbytes = 0, 2 * b * cells * c_in
    for li, (k, c_out) in enumerate(zip(kernels, channels)):
        layer = 2 * b * _taps(dims, k) * c_in * c_out
        if backward:
            flops += layer * (2 if li > 0 or need_dx else 1)
            nbytes += 2 * 2 * (k ** 4 * c_in * c_out + c_out)
            nbytes += 2 * b * cells * c_out  # the saved output
        else:
            flops += layer
            nbytes += 2 * (k ** 4 * c_in * c_out + c_out)
        c_in = c_out
    nbytes += 2 * b * cells * channels[-1]  # the output, or the cotangent
    if backward and need_dx:
        nbytes += 2 * b * cells
    return flops, nbytes


def chain_work(shape, k, c):
    """(FLOP, bytes) the tap-swap chain (``models/ncnet.py::
    tap_swap_chain``) of a two-layer (C, 1) stack of kernel ``k`` needs on
    a 1-channel volume: the fused first layer (1 → 2C), and the second
    layer and its tap-swapped twin (C → 1 each) on the two halves; the
    zero blocks of the chain's block-diagonal 2C → 2 layer are no work.
    Bytes: the input, those weights and the 2-channel output once (bf16)."""
    b, *dims = shape
    taps, cells = _taps(dims, k), b * _prod(dims)
    flops = 2 * b * taps * 2 * c + 2 * (2 * b * taps * c)
    nbytes = 2 * (cells + (k ** 4 * 2 * c + 2 * c) + 2 * (k ** 4 * c + 1)
                  + 2 * cells)
    return flops, nbytes


def dw_work(shape, k, c_in, c_out):
    """(FLOP, bytes) of one layer's dW and db (``nc_vjp_dw``): the
    forward's multiply-adds at taps inside the volume; it reads the input,
    the saved output and the cotangent (bf16) once and writes ``gz`` (bf16)
    and dW, db (f32) once."""
    b, *dims = shape
    cells = b * _prod(dims)
    flops = 2 * b * _taps(dims, k) * c_in * c_out
    nbytes = 2 * cells * (c_in + 3 * c_out) + 4 * (k ** 4 * c_in * c_out + c_out)
    return flops, nbytes


def b5_work(shape, k, c_in, c_out, dtype):
    """(FLOP, bytes, bf16 products) of one B5 launch: multiply-adds only at
    taps inside the volume; the volume, weights and output once each; the
    tensor-core kernel computes an f32 volume as three bf16 products (each
    at the bf16 peak), a bf16 volume as one."""
    b, *dims = shape
    cells = _prod(dims)
    size = 4 if dtype == "float32" else 2
    flops = 2 * b * _taps(dims, k) * c_in * c_out
    nbytes = size * (b * cells * c_in + k ** 4 * c_in * c_out
                     + b * cells * c_out)
    return flops, nbytes, 3 if dtype == "float32" else 1


def gather_work(fa_p2, fb, rows, k):
    """(FLOP, bytes) of one B4 launch: every output's C multiply-adds;
    fa_p2, fb, the two index arrays and the bf16 output once each."""
    b, n, p2, c = (int(d) for d in fa_p2.shape)
    flops = 2 * b * n * k * p2 * p2 * c
    nbytes = (2 * fa_p2.numel() + 2 * fb.numel() + 2 * 4 * rows.numel()
              + 2 * b * n * k * p2 * p2)
    return flops, nbytes


def l2_work(batch):
    """(FLOP, bytes, GEMM FLOP) of one T1 launch: multiply-adds only at taps
    inside the 25⁴ volume (16 → 16, k = 5); the padded fused-lane input,
    the weights, bias, mask and the output once each; and, as context, the
    GEMM formulation's count (400 × 400 per 841-lane row)."""
    from ncnet_tpu_torch.tools.pallas_l2_probe import C, K, KL, S, SP

    taps = _taps((S,) * 4, K)
    flops = 2 * batch * taps * C * C
    nbytes = (2 * batch * SP * SP * C * KL + 2 * (K * K * C) ** 2 + 2 * C
              + 2 * KL + 2 * batch * S * S * C * KL)
    gemm = 2 * batch * S * S * (K * K * C) ** 2 * KL
    return flops, nbytes, gemm


def filter_work(batch: int, side: int, feat_channels: int,
                kernels: Sequence[int], channels: Sequence[int]):
    """(FLOP, bytes) of the bf16 filter from a feature pair
    (``correlation_4d`` then ``ncnet_filter``) on ``batch`` pairs of square
    ``side`` grids: the NC stack on both directions of each pair's volume
    (:func:`stack_work` on ``2·batch`` volumes; the correlation and the two
    mutual-matching passes add under 1 % and are not counted); bytes: the
    two float32 feature batches read once, the stack's weights once and the
    bf16 filtered volumes written once."""
    vol = (2 * batch,) + (side,) * 4
    flops, _ = stack_work(vol, kernels, channels)
    weights, c_in = 0, 1
    for k, c_out in zip(kernels, channels):
        weights += 2 * (k ** 4 * c_in * c_out + c_out)
        c_in = c_out
    nbytes = (2 * 4 * batch * side * side * feat_channels + weights
              + 2 * batch * side ** 4)
    return flops, nbytes


def _taps(dims, k) -> int:
    """(cell, tap) pairs of a same-padded size-``k`` conv on a volume of
    ``dims`` whose tap lies inside the volume."""
    d = k // 2
    return _prod(sum(min(n - 1, x + d) - max(0, x - d) + 1 for x in range(n))
                 for n in dims)


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out
