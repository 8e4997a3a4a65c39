"""T1: the L2 layer probe (16→16, k = 5, 25⁴) as a hand-written CUDA kernel.

The JAX tool ``tools/pallas_l2_probe.py`` measures a Pallas TPU kernel,
``conv_l2_pallas``, from which the TPU's fused-lane NC layer (B1) was
designed: the layer in a padded fused-lane frame ``(B, 29, 29, 16, 841)``
(``(hB, wB)`` padded by 2 and fused into 841 lanes), the (p, q, c) = 400
contraction against N = (r, s, o) = 400 for each lane row, then the B-side
taps as lane-offset shift-adds.  Here the same function, under the same
module and function names so that a reader finds the counterpart, is the
CUDA kernel ``csrc/conv_l2_fused_lane.cu`` (an implicit GEMM on the tensor
cores, bf16 operands and f32 sums, over the interior cells of a plane;
its header says how).  The wrapper hands it the weights as bf16 B tiles
(:func:`pack_b_tiles`) and a scratch for its cell-major copy of ``xp``.

:func:`conv_l2_pallas` launches the kernel on a CUDA tensor and runs the
plain twin :func:`conv_l2_reference` on a CPU tensor, never the twin on a
CUDA tensor (a kernel that cannot build or launch raises).  Both round each
Y term to ``ydt`` (bf16 by default, as the JAX tool's ``YDT``) before the
(r, s) sum; ``ydt=torch.float32`` skips that rounding.

Run on the card from the repository root::

    python3 -m ncnet_tpu_torch.tools.pallas_l2_probe [batch] [bf16|f32]

It prints the card's name and power limit, the parity lines of
:func:`check`, then ms per volume for the layout conversion alone, the
kernel including the layout, and the cuDNN ``coutfold`` formulation +
ReLU.  The JAX tool's j-chunk, ablation and A-build arguments chose between
Mosaic code shapes of one TPU design; the CUDA kernel has one design.

``launches`` counts the kernel's launches in this process, so a run can
show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import subprocess
import sys
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ncnet_tpu_torch.models.ncnet import resolve_device
from ncnet_tpu_torch.ops import kernel_build
from ncnet_tpu_torch.tools._timing import timeit

SOURCE = "conv_l2_fused_lane.cu"
S, K, C = 25, 5, 16
SP = S + K - 1          # 29: padded rows/cols
KL = SP * SP            # 841 fused (k, l) lanes
LO = 2 * SP + 2         # 60: the first interior lane
NT = (S - 1) * SP + S   # 721 lanes from the first interior lane to the last
YDTS = {"bf16": torch.bfloat16, "f32": torch.float32}

#: kernel launches since the process started (or the caller last reset it)
launches = 0


def to_fused_layout(x: torch.Tensor) -> torch.Tensor:
    """(B, 25, 25, 25, 25, 16) -> (B, 29, 29, 16, 841) padded, contiguous."""
    b = x.shape[0]
    xp = F.pad(x, (0, 0) + (2, 2) * 4)
    return xp.permute(0, 1, 2, 5, 3, 4).reshape(b, SP, SP, C, KL).contiguous()


def from_fused_layout(y: torch.Tensor) -> torch.Tensor:
    """(B, 25, 25, 16, 841) -> (B, 25, 25, 25, 25, 16)."""
    b = y.shape[0]
    y = y.reshape(b, S, S, C, SP, SP)[:, :, :, :, 2:2 + S, 2:2 + S]
    return y.permute(0, 1, 2, 4, 5, 3)


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """(5, 5, 5, 5, 16, 16) -> (400, 400) [(p, q, c), (r, s, o)], contiguous."""
    return w.permute(0, 1, 4, 2, 3, 5).reshape(K * K * C, K * K * C).contiguous()


def pack_b_tiles(w2: torch.Tensor) -> torch.Tensor:
    """(400, 400) [(p, q, c), (r, s, o)] -> (25, 25, 4, 8, 8) [(p, q),
    (r, s), 2 (o // 8) + c // 8, c % 8, o % 8], contiguous: the kernel's B
    tiles, one (p, q)'s 25 taps a run, each tap the four 8 x 8 matrices of
    an ``ldmatrix.trans`` one after the other, so lane l reads the 16 bytes
    at 16 l."""
    t = w2.reshape(K * K, 2, 8, K * K, 2, 8)      # (pq, ch, c8, rs, oh, o8)
    return t.permute(0, 3, 4, 1, 2, 5).reshape(K * K, K * K, 4, 8, 8).contiguous()


def make_mask(device=None) -> torch.Tensor:
    """(1, 1, 841) bf16: 1 on the interior (hB, wB) lanes, 0 on the halo."""
    m = np.zeros((SP, SP), np.float32)
    m[2:2 + S, 2:2 + S] = 1.0
    return torch.from_numpy(m.reshape(1, 1, KL)).to(resolve_device(device),
                                                     torch.bfloat16)


def _check(xp, w2, bias, mask, ydt) -> None:
    if xp.dim() != 5 or tuple(xp.shape[1:]) != (SP, SP, C, KL):
        raise ValueError(f"xp must be (B, {SP}, {SP}, {C}, {KL}), got "
                         f"{tuple(xp.shape)}")
    if tuple(w2.shape) != (K * K * C, K * K * C):
        raise ValueError(f"w2 must be (400, 400), got {tuple(w2.shape)}")
    if bias.numel() != C or mask.numel() != KL:
        raise ValueError(f"bias must hold {C} values and mask {KL}, got "
                         f"{tuple(bias.shape)} and {tuple(mask.shape)}")
    if xp.dtype != torch.bfloat16 or w2.dtype != torch.bfloat16:
        raise TypeError(f"xp and w2 must be bf16, got {xp.dtype} and {w2.dtype}")
    if ydt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"ydt must be bf16 or f32, got {ydt}")


def conv_l2_reference(xp: torch.Tensor, w2: torch.Tensor, bias: torch.Tensor,
                      mask: torch.Tensor, ydt=torch.bfloat16) -> torch.Tensor:
    """The plain twin of one launch, with its rounding points: per (b, i)
    row, Y = W2ᵀ·A in f32 (A the 25 shifted (p, q) slabs of the padded
    rows), each Y term rounded to ``ydt``, the 25 lane-shifted (r, s) terms
    summed r-major in f32, bias, ReLU, mask, one rounding to ``xp.dtype``."""
    _check(xp, w2, bias, mask, ydt)
    b = xp.shape[0]
    w = w2.float()
    bias_f = bias.float().reshape(1, C, 1)
    mask_f = mask.float().reshape(1, 1, KL)[..., LO:LO + NT]
    out = torch.zeros((b, S, S, C, KL), dtype=xp.dtype, device=xp.device)
    for bi in range(b):
        for i in range(S):
            rows = xp[bi, i:i + K]  # (5, 29, 16, 841)
            a = torch.stack([rows[p, q:q + S] for p in range(K)
                             for q in range(K)], dim=1)  # (j, (p, q), c, l)
            y = torch.matmul(w.t(), a.reshape(S, K * K * C, KL).float())
            y = y.to(ydt).float()  # (j, (r, s, o), l)
            acc = torch.zeros((S, C, NT), dtype=torch.float32, device=xp.device)
            for r in range(K):
                for s in range(K):
                    blk, off = (r * K + s) * C, r * SP + s
                    acc = acc + y[:, blk:blk + C, off:off + NT]
            acc = torch.relu(acc + bias_f)
            out[bi, i, :, :, LO:LO + NT] = (acc * mask_f).to(xp.dtype)
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    lib = kernel_build.load(SOURCE)
    lib.conv_l2_fused_lane.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.conv_l2_fused_lane.restype = ctypes.c_int
    lib.conv_l2_fused_lane_scratch_bytes.argtypes = [ctypes.c_int]
    lib.conv_l2_fused_lane_scratch_bytes.restype = ctypes.c_longlong
    lib.conv_l2_fused_lane_error_string.argtypes = [ctypes.c_int]
    lib.conv_l2_fused_lane_error_string.restype = ctypes.c_char_p
    return lib


def conv_l2_cuda(xp: torch.Tensor, w2: torch.Tensor, bias: torch.Tensor,
                 mask: torch.Tensor, ydt=torch.bfloat16) -> torch.Tensor:
    """One launch of ``csrc/conv_l2_fused_lane.cu`` on the current stream (no
    synchronisation).  ``xp`` and ``w2`` bf16 and contiguous on the card;
    ``bias`` and ``mask`` any float dtype (the kernel reads them as f32,
    as the TPU kernel casts them).  The kernel reads only xp's interior
    planes and writes only the interior lanes: the frame's padding planes
    and the mask's halo lanes are zero, as :func:`to_fused_layout` and
    :func:`make_mask` make them."""
    global launches
    _check(xp, w2, bias, mask, ydt)
    if xp.device.type != "cuda" or any(t.device != xp.device
                                       for t in (w2, bias, mask)):
        raise RuntimeError(f"conv_l2_cuda runs on CUDA tensors, got "
                           f"{xp.device}, {w2.device}, {bias.device}, "
                           f"{mask.device}")
    if not (xp.is_contiguous() and w2.is_contiguous()):
        raise ValueError("conv_l2_cuda takes contiguous xp and w2")
    if not 0 < xp.shape[0] < 2 ** 16:
        raise ValueError(f"batch must be in [1, 65535], got {xp.shape[0]}")
    lib = _library()
    batch = int(xp.shape[0])
    wt = pack_b_tiles(w2)
    bias_f = bias.float().reshape(C).contiguous()
    mask_f = mask.float().reshape(KL).contiguous()
    scratch = torch.empty(lib.conv_l2_fused_lane_scratch_bytes(batch),
                          dtype=torch.uint8, device=xp.device)
    out = torch.empty((batch, S, S, C, KL), dtype=torch.bfloat16,
                      device=xp.device)
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream(xp.device).cuda_stream
        rc = lib.conv_l2_fused_lane(
            xp.data_ptr(), wt.data_ptr(), bias_f.data_ptr(), mask_f.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), batch,
            int(ydt == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError("conv_l2_fused_lane launch failed: "
                           + lib.conv_l2_fused_lane_error_string(rc).decode())
    launches += 1
    return out


def conv_l2_pallas(xp: torch.Tensor, w2: torch.Tensor, bias: torch.Tensor,
                   mask: torch.Tensor, ydt=torch.bfloat16) -> torch.Tensor:
    """relu(conv4d + bias) of the 16→16, k = 5 layer at 25⁴ in the padded
    fused-lane frame: the T1 CUDA kernel on a CUDA tensor, its twin on a CPU
    tensor.

    Args:
      xp: ``(B, 29, 29, 16, 841)`` padded fused-lane volume, bf16.
      w2: ``(400, 400)`` = w[(p, q, c), (r, s, o)], bf16.
      bias: ``(1, 16, 1)``; mask: ``(1, 1, 841)`` (:func:`make_mask`).
      ydt: the type each Y term is rounded to, bf16 or f32.

    Returns ``(B, 25, 25, 16, 841)`` bf16 in the same padded-lane frame, the
    halo lanes zero."""
    if xp.device.type == "cpu":
        return conv_l2_reference(xp, w2, bias, mask, ydt)
    return conv_l2_cuda(xp, w2, bias, mask, ydt)


def bit_equal_share(got: torch.Tensor, want: torch.Tensor) -> float:
    """The share of ``got``'s nonzero interior outputs that equal ``want``'s
    bit for bit (0 if none is nonzero).  With bf16 Y terms a term rounded
    at another point moves its output by a bf16 ulp of the term, far more
    than f32 sums in another order do, so this share tells the Y dtypes
    apart where the normalized error cannot."""
    interior = make_mask(got.device).reshape(KL) != 0
    got, want = got[..., interior], want[..., interior]
    nonzero = got != 0
    n = int(nonzero.sum())
    return float((got == want)[nonzero].sum()) / n if n else 0.0


def _normalized(got: torch.Tensor, want: torch.Tensor):
    err = float((got.float() - want.float()).abs().max())
    return err, err / max(1e-6, float(want.float().abs().max()))


def check(device=None, ydt=torch.bfloat16, batch: int = 2) -> Dict[str, float]:
    """The JAX tool's ``check()``: relu(``conv4d(variant="unroll")`` + bias)
    against the kernel, relative error < 5 %; and the kernel against its
    twin.  Seeded as the JAX check (numpy, seed 0; bf16 volume, weights and
    bias).  Prints the parity lines and returns their numbers."""
    from ncnet_tpu_torch.ops.conv4d import conv4d

    dev = resolve_device(device)
    rng = np.random.default_rng(0)

    def bf16(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)

    x = bf16(rng.normal(size=(batch, S, S, S, S, C)) * 0.1)
    w = bf16(rng.normal(size=(K, K, K, K, C, C)) * 0.05)
    bias = bf16(rng.normal(size=(C,)) * 0.1)

    ref = torch.relu(conv4d(x, w, bias, variant="unroll"))
    args = (to_fused_layout(x), pack_weight(w), bias.reshape(1, C, 1),
            make_mask(dev))
    out = conv_l2_pallas(*args, ydt=ydt)
    err, rel = _normalized(from_fused_layout(out), ref)
    print(f"parity: max abs err {err:.4g} (rel {rel:.3%})", flush=True)
    twin_err, twin_rel = _normalized(out, conv_l2_reference(*args, ydt=ydt))
    print(f"parity vs twin: max abs err {twin_err:.4g} (rel {twin_rel:.3e})",
          flush=True)
    if not rel < 0.05:
        raise AssertionError("numerics mismatch")
    return {"max_abs_err": err, "rel_err": rel, "twin_max_abs_err": twin_err,
            "twin_rel_err": twin_rel}


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def main(argv: Optional[List[str]] = None, device=None) -> Dict[str, float]:
    """``[batch] [bf16|f32]``: parity, then ms per volume for the layout
    conversion, the kernel (+ layout) and the cuDNN ``coutfold`` reference
    + ReLU.  Returns the printed numbers."""
    from ncnet_tpu_torch.ops.conv4d import conv4d

    args = sys.argv[1:] if argv is None else list(argv)
    batch = int(args[0]) if args else 8
    ydt_name = args[1] if len(args) > 1 else "bf16"
    if ydt_name not in YDTS:
        raise ValueError(f"Y dtype must be one of {sorted(YDTS)}, got {ydt_name!r}")
    ydt = YDTS[ydt_name]
    dev = resolve_device(device)
    card = card_line() if dev.type == "cuda" else "cpu"
    print(f"{card}; n_volumes={batch} ydt={ydt_name}", flush=True)
    results = check(dev, ydt)

    def make_input(g):
        def randn(shape, scale):
            return (torch.randn(shape, generator=g, device=dev) * scale
                    ).to(torch.bfloat16)

        return (randn((batch, S, S, S, S, C), 0.1),
                randn((K,) * 4 + (C, C), 0.05), randn((C,), 0.1))

    mask = make_mask(dev)

    def fold(x, out):
        eps = (out.float().sum() * 1e-12).to(x.dtype)
        return x + eps

    def step_layout_only(carry):
        x, w, bias = carry
        return fold(x, to_fused_layout(x)), w, bias

    def step_kernel(carry):
        x, w, bias = carry
        out = conv_l2_pallas(to_fused_layout(x), pack_weight(w),
                             bias.reshape(1, C, 1), mask, ydt=ydt)
        return fold(x, out), w, bias

    def step_coutfold(carry):
        x, w, bias = carry
        out = torch.relu(conv4d(x, w, bias, variant="coutfold"))
        return fold(x, out), w, bias

    kw = dict(per=batch, n_long=8, device=dev)
    results["layout_ms"] = timeit(step_layout_only, make_input, **kw)
    results["kernel_ms"] = timeit(step_kernel, make_input, **kw)
    results["coutfold_ms"] = timeit(step_coutfold, make_input, **kw)
    print(f"layout conversion only : {results['layout_ms']:7.3f} ms/volume "
          f"({card})")
    print(f"cuda kernel (+layout)  : {results['kernel_ms']:7.3f} ms/volume "
          f"({card})")
    print(f"coutfold reference     : {results['coutfold_ms']:7.3f} ms/volume "
          f"({card})", flush=True)
    return results


if __name__ == "__main__":
    main()
