"""B5: the small-C_out same-padded conv4d, as hand-written CUDA kernels.

The JAX package's ``ncnet_tpu/ops/conv4d_pallas.py::conv4d_small_cout`` is
a Pallas TPU kernel (``_fwd_impl``) that folds the taps into the matmul's N
dimension; ``conv4d(variant="auto")`` sends every same-padded, cubic, odd
layer with C_out ≤ 4 to it.  Here the same function, under the same module
and function names so that a reader finds the counterpart, is
``csrc/conv4d_small_cout.cu``, two kernels chosen by the kernel size alone:

* k in :data:`TC_KERNEL_SIZES` (3 and 5, every model configuration's): the
  tensor-core kernel, an implicit GEMM on ``mma.sync`` with bf16 operands
  and f32 sums; an f32 volume is three bf16 products (x_hi w_hi + x_hi w_lo
  + x_lo w_hi, hi = bf16(v), lo = bf16(v - hi)), a bf16 volume one.  Its
  call runs a split pass that writes x's hi and lo parts once, a pass that
  lays out the weights, and the products, which stage both by bulk copies
  (TMA); the wrapper allocates their scratch (80 bytes a 16-channel chunk
  of a cell in f32, 48 in bf16);
* any other odd k up to :data:`MAX_K`: the direct CUDA-core kernel (a block
  stages each (p, q) tap pair's input slab and weights in shared memory, a
  thread owns a strip of 4 output cells, f32 sums).

The source's header says why.  :func:`split_products_reference` emulates the
tensor-core kernel's rounding points in PyTorch, for the tests.

:func:`conv4d_small_cout` is a ``torch.autograd.Function``: its forward is
a kernel on a CUDA tensor and the plain twin
:func:`conv4d_small_cout_reference` on a CPU tensor, never the twin on a
CUDA tensor (a kernel that cannot build or launch raises).  Its backward is
the autograd of ``conv4d(variant="coutfold")``, as the JAX ``_bwd_rule``.
It takes f32 or bf16 ``x``, casts the weights to ``x.dtype``, sums in f32
and rounds once to ``x.dtype``; it takes any C_in and any C_out (chunks of
4), and raises on a non-cubic or even kernel or one above :data:`MAX_K`
(where one group of 4 channels no longer fits the card's shared memory;
``ops/conv4d.py``'s chooser never sends one).

``launches_by_kernel`` counts each kernel's launches in this process (a
call of the tensor-core kernel, its passes included, is one), so a run can
show that its path went through the kernel it expects; ``launches`` reads
their sum.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ncnet_tpu_torch.ops import kernel_build

SOURCE = "conv4d_small_cout.cu"
#: the largest kernel size the kernel takes (``kMaxK`` in the source)
MAX_K = 27

#: the kernel sizes the tensor-core kernel takes; every other odd size up
#: to MAX_K runs on the CUDA-core kernel
TC_KERNEL_SIZES = (3, 5)

#: launches by kernel, "tensor_core" and "cuda_core", since the process
#: started (or the caller last reset them)
launches_by_kernel = {"tensor_core": 0, "cuda_core": 0}


def __getattr__(name: str) -> int:
    # ``launches``: both kernels' launches, read from launches_by_kernel
    if name == "launches":
        return sum(launches_by_kernel.values())
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 6 or w.dim() != 6:
        raise ValueError(f"conv4d_small_cout takes x (B, hA, wA, hB, wB, C_in) "
                         f"and w (k, k, k, k, C_in, C_out), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    k = int(w.shape[0])
    if tuple(w.shape[:4]) != (k,) * 4:
        raise ValueError(f"kernel must be cubic (k,k,k,k), got {tuple(w.shape[:4])}")
    if k % 2 == 0:
        raise ValueError(f"same-padding requires an odd kernel size, got {k}")
    if k > MAX_K:
        raise NotImplementedError(f"conv4d_small_cout takes kernel sizes up "
                                  f"to {MAX_K}, got {k}")
    if x.shape[5] != w.shape[4]:
        raise ValueError(f"channel mismatch: {x.shape[5]} vs {w.shape[4]}")


def conv4d_small_cout_reference(x: torch.Tensor, w: torch.Tensor
                                ) -> torch.Tensor:
    """The plain twin of one launch, with its rounding points: the weights
    cast to ``x.dtype``, both taken to f32 (f64 for an f64 volume), a
    same-padded conv4d (the ``unroll`` formulation), one rounding to
    ``x.dtype``."""
    from ncnet_tpu_torch.ops.conv4d import conv4d

    _check(x, w)
    acc = torch.promote_types(x.dtype, torch.float32)
    w = w.to(x.dtype).to(acc)
    return conv4d(x.to(acc), w, variant="unroll").to(x.dtype)


def split_products_reference(x: torch.Tensor, w: torch.Tensor
                             ) -> torch.Tensor:
    """The tensor-core kernel's rounding points, emulated: for an f32 volume,
    x = x_hi + x_lo and w = w_hi + w_lo with hi = bf16(v) and lo = bf16(v -
    hi), the three products x_hi w_hi, x_hi w_lo and x_lo w_hi each taken
    in f32 through the plain ``unroll`` conv4d and summed (x_lo w_lo is
    dropped), then one rounding to ``x.dtype``; a bf16 volume is one product,
    the twin's.  Only the tests call it."""
    from ncnet_tpu_torch.ops.conv4d import conv4d

    _check(x, w)
    if x.dtype != torch.float32:
        return conv4d_small_cout_reference(x, w)

    def split(v):
        hi = v.to(torch.bfloat16).float()
        return hi, (v - hi).to(torch.bfloat16).float()

    (x_hi, x_lo), (w_hi, w_lo) = split(x), split(w.float())
    return (conv4d(x_hi, w_hi, variant="unroll")
            + conv4d(x_hi, w_lo, variant="unroll")
            + conv4d(x_lo, w_hi, variant="unroll")).to(x.dtype)


def near_bf16_midpoints(rng: np.random.Generator, dims, e: int) -> np.ndarray:
    """f32 test values just above a bf16 rounding midpoint, (n + 0.55 + 0.4 u)
    2^-7 2^e with n a random integer in [128, 255): bf16 rounds every one up,
    so one bf16 product a term misses an all-positive f32 sum by ~2e-3 of it
    while three products (:func:`split_products_reference`) do not.  Only
    the tests and the card check call it."""
    n = rng.integers(128, 255, dims)
    return ((n + 0.55 + 0.4 * rng.random(dims)) * 2.0 ** (e - 7)).astype(np.float32)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = kernel_build.load(SOURCE)
    lib.conv4d_small_cout.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    lib.conv4d_small_cout.restype = ctypes.c_int
    lib.conv4d_small_cout_tc.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    lib.conv4d_small_cout_tc.restype = ctypes.c_int
    lib.conv4d_small_cout_tc_scratch_bytes.argtypes = [ctypes.c_int] * 9
    lib.conv4d_small_cout_tc_scratch_bytes.restype = ctypes.c_longlong
    lib.conv4d_small_cout_max_k.restype = ctypes.c_int
    lib.conv4d_small_cout_error_string.argtypes = [ctypes.c_int]
    lib.conv4d_small_cout_error_string.restype = ctypes.c_char_p
    if lib.conv4d_small_cout_max_k() != MAX_K:
        raise RuntimeError(f"{SOURCE} takes kernel sizes up to "
                           f"{lib.conv4d_small_cout_max_k()}, MAX_K says {MAX_K}")
    return lib


def conv4d_small_cout_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One launch of ``csrc/conv4d_small_cout.cu`` on the current stream (no
    synchronisation): ``x`` f32 or bf16 on the card, ``w`` cast to its
    dtype; returns ``(B, hA, wA, hB, wB, C_out)`` in ``x.dtype``.  The
    kernel is chosen by the kernel size alone: the tensor-core kernel for k
    in :data:`TC_KERNEL_SIZES`, the CUDA-core kernel for any other."""
    return _launch(x, w, tensor_core=int(w.shape[0]) in TC_KERNEL_SIZES)


def _launch(x: torch.Tensor, w: torch.Tensor, tensor_core: bool
            ) -> torch.Tensor:
    """One launch of the kernel named (``tensor_core`` False: the CUDA-core
    kernel, at any k up to :data:`MAX_K`)."""
    _check(x, w)
    if x.device.type != "cuda" or w.device != x.device:
        raise RuntimeError(f"conv4d_small_cout_cuda runs on CUDA tensors, got "
                           f"{x.device} and {w.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv4d_small_cout takes f32 or bf16 volumes, got {x.dtype}")
    k, c_in, c_out = int(w.shape[0]), int(w.shape[4]), int(w.shape[5])
    if tensor_core and k not in TC_KERNEL_SIZES:
        raise ValueError(f"the tensor-core kernel takes k in {TC_KERNEL_SIZES}, "
                         f"got {k}")
    if any(int(d) >= 2**31 for d in x.shape) or x.numel() >= 2**62:
        raise ValueError(f"volume {tuple(x.shape)} is too large for the kernel")
    lib = _library()
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernels' vector loads need 16-byte alignment
        x = x.clone()
    w = w.to(x.dtype).contiguous()
    out = torch.empty(x.shape[:5] + (c_out,), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    dims = [int(d) for d in x.shape[:5]]
    bf16 = int(x.dtype == torch.bfloat16)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if tensor_core:
            # the split copy of x and the weight tiles the kernel stages
            scratch = torch.empty(
                lib.conv4d_small_cout_tc_scratch_bytes(*dims, k, c_in, c_out,
                                                       bf16),
                dtype=torch.uint8, device=x.device)
            rc = lib.conv4d_small_cout_tc(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                *dims, k, c_in, c_out, bf16, stream)
        else:
            rc = lib.conv4d_small_cout(x.data_ptr(), w.data_ptr(),
                                       out.data_ptr(), *dims, k, c_in, c_out,
                                       bf16, stream)
    if rc != 0:
        raise RuntimeError("conv4d_small_cout launch failed: "
                           + lib.conv4d_small_cout_error_string(rc).decode())
    launches_by_kernel["tensor_core" if tensor_core else "cuda_core"] += 1
    return out


def _forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return conv4d_small_cout_reference(x, w)
    return conv4d_small_cout_cuda(x, w)


class _SmallCout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _forward(x, w)

    @staticmethod
    def backward(ctx, g):
        from ncnet_tpu_torch.ops.conv4d import conv4d

        x, w = ctx.saved_tensors
        with torch.enable_grad():
            xx = x.detach().requires_grad_()
            ww = w.detach().requires_grad_()
            y = conv4d(xx, ww.to(xx.dtype), variant="coutfold")
            dx, dw = torch.autograd.grad(y, (xx, ww), g)
        return dx, dw


def conv4d_small_cout(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """'Same'-padded 4D conv through a B5 CUDA kernel (its twin on a CPU
    tensor).

    Args:
      x: ``(B, hA, wA, hB, wB, C_in)`` volume, f32 or bf16.
      w: ``(k, k, k, k, C_in, C_out)``, one odd kernel size on all four dims.

    Returns ``(B, hA, wA, hB, wB, C_out)`` in ``x.dtype``; differentiable
    (the backward is the ``coutfold`` formulation's autograd)."""
    _check(x, w)
    return _SmallCout.apply(x, w)
