"""The work a call actually ran: the executed count behind the bench's
``forward_bf16_mfu_executed_pct`` (``tools/bench.py``).  A measurement aid:
nothing on the main path counts FLOPs, and no wrapper counts more than its
launches.

Where ``observability/roofline.py::forward_work`` counts what the forward
needs whatever runs it (the algorithmic count), :func:`executed_work`
counts what the route the choosers took ran, in three parts:

  * ``library``: the PyTorch ops, as ``torch.utils.flop_counter.
    FlopCounterMode`` counts them: convolutions and matrix products, two
    FLOPs a multiply-add, at every kernel tap (a padded border's too: a
    library convolution computes them);
  * ``spectral``: the FFT tier's transforms, 5·N·log₂N real FLOPs a complex
    N-point transform and half that a real-to-complex or complex-to-real
    one (each ``torch.fft`` op at its own N), and the six FLOPs of a complex
    multiply-add's eight that FlopCounterMode's two leave out;
  * ``kernels``: the hand-written forward kernels' launches, each at its
    ``roofline.py`` count (multiply-adds at taps inside the volume; B5's
    tensor-core kernel computes an f32 volume as three bf16 products),
    taken from the shapes of the calls in which the wrapper counted a
    launch.  On the CPU the twins run, no launch is counted, and their ops
    are library ops.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ncnet_tpu_torch.observability import roofline
from ncnet_tpu_torch.ops import conv4d_pallas, nc_fused_lane, sparse_corr

# real FLOPs a transformed element, times log₂N: a complex transform's
# 5·N·log₂N, half that a real one's
_FFT_COEFF = {"_fft_c2c": 5.0, "_fft_r2c": 2.5, "_fft_c2r": 2.5}


def _b6(x, w, b):
    return roofline.stack_work(tuple(x.shape[:5]), (int(w.shape[0]),),
                               (int(w.shape[5]),), c_in=int(w.shape[4]))[0]


def _b8(fa_p2, fb, row_blocks, col_starts, **_):
    return roofline.gather_work(fa_p2, fb, row_blocks,
                                int(row_blocks.shape[2]))[0]


def _b5(x, w, tensor_core):
    flops, _, products = roofline.b5_work(
        tuple(x.shape[:5]), int(w.shape[0]), int(w.shape[4]),
        int(w.shape[5]), "float32" if x.dtype == torch.float32 else "bf16")
    return flops * (products if tensor_core else 1)


# kernel name (the bench's launch counts) → (module, wrapper that launches
# it, its launch counter, the work of one launch from the wrapper's args)
KERNELS = {
    "nc_conv4d_bf16": (nc_fused_lane, "nc_conv4d_layer",
                       lambda: nc_fused_lane.launches, _b6),
    "gather_tile_corr_bf16": (sparse_corr, "gather_tile_corr_pallas",
                              lambda: sparse_corr.launches, _b8),
    "conv4d_small_cout": (conv4d_pallas, "_launch",
                          lambda: conv4d_pallas.launches, _b5),
}


@dataclass
class Executed:
    """One call's executed FLOPs by part, and each kernel's launches."""

    library: float = 0.0
    spectral: float = 0.0
    kernels: Dict[str, float] = field(
        default_factory=lambda: dict.fromkeys(KERNELS, 0.0))
    launches: Dict[str, int] = field(
        default_factory=lambda: dict.fromkeys(KERNELS, 0))

    @property
    def total(self) -> float:
        return self.library + self.spectral + sum(self.kernels.values())


class _Spectral(TorchDispatchMode):
    """Counts the FFT ops and the complex matrix products' extra FLOPs."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in _FFT_COEFF:
            # the real side's sizes (the output of a c2r), the dims transformed
            real = out if name == "_fft_c2r" else args[0]
            n = math.prod(int(real.shape[d]) for d in args[1])
            self.flops += _FFT_COEFF[name] * real.numel() * math.log2(n)
        elif name in ("mm", "bmm") and args[0].is_complex():
            self.flops += 6 * args[0].numel() * int(args[1].shape[-1])
        return out


def _counting(ex: Executed, name: str, real: Callable, counter: Callable,
              work: Callable) -> Callable:
    def wrapper(*args, **kwargs):
        before = counter()
        out = real(*args, **kwargs)
        n = counter() - before
        if n:
            ex.launches[name] += n
            ex.kernels[name] += n * work(*args, **kwargs)
        return out
    return wrapper


def executed_work(fn: Callable[[], Any]) -> Tuple[Any, Executed]:
    """``fn()``'s result and the work it ran (:class:`Executed`).  The
    kernels' wrappers are wrapped for the call only."""
    ex = Executed()
    saved = {name: getattr(mod, attr)
             for name, (mod, attr, _, _) in KERNELS.items()}
    for name, (mod, attr, counter, work) in KERNELS.items():
        setattr(mod, attr, _counting(ex, name, saved[name], counter, work))
    try:
        with FlopCounterMode(display=False) as fc, _Spectral() as spectral:
            out = fn()
    finally:
        for name, (mod, attr, _, _) in KERNELS.items():
            setattr(mod, attr, saved[name])
    ex.library = float(fc.get_total_flops())
    ex.spectral = spectral.flops
    return out, ex
