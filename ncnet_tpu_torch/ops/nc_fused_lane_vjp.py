"""Backward of the bf16 NC stack on the H100 (the port of B3).

Ports ``ncnet_tpu/ops/nc_fused_lane_vjp.py::nc_stack_fused_vjp``, whose TPU
kernel ``_vjp_stage`` runs one ``pallas_call`` per layer, last to first.
For layer ``l`` with bf16 input ``x_l``, bf16 output ``y_l`` and the bf16
cotangent ``Γ_l`` of ``y_l``:

  * ``gz_l = Γ_l ⊙ (y_l > 0)`` (bf16; the TPU kernel's ``bf16(z) > 0``
    selects the same cells);
  * ``dW_l = Σ_cells x_l[cell + tap − k/2] ⊗ gz_l[cell]`` and
    ``db_l = Σ gz_l``, both summed in f32, then cast to the parameters'
    dtype (``nc_fused_lane_vjp.py:601-607``);
  * ``Γ_{l−1} = conv4d_same(gz_l, w_l flipped in all four tap dims, C_in and
    C_out swapped)``, no bias, no ReLU, f32 sums rounded to bf16; at
    ``l = 0`` it is ``dx``.

On CUDA tensors three hand-written kernels do this, each with its own
launch count in ``launches``:

  * ``nc_vjp_dw`` (``csrc/nc_conv4d_vjp.cuh``, on the tensor cores; one
    library a kernel size, ``csrc/nc_conv4d_vjp_k<k>.cu``): the mask,
    ``gz``, and f32 per-block partials of dW and db, over bands of the
    (hB, wB) plane and 16-channel tiles of C_in and C_out, so any plane
    size and any width up to ``nc_fused_lane.MAX_WIDTH`` runs;
  * ``nc_vjp_reduce`` (same source): the partials summed in a fixed order,
    so two runs give bit-identical gradients (no float atomics);
  * ``nc_conv4d_transpose`` (``csrc/nc_conv4d.cuh``, the forward kernel's
    transposed variant): ``Γ_{l−1}``.

Per layer that is one launch of each, except that ``Γ_{−1}`` (``dx``) is
skipped when the input needs no gradient.  They serve every layer that
``nc_fused_lane.layer_held`` holds (the training gate's
``nc_fused_lane.kernels_hold``) and refuse any other before a launch.  On
CPU tensors the plain twin runs instead (:func:`layer_vjp_reference`,
with the kernels' rounding points); on a CUDA tensor a kernel that cannot
build or launch raises.

Unlike the TPU kernel, which replays the forward in VMEM rings, the port
keeps the forward's bf16 layer outputs (``nc_fused_lane.NCStackFused``
saves them); :func:`nc_stack_fused_vjp` recomputes them to keep the JAX
signature ``(nc_params, x, g)``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ncnet_tpu_torch.ops import kernel_build, nc_fused_lane
from ncnet_tpu_torch.ops.conv4d import conv4d

#: partial rows of the dW/db reduction: bounds its buffer at
#: DW_PARTIALS · (k⁴·C_in·C_out + C_out) f32 (41 MB for a 16→16 k=5 layer)
DW_PARTIALS = 64

#: kernel launches since the process started (or the caller last reset them)
launches: Dict[str, int] = {"nc_vjp_dw": 0, "nc_vjp_reduce": 0,
                            "nc_conv4d_transpose": 0}


def flip_transpose(w: torch.Tensor) -> torch.Tensor:
    """``(k, k, k, k, C_in, C_out)`` → the transposed conv's weights: all
    four tap dims flipped, channel roles swapped (``_flip_pack``,
    ``nc_fused_lane_vjp.py:96-101``)."""
    return w.flip(0, 1, 2, 3).transpose(4, 5).contiguous()


# ---------------------------------------------------------------------------
# the plain twin
# ---------------------------------------------------------------------------


def layer_vjp_reference(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
                        w: torch.Tensor, need_dx: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor,
                                   Optional[torch.Tensor]]:
    """One layer's backward with the kernels' rounding points: bf16 ``gz``,
    f32 sums for dW (autograd of the f32 ``conv4d``, its ``unroll``
    formulation, on the bf16 operands),
    db and ``Γ_{l−1}``, and bf16 ``Γ_{l−1}``.  Returns ``(dW f32, db f32,
    Γ_{l−1} bf16 or None)``."""
    gz = torch.where(y > 0, g.to(torch.bfloat16),
                     torch.zeros((), dtype=torch.bfloat16, device=g.device))
    w32 = w.to(torch.bfloat16).to(torch.float32)
    with torch.enable_grad():
        wv = w32.detach().requires_grad_()
        z = conv4d(x.to(torch.bfloat16).to(torch.float32), wv,
                   variant="unroll")
        (dw,) = torch.autograd.grad(z, [wv], gz.to(torch.float32))
    db = gz.to(torch.float32).sum(dim=(0, 1, 2, 3, 4))
    dx = None
    if need_dx:
        dx = conv4d(gz.to(torch.float32), flip_transpose(w32),
                    variant="unroll").to(torch.bfloat16)
    return dw, db, dx


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def source(k: int) -> str:
    """B7's source at kernel size ``k``, relative to ``csrc/``."""
    return f"nc_conv4d_vjp_k{int(k)}.cu"


@functools.cache
def _library(k: int) -> ctypes.CDLL:
    lib = kernel_build.load(source(k))
    lib.nc_vjp_dw_bf16.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    lib.nc_vjp_dw_bf16.restype = ctypes.c_int
    lib.nc_vjp_reduce_f32.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.nc_vjp_reduce_f32.restype = ctypes.c_int
    lib.nc_vjp_supported.argtypes = [ctypes.c_int] * 3
    lib.nc_vjp_supported.restype = ctypes.c_int
    lib.nc_vjp_error_string.argtypes = [ctypes.c_int]
    lib.nc_vjp_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(rc: int, name: str, k: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + _library(k).nc_vjp_error_string(rc).decode())


def nc_vjp_dw(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
              k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mask and the dW/db partials of one layer through
    ``nc_vjp_dw_kernel``: ``x`` (B, hA, wA, hB, wB, C_in), ``y`` and ``g``
    (…, C_out), all bf16 on the card.  Returns ``(gz bf16 like y, partial
    f32 (P, k⁴·C_in·C_out + C_out))``.  Launches on the current stream and
    does not synchronise."""
    ts = (x, y, g)
    if x.device.type != "cuda":
        raise RuntimeError(f"nc_vjp_dw runs on CUDA tensors, got {x.device}")
    if any(t.dtype != torch.bfloat16 or t.device != x.device for t in ts):
        raise TypeError("nc_vjp_dw takes bf16 tensors on one device, got "
                        f"{[(t.dtype, str(t.device)) for t in ts]}")
    if (x.dim() != 6 or y.shape != g.shape or y.dim() != 6
            or x.shape[:5] != y.shape[:5]):
        raise ValueError(f"nc_vjp_dw: volume {tuple(x.shape)}, output "
                         f"{tuple(y.shape)} and cotangent {tuple(g.shape)} "
                         "disagree")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("nc_vjp_dw takes contiguous tensors")
    c_in, c_out = int(x.shape[5]), int(y.shape[5])
    bsz, ha, wa, hb, wb = (int(d) for d in x.shape[:5])
    if not nc_fused_lane.layer_held(k, c_in, c_out):
        raise NotImplementedError(
            f"nc_vjp_dw: the kernels do not serve k={k}, {c_in}->{c_out} "
            f"channels (odd k <= {nc_fused_lane.MAX_K}, widths <= "
            f"{nc_fused_lane.MAX_WIDTH})")
    lib = _library(k)
    x, y, g = (nc_fused_lane._aligned16(t) for t in (x, y, g))
    n_parts = min(DW_PARTIALS, bsz * ha * wa)
    gz = torch.empty_like(y)
    partial = torch.empty((n_parts, k ** 4 * c_in * c_out + c_out),
                          dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.nc_vjp_dw_bf16(x.data_ptr(), y.data_ptr(), g.data_ptr(),
                                gz.data_ptr(), partial.data_ptr(), bsz, ha,
                                wa, hb, wb, k, c_in, c_out, n_parts, stream)
    if rc == -1:  # the library's own limits refused the shape
        raise NotImplementedError(
            f"nc_vjp_dw: {source(k)} does not serve k={k}, {c_in}->{c_out}")
    _raise_on(rc, "nc_vjp_dw", k)
    launches["nc_vjp_dw"] += 1
    return gz, partial


def nc_vjp_reduce(partial: torch.Tensor, k: int = 5) -> torch.Tensor:
    """``partial.sum(0)`` in f32 through ``nc_vjp_reduce_kernel``, the rows
    added in order 0, 1, …: ``partial`` (P, n) f32 contiguous on the card.
    Every kernel size's library holds the same reduction: ``k`` names the
    one that runs it (the layer's, so no other library is built)."""
    if partial.device.type != "cuda":
        raise RuntimeError(f"nc_vjp_reduce runs on CUDA tensors, got {partial.device}")
    if (partial.dtype != torch.float32 or partial.dim() != 2
            or not partial.is_contiguous()):
        raise TypeError("nc_vjp_reduce takes a contiguous 2-D f32 tensor, got "
                        f"{partial.dtype} {tuple(partial.shape)}")
    n_parts, n = (int(d) for d in partial.shape)
    out = torch.empty((n,), dtype=torch.float32, device=partial.device)
    with torch.cuda.device(partial.device):
        stream = torch.cuda.current_stream(partial.device).cuda_stream
        rc = _library(k).nc_vjp_reduce_f32(partial.data_ptr(),
                                           out.data_ptr(), n, n_parts, stream)
    _raise_on(rc, "nc_vjp_reduce", k)
    launches["nc_vjp_reduce"] += 1
    return out


def nc_conv4d_transpose(gz: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``Γ_{l−1}`` of a forward layer with weights ``w`` (k, k, k, k, C_in,
    C_out) from its masked cotangent ``gz`` (…, C_out) bf16 on the card,
    through the forward kernel's transposed variant; returns bf16 (…,
    C_in)."""
    out = nc_fused_lane._conv(gz, flip_transpose(w.to(torch.bfloat16)), None,
                              "nc_conv4d_transpose")
    launches["nc_conv4d_transpose"] += 1
    return out


def layer_vjp(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
              w: torch.Tensor, need_dx: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """One layer's backward through the kernels: ``(dW f32, db f32,
    Γ_{l−1} bf16 or None)``, as :func:`layer_vjp_reference`."""
    k, c_in, c_out = int(w.shape[0]), int(w.shape[4]), int(w.shape[5])
    gz, partial = nc_vjp_dw(x.contiguous(), y.contiguous(),
                            g.to(torch.bfloat16).contiguous(), k)
    sums = nc_vjp_reduce(partial, k)
    dw = sums[:-c_out].reshape(w.shape)
    db = sums[-c_out:]
    dx = nc_conv4d_transpose(gz, w) if need_dx else None
    return dw, db, dx


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------


def stack_vjp(nc_params: List[dict], acts: Sequence[torch.Tensor],
              g: torch.Tensor, need_dx: bool = True, twin: bool = False
              ) -> Tuple[List[dict], Optional[torch.Tensor]]:
    """The stack's backward from its saved activations ``acts = [x, y_0, …,
    y_{L−1}]`` (bf16) and the cotangent ``g`` of ``y_{L−1}``: returns
    ``(d_params, dx)`` with dW and db in the parameters' dtypes and ``dx``
    bf16, or None unless ``need_dx``.  The kernels run on CUDA tensors and
    the twin on CPU tensors; ``twin=True`` runs the twin on any device (the
    comparisons in the tests and ``chip_smoke.py``)."""
    if g.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"the NC stack runs on CUDA or CPU tensors, got {g.device}")
    layer = (layer_vjp_reference if twin or g.device.type == "cpu"
             else layer_vjp)
    gamma = g.to(torch.bfloat16)
    d_params: List[Optional[dict]] = [None] * len(nc_params)
    for li in reversed(range(len(nc_params))):
        w, b = nc_params[li]["w"], nc_params[li]["b"]
        dw, db, gamma = layer(acts[li], acts[li + 1], gamma, w,
                              need_dx=need_dx or li > 0)
        d_params[li] = {"w": dw.to(w.dtype), "b": db.to(b.dtype)}
    return d_params, gamma


def nc_stack_fused_vjp(nc_params: List[dict], x: torch.Tensor,
                       g: torch.Tensor) -> Tuple[List[dict], torch.Tensor]:
    """``(d_nc_params, dx)`` for cotangent ``g`` of ``nc_stack_fused(
    nc_params, x)``: the kernels on CUDA tensors, the twin on CPU tensors.
    The forward's layer outputs are recomputed (the forward kernel on the
    card), as the JAX function consumes only ``(nc_params, x)``."""
    nc_fused_lane._check_fused(nc_params, x)
    acts = nc_fused_lane.stack_activations(nc_params, x)
    d_params, dx = stack_vjp(nc_params, acts, g)
    return d_params, dx.to(x.dtype)


def nc_stack_vjp_reference(nc_params: List[dict], x: torch.Tensor,
                           g: torch.Tensor) -> Tuple[List[dict], torch.Tensor]:
    """The plain twin of :func:`nc_stack_fused_vjp` on any device: the
    forward twin ``nc_stack_reference`` layer by layer, then
    :func:`layer_vjp_reference` last to first."""
    nc_fused_lane._check_fused(nc_params, x)
    acts = [x.to(torch.bfloat16)]
    for layer in nc_params:
        acts.append(nc_fused_lane.layer_reference(acts[-1], layer["w"],
                                                  layer["b"]))
    d_params, dx = stack_vjp(nc_params, acts, g, twin=True)
    return d_params, dx.to(x.dtype)
