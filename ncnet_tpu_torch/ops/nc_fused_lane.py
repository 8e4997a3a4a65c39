"""The bf16 neighbourhood-consensus stack on the H100.

Ports the two Pallas entry points of ``ncnet_tpu/ops/nc_fused_lane.py``:
``nc_stack_resident`` (the whole ``[conv4d_same + bias + ReLU]×L`` stack in
one TPU program) and ``nc_stack_fused_lane`` (one TPU program per layer).
Both keep their JAX signatures' tensors and shape-class checks; on a CUDA
tensor both launch the hand-written kernel ``csrc/nc_conv4d.cu`` once per
layer, with bf16 activations between layers and f32 sums inside each layer.
On a CPU tensor they run the plain twin :func:`nc_stack_reference`, and on a
CUDA tensor they never do: a kernel that cannot build or launch raises.

``nc_stack_fused`` is the differentiable stack (the JAX ``custom_vjp`` of
the same name): a ``torch.autograd.Function`` whose forward asks the tier
chooser as the JAX ``_fused_stack_impl`` does (the FFT tier, or the
per-layer kernel) and whose backward is ``ops/nc_fused_lane_vjp.py`` (the B3
kernels on the card, their twin on the CPU).  Unlike the TPU kernel, which
replays the forward in its backward, the Function saves the forward's bf16
layer outputs.

:func:`choose_fused_stack` is the tier authority
(``ncnet_tpu/ops/nc_fused_lane.py:838-976``): the arithmetic tiers first
(``"cp"``, ``"fft"``; any device, any dtype), then, for bf16 volumes and
weights, ``"resident"`` (B2's shape class, for the layer shapes the
kernels are compiled for: :data:`COMPILED_LAYER_SHAPES`), else None (the
conv4d formulations).  The TPU's VMEM gates and compile probes bind no CUDA
kernel and are not carried; the runtime demotion registry, the persistent
tier cache and the tier events wait in ROADMAP queue A.
:func:`last_selected_tier` reads the most recent decision per stage.

``launches`` counts the forward kernel's launches in this process (one per
layer per stack call), so a run can show that its path went through the
kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import torch

from ncnet_tpu_torch.ops import kernel_build
from ncnet_tpu_torch.ops.conv4d import conv4d
from ncnet_tpu_torch.ops.conv4d_cp import (
    cp_feasible,
    cp_stack_ranks,
    nc_stack_cp,
)
from ncnet_tpu_torch.ops.conv4d_fft import (
    fft_feasible,
    fft_stack_activations,
    nc_stack_fft,
)

SOURCE = "nc_conv4d.cu"

#: kernel launches since the process started (or the caller last reset it)
launches = 0


def _stack_shape(nc_params: List[dict]) -> Tuple[tuple, tuple]:
    kernels = tuple(int(layer["w"].shape[0]) for layer in nc_params)
    channels = tuple(int(layer["w"].shape[5]) for layer in nc_params)
    return kernels, channels


def _check_stack(nc_params: List[dict], x: torch.Tensor, name: str) -> None:
    """The shape class both entry points share: a 1-channel input volume
    and first layer, cubic odd kernels of one size, chained channels."""
    if x.dim() != 6 or x.shape[-1] != 1 or nc_params[0]["w"].shape[4] != 1:
        raise ValueError(
            f"{name} requires a 1-channel input volume (B, hA, wA, hB, wB, 1) "
            "and first layer (the NC-stack shape class)")
    kernels, channels = _stack_shape(nc_params)
    c_in = 1
    for layer, c_out in zip(nc_params, channels):
        w = layer["w"]
        if len(set(w.shape[:4])) != 1 or w.shape[4] != c_in:
            raise ValueError(f"{name}: layer weights {tuple(w.shape)} are not "
                             f"cubic with {c_in} input channels")
        c_in = c_out
    if len(set(kernels)) != 1 or kernels[0] % 2 == 0:
        raise ValueError(f"{name} needs one odd kernel size for the whole "
                         f"stack, got kernels={kernels}")


# the most recent decision per stage ("forward"): the tier name, or "xla"
# when the chooser sent the stack to the conv4d formulations
_last_selected: dict = {}


def last_selected_tier(stage: str = "forward"):
    """The tier the stage's chooser (or a forced tier) most recently
    decided on for any shape ('cp' / 'fft' / 'resident' / 'xla'), or None
    when it has not run in this process."""
    return _last_selected.get(stage)


def note_forced_tier(tier) -> None:
    """Record a forward tier decided outside the chooser as the stage's
    active decision: an explicitly forced one (``ModelConfig.nc_tier``), or
    the training gate's ``"xla"`` for a stack the kernels do not serve."""
    _last_selected["forward"] = tier


#: The ``(k, C_in, C_out)`` layer shapes the kernels are compiled for: the
#: ``NC_CONV4D_SHAPES`` list of ``csrc/nc_conv4d.cu`` (B6, and the
#: transposed launch of the backward under the same forward shape) and the
#: ``NC_VJP_SHAPES`` list of ``csrc/nc_conv4d_vjp.cu`` (B3's dW/db), which
#: repeat each other.  The routes below read it before any launch.
COMPILED_LAYER_SHAPES = frozenset({
    (5, 1, 16), (5, 16, 16), (5, 16, 1),
    (3, 1, 16), (3, 16, 16), (3, 16, 1),
    (3, 1, 10), (3, 10, 10), (3, 10, 1),
    (3, 1, 1), (3, 1, 2), (3, 1, 4), (3, 2, 1), (3, 2, 2), (3, 4, 1),
    (3, 4, 2), (3, 4, 4),
    (5, 1, 1), (5, 1, 2), (5, 1, 4), (5, 2, 1), (5, 2, 2), (5, 4, 1),
    (5, 4, 2), (5, 4, 4),
})


def stack_compiled(kernels, channels) -> bool:
    """Whether every ``(k, C_in, C_out)`` layer of the stack (a 1-channel
    input) is in :data:`COMPILED_LAYER_SHAPES`."""
    c_in, layers = 1, []
    for k, c_out in zip(kernels, channels):
        layers.append((int(k), c_in, int(c_out)))
        c_in = int(c_out)
    return all(s in COMPILED_LAYER_SHAPES for s in layers)


def fused_shape_class(kernels, channels) -> bool:
    """B2's shape class, from the stack's kernel sizes and channels: one
    odd kernel size for the whole stack, a final layer of at most 4
    channels (the whole-volume checks are ``_check_stack``'s), and every
    layer compiled into the kernels (:func:`stack_compiled`).  B3, the
    backward, serves the same class."""
    kernels, channels = tuple(kernels), tuple(channels)
    return (len(set(kernels)) == 1 and kernels[0] % 2 == 1
            and channels[-1] <= 4 and stack_compiled(kernels, channels))


def choose_fused_stack(ha, wa, hb, wb, kernels, channels, cp_ranks=None,
                       pallas_ok: bool = True):
    """The stack's tier at a shape class, the first that applies: ``"cp"``
    (every layer carries factors and ``conv4d_cp.cp_feasible`` passes),
    ``"fft"`` (``conv4d_fft.fft_feasible``), then, only when ``pallas_ok``
    (a bf16 volume and weights), ``"resident"`` (B2's shape class, whose
    layers the kernel is compiled for); else None (the conv4d formulations
    layer by layer, reported as ``"xla"``).  The JAX ladder's
    ``"perlayer"`` (a 1-channel final layer) lies inside B2's shape class,
    so without the VMEM gates it is never reached."""
    kernels, channels = tuple(kernels), tuple(channels)
    tier = None
    if cp_ranks and cp_feasible(ha, wa, hb, wb, kernels, channels,
                                tuple(cp_ranks)):
        tier = "cp"
    elif fft_feasible(ha, wa, hb, wb, kernels, channels):
        tier = "fft"
    elif pallas_ok and fused_shape_class(kernels, channels):
        tier = "resident"
    _last_selected["forward"] = tier or "xla"
    return tier


def layer_reference(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """The plain twin of one kernel launch, with its rounding points: bf16
    operands (input volume, weights, bias), an f32 same-padded conv4d
    (``ops/conv4d.py``, the ``unroll`` formulation), f32 bias and ReLU,
    bf16 output."""
    w = w.to(torch.bfloat16).to(torch.float32)
    b = b.to(torch.bfloat16).to(torch.float32)
    x = x.to(torch.bfloat16).to(torch.float32)
    return torch.relu(conv4d(x, w, b, variant="unroll")).to(torch.bfloat16)


def nc_stack_reference(nc_params: List[dict], x: torch.Tensor) -> torch.Tensor:
    """The plain twin of the stack: :func:`layer_reference` per layer."""
    x = x.to(torch.bfloat16)
    for layer in nc_params:
        x = layer_reference(x, layer["w"], layer["b"])
    return x


@functools.cache
def _library() -> ctypes.CDLL:
    lib = kernel_build.load(SOURCE)
    lib.nc_conv4d_bf16.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.nc_conv4d_bf16.restype = ctypes.c_int
    lib.nc_conv4d_transpose_bf16.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.nc_conv4d_transpose_bf16.restype = ctypes.c_int
    lib.nc_conv4d_supported.argtypes = [ctypes.c_int] * 3
    lib.nc_conv4d_supported.restype = ctypes.c_int
    lib.nc_conv4d_error_string.argtypes = [ctypes.c_int]
    lib.nc_conv4d_error_string.restype = ctypes.c_char_p
    return lib


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, copied if it does not start on 16 bytes: the port's CUDA
    kernels stage their inputs with 16-byte ``cp.async`` copies."""
    return t.clone() if t.data_ptr() % 16 else t


def _conv(x: torch.Tensor, w: torch.Tensor, b, name: str) -> torch.Tensor:
    """Launch one layer of ``csrc/nc_conv4d.cu``: with bias ``b`` the
    forward (bias + ReLU), with ``b=None`` the transposed variant (``w``
    the flipped, channel-swapped weights; no bias, no ReLU)."""
    if x.device.type != "cuda":
        raise RuntimeError(f"{name} runs on CUDA tensors, got {x.device}")
    ts = (x, w) if b is None else (x, w, b)
    if any(t.dtype != torch.bfloat16 or t.device != x.device for t in ts):
        raise TypeError(f"{name} takes bf16 tensors on one device, got "
                        f"{[(t.dtype, str(t.device)) for t in ts]}")
    k, c_in, c_out = int(w.shape[0]), int(w.shape[4]), int(w.shape[5])
    if (x.dim() != 6 or w.dim() != 6 or tuple(w.shape[:4]) != (k,) * 4
            or x.shape[5] != c_in
            or (b is not None and tuple(b.shape) != (c_out,))):
        raise ValueError(f"{name}: volume {tuple(x.shape)} and weights "
                         f"{tuple(w.shape)} (bias "
                         f"{None if b is None else tuple(b.shape)}) disagree")
    # the library is compiled per forward layer shape; a transposed launch
    # of forward shape (k, c_out, c_in) runs with these weights
    fwd = (k, c_in, c_out) if b is not None else (k, c_out, c_in)
    lib = _library()
    if not lib.nc_conv4d_supported(*fwd):
        raise NotImplementedError(
            f"nc_conv4d is not compiled for k={fwd[0]}, {fwd[1]}->{fwd[2]} "
            f"channels (add the shape to NC_CONV4D_SHAPES in csrc/{SOURCE})")
    x, w = (_aligned16(t.contiguous()) for t in (x, w))
    out = torch.empty(x.shape[:5] + (c_out,), dtype=torch.bfloat16,
                      device=x.device)
    bsz, ha, wa, hb, wb = (int(d) for d in x.shape[:5])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if b is None:
            rc = lib.nc_conv4d_transpose_bf16(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), bsz, ha, wa, hb,
                wb, *fwd, stream)
        else:
            b = b.contiguous()
            rc = lib.nc_conv4d_bf16(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), bsz,
                ha, wa, hb, wb, *fwd, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.nc_conv4d_error_string(rc).decode())
    return out


def nc_conv4d_layer(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """One NC layer through the CUDA kernel: ``x`` (B, hA, wA, hB, wB, C_in)
    bf16 on the card, ``w`` (k, k, k, k, C_in, C_out), ``b`` (C_out,);
    returns bf16 (B, hA, wA, hB, wB, C_out).  Launches on the current
    stream and does not synchronise."""
    global launches
    out = _conv(x, w, b, "nc_conv4d_layer")
    launches += 1
    return out


def _run_stack(nc_params: List[dict], x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return nc_stack_reference(nc_params, x)
    if x.device.type != "cuda":
        raise RuntimeError(f"the NC stack runs on CUDA or CPU tensors, got {x.device}")
    for layer in nc_params:
        x = nc_conv4d_layer(x, layer["w"], layer["b"])
    return x


def nc_stack_resident(nc_params: List[dict], x: torch.Tensor) -> torch.Tensor:
    """The full ``[conv4d_same + bias + ReLU]×L`` stack on ``x``
    ``(B, hA, wA, hB, wB, 1)``; returns ``(B, hA, wA, hB, wB, C_last)`` bf16
    with a final layer of at most 4 channels (the TPU kernel's shape class:
    1, or 2 for the tap-swap chain)."""
    _check_stack(nc_params, x, "nc_stack_resident")
    channels = _stack_shape(nc_params)[1]
    if channels[-1] > 4:
        raise ValueError(f"resident stack does not support channels={channels}"
                         " (the final layer is at most 4 channels wide)")
    return _run_stack(nc_params, x)


def nc_stack_fused_lane(nc_params: List[dict], x: torch.Tensor) -> torch.Tensor:
    """The same stack in the per-layer form's shape class: the final layer
    must have 1 channel; returns ``(B, hA, wA, hB, wB, 1)`` bf16."""
    _check_stack(nc_params, x, "nc_stack_fused_lane")
    if nc_params[-1]["w"].shape[5] != 1:
        raise ValueError("nc_stack_fused_lane requires a 1-channel final layer"
                         " (the NC-stack shape class)")
    return _run_stack(nc_params, x)


def _check_fused(nc_params: List[dict], x: torch.Tensor) -> None:
    _check_stack(nc_params, x, "nc_stack_fused")
    channels = _stack_shape(nc_params)[1]
    if channels[-1] > 4:
        raise ValueError(f"nc_stack_fused does not support channels={channels}"
                         " (the final layer is at most 4 channels wide)")


def stack_activations(nc_params: List[dict],
                      x: torch.Tensor) -> List[torch.Tensor]:
    """``[x, y_0, …, y_{L-1}]``: the bf16 input and every layer's bf16
    output (the kernel on a CUDA tensor, the twin on a CPU one)."""
    if x.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"the NC stack runs on CUDA or CPU tensors, got {x.device}")
    layer = nc_conv4d_layer if x.device.type == "cuda" else layer_reference
    acts = [x.to(torch.bfloat16)]
    for p in nc_params:
        acts.append(layer(acts[-1], p["w"], p["b"]))
    return acts


class NCStackFused(torch.autograd.Function):
    """The differentiable NC stack on ``(x, cp, w_0, b_0, w_1, b_1, …)``
    (``Function.apply`` tracks tensors, not a list of dicts; ``cp`` is the
    layers' CP factors or None).

    Forward: the tier :func:`choose_fused_stack` picks, as the JAX
    ``_fused_stack_impl``: ``"fft"`` runs ``fft_stack_activations``,
    ``"resident"`` :func:`stack_activations` (one kernel launch per layer),
    saving every layer's bf16 output either way.
    Backward: ``nc_fused_lane_vjp.stack_vjp`` on them, which launches the
    B3 kernels on CUDA tensors and runs their twin on CPU tensors; the
    input gradient of layer 0 is computed only when ``x`` needs one.
    Gradients come back in the dtypes of ``x`` and the parameters."""

    @staticmethod
    def forward(ctx, x, cp, *flat):
        params = [{"w": flat[i], "b": flat[i + 1]}
                  for i in range(0, len(flat), 2)]
        _check_fused(params, x)
        kernels, channels = _stack_shape(params)
        tier = choose_fused_stack(*x.shape[1:5], kernels, channels,
                                  cp_ranks=cp_stack_ranks(cp or []))
        if tier == "fft":
            acts = fft_stack_activations(params, x.to(torch.bfloat16))
            y = acts[-1]
        else:
            acts = stack_activations(params, x)
            y = acts[-1]
            if tier == "cp":
                # the JAX backward replays the dense stack: B3 takes the
                # dense activations, the value is the CP chain's
                y = nc_stack_cp([{**p, "cp": c["cp"]}
                                 for p, c in zip(params, cp)], acts[0])
        ctx.save_for_backward(*acts, *flat)
        ctx.n_layers, ctx.x_dtype = len(params), x.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        from ncnet_tpu_torch.ops.nc_fused_lane_vjp import stack_vjp

        saved = ctx.saved_tensors
        acts, flat = saved[:ctx.n_layers + 1], saved[ctx.n_layers + 1:]
        params = [{"w": flat[i], "b": flat[i + 1]}
                  for i in range(0, len(flat), 2)]
        d_params, dx = stack_vjp(params, acts, g,
                                 need_dx=ctx.needs_input_grad[0])
        if dx is not None:
            dx = dx.to(ctx.x_dtype)
        return (dx, None, *(t for d in d_params for t in (d["w"], d["b"])))


def nc_stack_fused(nc_params: List[dict], x: torch.Tensor) -> torch.Tensor:
    """The differentiable stack (``ncnet_tpu/ops/nc_fused_lane.py:1014``):
    ``x`` ``(B, hA, wA, hB, wB, 1)`` bf16 → ``(B, hA, wA, hB, wB, C_last)``
    bf16, through :class:`NCStackFused`.  CP factors ride along (not
    differentiated: the JAX backward is the dense stack's)."""
    flat = [t for layer in nc_params for t in (layer["w"], layer["b"])]
    cp = ([{"cp": layer["cp"]} for layer in nc_params]
          if cp_stack_ranks(nc_params) else None)
    return NCStackFused.apply(x, cp, *flat)


def fused_stack_forward(nc_params: List[dict], x: torch.Tensor
                        ) -> torch.Tensor:
    """The forward of :func:`nc_stack_fused` with no gradient recorded: the
    tier :func:`choose_fused_stack` picks for the volume (the JAX
    ``_fused_stack_impl``).  A stack no tier takes raises: the caller
    (``models/ncnet.py::neigh_consensus``) runs it layer by layer."""
    kernels, channels = _stack_shape(nc_params)
    tier = choose_fused_stack(*x.shape[1:5], kernels, channels,
                              cp_ranks=cp_stack_ranks(nc_params),
                              pallas_ok=x.dtype == torch.bfloat16)
    if tier == "cp":
        return nc_stack_cp(nc_params, x)
    if tier == "fft":
        return nc_stack_fft(nc_params, x)
    if tier is None:
        raise ValueError(
            f"no tier of choose_fused_stack takes the {x.dtype} stack "
            f"{kernels}/{channels} on {tuple(x.shape[1:5])}")
    return nc_stack_resident(nc_params, x)
