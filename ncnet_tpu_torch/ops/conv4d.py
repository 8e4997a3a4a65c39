"""4D convolution over the correlation volume: the conv4d formulations.

The counterpart of the JAX package's XLA conv4d (``ncnet_tpu/ops/conv4d.py``)
with its five formulations, built here from ``F.conv3d`` / ``F.conv2d`` /
``torch.einsum`` with the same channel folds:

  * ``unroll``     — a sum over the kA taps of a 3D conv on shifted views;
  * ``tapfold``    — the kA taps folded into the input channels (one 3D conv
                     with kA·C_in inputs);
  * ``coutfold``   — the kA taps folded into the output channels (one 3D conv
                     with kA·C_out outputs and a shifted sum over hA);
  * ``afold``      — the whole A-side stencil folded into the output channels
                     (one 2D conv over (hB, wB), shifted sums over both A dims);
  * ``toeplitz_b`` — the B-side stencil as a dense banded matrix, kA·kWA
                     matmuls.

``variant="auto"`` asks :func:`choose_conv4d_variant`, the JAX chooser's
rules with their constants; its ``"pallas"`` branch sends a same-padded,
cubic, odd, small-C_out layer to ``ops/conv4d_pallas.py::conv4d_small_cout``
(the B5 CUDA kernel on the card, its plain twin on the CPU).  The TPU gates
of that branch (a TPU backend, a Mosaic compile probe, a VMEM budget) bind
no CUDA kernel and are not carried; in their place stands the CUDA
kernel's own limit, a kernel size up to ``conv4d_pallas.MAX_K`` (27; it
stages C_in in chunks, so no channel count or volume binds it).  The
branch is taken on both devices, so the CPU routes as the card does.

Only the tests reach ``afold``, ``toeplitz_b`` (``auto`` never picks
them; ``make_conv4d_same`` can route a gradient through them) and the
valid-dim forms (``pad_*`` False: the JAX package's sharded paths, which
the port does not have): they are kept for parity with the JAX package,
and ROADMAP §D asks whether to drop them.

All formulations are the reference's semantics: cross-correlation with zero
"same" padding of ``k//2`` per spatial dim (lib/conv4d.py:39-48), and
``pad_ha``/``pad_hb``/``pad_wa``/``pad_wb`` = False treats that dim as valid
(the caller padded it; the output is ``k//2`` smaller on each side).
:func:`conv4d_same` routes its gradients explicitly (``make_conv4d_same``).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ncnet_tpu_torch.ops.conv4d_pallas import MAX_K as _SMALL_COUT_MAX_K
from ncnet_tpu_torch.ops.conv4d_pallas import conv4d_small_cout


def _pads3(kwa: int, kb: int, kwb: int, pad_hb: bool, pad_wa: bool = True,
           pad_wb: bool = True) -> Tuple[int, int, int]:
    return (kwa // 2 if pad_wa else 0, kb // 2 if pad_hb else 0,
            kwb // 2 if pad_wb else 0)


def _conv3d(x: torch.Tensor, w: torch.Tensor, padding) -> torch.Tensor:
    """A channels-last 3D conv: ``x`` ``(N, D, H, W, C_in)``, ``w`` ``(kD,
    kH, kW, C_in, C_out)`` (the JAX DHWIO layout) → ``(N, D', H', W',
    C_out)``.

    On a CPU tensor in bf16 the product runs in f32 and is rounded once to
    bf16 (ROADMAP C3): the CPU library's bf16 conv3d computes a wrong,
    nondeterministic weight gradient whenever the kernel is wider than an
    input side.  Autograd then differentiates the f32 conv, so the CPU path
    rounds at three points, each once: the output, the input gradient and
    the weight gradient, each an f32 sum of bf16 operands rounded to bf16.
    Those are XLA:CPU's rounding points for a bf16 conv and its VJP.  A CUDA
    tensor runs the bf16 conv as given."""
    xt, wt = x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2)
    if x.dtype == torch.bfloat16 and x.device.type == "cpu":
        y = F.conv3d(xt.float(), wt.float(), padding=padding).to(x.dtype)
    else:
        y = F.conv3d(xt, wt, padding=padding)
    return y.permute(0, 2, 3, 4, 1)


def _pad_dim1(x: torch.Tensor, d: int) -> torch.Tensor:
    """Zero-pad dim 1 of a 6-D volume by ``d`` on each side."""
    return F.pad(x, (0, 0) * 4 + (d, d))


def _out_dims(x, weight, pad_hb, pad_wa, pad_wb):
    _, _, wa, hb, wb, _ = x.shape
    _, kwa, kb, kwb, _, _ = weight.shape
    return (wa if pad_wa else wa - (kwa - 1), hb if pad_hb else hb - (kb - 1),
            wb if pad_wb else wb - (kwb - 1))


def _conv4d_unroll(x, weight, *, pad_ha, pad_hb, pad_wa, pad_wb):
    """Sum over kA taps of a 3D conv on shifted whole-volume views."""
    b, _, wa, hb, wb, c_in = x.shape
    ka, kwa, kb, kwb, _, c_out = weight.shape
    if pad_ha:
        x = _pad_dim1(x, ka // 2)
    ha = x.shape[1] - (ka - 1)
    out = None
    for p in range(ka):
        o = _conv3d(x[:, p:p + ha].reshape(b * ha, wa, hb, wb, c_in),
                    weight[p], _pads3(kwa, kb, kwb, pad_hb, pad_wa, pad_wb))
        out = o if out is None else out + o
    return out.reshape((b, ha) + _out_dims(x, weight, pad_hb, pad_wa, pad_wb)
                       + (c_out,))


def _conv4d_tapfold(x, weight, *, pad_ha, pad_hb, pad_wa, pad_wb):
    """One 3D conv with the kA taps folded into input channels."""
    b, _, wa, hb, wb, c_in = x.shape
    ka, kwa, kb, kwb, _, c_out = weight.shape
    if pad_ha:
        x = _pad_dim1(x, ka // 2)
    ha = x.shape[1] - (ka - 1)
    shifts = torch.cat([x[:, p:p + ha] for p in range(ka)], dim=-1)
    wf = weight.permute(1, 2, 3, 0, 4, 5).reshape(kwa, kb, kwb, ka * c_in,
                                                  c_out)
    o = _conv3d(shifts.reshape(b * ha, wa, hb, wb, ka * c_in), wf,
                _pads3(kwa, kb, kwb, pad_hb, pad_wa, pad_wb))
    return o.reshape((b, ha) + _out_dims(x, weight, pad_hb, pad_wa, pad_wb)
                     + (c_out,))


def _conv4d_coutfold(x, weight, *, pad_ha, pad_hb, pad_wa, pad_wb):
    """One 3D conv producing kA·C_out channels + shifted sum over hA."""
    b, ha_in, wa, hb, wb, c_in = x.shape
    ka, kwa, kb, kwb, _, c_out = weight.shape
    wf = weight.permute(1, 2, 3, 4, 0, 5).reshape(kwa, kb, kwb, c_in,
                                                  ka * c_out)
    y = _conv3d(x.reshape(b * ha_in, wa, hb, wb, c_in), wf,
                _pads3(kwa, kb, kwb, pad_hb, pad_wa, pad_wb))
    # out[i] = Σ_p y[i + p − (pad: ka//2 / valid: 0), …, tap-p channel block]
    y = y.reshape((b, ha_in) + _out_dims(x, weight, pad_hb, pad_wa, pad_wb)
                  + (ka * c_out,))
    if pad_ha:
        y = _pad_dim1(y, ka // 2)
    ha = y.shape[1] - (ka - 1)
    out = None
    for p in range(ka):
        o = y[:, p:p + ha, ..., p * c_out:(p + 1) * c_out]
        out = o if out is None else out + o
    return out


def _conv4d_afold(x, weight, *, pad_ha, pad_hb, pad_wa=True, pad_wb=True):
    """One 2D conv over (hB, wB) producing kA·kWA·C_out channels + a shifted
    sum over both A dims."""
    if not (pad_wa and pad_wb):
        raise ValueError(
            "afold does not support valid (unpadded) wA/wB; use "
            "unroll/tapfold/coutfold for the 2D-sharded shapes")
    b, ha, wa, hb, wb, c_in = x.shape
    ka, kwa, kb, kwb, _, c_out = weight.shape
    hb_out = hb if pad_hb else hb - (kb - 1)
    wf = weight.permute(2, 3, 4, 0, 1, 5).reshape(kb, kwb, c_in,
                                                  ka * kwa * c_out)
    y = F.conv2d(x.reshape(b * ha * wa, hb, wb, c_in).permute(0, 3, 1, 2),
                 wf.permute(3, 2, 0, 1),
                 padding=(kb // 2 if pad_hb else 0, kwb // 2))
    y = y.permute(0, 2, 3, 1).reshape(b, ha, wa, hb_out, wb,
                                      ka * kwa * c_out)
    # out[i,j] = Σ_{p,q} y[i+p−padA, j+q−kwa//2, …, tap-(p,q) channel block]
    pa = ka // 2 if pad_ha else 0
    y = F.pad(y, (0, 0) * 3 + (kwa // 2, kwa // 2, pa, pa))
    ha_out = y.shape[1] - (ka - 1)
    out = None
    for p in range(ka):
        yp = y[:, p:p + ha_out]
        for q in range(kwa):
            t = (p * kwa + q) * c_out
            o = yp[:, :, q:q + wa, ..., t:t + c_out]
            out = o if out is None else out + o
    return out


@functools.lru_cache(maxsize=32)
def _shift_masks(hb_in: int, wb_in: int, hb_out: int, wb_out: int,
                 kb: int, kwb: int, pad_hb: bool) -> np.ndarray:
    """One-hot banded shift masks ``(kB·kWB, hb_in·wb_in, hb_out·wb_out)``:
    ``M[(r,s), n_src, n_out] = 1`` iff source cell ``n_src`` sits at stencil
    offset ``(r,s)`` of output cell ``n_out`` (zero padding ⇒ missing rows)."""
    ms = []
    for r in range(kb):
        for s in range(kwb):
            sh = np.eye(hb_in, hb_out, k=(kb // 2 if pad_hb else 0) - r)
            sw = np.eye(wb_in, wb_out, k=kwb // 2 - s)
            ms.append(np.kron(sh, sw))
    return np.stack(ms).astype(np.float32)


def _conv4d_toeplitz_b(x, weight, *, pad_ha, pad_hb, pad_wa=True,
                       pad_wb=True):
    """kA·kWA shifted matmuls against a dense banded B-stencil matrix."""
    if not (pad_wa and pad_wb):
        raise ValueError(
            "toeplitz_b does not support valid (unpadded) wA/wB; use "
            "unroll/tapfold/coutfold for the 2D-sharded shapes")
    b, ha_in, wa, hb, wb, c_in = x.shape
    ka, kwa, kb, kwb, _, c_out = weight.shape
    hb_out = hb if pad_hb else hb - (kb - 1)
    n_in, n_out = hb * wb, hb_out * wb
    masks = torch.from_numpy(
        _shift_masks(hb, wb, hb_out, wb, kb, kwb, pad_hb)).to(weight)
    wv = weight.reshape(ka, kwa, kb * kwb, c_in, c_out)
    # T[p, q, K, (n_out, c_out)], K ordered (n_src, c_in) like the input's
    # flattening
    t = torch.einsum("pquio,unm->pqnimo", wv, masks)
    t = t.reshape(ka, kwa, n_in * c_in, n_out * c_out)
    xf = x.reshape(b, ha_in, wa, n_in * c_in)
    pa = ka // 2 if pad_ha else 0
    xf = F.pad(xf, (0, 0, kwa // 2, kwa // 2, pa, pa))
    ha = xf.shape[1] - (ka - 1)
    out = None
    for p in range(ka):
        for q in range(kwa):
            o = torch.einsum("bijk,kn->bijn", xf[:, p:p + ha, q:q + wa],
                             t[p, q])
            out = o if out is None else out + o
    return out.reshape(b, ha, wa, hb_out, wb, c_out)


_VARIANTS = {
    "unroll": _conv4d_unroll,
    "tapfold": _conv4d_tapfold,
    "coutfold": _conv4d_coutfold,
    "afold": _conv4d_afold,
    "toeplitz_b": _conv4d_toeplitz_b,
}

# The channel-folding formulations materialize a kA·C-channel copy of the
# whole volume (coutfold: kA·C_out; tapfold: kA·C_in).  Above this bound
# 'auto' falls back to the tap-unrolled formulation, whose intermediates
# stay at 1× the volume.  The JAX package's constant, kept so that the
# decisions are the same.
_FOLD_BYTES_LIMIT = 4 * 2**30


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def conv4d_fold_fits(batch: int, ha: int, wa: int, hb: int, wb: int, k: int,
                     ch: int, dtype) -> bool:
    """True when the channel-folding formulations' kA·ch whole-volume copy
    stays under ``_FOLD_BYTES_LIMIT`` (the bound ``auto`` demotes to
    ``unroll`` at; the symmetric fold in ``models/ncnet.py`` asks it too)."""
    cells = batch * ha * wa * hb * wb
    return cells * k * ch * _itemsize(dtype) <= _FOLD_BYTES_LIMIT


def choose_conv4d_variant(c_in: int, c_out: int, hb: int, wb: int, *,
                          shape_a: Optional[tuple] = None,
                          kernel: Optional[tuple] = None,
                          same_pad: bool = True, dtype=None,
                          batch: Optional[int] = None) -> str:
    """The per-layer formulation (``ncnet_tpu/ops/conv4d.py:297-382``):
    ``tapfold`` for C_in ≤ 4; for C_out ≤ 4 with the full shape context, a
    same-padded cubic odd kernel of at most ``conv4d_pallas.MAX_K`` taps,
    ``"pallas"`` (B5); else ``coutfold``.
    The channel folds demote to ``unroll`` past ``_FOLD_BYTES_LIMIT``.
    ``auto`` never picks ``toeplitz_b`` or ``afold``."""

    def fold_fits(ch: int) -> bool:
        if batch is None or shape_a is None or kernel is None or dtype is None:
            return True  # shape context unknown: legacy small-volume callers
        return conv4d_fold_fits(batch, shape_a[0], shape_a[1], hb, wb,
                                kernel[0], ch, dtype)

    if c_in <= 4:
        return "tapfold" if fold_fits(c_in) else "unroll"
    if (c_out <= 4 and same_pad and shape_a is not None
            and kernel is not None and dtype is not None
            and len(set(kernel)) == 1 and kernel[0] % 2 == 1
            and kernel[0] <= _SMALL_COUT_MAX_K):
        return "pallas"
    return "coutfold" if fold_fits(c_out) else "unroll"


def conv4d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, *, pad_ha: bool = True,
           pad_hb: bool = True, pad_wa: bool = True, pad_wb: bool = True,
           variant: str = "auto") -> torch.Tensor:
    """4D convolution over the correlation volume ("same" by default).

    Args:
      x:      ``(B, hA, wA, hB, wB, C_in)`` channels-last volume.
      weight: ``(kA, kWA, kB, kWB, C_in, C_out)``, odd sizes.
      bias:   ``(C_out,)`` or None.
      pad_ha / pad_hb / pad_wa / pad_wb: False treats that dim as valid
        (already padded by the caller); the output shrinks there.
      variant: ``"auto"`` (:func:`choose_conv4d_variant`), a formulation
        (``unroll``, ``tapfold``, ``coutfold``, ``afold``, ``toeplitz_b``),
        or ``"pallas"`` (B5, same-padded only).

    Returns:
      ``(B, hA', wA', hB', wB', C_out)`` (primed dims shrink iff unpadded).
    """
    if any(k % 2 == 0 for k in weight.shape[:4]):
        raise ValueError(f"conv4d needs odd kernel sizes, got {tuple(weight.shape[:4])}")
    c_in, c_out = weight.shape[4], weight.shape[5]
    if x.shape[5] != c_in:
        raise ValueError(f"channel mismatch: {x.shape[5]} vs {c_in}")
    same = pad_ha and pad_hb and pad_wa and pad_wb
    if variant == "auto":
        variant = choose_conv4d_variant(
            c_in, c_out, x.shape[3], x.shape[4], shape_a=(x.shape[1], x.shape[2]),
            kernel=tuple(weight.shape[:4]), same_pad=same, dtype=x.dtype,
            batch=x.shape[0])
    if variant == "pallas":
        if not same:
            raise ValueError("the pallas variant supports only the "
                             "same-padded volume form")
        out = conv4d_small_cout(x, weight)
    else:
        out = _VARIANTS[variant](x, weight, pad_ha=pad_ha, pad_hb=pad_hb,
                                 pad_wa=pad_wa, pad_wb=pad_wb)
    if bias is not None:
        out = out + bias
    return out.contiguous()


def conv4d_transpose_weights(weight: torch.Tensor) -> torch.Tensor:
    """Weights of the transposed conv4d: all four spatial dims flipped,
    channel roles swapped — ``(kA,kWA,kB,kWB,C_in,C_out) →
    (kA,kWA,kB,kWB,C_out,C_in)``.  For odd kernels the cotangent of a
    same-padded stride-1 cross-correlation is the same-padded
    cross-correlation with these weights."""
    return weight.flip(0, 1, 2, 3).permute(0, 1, 2, 3, 5, 4)


# the formulation whose autograd computes the weight gradient (the JAX
# package's measured default)
_DW_VARIANT = "coutfold"


class _Conv4dSame(torch.autograd.Function):
    """``conv4d(x, weight, bias)`` with its gradients routed as
    ``ncnet_tpu/ops/conv4d.py:516-533``: dx a same-padded conv4d of the
    cotangent with the transposed weights (``dx_variant``), dW the autograd
    of the ``dw_variant`` formulation (demoted to ``unroll`` past the fold
    gate), db a sum."""

    @staticmethod
    def forward(ctx, x, weight, bias, dx_variant, dw_variant):
        if any(k % 2 == 0 for k in weight.shape[:4]):
            raise ValueError("conv4d_same requires odd kernel sizes "
                             "(same-padding transpose)")
        ctx.save_for_backward(x, weight)
        ctx.variants = (dx_variant, dw_variant)
        return conv4d(x, weight, bias)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx_variant, dwv = ctx.variants
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx = dw = db = None
        if need_x:
            dx = conv4d(g, conv4d_transpose_weights(weight),
                        variant=dx_variant)
        fold_ch = {"coutfold": weight.shape[5], "tapfold": weight.shape[4],
                   "afold": weight.shape[1] * weight.shape[5]}.get(dwv)
        if fold_ch is not None and not conv4d_fold_fits(
                *x.shape[:5], weight.shape[0], fold_ch, x.dtype):
            dwv = "unroll"
        if need_w:
            with torch.enable_grad():
                ww = weight.detach().requires_grad_()
                (dw,) = torch.autograd.grad(
                    conv4d(x.detach(), ww, variant=dwv), ww, g)
        if need_b:
            db = g.sum(dim=(0, 1, 2, 3, 4))
        return dx, dw, db, None, None


@functools.lru_cache(maxsize=None)
def make_conv4d_same(dx_variant: str = "auto", dw_variant: str = _DW_VARIANT):
    """Same-padded ``conv4d(x, weight, bias)`` with an explicitly routed
    backward (:class:`_Conv4dSame`): ``dx`` through ``conv4d(variant=
    dx_variant)`` on the transposed weights, ``dw`` through the autograd
    of ``dw_variant``, ``db`` a sum.  Odd kernel sizes only."""

    def conv4d_same_routed(x, weight, bias):
        return _Conv4dSame.apply(x, weight, bias, dx_variant, dw_variant)

    return conv4d_same_routed


#: the default routing
conv4d_same = make_conv4d_same()


def conv4d_init(generator: torch.Generator, kernel_size: int, c_in: int,
                c_out: int, dtype: torch.dtype = torch.float32
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """torch-_ConvNd-style uniform init ±1/√(C_in·k⁴) (the reference's
    Conv4d defaults).  Returns ``(weight (k,k,k,k,C_in,C_out), bias)``."""
    bound = 1.0 / math.sqrt(c_in * kernel_size ** 4)
    weight = torch.empty((kernel_size,) * 4 + (c_in, c_out), dtype=dtype)
    weight.uniform_(-bound, bound, generator=generator)
    bias = torch.empty((c_out,), dtype=dtype).uniform_(
        -bound, bound, generator=generator)
    return weight, bias
