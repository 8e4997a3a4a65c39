"""FFT-domain conv4d: the spectral tier of the NC filter.

Port of ``ncnet_tpu/ops/conv4d_fft.py``.  Direct "same" conv4d pays
``2·cells·k⁴·C_in·C_out`` FLOPs; here the convolution runs in the frequency
domain (Mathieu, Henaff & LeCun, *Fast Training of Convolutional Networks
through FFTs*): a real FFT over the four spatial dims, each zero-padded to
``n+k−1`` so the circular theorem computes the linear correlation exactly,
a per-frequency complex contraction over C_in, the inverse FFT, and an
exact crop back to the "same" window.  Everything is computed in f32
(complex64 spectra) and cast back to the input dtype.  ``torch.fft`` is
cuFFT on the card, as the JAX package leaves its FFT to XLA.

The chooser (``ops/nc_fused_lane.py::choose_fused_stack``) asks
:func:`fft_feasible`: odd kernels, the weight spectrum inside
``_FFT_TEMP_BUDGET``, and spectral FLOPs, penalized by ``_FFT_VPU_PENALTY``,
below the dense stack's.  The constants are the JAX package's, so the port
decides as it does; there is no compile probe and no environment override.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch

from ncnet_tpu_torch.ops.conv4d_cp import dense_layer_flops

# real-FFT cost model: ~coeff·S·log2 S real FLOPs per S-cell 4-D transform
_FFT_COST_COEFF = 2.5
# the spectral FLOPs' penalty against the dense baseline's
_FFT_VPU_PENALTY = 4.0
# the weight spectrum (C_in·C_out complex64 padded volumes) must fit this
_FFT_TEMP_BUDGET = 2 * 1024 ** 3

_SPATIAL_AXES = (1, 2, 3, 4)


def _rfft4(x: torch.Tensor, sizes, axes) -> torch.Tensor:
    """Real 4-D FFT as rfft(last axis) ∘ fftn(first three), the JAX
    package's composition."""
    y = torch.fft.rfft(x, n=sizes[3], dim=axes[3])
    return torch.fft.fftn(y, s=sizes[:3], dim=axes[:3])


def _irfft4(y: torch.Tensor, sizes, axes) -> torch.Tensor:
    y = torch.fft.ifftn(y, s=sizes[:3], dim=axes[:3])
    return torch.fft.irfft(y, n=sizes[3], dim=axes[3])


def conv4d_fft(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """"Same" 4D cross-correlation + bias via the frequency domain.

    Args:
      x:      ``(B, hA, wA, hB, wB, C_in)`` channels-last volume.
      weight: ``(kA, kWA, kB, kWB, C_in, C_out)`` (odd taps).
      bias:   ``(C_out,)`` or None.
    Returns:
      ``(B, hA, wA, hB, wB, C_out)`` in ``x.dtype`` (f32 compute inside).
    """
    dtype = x.dtype
    spatial = tuple(x.shape[a] for a in _SPATIAL_AXES)
    taps = tuple(weight.shape[:4])
    if any(k % 2 == 0 for k in taps):
        raise ValueError(
            f"conv4d_fft serves the same-pad odd-tap shape class, got {taps}")
    sizes = tuple(n + k - 1 for n, k in zip(spatial, taps))
    xf = _rfft4(x.to(torch.float32), sizes, _SPATIAL_AXES)
    wf = _rfft4(weight.to(torch.float32), sizes, (0, 1, 2, 3))
    # correlation theorem: FFT(x)·conj(FFT(w)), contracting C_in per bin
    yf = torch.einsum("bpqrsc,pqrsco->bpqrso", xf, wf.conj())
    c = _irfft4(yf, sizes, _SPATIAL_AXES)
    # exact "same" crop: out[i] = c[(i − k//2) mod S] per dim
    c = torch.roll(c, shifts=tuple(k // 2 for k in taps), dims=_SPATIAL_AXES)
    out = c[:, :spatial[0], :spatial[1], :spatial[2], :spatial[3], :]
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(dtype).contiguous()


def fft_stack_activations(nc_params: List[dict],
                          x: torch.Tensor) -> List[torch.Tensor]:
    """``[x, y_0, …, y_{L-1}]``: the input and every layer's output of the
    [conv4d_same + bias + ReLU]×L stack through :func:`conv4d_fft` (the
    differentiable fused stack saves them for its B3 backward)."""
    acts = [x]
    for layer in nc_params:
        acts.append(torch.relu(conv4d_fft(acts[-1], layer["w"], layer["b"])))
    return acts


def nc_stack_fft(nc_params: List[dict], x: torch.Tensor) -> torch.Tensor:
    """The full [conv4d_same + bias + ReLU]×L stack through
    :func:`conv4d_fft`: the "fft" tier's stack body."""
    return fft_stack_activations(nc_params, x)[-1]


# ---------------------------------------------------------------------------
# the arithmetic gate
# ---------------------------------------------------------------------------


def _fft_cost(cells: int) -> float:
    return _FFT_COST_COEFF * cells * math.log2(max(cells, 2))


def fft_layer_flops(spatial: Sequence[int], k: int, c_in: int,
                    c_out: int) -> float:
    """Predicted real FLOPs of one spectral layer: the C_in input, C_in·C_out
    weight and C_out inverse transforms, and the per-bin complex contraction
    (~8 real FLOPs per multiply-add over the Hermitian half-spectrum)."""
    padded = 1
    for n in spatial:
        padded *= n + k - 1
    transforms = (c_in + c_out + c_in * c_out) * _fft_cost(padded)
    multiply = 8.0 * (padded / 2) * c_in * c_out
    return transforms + multiply


def fft_spectrum_bytes(spatial: Sequence[int], kernels: Sequence[int],
                       channels: Sequence[int]) -> int:
    """Peak weight-spectrum footprint across the stack: ``C_in·C_out``
    complex64 half-spectra of the padded volume."""
    peak = 0
    c_in = 1
    for k, c_out in zip(kernels, channels):
        padded = 1
        for n in spatial:
            padded *= n + k - 1
        peak = max(peak, int(c_in * c_out * (padded // 2 + 1) * 8))
        c_in = c_out
    return peak


def fft_feasible(ha: int, wa: int, hb: int, wb: int,
                 kernels: Sequence[int], channels: Sequence[int]) -> bool:
    """The FFT tier's arithmetic gate: odd kernels, the weight spectrum
    inside ``_FFT_TEMP_BUDGET``, and penalized spectral FLOPs below the
    dense stack's direct-k⁴ FLOPs over the whole stack."""
    if any(k % 2 == 0 for k in kernels):
        return False
    spatial = (ha, wa, hb, wb)
    if fft_spectrum_bytes(spatial, kernels, channels) > _FFT_TEMP_BUDGET:
        return False
    cells = ha * wa * hb * wb
    spectral = dense = 0.0
    c_in = 1
    for k, c_out in zip(kernels, channels):
        spectral += fft_layer_flops(spatial, k, c_in, c_out)
        dense += dense_layer_flops(cells, k, c_in, c_out)
        c_in = c_out
    return _FFT_VPU_PENALTY * spectral < dense
