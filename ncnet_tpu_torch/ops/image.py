"""Image resizing and normalization (channels-last, as the JAX package).

The port of ``ncnet_tpu/ops/image.py``.  The reference resizes by sampling
an identity affine grid with bilinear ``F.grid_sample``
(``lib/transformation.py:25-46``) and upsamples InLoc images with
``F.upsample(mode='bilinear')`` (``eval_inloc.py:84-89``): both are
*align-corners* bilinear resampling in torch-0.3 semantics, implemented here
directly.  The device form contracts the image against per-axis
interpolation matrices (each output row/column a 2-tap combination of input
rows/columns), two f32 products; the numpy form for the host keeps the
gather+lerp form.  Both derive from :func:`_tap_weights`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# torchvision ImageNet statistics (reference lib/normalization.py:19-20)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _align_corners_coords(out_len: int, in_len: int,
                          device_form: bool = False) -> np.ndarray:
    """``out_len`` float32 sample positions from 0 to ``in_len − 1``.

    The host form is numpy's ``linspace``; ``device_form`` rounds them as
    ``jnp.linspace`` does in the JAX package's programs, where XLA folds
    the constants: ``i · f32(stop · f32(1/(n − 1)))`` in float32, the
    endpoint appended (the two forms differ by an ulp here and there,
    which a resize amplifies by the image's gradient)."""
    if out_len == 1 or in_len == 1:
        return np.zeros((out_len,), dtype=np.float32)
    if not device_form:
        return np.linspace(0.0, in_len - 1.0, out_len, dtype=np.float32)
    stop = np.float32(in_len - 1)
    step = stop * (np.float32(1) / np.float32(out_len - 1))
    head = np.arange(out_len - 1, dtype=np.float32) * step
    return np.concatenate([head, np.float32([stop])])


def _tap_weights(out_n: int, in_n: int, device_form: bool = False):
    """Align-corners 2-tap sampling: numpy ``(y0, y1, f)`` with output
    sample ``i`` = ``(1-f_i)·src[y0_i] + f_i·src[y1_i]``.  The one
    definition of the sampling weights: the host gather form and the
    device product form both derive from it."""
    ys = _align_corners_coords(out_n, in_n, device_form)
    y0 = np.clip(np.floor(ys).astype(np.int32), 0, in_n - 1)
    y1 = np.minimum(y0 + 1, in_n - 1)
    return y0, y1, ys - y0


def _resize_bilinear(img, out_h: int, out_w: int):
    """The align-corners bilinear gather+lerp body on numpy ``(B, H, W,
    C)``."""
    b, h, w, c = img.shape
    y0, y1, fy = _tap_weights(out_h, h)
    x0, x1, fx = _tap_weights(out_w, w)
    wy = fy[None, :, None, None]
    wx = fx[None, None, :, None]
    top_rows = img[:, y0]
    bot_rows = img[:, y1]
    top = top_rows[:, :, x0] * (1 - wx) + top_rows[:, :, x1] * wx
    bot = bot_rows[:, :, x0] * (1 - wx) + bot_rows[:, :, x1] * wx
    return top * (1 - wy) + bot * wy


def _interp_matrix(out_n: int, in_n: int, device=None) -> torch.Tensor:
    """``(in_n, out_n)`` float32 align-corners interpolation matrix: column
    ``i`` has weight ``1-f`` at row ``y0_i`` and ``f`` at ``y1_i`` (summing
    to 1 where the taps coincide at the last row), the product form of
    :func:`_tap_weights`."""
    y0, y1, f = _tap_weights(out_n, in_n, device_form=True)
    # f is float64 in numpy; the fractional part of a float32 is exact in
    # float32, so the cast rounds nothing
    y0, y1, f = (torch.from_numpy(t).to(device)
                 for t in (y0, y1, f.astype(np.float32)))
    rows = torch.arange(in_n, dtype=torch.int32, device=device)[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return (torch.where(rows == y0[None, :], 1.0 - f[None, :], zero)
            + torch.where(rows == y1[None, :], f[None, :], zero))


def resize_bilinear_align_corners(img: torch.Tensor, out_h: int,
                                  out_w: int) -> torch.Tensor:
    """Bilinear resize with align-corners sampling of ``(B, H, W, C)`` or
    ``(H, W, C)``: two f32 contractions against the interpolation
    matrices, float32 out for every input dtype.  Full f32 products: the
    caller keeps TF32 off on the card
    (``torch.backends.cuda.matmul.allow_tf32 = False``, the default)."""
    squeeze = img.dim() == 3
    if squeeze:
        img = img[None]
    h, w = img.shape[1], img.shape[2]
    wy = _interp_matrix(out_h, h, img.device)
    wx = _interp_matrix(out_w, w, img.device)
    x = img.to(torch.float32)
    x = torch.einsum("hH,bhwc->bHwc", wy, x)
    out = torch.einsum("wW,bHwc->bHWc", wx, x)
    return out[0] if squeeze else out


def resize_bilinear_align_corners_np(img: np.ndarray, out_h: int,
                                     out_w: int) -> np.ndarray:
    """The numpy form of :func:`resize_bilinear_align_corners` for the
    host-side data pipeline.  ``img``: (H, W, C) float."""
    return _resize_bilinear(img[None], out_h, out_w)[0]


def normalize_imagenet(img: torch.Tensor, *,
                       scale_255: bool = True) -> torch.Tensor:
    """0-255 image ``(..., 3)`` → ImageNet-normalized float32
    (lib/normalization.py:16-27).  Integer images (the uint8 serving
    uploads) are promoted to float32 first."""
    x = img if img.is_floating_point() else img.to(torch.float32)
    if scale_255:
        x = x / 255.0
    mean, std = _imagenet_constants(x.dtype, x.device)
    return (x - mean) / std


@functools.lru_cache(maxsize=None)
def _imagenet_constants(dtype, device):
    """The mean and std as tensors on ``device``, made once: a tensor made
    from Python numbers on the card is a host-to-device copy, which makes
    the host wait for the card's queue (the eval step's first op)."""
    return (torch.tensor(IMAGENET_MEAN, dtype=dtype, device=device),
            torch.tensor(IMAGENET_STD, dtype=dtype, device=device))


def quantize_u8(img: np.ndarray) -> np.ndarray:
    """0-255 float image → uint8 by round-to-nearest (≤ 0.5/255 error before
    normalization): the quantization of the uint8-upload paths, whose
    :func:`normalize_imagenet` runs on the device."""
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)
