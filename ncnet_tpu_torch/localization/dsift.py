"""Dense SIFT descriptors + the pose-verification similarity score.

The port of ``ncnet_tpu/localization/dsift.py``.  The reference scores a
pose candidate by rendering the scan into the query camera and comparing
dense RootSIFT descriptors between the real and the synthetic view:
``score = 1 / median ‖d_q − d_synth‖`` over descriptors whose center lands
on rendered pixels (parfor_nc4d_PV.m; vl_phow 'sizes' 8 'step' 4 +
relja_rootsift, both external).  :func:`dense_sift` computes the
descriptors in torch on the device in the same geometry — 4×4 spatial bins
of ``bin_size`` pixels, 8 orientations, descriptors on a ``step``-pixel
grid; the rest stays numpy on the host.  Exact vl_phow bit-parity is
neither needed nor attempted: the score only compares descriptors computed
the same way on both images.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ncnet_tpu_torch.models.ncnet import resolve_device

N_ORIENT = 8
N_BINS = 4  # spatial bins per side


def descriptor_grid(
    height: int, width: int, bin_size: int = 8, step: int = 4
) -> Tuple[np.ndarray, np.ndarray]:
    """Descriptor-center coordinates ``(ys, xs)`` such that every 4×4-bin
    support (half-width 1.5·bin_size) stays inside the image."""
    margin = int(1.5 * bin_size)
    ys = np.arange(margin, height - margin, step)
    xs = np.arange(margin, width - margin, step)
    return ys, xs


def _pool_axis(p: torch.Tensor, tri, axis: int) -> torch.Tensor:
    """``valid``-mode correlation of ``p (8, H', W')`` along ``axis`` with
    the symmetric window ``tri``, as a sum of shifted slices (no cuDNN
    convolution, so no TF32 switch reaches it)."""
    n = p.shape[axis] - len(tri) + 1
    acc = tri[0] * p.narrow(axis, 0, n)
    for k in range(1, len(tri)):
        acc += tri[k] * p.narrow(axis, k, n)
    return acc


def _dense_sift(img: torch.Tensor, bin_size: int, step: int) -> torch.Tensor:
    """``(H, W)`` f32 image → ``(len(ys), len(xs), 128)`` descriptors."""
    height, width = img.shape
    ys, xs = descriptor_grid(height, width, bin_size, step)
    offs = (bin_size * (np.arange(N_BINS) - (N_BINS - 1) / 2.0)).astype(int)
    # triangular (bilinear) spatial window, separable
    tri = (1.0 - np.abs(np.arange(-bin_size + 1, bin_size)) / bin_size
           ).astype(np.float32).tolist()

    gy, gx = torch.gradient(img)
    mag = torch.sqrt(gx * gx + gy * gy)
    ang = torch.atan2(gy, gx)  # (-pi, pi]
    # soft orientation binning: linear split between the two nearest bins
    o = torch.remainder(ang / (2 * np.pi) * N_ORIENT, N_ORIENT)
    lo = torch.floor(o)
    frac = o - lo
    lo = lo.long() % N_ORIENT
    hi = (lo + 1) % N_ORIENT
    # lo != hi at every pixel: each scatter writes a cell once
    omap = torch.zeros((N_ORIENT, height, width), dtype=img.dtype,
                       device=img.device)
    omap.scatter_add_(0, lo[None], (mag * (1 - frac))[None])
    omap.scatter_add_(0, hi[None], (mag * frac)[None])
    # separable triangular pooling: each pixel of `p` holds one spatial
    # bin's weighted magnitude sum centered there
    pad = bin_size - 1
    p = _pool_axis(torch.nn.functional.pad(omap, (0, 0, pad, pad)), tri, 1)
    p = _pool_axis(torch.nn.functional.pad(p, (pad, pad)), tri, 2)
    # gather the 4×4 bin responses for every descriptor center
    rows = torch.from_numpy(ys[:, None] + offs[None, :]).to(img.device)
    cols = torch.from_numpy(xs[:, None] + offs[None, :]).to(img.device)
    d = p[:, rows[:, None, :, None], cols[None, :, None, :]]
    # d: (8, Ny, Nx, 4, 4) → (Ny, Nx, 4, 4, 8) → 128
    d = d.permute(1, 2, 3, 4, 0).reshape(len(ys), len(xs), -1)
    # SIFT normalization: L2 → clip 0.2 → L2
    d = d / torch.sqrt((d * d).sum(-1, keepdim=True)).clamp_min(1e-9)
    d = d.clamp_max(0.2)
    return d / torch.sqrt((d * d).sum(-1, keepdim=True)).clamp_min(1e-9)


def dense_sift(img: np.ndarray, bin_size: int = 8, step: int = 4,
               device=None) -> np.ndarray:
    """Dense SIFT descriptors ``(Ny, Nx, 128)`` for a float grayscale image,
    computed on ``device`` (CUDA unless the caller passes another, e.g.
    ``"cpu"``).  An image too small to fit one descriptor support yields a
    (0, 0, 128) array rather than an error."""
    dev = resolve_device(device)
    img = np.asarray(img, dtype=np.float32)
    ys, xs = descriptor_grid(img.shape[0], img.shape[1], bin_size, step)
    if len(ys) == 0 or len(xs) == 0:
        return np.zeros((len(ys), len(xs), N_BINS * N_BINS * N_ORIENT),
                        np.float32)
    return _dense_sift(torch.from_numpy(img).to(dev), bin_size,
                       step).cpu().numpy()


def rootsift(desc: np.ndarray) -> np.ndarray:
    """RootSIFT map (relja_rootsift): L1-normalize then element-wise sqrt —
    Euclidean distance between outputs is the Hellinger kernel distance."""
    d = np.asarray(desc, dtype=np.float32)
    n = np.sum(np.abs(d), axis=-1, keepdims=True)
    return np.sqrt(d / np.maximum(n, 1e-12))


def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """ITU-R BT.601 luma (MATLAB rgb2gray weights), float output in [0,255]
    for uint8 input."""
    img = np.asarray(img, dtype=np.float64)
    if img.ndim == 2:
        return img
    return img[..., 0] * 0.2989 + img[..., 1] * 0.5870 + img[..., 2] * 0.1140


def normalize_image_masked(img: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Zero-mean / unit-std normalization over the masked region (the
    reference's external ``image_normalization``): photometric gain/bias
    between the real query and the rendered view cancels before descriptor
    comparison."""
    img = np.asarray(img, dtype=np.float64)
    m = np.asarray(mask, dtype=bool)
    if not m.any():
        return np.zeros_like(img)
    mu = img[m].mean()
    sd = img[m].std()
    return (img - mu) / (sd + 1e-9)


def inpaint_nans(img: np.ndarray, iters: int = 100) -> np.ndarray:
    """Fill NaN holes by iterated 3×3 neighbor averaging (a diffusion
    equivalent of the reference's external ``inpaint_nans``) — dense SIFT's
    pooling windows must not see NaNs."""
    img = np.asarray(img, dtype=np.float64).copy()
    nan = ~np.isfinite(img)
    if not nan.any():
        return img
    img[nan] = np.nanmean(img) if np.isfinite(img).any() else 0.0
    known = ~nan
    kernel_sum = np.ones((3, 3))
    for _ in range(iters):
        padded = np.pad(img, 1, mode="edge")
        acc = np.zeros_like(img)
        for dy in (0, 1, 2):
            for dx in (0, 1, 2):
                acc += padded[dy : dy + img.shape[0], dx : dx + img.shape[1]]
        smoothed = acc / kernel_sum.sum()
        img = np.where(known, img, smoothed)
    return img


def pose_verification_score(
    query_gray: np.ndarray,
    synth_gray: np.ndarray,
    valid_mask: np.ndarray,
    bin_size: int = 8,
    step: int = 4,
    device=None,
) -> float:
    """Similarity between the query and a rendered synthetic view:
    ``1 / median ‖RootSIFT_q − RootSIFT_synth‖`` over descriptors centered on
    rendered pixels (parfor_nc4d_PV.m).  Returns 0.0 when nothing rendered.
    The descriptors are computed on ``device`` (:func:`dense_sift`).
    """
    mask = np.asarray(valid_mask, dtype=bool)
    if not mask.any():
        return 0.0
    q = np.asarray(query_gray, dtype=np.float64)
    ys, xs = descriptor_grid(q.shape[0], q.shape[1], bin_size, step)
    if len(ys) == 0 or len(xs) == 0:  # image smaller than one descriptor
        return 0.0
    q = normalize_image_masked(q, mask)
    s = np.where(mask, np.asarray(synth_gray, dtype=np.float64), np.nan)
    s = normalize_image_masked(inpaint_nans(s), mask)
    dq = rootsift(dense_sift(q, bin_size, step, device))
    ds = rootsift(dense_sift(s, bin_size, step, device))
    iseval = mask[ys[:, None], xs[None, :]]
    if not iseval.any():
        return 0.0
    err = np.linalg.norm(dq[iseval] - ds[iseval], axis=-1)
    med = float(np.median(err))
    return 1.0 / med if med > 0 else float("inf")
