"""Synthetic reference-schema fixtures for tests and smoke runs, the port of
``ncnet_tpu/data/synthetic.py`` (``make_shifted_pair``,
``write_pair_dataset``, ``write_pf_pascal_like``, ``write_inloc_like``).

The target image is a shifted crop of the source, so keypoint transfer has
an analytic answer.  The functions draw the same random sequence and write
the same CSV text as the JAX package's; the images are written in the raw
form the port's dataset reads (``<rel>.jpg.npy``, ROADMAP decision D1)
instead of as JPEGs, so a machine without an image decoder writes them.
The smooth texture's upsampling is PIL's bilinear resize of 8-bit images,
reproduced in numpy (its fixed-point filter, ``Resample.c``), so the pixels
equal the JAX package's ``make_shifted_pair`` for the same generator.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from ncnet_tpu_torch.data.datasets import raw_path

# PIL's fixed-point resampling of 8-bit images: coefficients carry 22
# fractional bits, sums start at one half
_PRECISION_BITS = 32 - 8 - 2


def _bilinear_coeffs(in_size: int, out_size: int) -> np.ndarray:
    """PIL's bilinear filter from ``in_size`` to ``out_size`` samples as an
    ``(out_size, in_size)`` int64 matrix of its fixed-point coefficients
    (``precompute_coeffs`` then ``normalize_coeffs_8bpc``)."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale  # the bilinear filter's support is 1
    ss = 1.0 / filterscale
    out = np.zeros((out_size, in_size), dtype=np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        weights = []
        for x in range(xmax):
            t = abs((x + xmin - center + 0.5) * ss)
            weights.append(1.0 - t if t < 1.0 else 0.0)
        ww = 0.0
        for w in weights:
            ww += w
        for x, w in enumerate(weights):
            if ww != 0.0:
                w /= ww
            w *= 1 << _PRECISION_BITS
            out[xx, x + xmin] = int(w - 0.5) if w < 0 else int(w + 0.5)
    return out


def _clip8(acc: np.ndarray) -> np.ndarray:
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def pil_bilinear_resize(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """``Image.fromarray(img).resize((w, h), Image.BILINEAR)`` of an
    ``(H, W, C)`` uint8 image, as numpy: the horizontal pass, rounded to
    8 bits, then the vertical one."""
    half = 1 << (_PRECISION_BITS - 1)
    kx = _bilinear_coeffs(img.shape[1], w)
    ky = _bilinear_coeffs(img.shape[0], h)
    tmp = _clip8(half + np.einsum("xX,yXc->yxc", kx, img.astype(np.int64)))
    return _clip8(half + np.einsum("yY,Yxc->yxc", ky, tmp.astype(np.int64)))


def _textured_image(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Smooth random texture (low-res noise, bilinearly upsampled) with
    local structure that feature extractors can match."""
    low = rng.uniform(0, 255, (max(h // 8, 2), max(w // 8, 2), 3))
    img = pil_bilinear_resize(low.astype(np.uint8), w, h)
    noise = rng.uniform(-12, 12, (h, w, 3))
    return np.clip(img + noise, 0, 255).astype(np.uint8)


def make_shifted_pair(rng: np.random.Generator, h: int, w: int,
                      shift: Tuple[int, int]
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Source + target where target[y + dy, x + dx] = source[y, x] on the
    overlap (content moves by (+dy, +dx) source→target); both (h, w, 3)."""
    dy, dx = shift
    big = _textured_image(rng, h + abs(dy), w + abs(dx))
    y0, x0 = max(dy, 0), max(dx, 0)
    src = big[y0: y0 + h, x0: x0 + w]
    tgt = big[y0 - dy: y0 - dy + h, x0 - dx: x0 - dx + w]
    return src, tgt


def write_pair_dataset(
    root: str,
    n_pairs: int = 6,
    image_hw: Tuple[int, int] = (96, 128),
    shift: Tuple[int, int] = (16, 16),
    seed: int = 0,
    splits: Tuple[str, ...] = ("train", "val"),
) -> str:
    """Weak-supervision layout: ``root/images/*.jpg`` (each in its raw
    form) and ``root/image_pairs/{split}_pairs.csv`` with the reference's
    ``source_image,target_image,class,flip`` columns."""
    rng = np.random.default_rng(seed)
    h, w = image_hw
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    csv_dir = os.path.join(root, "image_pairs")
    os.makedirs(csv_dir, exist_ok=True)
    for split in splits:
        rows = ["source_image,target_image,class,flip"]
        for i in range(n_pairs):
            src, tgt = make_shifted_pair(rng, h, w, shift)
            a = f"images/{split}_{i}_a.jpg"
            b = f"images/{split}_{i}_b.jpg"
            np.save(raw_path(os.path.join(root, a)), src)
            np.save(raw_path(os.path.join(root, b)), tgt)
            rows.append(f"{a},{b},{1 + i % 3},0")
        with open(os.path.join(csv_dir, f"{split}_pairs.csv"), "w") as f:
            f.write("\n".join(rows) + "\n")
    return root


def write_pf_pascal_like(
    root: str,
    n_pairs: int = 4,
    image_hw: Tuple[int, int] = (96, 128),
    shift: Tuple[int, int] = (16, 16),
    n_points: int = 6,
    seed: int = 0,
) -> str:
    """Keypoint-annotated layout mirroring PF-Pascal's on-disk layout
    (``root/image_pairs/test_pairs.csv`` + ``root/images/``, each image in
    its raw form): columns ``source_image,target_image,class,XA,YA,XB,YB``
    with ';'-joined 1-indexed pixel coordinates.  GT: content shifts by
    (+dy, +dx) source→target, so ``(xB, yB) = (xA + dx, yA + dy)``.
    Returns the CSV's path."""
    rng = np.random.default_rng(seed)
    h, w = image_hw
    dy, dx = shift
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    csv_dir = os.path.join(root, "image_pairs")
    os.makedirs(csv_dir, exist_ok=True)
    rows = ["source_image,target_image,class,XA,YA,XB,YB"]

    def _axis_bounds(length: int, s: int, margin: int = 4):
        """1-indexed B-coordinate bounds keeping every keypoint (and its A
        twin) inside both frames and two feature cells (2×|shift|) plus a
        bleed pad clear of the band the shift brings in, where a
        stride-16 trunk's receptive field mixes in unmatched content."""
        lo, hi = 1 + margin, length - margin
        pad = 2 * abs(s) + 8
        if s > 0:
            lo = max(lo, 1 + margin + s, pad)
        elif s < 0:
            hi = min(hi, length - margin + s, length - pad)
        return float(lo), float(hi)

    # corner-spanning keypoints: the first four pin the A-point bounding
    # box (L_pck, the PCK threshold scale) to the full safe box
    x_lo, x_hi = _axis_bounds(w, dx)
    y_lo, y_hi = _axis_bounds(h, dy)
    corner_frac = [(0.0, 0.0), (1.0, 1.0), (1.0, 0.0), (0.0, 1.0)]
    for i in range(n_pairs):
        src, tgt = make_shifted_pair(rng, h, w, shift)
        a, b = f"images/test_{i}_a.jpg", f"images/test_{i}_b.jpg"
        np.save(raw_path(os.path.join(root, a)), src)
        np.save(raw_path(os.path.join(root, b)), tgt)
        fracs = corner_frac[:n_points]
        if n_points > len(corner_frac):
            extra = rng.uniform(0.1, 0.9, (n_points - len(corner_frac), 2))
            fracs = fracs + [tuple(p) for p in extra]
        xb = np.asarray([x_lo + fx * (x_hi - x_lo) for fx, _ in fracs])
        yb = np.asarray([y_lo + fy * (y_hi - y_lo) for _, fy in fracs])
        xa, ya = xb - dx, yb - dy
        fmt = lambda v: ";".join(str(float(x)) for x in v)  # noqa: E731
        rows.append(f"{a},{b},{1 + i % 3},{fmt(xa)},{fmt(ya)},{fmt(xb)},"
                    f"{fmt(yb)}")
    csv_path = os.path.join(csv_dir, "test_pairs.csv")
    with open(csv_path, "w") as f:
        f.write("\n".join(rows) + "\n")
    return csv_path


def write_inloc_like(
    root: str,
    n_queries: int = 2,
    n_panos: int = 3,
    image_hw: Tuple[int, int] = (96, 128),
    seed: int = 0,
) -> str:
    """InLoc-shaped layout: ``root/query/iphone7/*.jpg``, ``root/pano/*.jpg``
    (each image in its raw form) and a densePE-style shortlist ``.mat``
    whose ``ImgList`` struct array indexes per-query pano shortlists the
    way the reference reads it (eval_inloc.py:97-101: ``db[q][0]`` the
    query name, ``db[q][1].ravel()[idx]`` a pano name).

    Pano 0 of each query is the query image, so a correct matcher scores
    near-identity matches on it.  Pano names follow the real dataset's
    cutout pattern (``DUC1/DUC_cutout_<scan>_<pan>_<tilt>.jpg``).  The
    random sequence is the JAX writer's, so the arrays are its images
    before their JPEG encoding.  Returns the shortlist path."""
    from scipy.io import savemat

    rng = np.random.default_rng(seed)
    h, w = image_hw
    qdir = os.path.join(root, "query", "iphone7")
    os.makedirs(qdir, exist_ok=True)
    os.makedirs(os.path.join(root, "pano", "DUC1"), exist_ok=True)
    entries = np.zeros(
        (1, n_queries),
        dtype=np.dtype([("queryname", object), ("topNname", object)]))
    for q in range(n_queries):
        qimg = _textured_image(rng, h, w)
        qfn = f"query_{q}.jpg"
        np.save(raw_path(os.path.join(qdir, qfn)), qimg)
        panos = []
        for p in range(n_panos):
            pfn = f"DUC1/DUC_cutout_{q:03d}_{p * 30}_0.jpg"
            img = qimg if p == 0 else _textured_image(rng, h, w)
            np.save(raw_path(os.path.join(root, "pano", pfn)), img)
            panos.append(pfn)
        entries[0, q] = (np.array([qfn]),
                         np.array(panos, dtype=object)[:, None])
    shortlist = os.path.join(root, "shortlist.mat")
    savemat(shortlist, {"ImgList": entries})
    return shortlist
