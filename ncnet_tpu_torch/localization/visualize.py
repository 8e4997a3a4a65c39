"""Side-by-side match visualization (lib_matlab/show_matches2_horizontal.m),
the port of ``ncnet_tpu/localization/visualize.py``.

Grayscale the two images, scale the shorter one to equal height, concatenate
horizontally, and draw tentative matches (blue) with inliers highlighted
(green points + connecting lines).  numpy on the host; matplotlib is
imported only here, and where it is not installed nothing is drawn and a
warning names the package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ncnet_tpu_torch.localization.dsift import rgb_to_gray

_GAP = 10  # horizontal gap between the two images, as in the reference


def show_matches_horizontal(
    image1: np.ndarray,
    image2: np.ndarray,
    xy1: np.ndarray,
    xy2: np.ndarray,
    inliers: Optional[np.ndarray] = None,
    ax=None,
    linewidth: float = 0.5,
):
    """Plot matches ``xy1 (N,2)`` in image1 ↔ ``xy2 (N,2)`` in image2 (pixel
    coords).  Returns the matplotlib axis (None without matplotlib)."""
    from ncnet_tpu_torch.utils.plot import pyplot

    plt = pyplot("the match figure")
    if plt is None:
        return None
    g1 = rgb_to_gray(image1)
    g2 = rgb_to_gray(image2)
    h1, w1 = g1.shape
    h2, w2 = g2.shape
    xy1 = np.asarray(xy1, dtype=np.float64).reshape(-1, 2).copy()
    xy2 = np.asarray(xy2, dtype=np.float64).reshape(-1, 2).copy()
    if h1 <= h2:  # scale image2 down to image1's height
        s = h1 / h2
        g2 = _rescale(g2, s)
        xy2 = xy2 * s
    else:
        s = h2 / h1
        g1 = _rescale(g1, s)
        xy1 = xy1 * s
    h = min(g1.shape[0], g2.shape[0])
    cat = np.concatenate(
        [g1[:h], np.full((h, _GAP), 255.0), g2[:h]], axis=1
    )
    xoff = g1.shape[1] + _GAP

    if ax is None:
        _, ax = plt.subplots(
            figsize=(cat.shape[1] / 100.0, cat.shape[0] / 100.0)
        )
    ax.imshow(cat, cmap="gray")
    ax.set_axis_off()
    ax.scatter(xy1[:, 0], xy1[:, 1], s=10, c="b")
    ax.scatter(xy2[:, 0] + xoff, xy2[:, 1], s=10, c="b")
    if inliers is not None and np.any(inliers):
        inl = np.asarray(inliers, dtype=bool)
        ax.scatter(xy1[inl, 0], xy1[inl, 1], s=10, c="g")
        ax.scatter(xy2[inl, 0] + xoff, xy2[inl, 1], s=10, c="g")
        for (x1, y1), (x2, y2) in zip(xy1[inl], xy2[inl]):
            ax.plot(
                [x1, x2 + xoff], [y1, y2], "-g", linewidth=linewidth
            )
    return ax


def _rescale(gray: np.ndarray, scale: float) -> np.ndarray:
    """Bilinear rescale of a 2D array (align-corners, matching ops/image)."""
    from ncnet_tpu_torch.ops.image import resize_bilinear_align_corners_np

    out_h = max(1, int(round(gray.shape[0] * scale)))
    out_w = max(1, int(round(gray.shape[1] * scale)))
    return resize_bilinear_align_corners_np(
        gray[:, :, None].astype(np.float32), out_h, out_w
    )[:, :, 0]
