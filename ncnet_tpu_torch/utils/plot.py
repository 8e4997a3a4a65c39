"""Plot helpers: de-normalized image display + marginless figure saving,
the port of ``ncnet_tpu/utils/plot.py``.

Parity with the reference's ``lib/plot.py`` (plot_image :6-19, save_plot
:21-29), channels-last and matplotlib-Agg-safe for headless use.  The
arrays are numpy on the host; matplotlib is imported only where a figure
is drawn, and where it is not installed the drawing is skipped with a
warning that names the package (and the file not written).
"""

from __future__ import annotations

import numpy as np

from ncnet_tpu_torch.observability import get_logger
from ncnet_tpu_torch.ops.image import IMAGENET_MEAN, IMAGENET_STD

log = get_logger("plot")

_MEAN = np.asarray(IMAGENET_MEAN, dtype=np.float32)
_STD = np.asarray(IMAGENET_STD, dtype=np.float32)


def pyplot(what: str):
    """``matplotlib.pyplot`` on the Agg backend, or None with a warning
    that ``what`` is not drawn when matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        log.warning(f"matplotlib is not installed: {what} is not drawn",
                    kind="io")
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def denormalize_image(image: np.ndarray) -> np.ndarray:
    """Invert ImageNet normalization → [0,1] float image (H, W, 3)."""
    img = np.asarray(image)
    if img.ndim == 4:
        img = img[0]
    return np.clip(img * _STD + _MEAN, 0.0, 1.0)


def plot_image(image, return_im: bool = False, ax=None):
    """De-normalize and imshow (reference plot_image, lib/plot.py:6-19).

    ``image``: (H, W, 3) or (1, H, W, 3) ImageNet-normalized array.
    ``return_im=True`` returns the displayable array without plotting;
    otherwise the axis, or None where matplotlib is not installed.
    """
    im = denormalize_image(image)
    if return_im:
        return im
    plt = pyplot("the image") if ax is None else None
    if ax is None and plt is None:
        return None
    ax = ax or plt.gca()
    ax.imshow(im)
    ax.set_axis_off()
    return ax


def save_plot(filename: str, fig=None) -> None:
    """Save the current figure without margins (lib/plot.py:21-29)."""
    if fig is None:
        plt = pyplot(f"the figure {filename}")
        if plt is None:
            return
        fig = plt.gcf()
    fig.subplots_adjust(left=0, right=1, top=1, bottom=0)
    for ax in fig.axes:
        ax.set_axis_off()
    fig.savefig(filename, bbox_inches="tight", pad_inches=0)
