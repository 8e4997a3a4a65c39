"""Localization-rate curves vs reference poses (ht_plotcurve_WUSTL.m).

Given per-query top-1 poses and the ground-truth pose lists (DUC1/DUC2), a
query is "correctly localized" at distance threshold d when its top-1 cutout
is on the right floor, its pose is finite, its camera-center error is < d and
its orientation error is ≤ 10°.  The reference plots % localized over
thresholds 0→2 m and writes one ``error_<method>.txt`` with per-query errors.
The port of ``ncnet_tpu/localization/curves.py``; the figure is drawn where
matplotlib is installed (ROADMAP: the card's installation may lack it).
"""

from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ncnet_tpu_torch.localization.geometry import pose_distance
from ncnet_tpu_torch.observability import get_logger

log = get_logger("localization")

# the reference's threshold grid: 0:0.0625:1 then 1.125:0.125:2
ERROR_THRESHOLDS = np.concatenate(
    [np.arange(0.0, 1.0 + 1e-9, 0.0625), np.arange(1.125, 2.0 + 1e-9, 0.125)]
)
MAX_ORIENTATION_ERR_DEG = 10.0


class MethodResult(NamedTuple):
    description: str
    # per-query: queryname -> (top1 cutout name, top1 pose (3,4))
    top1: Dict[str, Tuple[str, np.ndarray]]


def load_reference_poses(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Parse the ground-truth pose .mat (lib_matlab/DUC_refposes_all.mat):
    ``{'DUC1': {queryname: P (3,4)}, 'DUC2': {...}}``."""
    from scipy.io import loadmat

    mat = loadmat(path, simplify_cells=True)
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for floor in ("DUC1", "DUC2"):
        reflist = mat[f"{floor}_RefList"]
        if isinstance(reflist, dict):  # single-entry lists simplify to a dict
            reflist = [reflist]
        out[floor] = {
            str(e["queryname"]): np.asarray(e["P"], dtype=np.float64)[:3, :4]
            for e in reflist
        }
    return out


def pose_errors(
    method: MethodResult,
    refposes: Dict[str, Dict[str, np.ndarray]],
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Per-query (position, orientation) errors against ground truth, inf for
    missing / wrong-floor / NaN poses — the reference's exact gating
    (ht_plotcurve_WUSTL.m: top-1 floor must match the GT floor prefix)."""
    poserr, orierr, names = [], [], []
    for floor, ref in refposes.items():
        for qname, P_ref in ref.items():
            names.append(qname)
            entry = method.top1.get(qname)
            if entry is None:
                poserr.append(np.inf)
                orierr.append(np.inf)
                continue
            top1_name, P = entry
            floor_ok = top1_name.replace("\\", "/").split("/")[0] == floor
            if floor_ok and np.all(np.isfinite(np.asarray(P))):
                dp, do = pose_distance(P_ref, P)
                poserr.append(dp)
                orierr.append(do)
            else:
                poserr.append(np.inf)
                orierr.append(np.inf)
    return np.asarray(poserr), np.asarray(orierr), names


def localized_rate_curve(
    poserr: np.ndarray,
    orierr: np.ndarray,
    thresholds: np.ndarray = ERROR_THRESHOLDS,
    max_orierr_deg: float = MAX_ORIENTATION_ERR_DEG,
) -> np.ndarray:
    """Fraction of queries with position error < each threshold, orientation
    gated at ``max_orierr_deg`` (ht_plotcurve_WUSTL.m:70-84)."""
    err = np.where(
        np.rad2deg(orierr) > max_orierr_deg, np.inf, poserr
    )
    return (err[:, None] < thresholds[None, :]).mean(axis=0)


def write_error_txt(
    path: str, names: Sequence[str], poserr: np.ndarray, orierr: np.ndarray
) -> None:
    """Per-query ``<name> <poserr> <orierr>`` lines
    (the reference's error_<method>.txt)."""
    with open(path, "w") as f:
        for n, dp, do in zip(names, poserr, orierr):
            f.write(f"{n} {dp:f} {do:f}\n")


def plot_localization_curves(
    methods: Sequence[MethodResult],
    refposes: Dict[str, Dict[str, np.ndarray]],
    out_dir: str,
    markers: Optional[Sequence[str]] = None,
) -> Dict[str, np.ndarray]:
    """Compute, plot and persist the localization curves for all methods.

    Writes ``error_<method>.txt`` per method plus the curve figure
    (``athr10_<N>.png``/.eps twins of the reference's .fig/.eps) into
    ``out_dir``.  Returns ``{description: curve}``.  Without matplotlib the
    curves and the error files are still written, and a warning names the
    figure that was not drawn.
    """
    os.makedirs(out_dir, exist_ok=True)
    curves: Dict[str, np.ndarray] = {}
    n_queries = 0
    for method in methods:
        poserr, orierr, names = pose_errors(method, refposes)
        n_queries = len(names)
        write_error_txt(
            os.path.join(out_dir, f"error_{method.description}.txt"),
            names, poserr, orierr,
        )
        curves[method.description] = localized_rate_curve(poserr, orierr)
    base = os.path.join(
        out_dir, f"athr{MAX_ORIENTATION_ERR_DEG:.4f}_{n_queries}"
    )
    try:
        import matplotlib
    except ImportError:
        log.warning(f"matplotlib is not installed: the curve figure "
                    f"{base}.png/.eps is not drawn (the curves and the "
                    "error files are written)", kind="io")
        return curves

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(5, 5))
    styles = markers or ["--b", "--c", "--m", "--g"]
    for i, (desc, curve) in enumerate(curves.items()):
        ax.plot(
            ERROR_THRESHOLDS, curve * 100.0, styles[i % len(styles)],
            linewidth=2.0, label=desc,
        )
    ax.set_xlim(0, 2)
    ax.set_ylim(0, 80)
    ax.grid(True)
    ax.set_xticks(np.arange(0, 2.25, 0.25))
    ax.set_xlabel("Distance threshold [meters]")
    ax.set_ylabel("Correctly localized queries [%]")
    ax.legend(loc="lower right", fontsize=10)
    fig.savefig(base + ".png", dpi=160)
    fig.savefig(base + ".eps")
    plt.close(fig)
    return curves
