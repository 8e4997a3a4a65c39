"""PCK (percentage of correct keypoints), the port of
``ncnet_tpu/evaluation/pck.py``.

Reference: ``pck`` / ``pck_metric`` (``lib/eval_util.py:12-50``).  The
reference loops per sample over the first N valid keypoints; here the whole
computation is masked and batched (keypoints are padded to 20 with −1, the
padding a suffix: ``lib/pf_dataset.py:106-108``).
"""

from __future__ import annotations

from typing import Dict

import torch

from ncnet_tpu_torch.ops.matching import (
    Matches,
    bilinear_interp_point_tnf,
    points_to_pixel_coords,
    points_to_unit_coords,
)


def pck(source_points: torch.Tensor, warped_points: torch.Tensor,
        l_pck: torch.Tensor, alpha: float = 0.1) -> torch.Tensor:
    """Per-sample fraction of keypoints within ``alpha · L_pck``.

    ``source_points`` ``(B, 2, N)`` pixel coordinates, −1-padded (suffix);
    ``warped_points`` ``(B, 2, N)`` the estimated correspondents of the
    targets; ``l_pck`` ``(B,)`` or ``(B, 1)``.  Returns ``(B,)`` float32, NaN
    for a sample with no valid point (true division by zero, as the
    reference; callers filter it)."""
    valid = (source_points[:, 0, :] != -1) & (source_points[:, 1, :] != -1)
    dist = torch.sqrt(((source_points - warped_points) ** 2).sum(dim=1))
    thresh = l_pck.reshape(-1, 1) * alpha
    correct = (dist <= thresh) & valid
    return (correct.sum(dim=1).to(torch.float32)
            / valid.sum(dim=1).to(torch.float32))


def pck_metric(batch: Dict[str, torch.Tensor], matches: Matches,
               alpha: float = 0.1) -> torch.Tensor:
    """Warp the target keypoints through the match field and score PCK
    against the source keypoints (eval_util.py:27-50).  ``batch`` holds
    ``source_points``/``target_points`` ``(B, 2, N)``,
    ``source_im_size``/``target_im_size`` ``(B, 3)`` as (h, w, c) and
    ``L_pck`` ``(B, 1)``."""
    target_norm = points_to_unit_coords(batch["target_points"],
                                        batch["target_im_size"])
    warped_norm = bilinear_interp_point_tnf(matches, target_norm)
    warped = points_to_pixel_coords(warped_norm, batch["source_im_size"])
    return pck(batch["source_points"], warped, batch["L_pck"], alpha)
