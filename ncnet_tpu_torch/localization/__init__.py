"""The InLoc localization stage: the reference's MATLAB L6 pipeline, the
port of ``ncnet_tpu/localization/``.

The reference hands the dense matches written by ``eval_inloc`` to a MATLAB
harness (compute_densePE_NCNet.m + lib_matlab/) that depends on two external
repos (InLoc_demo, VLFeat).  This package re-implements that whole
downstream stage in numpy on the host, with the two parts that carry the
arithmetic in torch on the device (CUDA unless the caller passes
``device="cpu"``):

  geometry.py      camera model, pose distance (p2c.m, p2dist.m), image cap
  p3p.py           batched Grunert P3P + Kabsch and LO-RANSAC with the
                   hypothesis×point scoring on the device (ht_lo_ransac_p3p)
  scan.py          cutout-name parsing, scan transformation files, depth-map
                   back-projection, scan point-cloud loading
  render.py        point-cloud → perspective z-buffer render (ht_Points2Persp)
  dsift.py         dense SIFT on the device + RootSIFT (vl_phow +
                   relja_rootsift)
  pnp.py           per-pair pose estimation (parfor_NC4D_PE_pnponly.m)
  verification.py  synthetic-view pose verification (parfor_nc4d_PV.m,
                   ht_top10_NC4D_PV_localization.m)
  curves.py        localization-rate curves (ht_plotcurve_WUSTL.m)
  driver.py        the compute_densePE_NCNet.m pipeline

The JAX package's ``visualize.py`` (match plots, no caller on any path) is
not ported yet (ROADMAP A14).
"""

from ncnet_tpu_torch.localization.geometry import (
    camera_center,
    cap_longest_side_shape,
    intrinsics,
    pixel_rays,
    pose_distance,
    project_points,
)
from ncnet_tpu_torch.localization.p3p import (
    lo_ransac_p3p,
    p3p_solve,
    refine_pose_object_space,
)
from ncnet_tpu_torch.localization.pnp import estimate_pose_from_matches
from ncnet_tpu_torch.localization.driver import run_localization

__all__ = [
    "camera_center",
    "cap_longest_side_shape",
    "intrinsics",
    "pixel_rays",
    "pose_distance",
    "project_points",
    "p3p_solve",
    "lo_ransac_p3p",
    "refine_pose_object_space",
    "estimate_pose_from_matches",
    "run_localization",
]
