"""CLI for the InLoc localization stage, the port of
``ncnet_tpu/cli/compute_localization.py`` — the Python equivalent of the
reference's MATLAB driver (compute_densePE_NCNet.m), with its parameters
(score threshold 0.75, PnP threshold 0.2°, top-10, optional densePV) exposed
as flags:

    python -m ncnet_tpu_torch.cli.compute_localization \
        --matches_dir matches/<experiment>

Flag names and defaults are the JAX CLI's, plus ``--device`` (default
``cuda``; ``cpu`` runs the scoring and the dense SIFT on the host).  The
queries are read in their raw form (ROADMAP D1: ``<name>.npy`` beside each
image).  A degraded PnP stage (a query quarantined in its manifest) exits
2.
"""

from __future__ import annotations

import argparse

import numpy as np

from ncnet_tpu_torch.cli.common import str_to_bool as _str_to_bool


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="InLoc localization from NCNet matches "
        "(PnP + optional pose verification + curves)"
    )
    p.add_argument("--matches_dir", type=str, required=True,
                   help="matches/<experiment> directory from eval_inloc")
    p.add_argument("--shortlist", type=str,
                   default="datasets/inloc/densePE_top100_shortlist_cvpr18.mat")
    p.add_argument("--query_path", type=str,
                   default="datasets/inloc/query/iphone7/")
    p.add_argument("--cutout_path", type=str, default="datasets/inloc/pano/",
                   help="cutout images + their XYZcut depth .mat files")
    p.add_argument("--scan_path", type=str, default="datasets/inloc/scans/")
    p.add_argument("--transformation_path", type=str, default="datasets/inloc/")
    p.add_argument("--refposes", type=str,
                   default="datasets/inloc/DUC_refposes_all.mat")
    p.add_argument("--output_dir", type=str, default="outputs_localization")
    p.add_argument("--pnp_topN", type=int, default=10)
    p.add_argument("--thr", type=float, default=0.75,
                   help="match score threshold (params.ncnet.thr)")
    p.add_argument("--pnp_thr", type=float, default=0.2,
                   help="RANSAC inlier threshold, degrees (params.ncnet.pnp_thr)")
    p.add_argument("--ransac_iters", type=int, default=10000)
    p.add_argument("--do_densePV", type=_str_to_bool, default=True)
    p.add_argument("--query_focal_length", type=float, default=0.0,
                   help="query focal in pixels; 0 = iPhone 7 EXIF default")
    p.add_argument("--n_queries", type=int, default=0, help="0 = all")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_workers", type=int, default=0,
                   help="process-pool width for the PnP (per-query) and "
                        "pose-verification (per-scan) stages — the "
                        "reference's two parfor loops; 0 = in-process")
    p.add_argument("--query_retries", type=int, default=2,
                   help="per-query PnP retries after the first failure, "
                        "before quarantine")
    p.add_argument("--retry_backoff_s", type=float, default=0.5,
                   help="retry backoff seconds, doubled per attempt")
    p.add_argument("--quarantine", type=_str_to_bool, default=True,
                   help="exhausted retries quarantine the query into the "
                        "stage manifest (it scores as not-localized) "
                        "instead of aborting the stage")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the RANSAC scoring and the dense SIFT run: "
                        "cuda (the default; without a GPU the run stops) "
                        "or cpu")
    return p


def main(argv=None) -> int:
    print("NCNet localization - InLoc dataset")
    args = build_parser().parse_args(argv)
    from ncnet_tpu_torch.config import LocalizationConfig
    from ncnet_tpu_torch.localization.driver import run_localization

    config = LocalizationConfig(
        matches_dir=args.matches_dir,
        shortlist=args.shortlist,
        query_path=args.query_path,
        cutout_path=args.cutout_path,
        scan_path=args.scan_path,
        transformation_path=args.transformation_path,
        refposes=args.refposes,
        output_dir=args.output_dir,
        pnp_topN=args.pnp_topN,
        match_score_thr=args.thr,
        pnp_inlier_thr_deg=args.pnp_thr,
        ransac_iters=args.ransac_iters,
        do_pose_verification=args.do_densePV,
        query_focal_length=args.query_focal_length,
        n_queries=args.n_queries,
        seed=args.seed,
        num_workers=args.num_workers,
        query_retries=args.query_retries,
        retry_backoff_s=args.retry_backoff_s,
        quarantine=args.quarantine,
    )
    print(args)
    curves = run_localization(config, device=args.device)
    from ncnet_tpu_torch.localization.curves import ERROR_THRESHOLDS

    for desc, curve in curves.items():
        at_05 = curve[np.abs(ERROR_THRESHOLDS - 0.5).argmin()]
        at_10 = curve[np.abs(ERROR_THRESHOLDS - 1.0).argmin()]
        print(f"{desc}: localized @0.5m {at_05 * 100:.1f}%  "
              f"@1.0m {at_10 * 100:.1f}%")
    print("Outputs in " + config.output_dir)
    from ncnet_tpu_torch.localization.driver import pnp_stage_degraded

    if pnp_stage_degraded(config):
        # degraded result (quarantined PnP queries): exit nonzero so CI /
        # schedulers notice; a rerun retries them
        print("warning: PnP stage has quarantined queries (see its "
              "manifest.json); curves are partial")
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
