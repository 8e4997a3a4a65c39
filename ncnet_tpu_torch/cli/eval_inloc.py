"""CLI for InLoc dense matching, the port of ``ncnet_tpu/cli/eval_inloc.py``:

    python -m ncnet_tpu_torch.cli.eval_inloc --checkpoint ncnet_ivd.pth.tar \
        --inloc_shortlist datasets/inloc/densePE_top100_shortlist_cvpr18.mat

Flag names and defaults are the JAX CLI's (which mirror the reference's,
eval_inloc.py:29-40), plus ``--device`` (default ``cuda``; ``cpu`` runs on
the host).  ``--spatial_shards N`` splits each pair's volume over N local
devices along hB (``parallel/spatial.py``; N GPUs, or the host with
``--device cpu``); ``--feature_store_dir`` is refused
(``evaluation/inloc.py::check_inloc_ported``).  The images are read in
their raw form (ROADMAP decision D1: ``tools/convert_images.py`` writes
them from a JPEG tree).  A degraded run (a query quarantined in this host's
manifest) exits 2.
"""

from __future__ import annotations

import argparse

from ncnet_tpu_torch.cli.common import str_to_bool as _str_to_bool


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Compute InLoc matches")
    p.add_argument("--checkpoint", type=str, default="")
    p.add_argument("--inloc_shortlist", type=str,
                   default="datasets/inloc/densePE_top100_shortlist_cvpr18.mat")
    p.add_argument("--k_size", type=int, default=2)
    p.add_argument("--image_size", type=int, default=3200)
    p.add_argument("--n_queries", type=int, default=356)
    p.add_argument("--n_panos", type=int, default=10)
    p.add_argument("--softmax", type=_str_to_bool, default=True)
    p.add_argument("--matching_both_directions", type=_str_to_bool, default=True)
    p.add_argument("--flip_matching_direction", type=_str_to_bool, default=False)
    p.add_argument("--pano_path", type=str, default="datasets/inloc/pano/",
                   help="path to InLoc panos - should contain CSE3,CSE4,CSE5,"
                        "DUC1 and DUC2 folders")
    p.add_argument("--query_path", type=str, default="datasets/inloc/query/iphone7/",
                   help="path to InLoc queries")
    p.add_argument("--output_root", type=str, default="matches")
    p.add_argument("--spatial_shards", type=int, default=1,
                   help="shard the 4D volume's hB over this many local "
                        "devices (1 = off)")
    p.add_argument("--pipeline_depth", type=int, default=0,
                   help="dispatch/fetch pipeline depth (0 = adaptive to the "
                        "link's latency regime; >0 pins it)")
    p.add_argument("--host_index", type=int, default=-1,
                   help="stripe queries across hosts: this host's index "
                        "(-1 = the torch.distributed rank when initialised)")
    p.add_argument("--host_count", type=int, default=0,
                   help="total hosts striping queries (0 = auto)")
    p.add_argument("--skip_existing", type=_str_to_bool, default=True,
                   help="resume: skip queries whose output .mat exists")
    p.add_argument("--validate_existing", type=_str_to_bool, default=True,
                   help="loadmat-validate an existing .mat before skipping "
                        "it, so a foreign/truncated artifact is recomputed")
    p.add_argument("--query_retries", type=int, default=2,
                   help="per-query retries after the first failure, before "
                        "quarantine")
    p.add_argument("--retry_backoff_s", type=float, default=0.5,
                   help="retry backoff seconds, doubled per attempt")
    p.add_argument("--quarantine", type=_str_to_bool, default=True,
                   help="exhausted retries quarantine the query into "
                        "manifest.json instead of aborting the run")
    p.add_argument("--fetch_timeout_s", type=float, default=0.0,
                   help="watchdog around each pair fetch; a hung fetch "
                        "becomes a retryable timeout (0 = off)")
    p.add_argument("--telemetry_dir", type=str, default="",
                   help="open a structured event log here (per-query events "
                        "+ metrics)")
    p.add_argument("--feature_store_dir", type=str, default="",
                   help="persistent database-side feature store (not "
                        "ported: refused)")
    p.add_argument("--sparse_topk", type=int, default=0,
                   help="coarse-to-fine sparse matching (requires --k_size "
                        "1; 0 = dense, the default)")
    p.add_argument("--feature_store_budget_mb", type=int, default=0,
                   help="LRU-evict store entries above this many MiB "
                        "(0 = unbounded)")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the model runs: cuda (the default; without a "
                        "GPU the run stops) or cpu")
    return p


def main(argv=None) -> int:
    print("NCNet evaluation script - InLoc dataset")
    args = build_parser().parse_args(argv)
    # deferred imports: --help and flag errors don't pay the torch startup
    import os

    from ncnet_tpu_torch.config import EvalInLocConfig
    from ncnet_tpu_torch.evaluation.inloc import (
        manifest_name,
        output_folder_name,
        resolve_host_stripe,
        run_inloc_eval,
    )
    from ncnet_tpu_torch.evaluation.resilience import manifest_has_quarantined

    config = EvalInLocConfig(
        checkpoint=args.checkpoint,
        inloc_shortlist=args.inloc_shortlist,
        k_size=args.k_size,
        image_size=args.image_size,
        n_queries=args.n_queries,
        n_panos=args.n_panos,
        softmax=args.softmax,
        matching_both_directions=args.matching_both_directions,
        flip_matching_direction=args.flip_matching_direction,
        pano_path=args.pano_path,
        query_path=args.query_path,
        output_root=args.output_root,
        spatial_shards=args.spatial_shards,
        pipeline_depth=args.pipeline_depth,
        host_index=args.host_index,
        host_count=args.host_count,
        skip_existing=args.skip_existing,
        validate_existing=args.validate_existing,
        query_retries=args.query_retries,
        retry_backoff_s=args.retry_backoff_s,
        quarantine=args.quarantine,
        fetch_timeout_s=args.fetch_timeout_s,
        telemetry_dir=args.telemetry_dir,
        feature_store_dir=args.feature_store_dir,
        feature_store_budget_mb=args.feature_store_budget_mb,
        sparse_topk=args.sparse_topk,
    )
    print(args)
    print("Output matches folder: " + output_folder_name(config))
    out_dir = run_inloc_eval(config, device=args.device)
    print("Wrote matches to " + out_dir)
    # degraded result (a quarantined query in this host's manifest, not a
    # glob over other stripes' files): exit non-zero so schedulers notice
    # even though the run survived
    if config.write_manifest and manifest_has_quarantined(
            os.path.join(out_dir, manifest_name(*resolve_host_stripe(config)))):
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
