"""CLI for PF-Pascal PCK evaluation, the port of
``ncnet_tpu/cli/eval_pf_pascal.py``:

    python -m ncnet_tpu_torch.cli.eval_pf_pascal --checkpoint ncnet_pfpascal.pth.tar \
        --eval_dataset_path datasets/pf-pascal/

Flag names and defaults are the JAX CLI's (which mirror the reference's,
eval_pf_pascal.py:27-30; ``--batch_size`` extends the reference's fixed
1), plus ``--device`` (default ``cuda``; ``cpu`` runs on the host).
``--checkpoint`` takes a reference ``.pth.tar``, a native checkpoint
directory or a root ``fit`` wrote (its newest complete version).  The
dataset's images are read in their raw form (ROADMAP decision D1:
``tools/convert_images.py`` writes them from a JPEG tree).  It prints the
reference's three lines; a degraded run (a quarantined batch, or an
undecodable image whose pair scored invalid) exits 2.
"""

from __future__ import annotations

import argparse

from ncnet_tpu_torch.cli.common import str_to_bool as _str_to_bool


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Compute PF Pascal matches")
    p.add_argument("--checkpoint", type=str, default="")
    p.add_argument("--image_size", type=int, default=400)
    p.add_argument("--eval_dataset_path", type=str, default="datasets/pf-pascal/",
                   help="path to PF Pascal dataset")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--num_workers", type=int, default=0)
    p.add_argument("--backbone", type=str, default="resnet101",
                   help="used only when no checkpoint is given")
    p.add_argument("--backbone_weights", type=str, default="",
                   help="torchvision state_dict (.pth) for the trunk when no "
                        "checkpoint is given")
    p.add_argument("--pipeline_depth", type=int, default=0,
                   help="dispatch/fetch queue depth; 0 = adaptive (the "
                        "InLoc controller, per-batch wall caps)")
    p.add_argument("--host_normalize", action="store_true",
                   help="upload host-normalized float images instead of the "
                        "default resized-uint8 + on-device normalization "
                        "(exact reference numerics; 4x the transfer bytes)")
    p.add_argument("--journal_dir", type=str, default="",
                   help="journal per-batch PCK contributions + run manifest "
                        "here; a rerun with the same settings resumes "
                        "mid-eval to a bitwise-identical result")
    p.add_argument("--query_retries", type=int, default=2,
                   help="per-batch retries after the first dispatch/fetch "
                        "failure, before quarantine")
    p.add_argument("--retry_backoff_s", type=float, default=0.5,
                   help="retry backoff seconds, doubled per attempt")
    p.add_argument("--decode_retries", type=int, default=1,
                   help="per-image transient decode retries (the eval twin "
                        "of train.py's flag)")
    p.add_argument("--quarantine", type=_str_to_bool, default=True,
                   help="exhausted retries quarantine the batch (its pairs "
                        "score invalid) instead of aborting the run")
    p.add_argument("--fetch_timeout_s", type=float, default=0.0,
                   help="watchdog around each result fetch; a hung fetch "
                        "becomes a retryable timeout (0 = off)")
    p.add_argument("--telemetry_dir", type=str, default="",
                   help="open a structured event log here (per-batch eval "
                        "events + metrics)")
    p.add_argument("--sparse_topk", type=int, default=0,
                   help="coarse-to-fine sparse matching: filter a pooled "
                        "coarse volume, keep the top-k candidate target "
                        "neighbourhoods per coarse source cell, and "
                        "evaluate fine correlation only there (0 = dense, "
                        "the default; README 'Coarse-to-fine matching')")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the model runs: cuda (the default; without a "
                        "GPU the run stops) or cpu")
    return p


def main(argv=None) -> int:
    print("NCNet evaluation script - PF Pascal dataset")
    args = build_parser().parse_args(argv)
    # deferred imports: --help and flag errors don't pay the torch startup
    from ncnet_tpu_torch.config import EvalPFPascalConfig, ModelConfig
    from ncnet_tpu_torch.evaluation import run_eval

    config = EvalPFPascalConfig(
        checkpoint=args.checkpoint,
        image_size=args.image_size,
        eval_dataset_path=args.eval_dataset_path,
        journal_dir=args.journal_dir,
        query_retries=args.query_retries,
        retry_backoff_s=args.retry_backoff_s,
        quarantine=args.quarantine,
        fetch_timeout_s=args.fetch_timeout_s,
        decode_retries=args.decode_retries,
        telemetry_dir=args.telemetry_dir,
        sparse_topk=args.sparse_topk,
    )
    stats = run_eval(
        config,
        model_config=ModelConfig(backbone=args.backbone,
                                 backbone_weights=args.backbone_weights),
        batch_size=args.batch_size,
        num_workers=args.num_workers,
        device_normalize=not args.host_normalize,
        pipeline_depth=args.pipeline_depth,
        device=args.device,
    )
    print("Total: " + str(stats["total"]))
    print("Valid: " + str(stats["valid"]))
    print("PCK:", "{:.2%}".format(stats["pck"]))
    degraded = False
    if stats.get("quarantined_batches"):
        print("Quarantined batches: " + str(stats["quarantined_batches"]))
        degraded = True
    if stats.get("decode_quarantined"):
        print("Undecodable images (pairs scored invalid): "
              + str(stats["decode_quarantined"]))
        degraded = True
    # degraded result: exit nonzero so CI / schedulers notice even though
    # the run itself survived
    return 2 if degraded else 0


if __name__ == "__main__":
    raise SystemExit(main())
