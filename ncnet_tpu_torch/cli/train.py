"""CLI for weak-supervision training, the port of ``ncnet_tpu/cli/train.py``:

    python -m ncnet_tpu_torch.cli.train --dataset_image_path <root> \
        --dataset_csv_path <root>/image_pairs/ [--checkpoint <weights|root>]

Flag names and defaults are the JAX CLI's (which mirror the reference's,
train.py:34-47), plus ``--device`` (default ``cuda``; ``cpu`` trains on the
host).  The dataset's images are read in their raw form (ROADMAP decision
D1: ``tools/convert_images.py`` writes them from a JPEG tree).
``--checkpoint`` takes a reference ``.pth.tar``, a native directory, or a
root written by an earlier run, which resumes it in place (its newest
complete version: params, Adam state, step and loader position); SIGTERM
or SIGINT checkpoint at the next step and exit cleanly.

Data parallelism over N GPUs of a host is one process a GPU under torchrun
(ROADMAP D7); ``--batch_size`` stays the global batch:

    torchrun --nproc_per_node=N -m ncnet_tpu_torch.cli.train ...
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Compute PF Pascal matches")
    p.add_argument("--checkpoint", type=str, default="")
    p.add_argument("--image_size", type=int, default=400)
    p.add_argument("--dataset_image_path", type=str, default="datasets/pf-pascal/",
                   help="path to PF Pascal dataset")
    p.add_argument("--dataset_csv_path", type=str,
                   default="datasets/pf-pascal/image_pairs/",
                   help="path to PF Pascal training csv")
    p.add_argument("--num_epochs", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--lr", type=float, default=0.0005)
    p.add_argument("--ncons_kernel_sizes", nargs="+", type=int, default=[5, 5, 5],
                   help="kernels sizes in neigh. cons.")
    p.add_argument("--ncons_channels", nargs="+", type=int, default=[16, 16, 1],
                   help="channels in neigh. cons")
    p.add_argument("--result_model_fn", type=str, default="checkpoint_adam")
    p.add_argument("--result-model-dir", dest="result_model_dir", type=str,
                   default="trained_models")
    p.add_argument("--fe_finetune_params", type=int, default=0,
                   help="number of backbone blocks to finetune")
    p.add_argument("--finetune_cp_rank", type=int, default=0,
                   help="decompose the (loaded) NC kernels to rank-R CP "
                        "factors and fine-tune the FACTORS with the trunk "
                        "frozen (the tools/cp_decompose.py recipe); 0 = dense "
                        "training")
    p.add_argument("--backbone", type=str, default="resnet101")
    p.add_argument("--backbone_weights", type=str, default="",
                   help="torchvision state_dict (.pth) to initialize the trunk "
                        "(the reference always starts from ImageNet weights)")
    p.add_argument("--num_workers", type=int, default=0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--half_precision", action="store_true",
                   help="bf16 volume + NC weights during training")
    p.add_argument("--remat_nc_layers", action="store_true",
                   help="rematerialize each NC layer in the backward "
                        "(less activation memory, more compute)")
    p.add_argument("--nc_custom_grad", action="store_true",
                   help="conv4d custom backward: less backward temp "
                        "memory (the other memory knob)")
    p.add_argument("--accum_chunks", type=int, default=-1,
                   help="volume-chunked gradient accumulation (frozen trunk "
                        "only): -1 auto (default), 0 whole-batch backward, "
                        ">1 explicit chunk count")
    p.add_argument("--fold_pos_neg", action="store_true",
                   help="run the positive+negative volumes through ONE "
                        "2B-batch NC-filter call instead of two B-sized "
                        "calls (identical math; only applies with "
                        "--accum_chunks 0 — the chunked path already folds "
                        "the 2B volume batch)")
    p.add_argument("--no_nc_pallas_vjp", action="store_true",
                   help="disable the NC stack's backward kernel (B3, the "
                        "training default where the shape class is "
                        "compiled) and differentiate the conv4d "
                        "formulations with autograd")
    # fault tolerance (see the training/train.py module docstring)
    p.add_argument("--checkpoint_steps", type=int, default=0,
                   help="also checkpoint every N train steps (atomic "
                        "step_<N> versions with a mid-epoch resume "
                        "position); 0 = epoch-end saves only")
    p.add_argument("--keep_checkpoints", type=int, default=3,
                   help="retention window of step_<N> checkpoint versions "
                        "(the best_ copy is separate and never pruned)")
    p.add_argument("--max_bad_steps", type=int, default=3,
                   help="abort after this many CONSECUTIVE non-finite-loss "
                        "steps (each one is skipped, keeping the bad batch "
                        "out of Adam state)")
    p.add_argument("--no_nan_guard", action="store_true",
                   help="disable the non-finite-loss guard (a NaN then "
                        "poisons Adam state, as in the reference)")
    p.add_argument("--decode_retries", type=int, default=1,
                   help="transient per-image decode retries before a sample "
                        "is quarantined")
    p.add_argument("--fail_on_bad_samples", action="store_true",
                   help="crash on an undecodable image instead of "
                        "quarantining it and substituting the next healthy "
                        "sample")
    # observability (README "Observability")
    p.add_argument("--no_telemetry", action="store_true",
                   help="disable the structured event log + heartbeat + "
                        "device snapshots (on by default; replay the log "
                        "with tools/run_report.py)")
    p.add_argument("--telemetry_dir", type=str, default="",
                   help="where the event log + heartbeat live (default: "
                        "<checkpoint root>/telemetry, so crash/resume "
                        "cycles of one lineage share one log)")
    p.add_argument("--device", type=str, default="cuda",
                   help="the device to train on ('cpu' runs on the host)")
    return p


def config_from_args(args: argparse.Namespace):
    """The :class:`TrainConfig` the CLI trains with."""
    from ncnet_tpu_torch.config import ModelConfig, TrainConfig

    return TrainConfig(
        model=ModelConfig(
            backbone=args.backbone,
            backbone_weights=args.backbone_weights,
            ncons_kernel_sizes=tuple(args.ncons_kernel_sizes),
            ncons_channels=tuple(args.ncons_channels),
            checkpoint=args.checkpoint,
            half_precision=args.half_precision,
        ),
        image_size=args.image_size,
        dataset_image_path=args.dataset_image_path,
        dataset_csv_path=args.dataset_csv_path,
        num_epochs=args.num_epochs,
        batch_size=args.batch_size,
        lr=args.lr,
        result_model_fn=args.result_model_fn,
        result_model_dir=args.result_model_dir,
        fe_finetune_params=args.fe_finetune_params,
        finetune_cp_rank=args.finetune_cp_rank,
        seed=args.seed,
        num_workers=args.num_workers,
        remat_nc_layers=args.remat_nc_layers,
        nc_custom_grad=args.nc_custom_grad,
        accum_chunks=args.accum_chunks,
        fold_pos_neg=args.fold_pos_neg,
        nc_pallas_vjp=not args.no_nc_pallas_vjp,
        checkpoint_steps=args.checkpoint_steps,
        keep_checkpoints=args.keep_checkpoints,
        max_bad_steps=args.max_bad_steps,
        nan_guard=not args.no_nan_guard,
        decode_retries=args.decode_retries,
        quarantine_decode_errors=not args.fail_on_bad_samples,
        telemetry=not args.no_telemetry,
        telemetry_dir=args.telemetry_dir,
    )


def main(argv=None) -> int:
    print("ImMatchNet training script")
    args = build_parser().parse_args(argv)
    print(args)

    from ncnet_tpu_torch.training import fit

    fit(config_from_args(args), device=args.device)
    print("Done!")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
