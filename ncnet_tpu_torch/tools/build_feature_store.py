"""Resumable bulk builder for the persistent database feature store, the
port of the root ``tools/build_feature_store.py``.

The InLoc database is fixed; its backbone features should be computed ONCE,
offline, instead of lazily during the first (cold) serving day.  This tool
walks a densePE shortlist's unique pano set and resolves every image
through the same ``matcher.prepare_db`` path the eval and serving tiers
read, on the card unless ``--device`` names another — so the committed
bytes are what a live miss would compute, and a later ``run_inloc_eval``
with ``feature_store_dir`` starts warm.

Robustness (the JAX tool's):

  * each pano builds under ``run_isolated`` — bounded retry + backoff,
    classified failures — and an exhausted budget QUARANTINES the pano
    into a per-stripe manifest
    (``<store_dir>/build_manifest.shard<i>_of_<n>.json``) instead of
    aborting the build;
  * resumable two ways: a completed unit in the manifest is skipped without
    even decoding, and a unit whose entry already sits in the store is a
    verified hit (the store's two-phase commits mean no torn entry can
    fool a rerun after a SIGKILL);
  * striping: ``--shard_index/--shard_count`` split the pano set across
    hosts, one manifest per stripe (entry commits are atomic and content-
    addressed, so double-building an overlapping pano is harmless).

The store's fingerprint carries the port's program token
(``store/feature_store.py::backbone_fingerprint``): a directory the JAX
tool built is a miss here and the other way round (ROADMAP D8).

Exit codes: 0 = every pano in this stripe built (or already present),
2 = quarantined panos remain (see the manifest).

Usage::

    python -m ncnet_tpu_torch.tools.build_feature_store --store_dir DIR \\
        --inloc_shortlist datasets/inloc/densePE_top100_shortlist_cvpr18.mat \\
        --pano_path datasets/inloc/pano/ --checkpoint <ckpt> \\
        [--image_size 3200] [--k_size 2] [--n_panos 10] [--budget_mb 0] \\
        [--shard_index 0 --shard_count 4] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Bulk-build the persistent database feature store from "
                    "an InLoc shortlist (resumable, per-shard manifests)")
    p.add_argument("--store_dir", required=True,
                   help="feature store root (shared across shards)")
    p.add_argument("--inloc_shortlist", type=str,
                   default="datasets/inloc/densePE_top100_shortlist_cvpr18"
                           ".mat")
    p.add_argument("--pano_path", type=str, default="datasets/inloc/pano/")
    p.add_argument("--checkpoint", type=str, default="")
    p.add_argument("--backbone", type=str, default="",
                   help="override the trunk when building without a "
                        "checkpoint (e.g. 'tiny' for the CPU smoke test); "
                        "default: the ModelConfig default")
    p.add_argument("--image_size", type=int, default=3200)
    p.add_argument("--k_size", type=int, default=2)
    p.add_argument("--n_panos", type=int, default=10,
                   help="shortlist depth per query (the eval's n_panos — "
                        "only these panos are ever read)")
    p.add_argument("--budget_mb", type=int, default=0,
                   help="LRU eviction budget in MiB (0 = unbounded; a bulk "
                        "build larger than the budget churns — size it)")
    p.add_argument("--shard_index", type=int, default=0)
    p.add_argument("--shard_count", type=int, default=1)
    p.add_argument("--retries", type=int, default=2)
    p.add_argument("--retry_backoff_s", type=float, default=0.5)
    p.add_argument("--no_gc", action="store_true",
                   help="skip superseded-generation GC on open")
    p.add_argument("--telemetry_dir", type=str, default="",
                   help="open a structured event log here (store events + "
                        "retry/quarantine; replay with run_report --store)")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the trunk runs (default cuda; cpu for the "
                        "tests)")
    return p


def unique_panos(shortlist_path: str, n_panos: int):
    """The de-duplicated pano name list a depth-``n_panos`` eval would ever
    read, in first-appearance order (deterministic across shards)."""
    from ncnet_tpu_torch.evaluation.inloc import _as_str, load_shortlist

    _, pano_fns = load_shortlist(shortlist_path)
    seen, out = set(), []
    for fns in pano_fns:
        for idx in range(min(n_panos, len(fns))):
            name = _as_str(fns[idx])
            if name not in seen:
                seen.add(name)
                out.append(name)
    return out


def load_model(args):
    """``(model_config, params)`` the builder runs: the checkpoint's, in
    bf16 at ``--k_size``, or ``init_ncnet`` at seed 1 (the port's own
    draw: it differs from the JAX tool's, so a shared index needs a
    checkpoint)."""
    from ncnet_tpu_torch.config import ModelConfig

    base = ModelConfig(checkpoint=args.checkpoint, half_precision=True,
                       relocalization_k_size=args.k_size,
                       **({"backbone": args.backbone} if args.backbone
                          else {}))
    if args.checkpoint:
        from ncnet_tpu_torch.models.checkpoint import load_params

        model_config, params = load_params(args.checkpoint, base)
        return model_config.replace(half_precision=True,
                                    relocalization_k_size=args.k_size), params
    from ncnet_tpu_torch.models.ncnet import init_ncnet

    return base, init_ncnet(base, seed=1)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    out = sys.stdout.write

    if not 0 <= args.shard_index < max(1, args.shard_count):
        raise SystemExit(f"shard_index {args.shard_index} out of range for "
                         f"shard_count {args.shard_count}")

    from ncnet_tpu_torch.data.datasets import load_image
    from ncnet_tpu_torch.evaluation.inloc import make_pair_matcher
    from ncnet_tpu_torch.evaluation.resilience import (
        FaultPolicy,
        RunManifest,
        run_isolated,
    )
    from ncnet_tpu_torch.models.ncnet import resolve_device
    from ncnet_tpu_torch.observability import events as obs_events
    from ncnet_tpu_torch.observability.memory import hbm_stats, is_oom
    from ncnet_tpu_torch.store import FeatureStore, backbone_fingerprint

    device = resolve_device(args.device)
    model_config, params = load_model(args)

    own_sink = None
    if args.telemetry_dir:
        from ncnet_tpu_torch.observability.events import EventLog

        log_name = ("events.jsonl" if args.shard_count <= 1 else
                    f"events.shard{args.shard_index}.jsonl")
        own_sink = EventLog(
            os.path.join(args.telemetry_dir, log_name),
            run_meta={"tool": "build_feature_store",
                      "shard_index": args.shard_index,
                      "shard_count": args.shard_count})
        obs_events.set_global_sink(own_sink)

    fingerprint = backbone_fingerprint(
        params, image_size=args.image_size, k_size=args.k_size, dtype="bf16",
        device=device)
    store = FeatureStore(args.store_dir, fingerprint,
                         budget_bytes=args.budget_mb * 2 ** 20,
                         scope="store_build")
    if not args.no_gc:
        store.gc_superseded()
    matcher = make_pair_matcher(
        model_config, params, do_softmax=True, both_directions=True,
        flip_direction=False, preprocess_image_size=args.image_size,
        store=store, device=device)

    panos = unique_panos(args.inloc_shortlist, args.n_panos)
    stripe = panos[args.shard_index::max(1, args.shard_count)]
    manifest = RunManifest(
        os.path.join(
            args.store_dir,
            f"build_manifest.shard{args.shard_index}"
            f"_of_{max(1, args.shard_count)}.json"),
        meta={"tool": "build_feature_store", "fingerprint": fingerprint,
              "shortlist": os.path.basename(args.inloc_shortlist),
              "n_panos": args.n_panos,
              "shard_index": args.shard_index,
              "shard_count": max(1, args.shard_count)})
    policy = FaultPolicy(retries=args.retries,
                         backoff_s=args.retry_backoff_s, quarantine=True)

    t0 = time.perf_counter()
    built = skipped = 0
    statuses = {"hit": 0, "miss": 0, "recompute": 0}
    for name in stripe:
        if manifest.is_completed(name):
            skipped += 1
            continue

        def work(name=name):
            raw = load_image(os.path.join(args.pano_path, name))[None]
            return matcher.prepare_db(raw)

        def on_failure(exc, kind, name=name):
            # the same program retries under the budget (ROADMAP D4: no
            # tier is demoted); the event records what the card said
            if kind == "device":
                obs_events.emit("device_failure", unit=name, oom=is_oom(exc),
                                hbm=hbm_stats())

        ok, prepared = run_isolated(name, work, policy=policy,
                                    manifest=manifest,
                                    on_failure=on_failure,
                                    label=f"pano {name}")
        if ok:
            built += 1
            statuses[prepared.status] = statuses.get(prepared.status, 0) + 1

    doc = {
        "tool": "build_feature_store",
        "fingerprint": fingerprint,
        "shard": f"{args.shard_index}/{max(1, args.shard_count)}",
        "stripe_panos": len(stripe),
        "built": built,
        "skipped_completed": skipped,
        "statuses": statuses,
        "quarantined": list(manifest.quarantined_ids),
        "store": store.flush_stats(tool="build_feature_store"),
        "wall_s": round(time.perf_counter() - t0, 3),
    }
    out(json.dumps(doc, sort_keys=True) + "\n")
    store.close()
    if own_sink is not None:
        obs_events.set_global_sink(None)
        own_sink.close()
    return 2 if manifest.quarantined_ids else 0


if __name__ == "__main__":
    raise SystemExit(main())
