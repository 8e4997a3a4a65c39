"""Resumable sharded builder for the retrieval tier's coarse-volume index,
the port of the root ``tools/build_coarse_index.py``.

The scatter-gather retrieval tier (``ncnet_tpu_torch/retrieval/``) serves
cached COARSE volumes — per-pano pooled descriptive grids 1/factor^4 the
size of dense features — out of the feature store.  This tool walks a
shortlist's unique pano set, computes each pano's coarse volume, commits
it under the coarse generation (``coarse_fingerprint``), and writes the
durable index manifest (``coarse_index.shard<i>_of_<n>.json``) mapping
pano names to content digests that shard hosts and the coordinator load.

Same robustness contract as ``build_feature_store``:

  * each pano builds under ``run_isolated`` — bounded retry + backoff,
    quarantine into the per-stripe run manifest instead of aborting;
    exit 2 while quarantined panos remain;
  * resumable two ways: a pano already in this stripe's index manifest is
    skipped without decoding, and a recomputed pano whose entry already
    sits in the store is a verified HIT (two-phase commits mean a rerun
    after a SIGKILL can never be fooled by a torn entry);
  * striping: ``--shard_index/--shard_count`` split the pano set across
    builder hosts; shard hosts later merge the per-stripe manifests
    (``load_index_manifests`` refuses mixed generations).

Extractors: ``--raw`` builds model-free color/gradient-statistics volumes
(numpy only: the fingerprint and the entry bytes equal the JAX tool's on
the same pixels, so a raw index is shared by both packages); the default
pools the trunk's features by ``--factor``, the trunk run on the card
(``--device``) through the port's ``make_pair_matcher(...).preprocess``.
A backbone index's fingerprint carries the port's program token
(``...-bf16-torch.cuda-c4``); ``run_inloc_eval`` of either package opens
the store under whatever fingerprint the index carries (ROADMAP D10).

The summary line adds ``stage_ms`` beside the JAX tool's keys: the
summed walls of the built panos' stages.  A backbone index books
``decode``, ``trunk`` (preprocess and features, synchronized),
``to_host`` (the features' device→host copy), ``pool`` (the numpy
pooling into coarse cells) and ``commit`` (the store's write); a raw
index books ``decode``, ``extract`` (the numpy extractor) and
``commit``.

Usage::

    python -m ncnet_tpu_torch.tools.build_coarse_index --store_dir DIR \\
        --inloc_shortlist .../densePE_top100_shortlist_cvpr18.mat \\
        --pano_path datasets/inloc/pano/ --factor 4 [--raw] \\
        [--checkpoint <ckpt> | --backbone tiny] [--n_panos 10] \\
        [--shard_index 0 --shard_count 4] [--telemetry_dir DIR] \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Build the coarse-volume retrieval index from an InLoc "
                    "shortlist (resumable, per-shard manifests)")
    p.add_argument("--store_dir", required=True,
                   help="feature store root for the coarse generation "
                        "(shared across builder shards)")
    p.add_argument("--inloc_shortlist", type=str,
                   default="datasets/inloc/densePE_top100_shortlist_cvpr18"
                           ".mat")
    p.add_argument("--pano_path", type=str, default="datasets/inloc/pano/")
    p.add_argument("--factor", type=int, default=4,
                   help="coarse pooling factor (rides the fingerprint and "
                        "the index manifest)")
    p.add_argument("--raw", action="store_true",
                   help="model-free extractor (numpy only, no trunk) — "
                        "the CPU chaos-suite path")
    p.add_argument("--raw_grid", type=int, default=16,
                   help="raw extractor's fine grid the factor pools from")
    p.add_argument("--checkpoint", type=str, default="")
    p.add_argument("--backbone", type=str, default="",
                   help="trunk override when building without a checkpoint "
                        "(e.g. 'tiny' for the CPU smoke test)")
    p.add_argument("--image_size", type=int, default=3200)
    p.add_argument("--k_size", type=int, default=2)
    p.add_argument("--n_panos", type=int, default=10)
    p.add_argument("--shard_index", type=int, default=0)
    p.add_argument("--shard_count", type=int, default=1)
    p.add_argument("--retries", type=int, default=2)
    p.add_argument("--retry_backoff_s", type=float, default=0.5)
    p.add_argument("--telemetry_dir", type=str, default="",
                   help="open a structured event log here (replay with "
                        "run_report --store)")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the backbone extractor's trunk runs (default "
                        "cuda; cpu for the tests); --raw uses none")
    return p


def raw_base_fingerprint(grid: int) -> str:
    """The model-free extractor's synthetic base fingerprint — same
    ``<weights>-s<size>-k<k>-<dtype>`` shape as a backbone fingerprint so
    the store's weights-segment GC semantics apply unchanged."""
    return f"raw-s{int(grid)}-k0-f32"


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    out = sys.stdout.write

    if not 0 <= args.shard_index < max(1, args.shard_count):
        raise SystemExit(f"shard_index {args.shard_index} out of range for "
                         f"shard_count {args.shard_count}")

    from ncnet_tpu_torch.data.datasets import load_image
    from ncnet_tpu_torch.evaluation.resilience import (
        FaultPolicy,
        RunManifest,
        run_isolated,
    )
    from ncnet_tpu_torch.observability import events as obs_events
    from ncnet_tpu_torch.retrieval.index import (
        load_index_manifests,
        write_index_manifest,
    )
    from ncnet_tpu_torch.retrieval.scoring import (
        coarse_volume_from_features,
        raw_coarse_volume,
    )
    from ncnet_tpu_torch.store import (
        FeatureStore,
        coarse_fingerprint,
        content_digest,
    )
    from ncnet_tpu_torch.tools.build_feature_store import unique_panos

    own_sink = None
    if args.telemetry_dir:
        from ncnet_tpu_torch.observability.events import EventLog

        log_name = ("events.jsonl" if args.shard_count <= 1 else
                    f"events.shard{args.shard_index}.jsonl")
        own_sink = EventLog(
            os.path.join(args.telemetry_dir, log_name),
            run_meta={"tool": "build_coarse_index",
                      "shard_index": args.shard_index,
                      "shard_count": args.shard_count})
        obs_events.set_global_sink(own_sink)

    if args.raw:
        extractor = "raw"
        base_fp = raw_base_fingerprint(args.raw_grid)
        stage_ms = {"decode": 0.0, "extract": 0.0, "commit": 0.0}

        def volume_of(raw):
            t = time.perf_counter()
            vol = raw_coarse_volume(raw, args.factor, grid=args.raw_grid)
            stage_ms["extract"] += (time.perf_counter() - t) * 1e3
            return vol
    else:
        import torch

        from ncnet_tpu_torch.evaluation.inloc import make_pair_matcher
        from ncnet_tpu_torch.models.ncnet import resolve_device
        from ncnet_tpu_torch.store import backbone_fingerprint
        from ncnet_tpu_torch.tools.build_feature_store import load_model

        extractor = "backbone"
        stage_ms = {"decode": 0.0, "trunk": 0.0, "to_host": 0.0,
                    "pool": 0.0, "commit": 0.0}
        device = resolve_device(args.device)
        model_config, params = load_model(args)
        base_fp = backbone_fingerprint(
            params, image_size=args.image_size, k_size=args.k_size,
            dtype="bf16", device=device)
        matcher = make_pair_matcher(
            model_config, params, do_softmax=True, both_directions=True,
            flip_direction=False, preprocess_image_size=args.image_size,
            device=device)

        def volume_of(raw):
            t = time.perf_counter()
            prepared = matcher.preprocess(raw[None])
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t1 = time.perf_counter()
            features = prepared.features.float().cpu().numpy()
            t2 = time.perf_counter()
            vol = coarse_volume_from_features(features, args.factor)
            stage_ms["trunk"] += (t1 - t) * 1e3
            stage_ms["to_host"] += (t2 - t1) * 1e3
            stage_ms["pool"] += (time.perf_counter() - t2) * 1e3
            return vol

    fingerprint = coarse_fingerprint(base_fp, args.factor)
    store = FeatureStore(args.store_dir, fingerprint, scope="coarse_build")
    shard_tag = f"shard{args.shard_index}_of_{max(1, args.shard_count)}"
    index_path = os.path.join(args.store_dir,
                              f"coarse_index.{shard_tag}.json")
    # fast-forward: panos already in this stripe's index manifest carry
    # their digest and are skipped without even decoding
    index_panos = {}
    if os.path.exists(index_path):
        try:
            prior = load_index_manifests(index_path)
            if prior["fingerprint"] == fingerprint \
                    and prior["factor"] == args.factor \
                    and prior["extractor"] == extractor:
                index_panos = dict(prior["panos"])
        except (OSError, ValueError):
            pass  # a foreign/torn manifest restarts the stripe, not the run

    panos = unique_panos(args.inloc_shortlist, args.n_panos)
    stripe = panos[args.shard_index::max(1, args.shard_count)]
    manifest = RunManifest(
        os.path.join(args.store_dir, f"coarse_manifest.{shard_tag}.json"),
        meta={"tool": "build_coarse_index", "fingerprint": fingerprint,
              "factor": args.factor, "extractor": extractor,
              "shortlist": os.path.basename(args.inloc_shortlist),
              "n_panos": args.n_panos,
              "shard_index": args.shard_index,
              "shard_count": max(1, args.shard_count)})
    policy = FaultPolicy(retries=args.retries,
                         backoff_s=args.retry_backoff_s, quarantine=True)

    t0 = time.perf_counter()
    built = skipped = 0
    for name in stripe:
        if name in index_panos:
            skipped += 1
            if not manifest.is_completed(name):
                manifest.complete(name)
            continue

        def work(name=name):
            t = time.perf_counter()
            raw = load_image(os.path.join(args.pano_path, name))
            digest = content_digest(raw)
            t1 = time.perf_counter()
            before = sum(stage_ms.values())
            store.resolve(digest, lambda raw=raw: volume_of(raw))
            computed = sum(stage_ms.values()) - before
            stage_ms["decode"] += (t1 - t) * 1e3
            stage_ms["commit"] += (time.perf_counter() - t1) * 1e3 - computed
            return digest

        ok, digest = run_isolated(name, work, policy=policy,
                                  manifest=manifest,
                                  label=f"pano {name}")
        if ok:
            built += 1
            index_panos[name] = digest
            write_index_manifest(
                index_path, fingerprint=fingerprint, factor=args.factor,
                extractor=extractor, panos=index_panos,
                meta={"shard_index": args.shard_index,
                      "shard_count": max(1, args.shard_count)})

    doc = {
        "tool": "build_coarse_index",
        "fingerprint": fingerprint,
        "extractor": extractor,
        "factor": args.factor,
        "shard": f"{args.shard_index}/{max(1, args.shard_count)}",
        "index": index_path,
        "stripe_panos": len(stripe),
        "built": built,
        "skipped_indexed": skipped,
        "quarantined": list(manifest.quarantined_ids),
        "store": store.flush_stats(tool="build_coarse_index"),
        "wall_s": round(time.perf_counter() - t0, 3),
        "stage_ms": {k: round(v, 3) for k, v in stage_ms.items()},
    }
    out(json.dumps(doc, sort_keys=True) + "\n")
    store.close()
    if own_sink is not None:
        obs_events.set_global_sink(None)
        own_sink.close()
    return 2 if manifest.quarantined_ids else 0


if __name__ == "__main__":
    raise SystemExit(main())
