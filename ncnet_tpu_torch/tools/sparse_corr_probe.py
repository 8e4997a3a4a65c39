"""Coarse-to-fine sparse correlation probe: per-k memory and wall
characterization of the sparse pipeline (B8 on the gathered tiles, B6 on
their 6⁴ NC stacks) against the dense filter.

Usage::

    python -m ncnet_tpu_torch.tools.sparse_corr_probe --k 1,2,4,8 --size 50 [--time] [--device cpu]
    python -m ncnet_tpu_torch.tools.sparse_corr_probe --tiny [--device cpu]

The port of ``tools/sparse_corr_probe.py``.  For each ``k`` it runs the
full sparse filter (coarse pass, top-k, gathered fine refinement:
``models/ncnet.py::coarse2fine_filter``) at the given feature shape and,
on the card, records the run's measured memory (the JAX tool's compiled
``memory_analysis()``; ROADMAP D9) as a ledger row of program
``sparse_corr_probe``, keyed per k, beside the dense filter's row at the
same shape; on the CPU none is measured.  The TPU gather tier's VMEM
verdict has no counterpart: bf16 features always take the B8 kernel
(``gather_tier``), f32 ones the plain gather.  ``--time``: walls, sparse
against dense (host clock around work that ends in a synchronise; on the
card only).  The report is one JSON line.

``--tiny``: every rung at a miniature shape, exit 1 on a parity failure:
the gather kernel against the plain gather tier (bitwise on the CPU,
where both are the twin; within 2⁻⁷ of the largest value in bf16 on the
card), k = full against the dense volume, a recall-vs-k curve monotone to
1.0, and the memory accounting path.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import List, Optional

import torch

from ncnet_tpu_torch.models.ncnet import resolve_device
from ncnet_tpu_torch.tools import _probe


def _out(text: str) -> None:
    sys.stdout.write(text)


def _err(text: str) -> None:
    sys.stderr.write(text)


GATHER_TOLERANCE = 2.0 ** -7


def _params_for(kernels, channels, key_seed=1, device="cpu"):
    return {"nc": _probe.init_stack(key_seed, kernels, channels,
                                    torch.device(device))}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def probe(args, dev) -> int:
    from ncnet_tpu_torch.config import ModelConfig
    from ncnet_tpu_torch.models.ncnet import coarse2fine_filter, ncnet_filter
    from ncnet_tpu_torch.observability import memory as obs_memory
    from ncnet_tpu_torch.ops.correlation import correlation_4d
    from ncnet_tpu_torch.ops.sparse_topk import patch_side, resolve_halo

    kernels = tuple(int(v) for v in args.kernels.split(","))
    channels = tuple(int(v) for v in args.channels.split(","))
    ks = [int(v) for v in args.k.split(",")]
    s, c_dim, b = args.size, args.c, args.batch
    halo = resolve_halo(args.halo, args.factor)
    patch = patch_side(args.factor, halo)
    dt = torch.bfloat16 if args.bf16 else torch.float32
    params = _params_for(kernels, channels, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    fa = (torch.randn((b, s, s, c_dim), generator=gen, device=dev)
          * 0.05).to(dt)
    fb = (torch.randn((b, s, s, c_dim), generator=gen, device=dev)
          * 0.05).to(dt)
    report = {
        "size": s, "channels": c_dim, "batch": b, "factor": args.factor,
        "halo": halo, "patch": patch, "dtype": str(dt).split(".")[-1],
        "device_kind": _probe.card_line(dev),
        "gather_tier": "kernel" if dt == torch.bfloat16 else "plain",
        "k": {},
    }
    cfg = ModelConfig(ncons_kernel_sizes=kernels, ncons_channels=channels,
                      half_precision=args.bf16, sparse_factor=args.factor,
                      sparse_halo=args.halo)

    def dense_fn():
        return ncnet_filter(cfg, params, correlation_4d(fa, fb)).corr

    def sparse_fn(k):
        return coarse2fine_filter(cfg.replace(sparse_topk=k), params, fa,
                                  fb).corr

    with torch.no_grad():
        try:
            _, dense_mem = _probe.measure_memory(dense_fn, dev, (fa, fb))
            report["dense"] = dense_mem
        except torch.cuda.OutOfMemoryError as e:
            report["dense"] = {"error": str(e)[:200]}
            dense_mem = None
        for k in ks:
            _, mem = _probe.measure_memory(lambda: sparse_fn(k), dev,
                                           (fa, fb))
            row = {"memory": mem}
            if mem is not None:
                obs_memory.record_program(
                    "sparse_corr_probe", f"{s}x{s}x{c_dim}xb{b}|k={k}|p={patch}",
                    analysis=mem, tier="coarse2fine", source="probe")
                if dense_mem and dense_mem.get("temp_bytes"):
                    row["temp_vs_dense"] = round(
                        mem["temp_bytes"] / dense_mem["temp_bytes"], 4)
            report["k"][k] = row

        if args.time and dev.type != "cuda":
            report["dense_wall_ms"] = None  # not measured: the CPU was asked for
            for k in ks:
                report["k"][k]["wall_ms"] = None
        elif args.time:
            def wall(fn):
                fn()  # warm-up
                _sync(dev)
                walls = []
                for _ in range(args.reps):
                    t0 = time.perf_counter()
                    fn()
                    _sync(dev)
                    walls.append((time.perf_counter() - t0) * 1e3)
                return round(statistics.median(walls), 3)

            report["dense_wall_ms"] = wall(dense_fn)
            for k in ks:
                report["k"][k]["wall_ms"] = wall(lambda: sparse_fn(k))

    _out(json.dumps(report, sort_keys=True, default=str) + "\n")
    return 0


def tiny(args, dev) -> int:
    """Every rung at a miniature shape; exit 1 on any parity failure."""
    import numpy as np

    from ncnet_tpu_torch.config import ModelConfig
    from ncnet_tpu_torch.models.ncnet import (
        coarse2fine_filter,
        ncnet_filter,
        ncnet_match_volume,
    )
    from ncnet_tpu_torch.ops import (
        candidate_recall,
        pool_features,
        sparse_fine_corr,
        topk_candidates,
    )
    from ncnet_tpu_torch.ops.correlation import correlation_4d
    from ncnet_tpu_torch.ops.norm import feature_l2_norm
    from ncnet_tpu_torch.ops.sparse_corr import (
        gather_source_patches,
        gather_tile_corr_pallas,
        source_patch_index,
    )
    from ncnet_tpu_torch.ops.sparse_topk import candidate_origins, patch_side

    rng = np.random.default_rng(7)
    b, s, c_dim, factor, halo = 1, 8, 16, 2, 2
    patch = patch_side(factor, halo)
    fa = feature_l2_norm(torch.from_numpy(
        rng.normal(size=(b, s, s, c_dim)).astype(np.float32)).to(dev))
    fb = feature_l2_norm(torch.from_numpy(
        rng.normal(size=(b, s, s, c_dim)).astype(np.float32)).to(dev))
    cfg = ModelConfig(backbone="tiny", ncons_kernel_sizes=(3, 3),
                      ncons_channels=(4, 1))
    params = _params_for(cfg.ncons_kernel_sizes, cfg.ncons_channels,
                         device=dev)
    n_cells = (s // factor) ** 2

    # 1) the gather kernel vs the plain gather tier: the kernel takes bf16,
    #    so on the card both run in bf16; on the CPU both are the twin
    cand = torch.from_numpy(
        rng.integers(0, n_cells, (b, n_cells, 3)).astype(np.int32)).to(dev)
    gfa, gfb = ((fa, fb) if dev.type == "cpu"
                else (fa.to(torch.bfloat16), fb.to(torch.bfloat16)))
    tiles = sparse_fine_corr(gfa.float(), gfb.float(), cand, factor=factor,
                             halo=halo)
    ia, ja = source_patch_index(s, s, factor, patch)
    oi, oj = candidate_origins(cand, s // factor, factor, patch, s, s)
    fa_p2 = gather_source_patches(gfa, ia, ja).reshape(
        b, n_cells, patch * patch, c_dim)
    v_k = gather_tile_corr_pallas(
        fa_p2, gfb, oi // factor, oj, patch=patch, factor=factor,
    ).reshape(tiles.values.shape)
    d = float((v_k.float() - tiles.values).abs().max())
    _out(f"gather kernel vs plain tier: max|diff| = {d}\n")
    bound = 0.0 if dev.type == "cpu" else GATHER_TOLERANCE * float(
        tiles.values.abs().max())
    if d > bound:
        _err("FAIL: gather tiers disagree\n")
        return 1

    # 2) k = full coverage reproduces the dense filtered volume
    with torch.no_grad():
        dense = ncnet_filter(cfg, params, correlation_4d(fa, fb)).corr
        sparse = ncnet_match_volume(
            cfg.replace(sparse_topk=n_cells, sparse_factor=factor,
                        sparse_halo=halo), params, fa, fb).corr
    d = float((dense - sparse).abs().max())
    _out(f"k=full sparse vs dense volume: max|diff| = {d}\n")
    if not torch.allclose(dense, sparse, atol=1e-5, rtol=1e-4):
        _err("FAIL: k=full does not reproduce the dense volume\n")
        return 1

    # 3) the recall-vs-k curve is monotone to 1.0
    with torch.no_grad():
        coarse = ncnet_filter(cfg, params, correlation_4d(
            pool_features(fa, factor), pool_features(fb, factor))).corr
        raw = correlation_4d(fa, fb)
    recalls = [candidate_recall(topk_candidates(coarse, k), raw, factor)
               for k in (1, 4, n_cells)]
    _out(f"recall @ k=1,4,full: {[round(r, 3) for r in recalls]}\n")
    if recalls[-1] != 1.0 or any(
            recalls[i] > recalls[i + 1] + 1e-9 for i in range(2)):
        _err("FAIL: recall curve not monotone to 1.0\n")
        return 1

    # 4) the memory accounting path (measured on the card only)
    cfg_k = cfg.replace(sparse_topk=2, sparse_factor=factor, sparse_halo=halo)
    with torch.no_grad():
        _, mem = _probe.measure_memory(
            lambda: coarse2fine_filter(cfg_k, params, fa, fb).corr, dev,
            (fa, fb))
    _out(f"sparse measured memory: "
         f"{'none measured (the CPU was asked for)' if mem is None else mem}\n")
    _out("tiny smoke: OK\n")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Per-k memory/wall probe of the coarse-to-fine sparse "
                    "correlation pipeline")
    ap.add_argument("--k", default="1,2,4,8",
                    help="comma-separated candidate counts to probe")
    ap.add_argument("--size", type=int, default=50,
                    help="fine feature grid side (50 = 2x the PF-Pascal "
                         "bench grid)")
    ap.add_argument("--c", type=int, default=256,
                    help="feature channels (1024 = resnet101 layer3)")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--factor", type=int, default=2)
    ap.add_argument("--halo", type=int, default=-1,
                    help="-1 = auto (one coarse ring)")
    ap.add_argument("--kernels", default="5,5,5")
    ap.add_argument("--channels", default="16,16,1")
    ap.add_argument("--bf16", action="store_true", default=True)
    ap.add_argument("--no-bf16", dest="bf16", action="store_false")
    ap.add_argument("--time", action="store_true",
                    help="measure walls (on the card)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--tiny", action="store_true",
                    help="miniature parity/recall/memory pass")
    _probe.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.tiny:
        return tiny(args, dev)
    return probe(args, dev)


if __name__ == "__main__":
    raise SystemExit(main())
