"""CP / FFT arithmetic-tier probe: per-rank, per-shape measured memory and
walls of the tiers against the dense filter.

Usage::

    python -m ncnet_tpu_torch.tools.cp_fft_probe --ranks 4,8,16,32 --size 25 [--time] [--device cpu]
    python -m ncnet_tpu_torch.tools.cp_fft_probe --tiny [--device cpu]

The port of ``tools/cp_fft_probe.py``:

  * for each CP rank: decompose the probe's weights
    (``ops/cp_als.py::decompose_stack``), run the forced-CP stack at the
    given volume shape and, on the card, record its measured memory (the
    JAX tool's compiled ``memory_analysis()``; ROADMAP D9) as a ledger row
    of program ``cp_fft_probe``, keyed per rank, beside the dense stack's
    row at the same shape, with the arithmetic gate's verdict
    (``cp_feasible``): where the chooser would take the tier;
  * the FFT tier likewise (``fft_feasible`` and the forced-FFT row);
  * ``--time``: walls of each tier and of the dense stack (host clock
    around work that ends in a synchronise; on the card only).

Every stack is one pass of the port's ``models/ncnet.py::
neigh_consensus``: the dense one with ``allow_pallas=False`` (the conv4d
formulations, B5 for the 16 → 1 layer), the tiers through ``force_tier``.
The report is one JSON line.

``--tiny``: rank-full CP and FFT parity against the dense conv4d at
miniature shapes, the gates' directions at the production architectures,
and the 25⁴ / k = 5 memory row (the CP chain's temp bytes below the dense
stack's at the default rank), which is measured on the card and skipped,
with a line saying so, on the CPU.  Exit codes: 0 OK, 1 a tiny-mode
failure, 2 usage.
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


def _params_for(kernels, channels, key_seed=1, device="cpu"):
    return _probe.init_stack(key_seed, kernels, channels,
                             torch.device(device))


def _stack_fn(tier):
    """``(params, corr) → filtered``: one pass of ``neigh_consensus``
    through one tier."""
    from ncnet_tpu_torch.models.ncnet import neigh_consensus

    if tier == "dense":
        return lambda p, corr: neigh_consensus(p, corr, symmetric=False,
                                               allow_pallas=False)
    return lambda p, corr: neigh_consensus(p, corr, symmetric=False,
                                           force_tier=tier)


def _cast(params, dt):
    return [{k: (v.to(dt) if k != "cp" else {f: t.to(dt)
                                             for f, t in v.items()})
             for k, v in p.items()} for p in params]


def probe(args, dev) -> int:
    from ncnet_tpu_torch.observability import memory as obs_memory
    from ncnet_tpu_torch.ops.conv4d_cp import cp_feasible
    from ncnet_tpu_torch.ops.conv4d_fft import fft_feasible
    from ncnet_tpu_torch.ops.cp_als import decompose_stack

    kernels = tuple(int(v) for v in args.kernels.split(","))
    channels = tuple(int(v) for v in args.channels.split(","))
    ranks = [int(v) for v in args.ranks.split(",")]
    s, b = args.size, args.batch
    dt = torch.bfloat16 if args.bf16 else torch.float32
    params = _cast(_params_for(kernels, channels, device=dev), dt)
    corr = (torch.randn((b, s, s, s, s),
                        generator=torch.Generator(device=dev).manual_seed(0),
                        device=dev) * 0.05).to(dt)
    report = {
        "size": s, "batch": b, "kernels": list(kernels),
        "channels": list(channels), "dtype": str(dt).split(".")[-1],
        "device_kind": _probe.card_line(dev),
        "fft_feasible": fft_feasible(s, s, s, s, kernels, channels),
        "ranks": {},
    }

    def mem(tier, p, shape_cls):
        with torch.no_grad():
            _, row = _probe.measure_memory(lambda: _stack_fn(tier)(p, corr),
                                           dev, (corr,))
        if row is not None:
            obs_memory.record_program(
                "cp_fft_probe", shape_cls, analysis=row,
                tier="xla" if tier == "dense" else tier, source="probe")
        return row

    dense_mem = report["dense"] = mem("dense", params, f"{s}^4xb{b}|dense")

    def vs_dense(row):
        if dense_mem and row and dense_mem.get("temp_bytes"):
            return round(row["temp_bytes"] / dense_mem["temp_bytes"], 4)
        return None

    cp_params = {}
    for rank in ranks:
        row = {"cp_feasible": cp_feasible(s, s, s, s, kernels, channels,
                                          (rank,) * len(kernels))}
        p_cp, errs = decompose_stack(params, rank, iters=args.iters)
        cp_params[rank] = p_cp = _cast(p_cp, dt)
        row["rel_errs"] = [round(e, 4) for e in errs]
        row["memory"] = mem("cp", p_cp, f"{s}^4xb{b}|cp|r={rank}")
        row["temp_vs_dense"] = vs_dense(row["memory"])
        report["ranks"][rank] = row
    fft_mem = mem("fft", params, f"{s}^4xb{b}|fft")
    report["fft"] = {"memory": fft_mem, "temp_vs_dense": vs_dense(fft_mem)}

    if args.time and dev.type != "cuda":
        report["dense_wall_ms"] = None  # not measured: the CPU was asked for
    elif args.time:
        def wall(p, tier):
            fn = _stack_fn(tier)
            with torch.no_grad():
                fn(p, corr)  # warm-up
                torch.cuda.synchronize(dev)
                walls = []
                for _ in range(args.reps):
                    t0 = time.perf_counter()
                    fn(p, corr)
                    torch.cuda.synchronize(dev)
                    walls.append((time.perf_counter() - t0) * 1e3)
            return round(statistics.median(walls), 3)

        report["dense_wall_ms"] = wall(params, "dense")
        for rank in ranks:
            report["ranks"][rank]["wall_ms"] = wall(cp_params[rank], "cp")
        report["fft"]["wall_ms"] = wall(params, "fft")

    _out(json.dumps(report, sort_keys=True, default=str) + "\n")
    return 0


def tiny(args, dev) -> int:
    """Parity, the gates' directions and the 25⁴ / k = 5 memory row."""
    import numpy as np

    from ncnet_tpu_torch.ops.conv4d import conv4d
    from ncnet_tpu_torch.ops.conv4d_cp import (
        DEFAULT_CP_RANK,
        cp_apply_layer,
        cp_feasible,
        exact_cp_factors,
    )
    from ncnet_tpu_torch.ops.conv4d_fft import conv4d_fft, fft_feasible
    from ncnet_tpu_torch.ops.cp_als import decompose_stack

    rng = np.random.default_rng(7)

    # 1) rank-full CP and FFT parity vs the dense conv4d
    for (ha, wa, hb, wb), k, c_in, c_out in (
            ((6, 6, 6, 6), 3, 2, 3), ((5, 5, 5, 5), 5, 1, 2)):
        x = torch.from_numpy(
            rng.normal(size=(1, ha, wa, hb, wb, c_in)).astype(np.float32)
        ).to(dev)
        w = torch.from_numpy(rng.normal(
            size=(k, k, k, k, c_in, c_out)).astype(np.float32) * 0.2).to(dev)
        b_ = torch.from_numpy(
            rng.normal(size=(c_out,)).astype(np.float32)).to(dev)
        with torch.no_grad():
            ref = conv4d(x, w, b_)
            d_cp = float((cp_apply_layer(x, exact_cp_factors(w), b_)
                          - ref).abs().max())
            d_fft = float((conv4d_fft(x, w, b_) - ref).abs().max())
        _out(f"k={k} parity: rank-full CP {d_cp:.2e}, FFT {d_fft:.2e}\n")
        if d_cp > 1e-4 or d_fft > 1e-4:
            _err("FAIL: arithmetic tier parity vs dense conv4d\n")
            return 1

    # 2) the gates' directions at the production architectures
    k5, c5 = (5, 5, 5), (16, 16, 1)
    checks = (
        fft_feasible(25, 25, 25, 25, k5, c5),
        not fft_feasible(25, 25, 25, 25, (3, 3, 3), (10, 10, 1)),
        cp_feasible(25, 25, 25, 25, k5, c5, (DEFAULT_CP_RANK,) * 3),
        not cp_feasible(6, 6, 6, 6, (3,), (2,), (3 ** 4 * 2,)),
    )
    _out(f"gate direction (fft k5, !fft k3, cp r16, !cp rank-full): "
         f"{list(checks)}\n")
    if not all(checks):
        _err("FAIL: a gate verdict points the wrong way\n")
        return 1

    # 3) the memory row: CP at the default rank vs dense, 25⁴ / k = 5
    if dev.type != "cuda":
        _out("memory not measured on the CPU: the acceptance row is "
             "measured on the card\n")
        _out("tiny smoke: OK\n")
        return 0
    from ncnet_tpu_torch.observability import memory as obs_memory

    params = _params_for(k5, c5, device=dev)
    params_cp, _ = decompose_stack(params, DEFAULT_CP_RANK, iters=2)
    corr = torch.zeros((1, 25, 25, 25, 25), device=dev)
    with torch.no_grad():
        _, dense_mem = _probe.measure_memory(
            lambda: _stack_fn("dense")(params, corr), dev, (corr,))
        _, cp_mem = _probe.measure_memory(
            lambda: _stack_fn("cp")(params_cp, corr), dev, (corr,))
    obs_memory.record_program("cp_fft_probe", "25^4xb1|dense",
                              analysis=dense_mem, tier="xla", source="probe")
    obs_memory.record_program("cp_fft_probe", f"25^4xb1|cp|r={DEFAULT_CP_RANK}",
                              analysis=cp_mem, tier="cp", source="probe")
    _out(f"25^4/k=5 temp bytes: dense {dense_mem['temp_bytes']:,} "
         f"vs cp r{DEFAULT_CP_RANK} {cp_mem['temp_bytes']:,}\n")
    if cp_mem["temp_bytes"] >= dense_mem["temp_bytes"]:
        _err("FAIL: CP temp bytes not below dense at 25^4/k=5\n")
        return 1
    _out("tiny smoke: OK\n")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Per-rank/per-shape memory and wall probe of the CP and "
                    "FFT conv4d tiers vs the dense filter")
    ap.add_argument("--ranks", default="4,8,16,32",
                    help="comma-separated CP ranks to probe")
    ap.add_argument("--size", type=int, default=25,
                    help="volume side (25 = the PF-Pascal bench grid)")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--kernels", default="5,5,5")
    ap.add_argument("--channels", default="16,16,1")
    ap.add_argument("--iters", type=int, default=20,
                    help="ALS sweeps per decomposition")
    ap.add_argument("--bf16", action="store_true", default=True)
    ap.add_argument("--no-bf16", dest="bf16", action="store_false")
    ap.add_argument("--time", action="store_true",
                    help="measure walls (on the card)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--tiny", action="store_true",
                    help="parity/gates/memory-row pass at miniature shapes")
    _probe.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.tiny:
        return tiny(args, dev)
    return probe(args, dev)


if __name__ == "__main__":
    raise SystemExit(main())
