"""Open-loop streaming probe of the tracked match mode (serving/stream.py),
the port of the root ``tools/stream_probe.py``.

The streaming twin of ``serve_probe``.  Drives N concurrent camera streams
of jittered/bursty frames through ``MatchService.stream_submit`` against a
tracking-feasible bucket, injects one scene cut per stream, and reports:

  1. **Steady-frame walls** — latency percentiles of the TRACKED path
     (temporal candidates, coarse pass skipped, reference features
     resolved once per stream) vs the per-frame coarse-to-fine wall at
     the SAME shape.
  2. **Cut recovery** — the injected cut's fallback-frame wall (the exact
     coarse-to-fine re-seed) and the first tracked frame after it.
  3. **Skip accounting** — the coarse-skip fraction, the engine's
     ``coarse_passes`` spy delta over the steady segment (the fallback
     frames' only: tracked frames pay none), the kernels' launch counts
     over the cold and the steady segment (``ops/nc_fused_lane.launches``
     for B6, ``ops/sparse_corr.launches`` for B8; both stay 0 on the CPU,
     where only the plain twins run), and the stream-session digest/
     feature-cache effectiveness.
  4. **Replayability** — per-stream seq ordering and the frame-outcome
     identity (frames == tracked + fallback + cold) recomputed from the
     event log alone, the ``run_report`` discipline.

The model runs on ``--device``: CUDA unless ``cpu`` is named; without a
GPU it raises.

Usage::

    python -m ncnet_tpu_torch.tools.stream_probe [--tiny] [--streams 2]
        [--frames 14] [--rate 8.0] [--side 192] [--device cuda|cpu]
        [--json out.json]

``--tiny`` runs the CPU-sized smoke configuration (tiny backbone, 96 px).
Without it the model is the full-width one: ResNet-101, the (5, 5, 5) /
(16, 16, 1) bf16 NC stack, ``sparse_topk=4`` (random weights from seed 0).
Output: one JSON document (stdout, plus ``--json`` path).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Any, Dict, List


def _percentiles(xs: List[float]) -> Dict[str, float]:
    import numpy as np

    if not xs:
        return {}
    return {
        "p50": round(float(np.percentile(xs, 50)), 3),
        "p95": round(float(np.percentile(xs, 95)), 3),
        "p99": round(float(np.percentile(xs, 99)), 3),
        "mean": round(float(np.mean(xs)), 3),
        "n": len(xs),
    }


def _steady_launches(cfg, dev, cold: Dict[str, int], cold_passes: int,
                     tracked: int, passes: int) -> Dict[str, int]:
    """The kernel launches the steady segment's structure gives.  A tracked
    dispatch runs the fine pass alone, in both match directions: one B8
    gather and one B6 launch a layer of the NC stack each way.  A coarse
    pass (a fallback frame's) launches what a cold frame's did.  The bf16
    kernels launch only on a card, for a bf16 model."""
    kernels = dev.type == "cuda" and cfg.half_precision
    per_tracked = {"gather_tile_corr_bf16": 2 if kernels else 0,
                   "nc_conv4d_bf16": (2 * len(cfg.ncons_kernel_sizes)
                                      if kernels else 0)}
    return {k: per_tracked[k] * tracked
            + cold[k] // max(1, cold_passes) * passes for k in cold}


def probe(tiny: bool = False, streams: int = 2, frames: int = 14,
          rate_hz: float = 8.0, side: int = 192,
          events_path: str = "", device=None) -> Dict[str, Any]:
    import warnings

    import numpy as np
    import torch

    from ncnet_tpu_torch import models
    from ncnet_tpu_torch.config import ModelConfig
    from ncnet_tpu_torch.models.ncnet import resolve_device
    from ncnet_tpu_torch.observability import EventLog
    from ncnet_tpu_torch.observability import events as obs_events
    from ncnet_tpu_torch.ops import nc_fused_lane, sparse_corr
    from ncnet_tpu_torch.serving import MatchService, ServingConfig
    from ncnet_tpu_torch.serving.stream import run_stream_load

    dev = resolve_device(device)

    def launches() -> Dict[str, int]:
        return {"nc_conv4d_bf16": nc_fused_lane.launches,
                "gather_tile_corr_bf16": sparse_corr.launches}

    def since(before: Dict[str, int]) -> Dict[str, int]:
        return {k: v - before[k] for k, v in launches().items()}

    if tiny:
        cfg = ModelConfig(backbone="tiny", ncons_kernel_sizes=(3,),
                          ncons_channels=(1,), sparse_topk=4,
                          sparse_factor=2)
        side = min(side, 96)
    else:
        cfg = ModelConfig(ncons_kernel_sizes=(5, 5, 5),
                          ncons_channels=(16, 16, 1),
                          half_precision=True, backbone_bf16=True,
                          sparse_topk=4, sparse_factor=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # random-trunk warning: timing only
        params = models.init_ncnet(cfg, seed=0)

    scfg = ServingConfig(
        max_queue=128, max_batch=4, max_in_flight_per_client=256,
        buckets=((side, side),), max_buckets=2,
        warm_buckets=((side, side),), slo_ms=10_000.0)
    events_path = events_path or os.path.join(
        tempfile.mkdtemp(prefix="stream_probe_"), "events.jsonl")

    cut_at = max(frames * 2 // 3, 2)
    rng = np.random.default_rng(23)
    refs = [rng.integers(0, 255, (side, side, 3), dtype=np.uint8)
            for _ in range(streams)]
    # pre-generated (frame_fn runs on per-stream threads): small jitter
    # around the reference = steady frame, one unrelated image = the cut
    tgts = [[(rng.integers(0, 255, (side, side, 3), dtype=np.uint8)
              if fi == cut_at else
              np.clip(refs[si].astype(np.int16)
                      + rng.integers(-3, 4, refs[si].shape),
                      0, 255).astype(np.uint8))
             for fi in range(frames)]
            for si in range(streams)]

    out: Dict[str, Any] = {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else dev.type),
        "tiny": tiny, "side": side,
        "streams": streams, "frames_per_stream": frames,
        "rate_hz": rate_hz, "cut_at": cut_at,
        "events_path": events_path,
    }
    with obs_events.bound(EventLog(events_path)):
        service = MatchService(cfg, params, scfg, devices=[str(dev)]).start()
        try:
            eng = service._pool.replicas[0].engine
            out["tracking_feasible"] = bool(
                eng.tracking_feasible((side, side), (side, side)))
            # one cold frame per stream, then spy-count the steady segment
            # the warm-up dispatches run before READY: count after them
            deadline = time.monotonic() + 600.0
            while service.state != "READY" and time.monotonic() < deadline:
                time.sleep(0.01)
            cp0, l0 = eng.coarse_passes, launches()
            for si in range(streams):
                service.stream_submit(f"cam{si}", refs[si], tgts[si][0])
            out["coarse_passes_cold"] = eng.coarse_passes - cp0
            out["launches_cold"] = since(l0)
            cp0, td0, l0 = (eng.coarse_passes, eng.tracked_dispatches,
                            launches())
            recs = run_stream_load(
                service, lambda si, fi: (refs[si], tgts[si][fi + 1]),
                streams=streams, frames=frames - 1, rate_hz=rate_hz,
                jitter=0.3, burst_every=4, seed=23)
            served = [r for r in recs if r["outcome"] == "result"]
            steady = [r["wall_ms"] for r in served
                      if r["tracked"] and not r["fallback"]]
            cuts = [r["wall_ms"] for r in served if r["fallback"]]
            out["steady_wall_ms"] = _percentiles(steady)
            out["cut_recovery_ms"] = _percentiles(cuts)
            out["coarse_skip_pct"] = round(
                100.0 * len(steady) / max(len(served), 1), 2)
            # fallback frames + any post-cut re-seed pay exactly one
            # coarse pass each; steady tracked frames pay zero
            out["launches_steady"] = since(l0)
            out["tracked_dispatches_steady"] = eng.tracked_dispatches - td0
            out["coarse_passes_steady_delta"] = eng.coarse_passes - cp0
            out["launches_steady_expected"] = _steady_launches(
                cfg, dev, out["launches_cold"], out["coarse_passes_cold"],
                out["tracked_dispatches_steady"],
                out["coarse_passes_steady_delta"])
            out["expected_coarse_passes"] = len(served) - len(steady)
            out["tracked_dispatches"] = eng.tracked_dispatches
            out["recall"] = _percentiles(
                [r["recall"] for r in served if r["recall"] is not None])
            # the reference: the SAME pairs through the plain per-frame
            # coarse-to-fine path
            c2f = []
            for i in range(6):
                r = service.submit(
                    refs[i % streams],
                    tgts[i % streams][1 + i % (cut_at - 1)]
                ).result(timeout=600)
                c2f.append(r.wall_s * 1e3)
            out["c2f_frame_ms"] = _percentiles(c2f)
            out["steady_below_c2f"] = bool(
                steady and out["steady_wall_ms"]["p50"]
                < out["c2f_frame_ms"]["p50"])
            doc = service.health()
            out["streams_doc"] = {
                k: doc["streams"][k]
                for k in ("frames", "tracked_frames", "fallback_frames",
                          "cold_frames", "active")}
            out["slo_budget_burn_pct"] = doc["slo"]["budget_burn_pct"]
        finally:
            service.stop()

    # replay: ordering + the frame-outcome identity from the log alone
    _, events = obs_events.replay_events(events_path)
    frames_ev = [e for e in events if e.get("event") == "stream_frame"]
    per: Dict[str, List[int]] = {}
    for e in frames_ev:
        per.setdefault(e["stream"], []).append(e["seq"])
    out["replay_ordering_ok"] = all(
        seqs == sorted(seqs) and len(set(seqs)) == len(seqs)
        for seqs in per.values())
    kinds = [e.get("kind") for e in frames_ev]
    out["replay_outcome_identity_ok"] = (
        len(frames_ev)
        == kinds.count("tracked") + kinds.count("fallback")
        + kinds.count("cold"))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiny", action="store_true",
                    help="CPU-sized smoke configuration (tiny trunk, 96px)")
    ap.add_argument("--streams", type=int, default=2)
    ap.add_argument("--frames", type=int, default=14)
    ap.add_argument("--rate", type=float, default=8.0)
    ap.add_argument("--side", type=int, default=192)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (default cuda)")
    ap.add_argument("--json", default="", help="also write the document here")
    args = ap.parse_args(argv)

    doc = probe(tiny=args.tiny, streams=args.streams, frames=args.frames,
                rate_hz=args.rate, side=args.side, device=args.device)
    text = json.dumps(doc, indent=2, sort_keys=True)
    print(text)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
