"""Run ONE per-host match backend, the port of the root
``tools/serve_backend.py``: a resident ``MatchService`` behind the
introspection server's ``/healthz``/``/metrics`` control plane and
``POST /match`` wire data plane (``ncnet_tpu_torch/serving/wire.py``).

This is the process a ``serving/router.py::MatchRouter`` of either package
fans out to, and the process the multi-host chaos tests SIGKILL, restart
and drain.  Lifecycle contract (the JAX tool's):

  * on start it prints exactly ONE JSON line to stdout —
    ``{"url": "http://host:port", "pid": ...}`` — and nothing else
    (spawners block on that line to learn the ephemeral port);
  * SIGTERM begins the coordinated drain: the service finishes admitted
    work while its ``/healthz`` answers 503, so the fronting router
    demotes this host out of routing BEFORE the drain completes; the
    process exits 0 once STOPPED;
  * a fixed ``--port`` supports the restart-in-place shape (a supervisor
    reviving a killed host at the same address, which the router's
    resurrection probes then re-admit).

Engines: ``--tiny`` builds the real tiny-trunk model (random weights from
seed 0) on ``--device`` (CUDA unless ``cpu`` is named; a backend started
for the card that finds no GPU raises); ``--fake-engine`` substitutes the
chaos suite's deterministic fake device (``--latency`` per batch).
``--events`` binds the host's own event log (torn-tail tolerant, so a
SIGKILLed host's log still replays).

Usage::

    python -m ncnet_tpu_torch.tools.serve_backend [--port 0]
        [--host 127.0.0.1] [--tiny | --fake-engine] [--replicas N]
        [--latency 0.02] [--max-queue 64] [--max-batch 4]
        [--bucket-side 32] [--events events.jsonl] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time


class FakeEngine:
    """The chaos suite's device stand-in: real service and replica code
    paths, deterministic ``(B, 6, 16)`` tables, no model."""

    half_precision = False

    def __init__(self, latency_s: float = 0.02):
        self.latency_s = latency_s

    @staticmethod
    def split(table):
        from ncnet_tpu_torch.serving import BatchMatchEngine

        return BatchMatchEngine.split(table)

    def dispatch(self, src, tgt):
        from ncnet_tpu_torch.utils import faults

        faults.device_error_hook("fake_serve")
        return (src.shape[0], time.monotonic())

    def fetch(self, handle):
        import numpy as np

        b, t0 = handle
        while time.monotonic() - t0 < self.latency_s:
            time.sleep(0.005)
        table = np.zeros((b, 6, 16), np.float32)
        table[:, 4, :] = 1.0
        table[:, 5, :5] = [0.5, 0.1, 0.4, 0.9, 0.8]
        return table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="One per-host match backend: MatchService + /healthz "
                    "control plane + /match wire data plane")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="introspection/data-plane port (0 = ephemeral, "
                         "printed in the startup JSON line; fixed for the "
                         "restart-in-place shape)")
    ap.add_argument("--tiny", action="store_true",
                    help="real tiny-trunk engines")
    ap.add_argument("--fake-engine", action="store_true",
                    help="deterministic fake device — the process-level "
                         "chaos configuration")
    ap.add_argument("--replicas", type=int, default=1,
                    help="engines in this host's pool (fake or real)")
    ap.add_argument("--latency", type=float, default=0.02,
                    help="fake-engine seconds per batch")
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--bucket-side", type=int, default=32,
                    help="square bucket side (fixed single-bucket ladder)")
    ap.add_argument("--events", default=None,
                    help="bind this host's event log here (torn-tail "
                         "tolerant across SIGKILL)")
    ap.add_argument("--device", default="cuda",
                    help="the --tiny engines' device: cuda (every card, "
                         "round-robin), cuda:N, or cpu")
    args = ap.parse_args(argv)
    if args.tiny == args.fake_engine:
        ap.error("give exactly one of --tiny / --fake-engine")

    from ncnet_tpu_torch.observability import events as obs_events
    from ncnet_tpu_torch.serving import MatchService, ServingConfig

    if args.events:
        from ncnet_tpu_torch.observability import EventLog

        obs_events.set_global_sink(EventLog(args.events))

    side = int(args.bucket_side)
    serving_kw = dict(
        max_queue=args.max_queue, max_batch=args.max_batch,
        max_in_flight_per_client=max(args.max_queue, 64),
        bucket_multiple=side, max_image_side=side,
        buckets=((side, side),), max_buckets=2,
        install_sigterm=True,
        introspect_host=args.host, introspect_port=args.port,
    )
    n = max(1, args.replicas)
    if args.fake_engine:
        service = MatchService(
            engine=[FakeEngine(latency_s=args.latency) for _ in range(n)],
            serving=ServingConfig(**serving_kw))
    else:
        from ncnet_tpu_torch.config import ModelConfig
        from ncnet_tpu_torch.models.ncnet import init_ncnet, resolve_device

        devices = None
        if args.device != "cuda":
            devices = [resolve_device(args.device)] * n
        cfg = ModelConfig(backbone="tiny", ncons_kernel_sizes=(3,),
                          ncons_channels=(1,), half_precision=False)
        service = MatchService(cfg, init_ncnet(cfg, seed=0), ServingConfig(
            **serving_kw, replicas=n, warm_buckets=((side, side),)),
            devices=devices)

    service.start()
    if service.introspect_url is None:
        print(json.dumps({"error": f"failed to bind {args.host}:"
                          f"{args.port}"}), flush=True)
        service.stop()
        return 1
    print(json.dumps({"url": service.introspect_url, "pid": os.getpid()}),
          flush=True)
    # serve until a drain (SIGTERM via the service's handler, or a stop()
    # from another thread) runs to completion; the poll keeps the main
    # thread interruptible for the signal handler
    try:
        while service.state != "STOPPED":
            time.sleep(0.1)
            if service.state == "DRAINING":
                # join the worker's drain so exit is clean and ordered
                service.stop()
    except KeyboardInterrupt:
        service.stop(drain=False)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
