"""Run ONE retrieval shard host, the port of the root
``tools/serve_shard.py``: a ``ShardService`` over a coarse-volume store +
index, behind the ``/healthz``/``/metrics`` control plane and the
``POST /retrieve`` wire data plane (``ncnet_tpu_torch/retrieval/``).

This is the process a ``RetrievalCoordinator`` of either package scatters
to, and the process the retrieval chaos tests SIGKILL mid-sweep to prove
that replication turns shard death into lost capacity, not lost coverage.
A shard scores numpy volumes and does no device work: it never creates a
CUDA context.  Lifecycle contract (the JAX tool's):

  * on start it prints exactly ONE JSON line to stdout —
    ``{"url": ..., "pid": ..., "shard": ..., "assigned": ...}`` — and
    nothing else;
  * SIGTERM begins the coordinated drain: ``/healthz`` answers 503 so the
    coordinator demotes this host BEFORE it goes away; exits 0 STOPPED;
  * a fixed ``--port`` supports restart-in-place (a supervisor reviving a
    killed shard at the same address, which the coordinator's
    resurrection probes then re-admit).

The shard derives WHAT it serves from the index manifest + the rendezvous
assignment over ``--shards`` — no placement file, so every host spawned
with the same arguments agrees with the coordinator by construction.

Usage::

    python -m ncnet_tpu_torch.tools.serve_shard --shard-id s0 \\
        --shards s0,s1,s2,s3 --store /path/to/store \\
        --index 'coarse_index*.json' [--replication 2] [--topk 10] \\
        [--port 0] [--events ev.jsonl]
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="One retrieval shard host: ShardService + /healthz "
                    "control plane + /retrieve wire data plane")
    ap.add_argument("--shard-id", required=True)
    ap.add_argument("--shards", required=True,
                    help="comma-separated ids of the WHOLE shard set "
                         "(assignment is a pure function of this list)")
    ap.add_argument("--store", required=True,
                    help="feature-store root holding the coarse entries")
    ap.add_argument("--index", required=True,
                    help="coarse index manifest path or glob "
                         "(build_coarse_index output)")
    ap.add_argument("--replication", type=int, default=2)
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 = ephemeral (printed in the startup line); "
                         "fixed for the restart-in-place shape")
    ap.add_argument("--events", default=None,
                    help="bind this host's event log here (torn-tail "
                         "tolerant across SIGKILL)")
    args = ap.parse_args(argv)

    from ncnet_tpu_torch.observability import events as obs_events
    from ncnet_tpu_torch.retrieval import ShardService, load_index_manifests
    from ncnet_tpu_torch.store import FeatureStore

    if args.events:
        from ncnet_tpu_torch.observability import EventLog

        obs_events.set_global_sink(EventLog(args.events))

    shard_ids = [s for s in (t.strip() for t in args.shards.split(","))
                 if s]
    try:
        index = load_index_manifests(args.index)
    except (OSError, ValueError) as e:
        print(json.dumps({"error": f"index load failed: {e}"}), flush=True)
        return 1
    store = FeatureStore(args.store, index["fingerprint"], scope="coarse")
    service = ShardService(
        args.shard_id, shard_ids, index, store,
        replication=args.replication, default_topk=args.topk,
        introspect_host=args.host, introspect_port=args.port)
    service.start()
    if service.introspect_url is None:
        print(json.dumps({"error": f"failed to bind {args.host}:"
                          f"{args.port}"}), flush=True)
        service.stop()
        return 1

    def _sigterm(signum, frame):
        service.request_drain("sigterm")

    signal.signal(signal.SIGTERM, _sigterm)
    print(json.dumps({"url": service.introspect_url, "pid": os.getpid(),
                      "shard": service.shard_id,
                      "assigned": len(service.assigned)}), flush=True)
    try:
        while service.state not in ("STOPPED",):
            time.sleep(0.1)
            if service.state == "DRAINING":
                # give in-flight sweeps a beat to finish, then stop: the
                # coordinator has already demoted us off its scatter plan
                time.sleep(0.2)
                service.stop()
    except KeyboardInterrupt:
        service.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
