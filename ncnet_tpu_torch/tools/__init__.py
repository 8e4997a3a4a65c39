"""Probe tools of the port (the JAX package's ``tools/`` counterparts).

Each module runs from the repository root as a script on the card:

    python3 -m ncnet_tpu_torch.tools.pallas_l2_probe 8 bf16
    python3 -m ncnet_tpu_torch.tools.mosaic_probes [name ...]
    python3 -m ncnet_tpu_torch.tools.l2_variants [name ...]
    python3 -m ncnet_tpu_torch.tools.convert_images <dataset root>
    python3 -m ncnet_tpu_torch.tools.cp_decompose --checkpoint c --out o --rank R
    python3 -m ncnet_tpu_torch.tools.serve_backend --tiny [--device cpu]
    python3 -m ncnet_tpu_torch.tools.run_report events.jsonl [--pod ...]
    python3 -m ncnet_tpu_torch.tools.trace_export a.jsonl b.jsonl --federate
    python3 -m ncnet_tpu_torch.tools.stall_watchdog heartbeat.json | --url u
    python3 -m ncnet_tpu_torch.tools.perf_regress --check
    python3 -m ncnet_tpu_torch.tools.quality_drift --check events.jsonl
    python3 -m ncnet_tpu_torch.tools.serve_top http://host:port [--once]
    python3 -m ncnet_tpu_torch.tools.rollout http://host:port ckpt [--watch]
    python3 -m ncnet_tpu_torch.tools.stream_probe [--device cpu --tiny]
    python3 -m ncnet_tpu_torch.tools.serve_probe [--device cpu --tiny]

``pallas_l2_probe`` times the L2 layer's CUDA kernel in the padded
fused-lane frame; ``mosaic_probes`` builds and checks a battery of minimal
``sm_90a`` kernels, one Hopper primitive each; ``l2_variants`` times the
L2 kernel's design choices (its compile-time constants) against each
other.  They keep the JAX tools'
names so that a reader finds the counterpart, but they are CUDA: they run
on the card unless given ``device="cpu"`` (the tests), where only the plain
twins run.  ``convert_images`` (no JAX counterpart) writes the raw image
files the port's dataset reads from a JPEG tree, with PIL, on any host;
``cp_decompose`` attaches rank-R CP factors to a checkpoint's NC layers (on
the host, numpy); ``serve_backend`` runs one per-host match backend (a
``MatchService`` behind the introspection and wire planes) for a router.
The operator tools (``run_report`` to ``rollout``) read and drive a run's
records and live planes as the root ``tools/`` of the same names do, with
the same output, on hosts without JAX; ``stream_probe`` and
``serve_probe`` drive the port's service at full width on the card.
"""
