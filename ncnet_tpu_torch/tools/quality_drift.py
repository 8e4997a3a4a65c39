"""Match-quality drift sentinel, the port of the root
``tools/quality_drift.py``: gate a run's quality-signal distributions
against a reference (by default the committed ``perf/quality_ref.jsonl``).

The quality layer (``ncnet_tpu_torch/observability/quality.py``) streams per-pair
label-free signals — softmax score, match entropy, top1-top2 margin, hard
mutual-NN agreement, displacement coherence — into the event log as
``quality`` events tagged with the active fused tier.  This tool is the gate
on top, the accuracy twin of ``perf_regress``:

  * ``--check``: rebuild per-``(tier, signal)`` histogram digests from one
    or more event logs (binned exactly like the reference), score each
    against the committed reference distribution for the log's device kind
    with a PSI divergence (< 0.1 no shift, 0.1-0.25 moderate, > 0.25
    major — the default threshold), and **exit 1 on drift**.  A series
    of a device kind the reference does not hold is skipped, not judged
    (the committed file holds the JAX package's series only).  A bf16 tier
    promotion, a CP/FFT conv4d prototype, or a quarantine-degraded run that
    shifts match quality fails the job between labeled evals — this is the
    standing accuracy gate new kernel tiers run under (ROADMAP items 2-4).
  * ``--seed-ref``: (re)write the reference file from event logs of a CLEAN
    eval of the committed weights, or — with ``--synthetic`` — from the
    pinned deterministic synthetic PF-Pascal eval run on ``--device``
    (CUDA by default).

Usage::

    python -m ncnet_tpu_torch.tools.quality_drift --check events.jsonl [more.jsonl ...]
        [--ref perf/quality_ref.jsonl] [--threshold 0.25] [--json]
    python -m ncnet_tpu_torch.tools.quality_drift --seed-ref events.jsonl [--ref ...]
    python -m ncnet_tpu_torch.tools.quality_drift --seed-ref --synthetic [--ref ...]
        [--device cuda|cpu]

Exit codes: 0 = no drift (or seed OK; unjudgeable series are reported as
skipped, never guessed), 1 = drift detected, 2 = usage/input error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from ncnet_tpu_torch.observability.events import replay_events
from ncnet_tpu_torch.observability.quality import (
    DEFAULT_PSI_THRESHOLD,
    check_drift,
    default_reference_path,
    digests_from_events,
    load_reference,
    reference_binning,
    write_reference,
)

_out = sys.stdout.write
_err = sys.stderr.write

# the pinned synthetic fixture: what the committed reference was seeded from
# and what the tier-1 drift test replays.  Changing ANY of these re-defines
# the reference distribution — re-seed perf/quality_ref.jsonl in the same
# commit.
SYNTH_SEED = 11
SYNTH_PAIRS = 12
SYNTH_SCRAMBLED = 4          # trailing pairs whose target is unrelated
SYNTH_IMAGE_HW = (96, 96)
SYNTH_SHIFT = (16, 16)
SYNTH_BATCH = 2
# the coarse-to-fine tier's pinned fixture knobs: the same eval re-run with
# ModelConfig.sparse_topk = this k seeds/gates the "coarse2fine" series
# (6x6 feature grid -> 3x3 coarse grid; k=2 of 9 candidates).  The sparse
# fixture's shift is COARSE-ALIGNED (2 fine cells = 1 coarse cell at
# factor 2): the pooled coarse correlation is then crisp, top-k coverage
# contains the true cells, and the sparse confident pairs score PCK 1.0
# exactly like dense — the fixture demonstrates the lossless-under-coverage
# regime rather than the tiny 3x3 grid's pooling blur.
SYNTH_SPARSE_K = 2
SYNTH_SPARSE_SHIFT = (32, 32)


def synthetic_reference_run(workdir: str, perturb: bool = False,
                            sparse: bool = False, tier: str = "",
                            device=None):
    """Run the pinned deterministic synthetic PF-Pascal eval on ``device``
    (CUDA unless ``"cpu"`` is named; without a GPU it raises); returns
    ``(stats, events_path)``.

    The fixture mixes confident pairs (exact feature-cell shifts the
    identity NC stack recovers, PCK ~1) with scrambled pairs (unrelated
    target textures: diffuse match distributions, PCK ~0), so the
    signal-vs-PCK rank correlation is measurable and the reference
    distribution spans both regimes.  Everything is seed-pinned — dataset,
    trunk init, loader order — so two runs on one device produce the same
    signals.  The port's trunk init differs from the JAX package's at the
    same seed, and its device kind keys its own series, so its digests are
    never judged against the JAX package's.

    ``perturb=True`` coarsely quantizes the filtered volume before match
    extraction — the injected stand-in for a low-precision kernel-tier
    regression the drift gate must flag.

    ``sparse=True`` re-runs the same pinned fixture through the
    coarse-to-fine sparse pipeline (``ModelConfig.sparse_topk =
    SYNTH_SPARSE_K``): its quality events are tier-tagged ``coarse2fine``.

    ``tier="cp"`` attaches rank-1 CP factors to the NC params (the delta
    kernel is exactly rank 1, so ``choose_fused_stack`` selects "cp"
    naturally); ``tier="fft"`` forces the FFT tier via
    ``ModelConfig.nc_tier``.  Either way the quality events are tagged with
    the tier name, seeding that tier's own reference series.
    """
    import numpy as np
    import torch

    from ncnet_tpu_torch import models
    from ncnet_tpu_torch.config import EvalPFPascalConfig, ModelConfig
    from ncnet_tpu_torch.data.datasets import raw_path
    from ncnet_tpu_torch.data.synthetic import _textured_image, write_pf_pascal_like
    from ncnet_tpu_torch.evaluation import pf_pascal

    data = os.path.join(workdir, "data")
    shift = SYNTH_SPARSE_SHIFT if sparse else SYNTH_SHIFT
    write_pf_pascal_like(data, n_pairs=SYNTH_PAIRS, image_hw=SYNTH_IMAGE_HW,
                         shift=shift, seed=SYNTH_SEED)
    # scramble the trailing pairs' targets: unrelated texture, keypoints
    # kept — low PCK AND diffuse (low-confidence) match distributions; the
    # images are written raw, as the port's dataset reads them (ROADMAP D1)
    rng = np.random.default_rng(SYNTH_SEED + 1)
    h, w = SYNTH_IMAGE_HW
    for i in range(SYNTH_PAIRS - SYNTH_SCRAMBLED, SYNTH_PAIRS):
        np.save(raw_path(os.path.join(data, "images", f"test_{i}_b.jpg")),
                _textured_image(rng, h, w))

    cfg = ModelConfig(backbone="tiny", ncons_kernel_sizes=(3,),
                      ncons_channels=(1,))
    if sparse:
        cfg = cfg.replace(sparse_topk=SYNTH_SPARSE_K)
    if tier == "fft":
        cfg = cfg.replace(nc_tier="fft")
    net = models.NCNet(cfg, seed=0, device=device)
    iw = torch.zeros((3, 3, 3, 3, 1, 1), dtype=torch.float32)
    iw[1, 1, 1, 1, 0, 0] = 1.0
    net.params["nc"] = [{"w": iw.to(net.device),
                         "b": torch.zeros((1,), device=net.device)}]
    if tier == "cp":
        from ncnet_tpu_torch.ops.cp_als import decompose_stack

        net.params["nc"], _ = decompose_stack(net.params["nc"], 1)
    tdir = os.path.join(workdir, "telemetry")
    ecfg = EvalPFPascalConfig(eval_dataset_path=data, image_size=96,
                              telemetry_dir=tdir)
    # a fixture eval is NOT a perf datapoint: its walls/PCK must never be
    # ingested into the committed cross-run history the regression sentinel
    # gates on (the env knob is restored after the run)
    from ncnet_tpu_torch.observability.perfstore import STORE_ENV

    prev = os.environ.get(STORE_ENV)
    os.environ[STORE_ENV] = "off"
    forward = pf_pascal.ncnet_forward
    if perturb:
        def quantized(config, params, src, tgt):
            out = forward(config, params, src, tgt)
            # coarse value quantization of the filtered volume: the shape
            # of a numeric-precision regression (scores flatten, margins
            # shrink) without modeling any one kernel's exact rounding
            step = 0.05 * torch.max(torch.abs(out.corr))
            return out._replace(corr=torch.round(out.corr / step) * step)

        # the eval step calls the module's forward: swapped for this run
        pf_pascal.ncnet_forward = quantized
    try:
        stats = pf_pascal.run_eval(ecfg, net=net, batch_size=SYNTH_BATCH,
                                   num_workers=0, progress=False)
    finally:
        pf_pascal.ncnet_forward = forward
        if prev is None:
            os.environ.pop(STORE_ENV, None)
        else:
            os.environ[STORE_ENV] = prev
    return stats, os.path.join(tdir, "events.jsonl")


def perturbed_log(src: str, dst: str, shift: float = 0.35) -> None:
    """Write ``dst``: the event log ``src`` with every quality signal moved
    up by ``shift`` (clipped at 1), other lines byte for byte.  A reference
    seeded from it must turn ``--check`` of ``src`` red: the gate's
    positive control."""
    with open(src, "rb") as f:
        lines = f.read().split(b"\n")
    out = []
    for raw in lines:
        try:
            e = json.loads(raw)
        except ValueError:
            out.append(raw)
            continue
        if e.get("event") == "quality":
            e["signals"] = {k: [min(1.0, v + shift) for v in vs]
                            for k, vs in e["signals"].items()}
        out.append(json.dumps(e).encode())
    with open(dst, "wb") as f:
        f.write(b"\n".join(out))


def _load_logs(paths: List[str]):
    """Replay logs → (device_kind, events).  The device kind comes from the
    first header that names one — digests are only comparable within one
    backend, so it keys the reference lookup."""
    events: List[dict] = []
    device_kind: Optional[str] = None
    for path in paths:
        header, recs = replay_events(path)
        events.extend(recs)
        if device_kind is None:
            device_kind = (header.get("header") or {}).get("device_kind")
    return device_kind, events


def _render(findings: List[dict]) -> str:
    n_drift = sum(1 for f in findings if f["status"] == "drift")
    n_ok = sum(1 for f in findings if f["status"] == "ok")
    n_skip = sum(1 for f in findings if f["status"] == "skipped")
    lines = [f"=== quality_drift: {n_drift} drift(s), {n_ok} ok, "
             f"{n_skip} skipped ==="]
    for f in findings:
        tag = {"drift": "DRIFT", "ok": "ok", "skipped": "skipped"}[f["status"]]
        line = (f"[{tag}] {f['tier']}/{f['signal']} "
                f"({f['device_kind']}): n={f['count']}")
        if f.get("mean") is not None:
            line += f" mean={f['mean']:.4f}"
        if f["status"] == "skipped":
            line += f"  ({f['reason']})"
        else:
            line += (f"  psi={f['psi']:.4f} (threshold {f['threshold']}) "
                     f"ref: n={f['ref_count']} mean={f['ref_mean']:.4f}")
        lines.append(line)
    if not findings:
        lines.append("(no quality events in the given logs)")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Gate quality-signal distributions against the "
                    "committed reference")
    ap.add_argument("logs", nargs="*", help="events.jsonl file(s)")
    ap.add_argument("--ref", default=None,
                    help="reference file (default: perf/quality_ref.jsonl)")
    ap.add_argument("--check", action="store_true",
                    help="judge the logs' digests against the reference; "
                         "exit 1 on drift")
    ap.add_argument("--seed-ref", action="store_true",
                    help="(re)write the reference from the logs (or "
                         "--synthetic)")
    ap.add_argument("--synthetic", action="store_true",
                    help="with --seed-ref: run the pinned synthetic "
                         "eval on --device and seed from it")
    ap.add_argument("--device", default="cuda",
                    help="where --synthetic runs its eval (default cuda; "
                         "cpu for a host without a GPU)")
    ap.add_argument("--threshold", type=float, default=DEFAULT_PSI_THRESHOLD,
                    help=f"PSI drift threshold (default "
                         f"{DEFAULT_PSI_THRESHOLD})")
    ap.add_argument("--min-count", type=int, default=4,
                    help="samples required before judging a series "
                         "(default 4)")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as one JSON document")
    args = ap.parse_args(argv)

    ref_path = args.ref or default_reference_path()
    if not args.check and not args.seed_ref:
        _err("quality_drift: nothing to do (pass --check and/or "
             "--seed-ref)\n")
        return 2

    logs = list(args.logs)
    if args.seed_ref and args.synthetic:
        import tempfile

        work = tempfile.mkdtemp(prefix="quality_ref_")
        _err(f"running the pinned synthetic reference eval under {work}\n")
        _, events_path = synthetic_reference_run(work, device=args.device)
        # the same pinned fixture through the coarse-to-fine sparse
        # pipeline: seeds the "coarse2fine" tier's own reference series
        # beside the dense tiers' (one file carries every tier the tier-1
        # drift tests gate)
        work_sp = tempfile.mkdtemp(prefix="quality_ref_sparse_")
        _err("running the sparse (coarse2fine) synthetic reference eval "
             f"under {work_sp}\n")
        _, sparse_events = synthetic_reference_run(work_sp, sparse=True,
                                                   device=args.device)
        # the arithmetic conv4d tiers (CP factors chosen naturally by the
        # gate; FFT forced — see synthetic_reference_run) seed their own
        # series so quality_drift --check gates them like any kernel tier
        work_cp = tempfile.mkdtemp(prefix="quality_ref_cp_")
        _err(f"running the CP-tier synthetic reference eval under "
             f"{work_cp}\n")
        _, cp_events = synthetic_reference_run(work_cp, tier="cp",
                                               device=args.device)
        work_fft = tempfile.mkdtemp(prefix="quality_ref_fft_")
        _err(f"running the FFT-tier synthetic reference eval under "
             f"{work_fft}\n")
        _, fft_events = synthetic_reference_run(work_fft, tier="fft",
                                                device=args.device)
        logs = [events_path, sparse_events, cp_events, fft_events] + logs

    if not logs:
        _err("quality_drift: no event logs given\n")
        return 2
    try:
        device_kind, events = _load_logs(logs)
    except (OSError, ValueError) as e:
        _err(f"quality_drift: cannot replay logs: {e}\n")
        return 2

    if args.seed_ref:
        digests = digests_from_events(events)
        n = write_reference(
            ref_path, digests, device_kind=device_kind,
            meta={"logs": [os.path.basename(p) for p in logs]},
        )
        _err(f"seeded {n} reference series into {ref_path}\n")
        if not args.check:
            return 0

    reference = load_reference(ref_path)
    if not reference:
        _err(f"quality_drift: reference {ref_path} is missing or empty\n")
        return 2
    # bin the current run exactly like the reference per signal (the ref
    # self-describes its binning)
    current = digests_from_events(
        events, bins_like=reference_binning(reference))
    if not current:
        # an accuracy gate must never report green on zero evidence: a log
        # with no quality events means the emitter is broken or the wrong
        # file was passed — an input error, not a clean run
        _err("quality_drift: no quality events in the given logs — "
             "nothing to judge (broken emitter, or wrong events file?)\n")
        return 2
    findings = check_drift(reference, current, device_kind=device_kind,
                           threshold=args.threshold,
                           min_count=args.min_count)
    if args.json:
        _out(json.dumps({"ref": ref_path, "findings": findings},
                        indent=2, sort_keys=True) + "\n")
    else:
        _out(_render(findings))
    return 1 if any(f["status"] == "drift" for f in findings) else 0


if __name__ == "__main__":
    raise SystemExit(main())
