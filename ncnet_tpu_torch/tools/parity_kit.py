"""Real-weights parity kit: one command from a released checkpoint to
evidence, on the port.

The port of ``tools/parity_kit.py``, with its commands and formats:

  1. PCK on real data (the reference's quality bar)::

        python -m ncnet_tpu_torch.tools.parity_kit \\
            --torch_checkpoint trained_models/ncnet_pfpascal.pth.tar \\
            --dataset datasets/pf-pascal [--device cpu]

  2. A per-stage trace for cross-framework diffing::

        python -m ncnet_tpu_torch.tools.parity_kit --torch_checkpoint ... \\
            --dataset ... --record_trace ours.npz [--pairs 5]

     writes, for each of the first N test pairs, arrays named
     ``<stage>_<i>``: ``feature_A`` / ``feature_B`` (L2-normed trunk
     features, NHWC), ``corr_raw`` (the 4D correlation, (1,hA,wA,hB,wB)),
     ``corr_filtered`` (after MutualMatching → NC → MutualMatching) and
     ``matches`` ((5, N): xA, yA, xB, yB, score from ``corr_to_matches``
     with softmax, B → A), the JAX kit's names and layouts, so that a trace
     either package writes diffs against the other's.

  3. Diff two traces::

        python -m ncnet_tpu_torch.tools.parity_kit --compare ours.npz theirs.npz

     prints each stage's max abs diff and fails (exit 1) above
     ``--tolerance``; traces covering different stages fail unless
     ``--allow_missing``.

  4. The runbook, everything above as one command::

        python -m ncnet_tpu_torch.tools.parity_kit --all \\
            --pfpascal_checkpoint trained_models/ncnet_pfpascal.pth.tar \\
            --ivd_checkpoint trained_models/ncnet_ivd.pth.tar \\
            --dataset datasets/pf-pascal

     Per checkpoint: imports it through the port's loader
     (``models/checkpoint.py``: the legacy ``'vgg'`` → ``'model'`` rekey,
     the architecture from the stored args), prints the architecture, and
     checks the activations: the reference's whole forward restated in
     plain PyTorch (``tools/reference_twin.py``, on the CPU) against the
     port's forward on the device, with the checkpoint's own weights on a
     fixed synthetic pair.  With ``--dataset`` it runs the PF-Pascal eval
     on the pfpascal checkpoint and prints PCK@0.1 beside the reference's
     reported 78.9 % (BASELINE.md: reported by the paper, not reproduced
     here).  Exit 1 when an activation check exceeds its tolerance or,
     with ``--expect_pck``, PCK lands below it.

The dataset is read as the port reads it: raw images beside the JPEGs
(ROADMAP D1; ``python -m ncnet_tpu_torch.tools.convert_images <root>``).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from ncnet_tpu_torch.models.ncnet import resolve_device
from ncnet_tpu_torch.tools import _probe


def build_net(torch_checkpoint: str, device):
    from ncnet_tpu_torch.config import ModelConfig
    from ncnet_tpu_torch.models.ncnet import NCNet

    return NCNet(ModelConfig(checkpoint=torch_checkpoint), device=device)


def run_pck(net, dataset: str, image_size: int, progress: bool) -> dict:
    from ncnet_tpu_torch.config import EvalPFPascalConfig
    from ncnet_tpu_torch.evaluation.pf_pascal import run_eval

    cfg = EvalPFPascalConfig(eval_dataset_path=dataset,
                             image_size=image_size)
    return run_eval(cfg, net=net, progress=progress)


def record_trace(net, dataset: str, image_size: int, out_path: str,
                 n_pairs: int) -> None:
    from ncnet_tpu_torch.data import PFPascalDataset
    from ncnet_tpu_torch.models.ncnet import extract_features, ncnet_filter
    from ncnet_tpu_torch.ops.correlation import correlation_4d
    from ncnet_tpu_torch.ops.matching import corr_to_matches

    config, params, dev = net.config, net.params, net.device

    @torch.no_grad()
    def stages(src, tgt):
        fa = extract_features(config, params, src)
        fb = extract_features(config, params, tgt)
        if config.half_precision:
            fa16, fb16 = fa.to(torch.bfloat16), fb.to(torch.bfloat16)
        else:
            fa16, fb16 = fa, fb
        corr = correlation_4d(fa16, fb16)
        out = ncnet_filter(config, params, corr)
        m = corr_to_matches(out.corr.float(), do_softmax=True)
        return {
            "feature_A": fa, "feature_B": fb, "corr_raw": corr.float(),
            "corr_filtered": out.corr.float(),
            "matches": torch.stack([m.xA, m.yA, m.xB, m.yB, m.score])[:, 0],
        }

    ds = PFPascalDataset(
        csv_file=f"{dataset.rstrip('/')}/image_pairs/test_pairs.csv",
        dataset_path=dataset, output_size=(image_size, image_size),
        pck_procedure="scnet")
    arrays = {}
    n = min(n_pairs, len(ds))
    for i in range(n):
        sample = ds[i]
        got = stages(
            torch.as_tensor(np.asarray(sample["source_image"])[None]).to(dev),
            torch.as_tensor(np.asarray(sample["target_image"])[None]).to(dev))
        for k, v in got.items():
            arrays[f"{k}_{i}"] = v.cpu().numpy()
    np.savez_compressed(out_path, **arrays)
    print(f"recorded {len(arrays)} arrays ({n} pairs) to {out_path}")


def compare_traces(ours_path: str, theirs_path: str, tolerance: float,
                   allow_missing: bool = False) -> int:
    ours = np.load(ours_path)
    theirs = np.load(theirs_path)
    common = sorted(set(ours.files) & set(theirs.files))
    if not common:
        print(f"no common arrays between {ours_path} and {theirs_path}")
        return 1
    missing = sorted(set(ours.files) ^ set(theirs.files))
    if missing:
        print(f"{len(missing)} arrays present in only one trace: "
              f"{missing[:6]}{'...' if len(missing) > 6 else ''}")
        if not allow_missing:
            # a truncated trace must not read as a confirmed parity claim
            print("FAIL: traces cover different stages "
                  "(pass --allow_missing to diff the intersection only)")
            return 1
    worst = 0.0
    for k in common:
        a, b = ours[k], theirs[k]
        if a.shape != b.shape:
            print(f"{k:>20}: SHAPE MISMATCH {a.shape} vs {b.shape}")
            worst = float("inf")
            continue
        d = float(np.max(np.abs(a.astype(np.float64) - b.astype(np.float64)))) \
            if a.size else 0.0
        rel = d / (float(np.max(np.abs(b))) + 1e-12)
        print(f"{k:>20}: max_abs_diff {d:.3e}   rel {rel:.3e}")
        worst = max(worst, d)
    print(f"worst max_abs_diff: {worst:.3e} (tolerance {tolerance:g})")
    return 0 if worst <= tolerance else 1


def twin_activation_check(torch_checkpoint: str, net, image_size: int = 96,
                          tolerance: float = 2e-3) -> bool:
    """The reference's whole forward, restated in plain PyTorch
    (``reference_twin.torch_full_forward``, on the CPU), with the
    checkpoint's own weights, against the port's f32 forward on the net's
    device, on a fixed synthetic pair.  True on agreement within
    ``tolerance`` of the twin's largest value."""
    from ncnet_tpu_torch.models.checkpoint import split_reference_state_dict
    from ncnet_tpu_torch.models.ncnet import ncnet_forward
    from ncnet_tpu_torch.tools.reference_twin import torch_full_forward

    if net.config.backbone != "resnet101" or \
            net.config.backbone_last_layer not in ("", "layer3"):
        print("  twin check skipped: the twin covers the reference's "
              f"resnet101[:layer3] trunk, checkpoint has "
              f"{net.config.backbone}[{net.config.backbone_last_layer}]")
        return True
    if not os.path.isfile(torch_checkpoint):
        print("  twin check skipped: not a torch .pth.tar "
              "(a native checkpoint has no reference-layout state_dict)")
        return True

    ckpt = torch.load(torch_checkpoint, map_location="cpu",
                      weights_only=False)
    # the loader's own parsing (rekey, trunk split, NC enumeration)
    trunk_sd, nc_raw = split_reference_state_dict(ckpt["state_dict"],
                                                  net.config)
    # stored Conv4d layout (kA, C_out, C_in, kWA, kB, kWB) → the twin's
    # conv3d-loop layout (C_out, C_in, kA, kWA, kB, kWB)
    nc_layers = [
        (torch.from_numpy(np.ascontiguousarray(
            np.transpose(w, (1, 2, 0, 3, 4, 5)))), torch.from_numpy(b))
        for w, b in nc_raw]

    rng = np.random.default_rng(11)
    src = rng.standard_normal((1, 3, image_size, image_size)).astype(
        np.float32) * 0.4
    tgt = rng.standard_normal((1, 3, image_size, image_size)).astype(
        np.float32) * 0.4
    with torch.no_grad():
        ref = torch_full_forward(trunk_sd, nc_layers, torch.from_numpy(src),
                                 torch.from_numpy(tgt))[:, 0].numpy()
        cfg32 = net.config.replace(half_precision=False, backbone_bf16=False,
                                   relocalization_k_size=1)
        ours = ncnet_forward(
            cfg32, net.params,
            torch.from_numpy(np.transpose(src, (0, 2, 3, 1))).to(net.device),
            torch.from_numpy(np.transpose(tgt, (0, 2, 3, 1))).to(net.device),
        ).corr.float().cpu().numpy()
    diff = float(np.max(np.abs(ours - ref)))
    scale = float(np.max(np.abs(ref))) + 1e-12
    ok = diff / scale <= tolerance
    print(f"  twin activation check: max_abs_diff {diff:.3e} "
          f"(rel {diff / scale:.3e}) vs tolerance {tolerance:g} → "
          f"{'PASS' if ok else 'FAIL'}")
    return ok


def run_all(args, device) -> int:
    """The ``--all`` runbook (the module docstring's item 4)."""
    failed = False
    pck_ran = False
    for label, ckpt_path in (("pfpascal", args.pfpascal_checkpoint),
                             ("ivd", args.ivd_checkpoint)):
        if not ckpt_path:
            print(f"[{label}] no checkpoint given — skipped")
            continue
        print(f"[{label}] importing {ckpt_path}")
        net = build_net(ckpt_path, device)
        last = net.config.backbone_last_layer or (
            "layer3" if net.config.backbone == "resnet101" else "default-cut")
        print(f"  arch: backbone={net.config.backbone}[{last}] "
              f"ncons_kernel_sizes={list(net.config.ncons_kernel_sizes)} "
              f"ncons_channels={list(net.config.ncons_channels)}")
        if not twin_activation_check(ckpt_path, net,
                                     tolerance=args.twin_tolerance):
            failed = True
        if label == "pfpascal" and args.dataset:
            res = run_pck(net, args.dataset, args.image_size,
                          progress=not args.quiet)
            pck_ran = True
            print(f"  PCK@0.1: {res['pck'] * 100:.2f}%  "
                  f"({res['valid']}/{res['total']} valid pairs)  "
                  f"[reference-reported target: ⚠ 78.9%, BASELINE.md]")
            if args.expect_pck is not None and \
                    res["pck"] * 100 < args.expect_pck:
                print(f"  FAIL: PCK below --expect_pck {args.expect_pck}")
                failed = True
        elif label == "pfpascal":
            print("  PCK skipped: pass --dataset <pf-pascal root> to run it")
    if args.expect_pck is not None and not pck_ran:
        # the requested gate must not pass un-evaluated
        print("FAIL: --expect_pck given but the PCK eval never ran "
              "(need the pfpascal checkpoint AND --dataset)")
        failed = True
    return 1 if failed else 0


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--torch_checkpoint", help=".pth.tar (or a native "
                                              "checkpoint directory)")
    p.add_argument("--dataset", help="PF-Pascal root (images + image_pairs/)")
    p.add_argument("--image_size", type=int, default=400)
    p.add_argument("--record_trace", metavar="OUT_NPZ",
                   help="record per-stage outputs instead of running PCK")
    p.add_argument("--pairs", type=int, default=5,
                   help="pairs to trace with --record_trace")
    p.add_argument("--compare", nargs=2, metavar=("OURS", "THEIRS"),
                   help="diff two trace files; no model/data needed")
    p.add_argument("--tolerance", type=float, default=1e-2,
                   help="max allowed per-stage abs diff for --compare")
    p.add_argument("--allow_missing", action="store_true",
                   help="--compare: diff only the intersection instead of "
                        "failing when the traces cover different stages")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--all", action="store_true",
                   help="the full runbook (docstring item 4)")
    defaults = {
        "pfpascal_checkpoint": "trained_models/ncnet_pfpascal.pth.tar",
        "ivd_checkpoint": "trained_models/ncnet_ivd.pth.tar",
    }
    p.add_argument("--pfpascal_checkpoint",
                   default=defaults["pfpascal_checkpoint"],
                   help="--all: released PF-Pascal checkpoint")
    p.add_argument("--ivd_checkpoint", default=defaults["ivd_checkpoint"],
                   help="--all: released IVD checkpoint")
    p.add_argument("--twin_tolerance", type=float, default=2e-3,
                   help="--all: relative tolerance of the twin activation "
                        "check")
    p.add_argument("--expect_pck", type=float, default=None,
                   help="--all: fail (exit 1) when PCK%% lands below this")
    _probe.add_device_arg(p)
    args = p.parse_args(argv)

    if args.all:
        for a, default in defaults.items():
            path = getattr(args, a)
            if path and not os.path.exists(path):
                if path != default:
                    # an explicit path that does not exist is a typo, not a
                    # skip
                    p.error(f"--{a} {path}: file not found")
                setattr(args, a, "")
        if not args.pfpascal_checkpoint and not args.ivd_checkpoint:
            p.error("--all: no checkpoint found; pass --pfpascal_checkpoint "
                    "/ --ivd_checkpoint (trained_models/download.sh fetches "
                    "them where there is network)")
        return run_all(args, resolve_device(args.device))
    if args.compare:
        return compare_traces(args.compare[0], args.compare[1],
                              args.tolerance,
                              allow_missing=args.allow_missing)
    if not args.torch_checkpoint or not args.dataset:
        p.error("--torch_checkpoint and --dataset are required "
                "(unless using --compare)")
    net = build_net(args.torch_checkpoint, resolve_device(args.device))
    if args.record_trace:
        record_trace(net, args.dataset, args.image_size, args.record_trace,
                     args.pairs)
        return 0
    res = run_pck(net, args.dataset, args.image_size,
                  progress=not args.quiet)
    print(f"PCK: {res['pck']:.4f}  ({res['valid']}/{res['total']} valid pairs)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
