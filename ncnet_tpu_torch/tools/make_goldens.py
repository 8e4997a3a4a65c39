"""Record the frozen-weight activation goldens with the port, and check
them against the committed ones.

Usage::

    python -m ncnet_tpu_torch.tools.make_goldens --out record.npz [--device cpu]
    python -m ncnet_tpu_torch.tools.make_goldens --check [--golden path] [--device cpu]

The port of ``tools/make_goldens.py``.  Drift detection without released
weights uses self-goldens: fixed deterministic weights and fixed inputs
give recorded outputs, so a change to the numerics of the trunk, the
correlation, mutual matching, conv4d, match extraction, dense SIFT or P3P
shows as a golden mismatch.

:func:`deterministic_params` fills the port's parameter tree with the
values the JAX tool draws: one numpy generator (seed 1234), leaves in the
JAX pytree order (dict keys sorted, lists in order), each leaf drawn at
its JAX layout's shape (a trunk conv's HWIO) and moved to the port's
(OIHW), BatchNorm variances kept positive.  The record has the JAX tool's
keys.  It is written to ``--out`` (the committed
``tests/goldens/activations.npz`` is the JAX tool's and is never
overwritten here); ``--check`` compares the record with the committed
goldens at the JAX golden test's tolerances (``tests/test_goldens.py``:
rtol 1e-5 / atol 1e-6 for the tiny forward and its matches, the offsets
equal; rtol 1e-4 / atol 1e-5 for the ResNet-101 features and dense SIFT;
rtol 1e-6 / atol 1e-8 for P3P, which runs on the host) and prints, for
each key, its largest deviation and the atol it needs at its rtol.  The
card needs no other tolerance: on an NVIDIA H100 with TF32 off for
float32 matmuls and convolutions (as the caller sets it) every key meets
the CPU's.
"""

from __future__ import annotations

import argparse
import os
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ncnet_tpu_torch.models.ncnet import resolve_device
from ncnet_tpu_torch.tools import _probe

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "goldens", "activations.npz")

#: (rtol, atol) by key prefix: ``tests/test_goldens.py``'s
TOLERANCES: Dict[str, Tuple[float, float]] = {
    "tiny_delta": (0.0, 0.0),
    "tiny_": (1e-5, 1e-6),
    "resnet_": (1e-4, 1e-5),
    "dsift_": (1e-4, 1e-5),
    "p3p_": (1e-6, 1e-8),
}


def _walk_sorted(node, path=()):
    """``(path, leaf)`` in the JAX pytree order: dict keys sorted, lists in
    order."""
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _walk_sorted(node[k], path + (k,))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _walk_sorted(v, path + (i,))
    elif node is not None:
        yield path, node


def _set(tree, path, value) -> None:
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def deterministic_params(cfg):
    """The port's params (CPU tensors) with the JAX tool's values, from a
    numpy generator (stable across library versions)."""
    from ncnet_tpu_torch.models.ncnet import init_ncnet

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # a deliberately random trunk
        params = init_ncnet(cfg, 0)
    rng = np.random.default_rng(1234)
    for path, leaf in list(_walk_sorted(params)):
        trunk_conv = path[0] == "backbone" and path[-1] == "w" \
            and leaf.dim() == 4
        shape = (tuple(leaf.shape[i] for i in (2, 3, 1, 0)) if trunk_conv
                 else tuple(leaf.shape))
        vals = (rng.standard_normal(shape) * 0.05).astype(np.float32)
        # BN running variance must stay positive or sqrt(var + eps) is NaN
        if "var" in path:
            vals = np.abs(vals) + 0.1
        if trunk_conv:  # HWIO -> OIHW
            vals = np.ascontiguousarray(np.transpose(vals, (3, 2, 0, 1)))
        _set(params, path, torch.from_numpy(vals).to(leaf.dtype))
    return params


def canonical_p3p_order(sols: np.ndarray) -> np.ndarray:
    """NaN-mask and lexicographically sort each sample's ≤4 candidate
    poses (the solver's slot order follows ``eigvals``, which is
    implementation-defined)."""
    masked = np.nan_to_num(np.asarray(sols, dtype=np.float64), nan=-1e9)
    out = []
    for sample in masked:
        rows = sorted(sample.reshape(sample.shape[0], -1).tolist())
        out.append(np.asarray(rows).reshape(sample.shape))
    return np.stack(out)


def record(dev: torch.device) -> Dict[str, np.ndarray]:
    """The goldens' keys, computed by the port on ``dev``."""
    from ncnet_tpu_torch.config import ModelConfig
    from ncnet_tpu_torch.localization.dsift import dense_sift, rootsift
    from ncnet_tpu_torch.localization.p3p import p3p_solve
    from ncnet_tpu_torch.models.ncnet import (
        extract_features,
        ncnet_forward,
        params_to,
    )
    from ncnet_tpu_torch.ops.matching import corr_to_matches

    rng = np.random.default_rng(7)
    rec: Dict[str, np.ndarray] = {}

    # 1. the full forward, tiny trunk, a rectangular pair, relocalization k=2
    cfg = ModelConfig(backbone="tiny", ncons_kernel_sizes=(3, 3),
                      ncons_channels=(8, 1), relocalization_k_size=2)
    params = params_to(deterministic_params(cfg), dev)
    src = rng.uniform(-1, 1, (1, 64, 96, 3)).astype(np.float32)
    tgt = rng.uniform(-1, 1, (1, 96, 64, 3)).astype(np.float32)
    with torch.no_grad():
        out = ncnet_forward(cfg, params, torch.from_numpy(src).to(dev),
                            torch.from_numpy(tgt).to(dev))
        m = corr_to_matches(out.corr, delta4d=out.delta4d, k_size=2,
                            do_softmax=True, scale="positive")
    rec["tiny_src"], rec["tiny_tgt"] = src, tgt
    rec["tiny_corr"] = out.corr.cpu().numpy()
    for i, d in enumerate(out.delta4d):
        rec[f"tiny_delta{i}"] = d.cpu().numpy()
    rec["tiny_matches"] = np.stack([v.cpu().numpy() for v in m])

    # 2. the ResNet-101 trunk's features (random but deterministic weights)
    cfg_r = ModelConfig(backbone="resnet101", ncons_kernel_sizes=(3,),
                        ncons_channels=(1,))
    params_r = params_to(deterministic_params(cfg_r), dev)
    img = rng.uniform(-1, 1, (1, 96, 96, 3)).astype(np.float32)
    with torch.no_grad():
        feats = extract_features(cfg_r, params_r,
                                 torch.from_numpy(img).to(dev)).cpu().numpy()
    rec["resnet_img"] = img
    rec["resnet_feat_mean"] = feats.mean(axis=-1)
    rec["resnet_feat_slice"] = feats[0, :, :, :8]

    # 3. dense-SIFT descriptors and a P3P pose on fixed inputs
    img = rng.random((72, 88)).astype(np.float32)
    desc = rootsift(dense_sift(img, device=dev))
    rec["dsift_img"] = img
    rec["dsift_desc_sample"] = desc[::3, ::3, :16]
    rec["dsift_desc_mean"] = desc.mean(axis=-1)
    rays = rng.normal(size=(4, 3, 3))
    rays /= np.linalg.norm(rays, axis=2, keepdims=True)
    pts = rng.uniform(-1, 1, (4, 3, 3)) + np.array([0.0, 0.0, 4.0])
    rec["p3p_rays"], rec["p3p_pts"] = rays, pts
    rec["p3p_solutions"] = canonical_p3p_order(p3p_solve(rays, pts))
    return rec


def tolerance(key: str) -> Tuple[float, float]:
    for prefix, tol in TOLERANCES.items():
        if key.startswith(prefix):
            return tol
    return 0.0, 0.0  # the inputs: the same generator, the same bits


def check(rec: Dict[str, np.ndarray],
          golden: Dict[str, np.ndarray]) -> List[dict]:
    """One row a key: its tolerance, largest deviation, the atol it needs
    at its rtol, and whether it passes."""
    rows = []
    for key in sorted(golden):
        want = np.asarray(golden[key], np.float64)
        got = np.asarray(rec.get(key, np.zeros(0)), np.float64)
        rtol, atol = tolerance(key)
        if got.shape != want.shape:
            rows.append({"key": key, "ok": False, "shape": list(got.shape)})
            continue
        dev = np.abs(got - want)
        need = float(np.max(dev - rtol * np.abs(want), initial=0.0))
        rows.append({"key": key, "rtol": rtol, "atol": atol,
                     "max_abs": float(dev.max(initial=0.0)),
                     "atol_needed": need, "ok": need <= atol})
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="write the port's record here (.npz)")
    ap.add_argument("--check", action="store_true",
                    help="compare the record with the committed goldens")
    ap.add_argument("--golden", default=GOLDEN,
                    help="the goldens --check compares with")
    _probe.add_device_arg(ap)
    args = ap.parse_args(argv)
    if not args.out and not args.check:
        ap.error("give --out (write the record), --check, or both")
    dev = resolve_device(args.device)
    rec = record(dev)
    if args.out:
        np.savez_compressed(args.out, **rec)
        print(f"wrote {args.out} ({os.path.getsize(args.out) / 1024:.0f} KiB)")
    if not args.check:
        return 0
    with np.load(args.golden) as g:
        golden = {k: g[k] for k in g.files}
    rows = check(rec, golden)
    for r in rows:
        if "max_abs" not in r:
            print(f"{r['key']:>18}: MISSING or shape {r['shape']}")
            continue
        print(f"{r['key']:>18}: max|diff| {r['max_abs']:.3e}, needs atol "
              f"{r['atol_needed']:.3e} at rtol {r['rtol']:g} (allowed "
              f"{r['atol']:g}) {'ok' if r['ok'] else 'FAIL'}")
    bad = [r["key"] for r in rows if not r["ok"]]
    print(f"goldens on {_probe.card_line(dev)}: "
          f"{len(rows) - len(bad)}/{len(rows)} keys within tolerance"
          + (f"; FAIL {bad}" if bad else ""))
    _probe.summary({"tool": "make_goldens", "device": _probe.card_line(dev),
                    "failed": bad, "rows": rows})
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
