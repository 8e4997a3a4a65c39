"""Attribute the training step's backward stage by stage.

Usage::

    python -m ncnet_tpu_torch.tools.train_attr_probe [batch] [dtype] [fold:y/n] [--device cpu]

    dtype: bf16, anything else f32.

The port of ``tools/train_attr_probe.py``: the value and NC-parameter
gradients of ablated forms of the weak loss (``training/loss.py``), the
trunk replaced by L2-normalized random features (C = 1024), so that the
volume is born from the correlation, isolating by differences:

  * ``full``: correlation of positives and rolled negatives → the filter
    (folded into one call of 2B with ``fold``, else one call each) →
    per-pair scores (``match_score_per_pair``);
  * ``one_vol``: the positive volumes only;
  * ``no_mm``: mutual matching removed before and after the NC stack;
  * ``mean_score``: the softmax/max score replaced by a plain mean;
  * ``nc_only``: the bare symmetric NC stack and a mean.

The NC stack is the port's ``neigh_consensus`` (its tier chooser's route:
the FFT tier at 25⁴).  A variant that fails prints its error and the exit
code is 1.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from ncnet_tpu_torch.models.ncnet import resolve_device
from ncnet_tpu_torch.tools import _probe
from ncnet_tpu_torch.tools.vjp_sweep_probe import features_input, nudge

S, C = 25, 1024
KERNELS, CHANNELS = (5, 5, 5), (16, 16, 1)
VARIANTS = ("full", "one_vol", "no_mm", "mean_score", "nc_only")


def make_loss(variant: str, dt, fold: bool):
    from ncnet_tpu_torch.models.ncnet import neigh_consensus
    from ncnet_tpu_torch.ops.correlation import correlation_4d
    from ncnet_tpu_torch.ops.matching import mutual_matching
    from ncnet_tpu_torch.training.loss import match_score_per_pair

    def filt(params, corr, with_mm=True):
        if with_mm:
            corr = mutual_matching(corr)
        corr = neigh_consensus(params, corr, symmetric=True)
        if with_mm:
            corr = mutual_matching(corr)
        return corr

    def loss(params, fa, fb):
        b = fa.shape[0]
        params = [{k: t.to(dt) for k, t in p.items()} for p in params]
        corr_p = correlation_4d(fa, fb).to(dt)
        if variant == "nc_only":
            return neigh_consensus(params, corr_p, symmetric=True).float().mean()
        if variant == "one_vol":
            return -match_score_per_pair(filt(params, corr_p)).float().mean()
        corr_n = correlation_4d(torch.roll(fa, -1, dims=0), fb).to(dt)
        with_mm = variant != "no_mm"
        if fold:
            nc = filt(params, torch.cat([corr_p, corr_n], dim=0), with_mm)
            if variant == "mean_score":
                return nc[b:].float().mean() - nc[:b].float().mean()
            s = match_score_per_pair(nc).float()
            return s[b:].mean() - s[:b].mean()
        nc_p = filt(params, corr_p, with_mm)
        nc_n = filt(params, corr_n, with_mm)
        if variant == "mean_score":
            return nc_n.float().mean() - nc_p.float().mean()
        return (match_score_per_pair(nc_n).float().mean()
                - match_score_per_pair(nc_p).float().mean())

    return loss


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("batch", nargs="?", type=int, default=8)
    ap.add_argument("dtype", nargs="?", default="f32")
    ap.add_argument("fold", nargs="?", default="n")
    _probe.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    b, fold = args.batch, args.fold == "y"
    dt = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    params0 = _probe.init_stack(7, KERNELS, CHANNELS, dev)
    print(f"device={_probe.card_line(dev)} batch={b} dtype={args.dtype} "
          f"fold={fold}")
    rows, failed = {}, False
    for variant in VARIANTS:
        loss = make_loss(variant, dt, fold)

        def tick(carry, loss=loss):
            fa, fb, params = carry
            leaves = [{k: t.detach().requires_grad_() for k, t in p.items()}
                      for p in params]
            with torch.enable_grad():
                val = loss(leaves, fa, fb)
                g = torch.autograd.grad(
                    val, [t for p in leaves for t in (p["w"], p["b"])])
            fa = fa + (val.detach() * 1e-9).to(fa.dtype)
            return fa, fb, nudge(params, [{"w": g[i], "b": g[i + 1]}
                                          for i in range(0, len(g), 2)])

        try:
            ms = rows[variant] = _probe.time_ms(
                tick, features_input(b, params0, dev, S, C), dev, n_long=4,
                reps=3)
        except Exception as e:  # noqa: BLE001 — print and go on
            rows[variant], failed = f"FAILED: {str(e)[:200]}", True
            print(f"{variant:12s} FAILED: {str(e)[:200]}", flush=True)
            continue
        per = "" if ms is None else f"  {ms / b:6.2f} ms/pair"
        print(f"{variant:12s} {_probe.fmt_ms(ms, 8, 1)} ms/step{per}",
              flush=True)
    _probe.summary({"tool": "train_attr_probe", "batch": b,
                    "dtype": args.dtype, "fold": fold, "ms_per_step": rows})
    return int(failed)


if __name__ == "__main__":
    raise SystemExit(main())
