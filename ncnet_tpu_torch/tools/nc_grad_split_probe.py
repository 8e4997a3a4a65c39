"""Split the symmetric NC stack's backward cost into dx and dw.

Usage::

    python -m ncnet_tpu_torch.tools.nc_grad_split_probe [batch] [dtype] [--device cpu]

    dtype: bf16, anything else f32.

The port of ``tools/nc_grad_split_probe.py``, through the port's
``models/ncnet.py::neigh_consensus`` (symmetric, its tier chooser's
route; the FFT tier at 25⁴):

  * ``nc_fwd``: the forward alone;
  * ``nc_dx``: the gradient with respect to the volume, the parameters
    detached (the dx chain of every layer);
  * ``nc_dw``: the gradient with respect to the parameters (dw of every
    layer and dx of all but the first);
  * ``nc_both``: both.

The volume is born from the correlation of L2-normalized random features
(C = 1024); each step consumes the loss and every gradient.  A variant
that fails prints its error and the exit code is 1.
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
VARIANTS = ("nc_fwd", "nc_dx", "nc_dw", "nc_both")


def stack_loss(params, corr, dt):
    from ncnet_tpu_torch.models.ncnet import neigh_consensus

    params = [{k: t.to(dt) for k, t in p.items()} for p in params]
    return neigh_consensus(params, corr, symmetric=True).float().mean()


def tick_of(variant: str, dt):
    from ncnet_tpu_torch.ops.correlation import correlation_4d

    def tick(carry):
        fa, fb, params = carry
        corr = correlation_4d(fa, fb).to(dt)
        gp = gc = None
        if variant == "nc_fwd":
            with torch.no_grad():
                val = stack_loss(params, corr, dt)
        else:
            leaves = [{k: t.detach().requires_grad_(variant != "nc_dx")
                       for k, t in p.items()} for p in params]
            wrt = [t for p in leaves for t in (p["w"], p["b"])] \
                if variant != "nc_dx" else []
            if variant != "nc_dw":
                corr = corr.requires_grad_()
                wrt = wrt + [corr]
            with torch.enable_grad():
                val = stack_loss(leaves, corr, dt)
                grads = torch.autograd.grad(val, wrt)
            if variant != "nc_dw":
                *grads, gc = grads
            if variant != "nc_dx":
                gp = [{"w": grads[i], "b": grads[i + 1]}
                      for i in range(0, len(grads), 2)]
        fa = fa + (val.detach() * 1e-9).to(fa.dtype)
        if gc is not None:
            fa = fa + (gc.float().sum() * 1e-12).to(fa.dtype)
        if gp is not None:
            params = nudge(params, gp)
        return fa, fb, params

    return tick


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("batch", nargs="?", type=int, default=8)
    ap.add_argument("dtype", nargs="?", default="f32")
    _probe.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    b = args.batch
    dt = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    params0 = _probe.init_stack(7, KERNELS, CHANNELS, dev)
    print(f"device={_probe.card_line(dev)} batch={b} dtype={args.dtype}")
    rows, failed = {}, False
    for variant in VARIANTS:
        try:
            ms = rows[variant] = _probe.time_ms(
                tick_of(variant, dt), features_input(b, params0, dev, S, C),
                dev, n_long=4, reps=3)
        except Exception as e:  # noqa: BLE001 — print and go on
            rows[variant], failed = f"FAILED: {str(e)[:200]}", True
            print(f"{variant:8s} FAILED: {str(e)[:200]}", flush=True)
            continue
        per = "" if ms is None else f"  {ms / b:6.2f} ms/pair"
        print(f"{variant:8s} {_probe.fmt_ms(ms, 8, 1)} ms/step{per}",
              flush=True)
    _probe.summary({"tool": "nc_grad_split_probe", "batch": b,
                    "dtype": args.dtype, "ms_per_step": rows})
    return int(failed)


if __name__ == "__main__":
    raise SystemExit(main())
