"""Pick ``conv4d_same``'s weight-gradient formulation by measurement.

Usage::

    python -m ncnet_tpu_torch.tools.vjp_probe [batch] [dtype] [--device cpu]

    dtype: bf16, anything else f32.

The port of ``tools/vjp_probe.py``: the loss's value and gradients
through the symmetric NC stack (the training hot path) for each dw
formulation of ``ops/conv4d.py::make_conv4d_same`` (every layer routed
with dx ``auto``), beside the plain-autograd row (the port's
``neigh_consensus`` with autograd through its route: the FFT tier at
25⁴).  In place of the JAX tool's compiled temp-size estimate, each row
prints the measured peak of one step on the card (temp: the peak
allocated less what was allocated before and less the step's outputs); on
the CPU none is measured.  A row that fails prints its error and the exit
code is 1.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from ncnet_tpu_torch.models.ncnet import resolve_device
from ncnet_tpu_torch.tools import _probe
from ncnet_tpu_torch.tools.vjp_sweep_probe import nudge, routed_consensus

S = 25
CONFIGS = [("plain_ad", None), ("dw_coutfold", "coutfold"),
           ("dw_tapfold", "tapfold"), ("dw_afold", "afold"),
           ("dw_unroll", "unroll")]


def stack_input(b, dt, dev):
    def make(g):
        corr = (torch.randn((b, S, S, S, S), generator=g, device=dev)
                * 0.03).to(dt)
        return corr, _probe.normal_stack(g, (5, 5, 5), (16, 16, 1), dev, dt,
                                         b_scale=0)
    return make


def grad_step_of(dwv: Optional[str]):
    routing = None if dwv is None else [{"dx": "auto", "dw": dwv}] * 3

    def grad_step(carry):
        corr, params = carry
        leaves = [{k: t.detach().requires_grad_() for k, t in p.items()}
                  for p in params]
        cc = corr.detach().requires_grad_()
        with torch.enable_grad():
            out = routed_consensus(leaves, cc, routing)
            loss = torch.softmax(out.reshape(out.shape[0], -1).float(),
                                 dim=-1).max(dim=-1).values.mean()
            flat = [t for p in leaves for t in (p["w"], p["b"])]
            *gp, gc = torch.autograd.grad(loss, flat + [cc])
        grads = [{"w": gp[i], "b": gp[i + 1]} for i in range(0, len(gp), 2)]
        corr = corr + (loss * 1e-9).to(corr.dtype) + gc.to(corr.dtype) * 1e-12
        return corr, nudge(params, grads)

    return grad_step


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("batch", nargs="?", type=int, default=8)
    ap.add_argument("dtype", nargs="?", default="f32")
    _probe.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    b = args.batch
    dt = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    print(f"device={_probe.card_line(dev)} batch={b} dtype={args.dtype}")
    rows, failed = {}, False
    for name, dwv in CONFIGS:
        step = grad_step_of(dwv)
        try:
            carry = stack_input(b, dt, dev)(
                torch.Generator(device=dev).manual_seed(0))
            _, mem = _probe.measure_memory(lambda: step(carry), dev, carry)
            ms = _probe.time_ms(step, stack_input(b, dt, dev), dev,
                                n_long=4, per=b)
        except Exception as e:  # noqa: BLE001 — print and go on
            rows[name], failed = f"ERR {str(e)[:120]}", True
            print(f"{name:>12}: ERR {str(e)[:120]}")
            continue
        rows[name] = {"ms_per_pair": ms, "memory": mem}
        temp = ("not measured" if mem is None
                else f"{mem['temp_bytes'] / 2 ** 30:5.1f} GB")
        print(f"{name:>12}: {_probe.fmt_ms(ms)} ms/pair   temp {temp}")
    _probe.summary({"tool": "vjp_probe", "batch": b, "dtype": args.dtype,
                    "rows": rows})
    return int(failed)


if __name__ == "__main__":
    raise SystemExit(main())
