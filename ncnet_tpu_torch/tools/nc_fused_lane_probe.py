"""Parity and composed timing of the per-layer NC chain (B6, one kernel
launch a layer) against the plain conv4d stack.

Usage::

    python -m ncnet_tpu_torch.tools.nc_fused_lane_probe [batch_volumes] [--device cpu]

The port of ``tools/nc_fused_lane_probe.py``: ``ops/nc_fused_lane.py::
nc_stack_fused_lane`` (the per-layer form's shape class, a 1-channel
final layer) launches ``csrc/nc_conv4d.cuh`` once a layer; the plain
stack is ``relu(conv4d(...))`` with the chooser's formulation per layer.
A stack outside the kernels' gate (``nc_fused_lane.kernels_hold``) is
refused with ``NotImplementedError`` (exit 1).  Parity: within 5 % of the plain
stack's largest value; then ms a volume of each, every step consuming its
output.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from ncnet_tpu_torch.ops import nc_fused_lane
from ncnet_tpu_torch.models.ncnet import resolve_device
from ncnet_tpu_torch.tools import _probe

S = 25
KERNELS, CHANNELS = (5, 5, 5), (16, 16, 1)
PARITY_BATCH = 2
TOLERANCE = 0.05
N_LONG = 8


def make_params(gen: torch.Generator, dev: torch.device) -> List[dict]:
    return _probe.normal_stack(gen, KERNELS, CHANNELS, dev)


def check(params: List[dict], x: torch.Tensor) -> dict:
    ref = _probe.plain_stack(params, x)
    got = nc_fused_lane.nc_stack_fused_lane(params, x)
    err, rel = _probe.rel_err(got, ref)
    return {"plain": ref, "fused_lane": got, "err": err, "rel": rel}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("batch", nargs="?", type=int, default=8,
                    help="volumes a timed step")
    _probe.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    b = args.batch
    print(f"device={_probe.card_line(dev)} n_volumes={b}")
    held = nc_fused_lane.kernels_hold(KERNELS, CHANNELS)
    print(f"kernels hold the stack: {held}")
    if not held:
        print(f"NotImplementedError: the NC kernels do not serve the stack "
              f"{KERNELS}/{CHANNELS} (nc_fused_lane.kernels_hold)")
        return 1

    gen = torch.Generator(device=dev).manual_seed(0)
    params = make_params(gen, dev)
    x = (torch.randn((PARITY_BATCH, S, S, S, S, 1), generator=gen, device=dev)
         * 0.1).to(torch.bfloat16)
    res = check(params, x)
    print(f"parity: max abs err {res['err']:.4g} (rel {res['rel']:.3%})")
    if res["rel"] >= TOLERANCE:
        print(f"FAIL: the per-layer chain is {res['rel']:.3%} off the plain "
              f"stack (tolerance {TOLERANCE:.0%})")
        return 1

    def make_input(g):
        return ((torch.randn((b, S, S, S, S, 1), generator=g, device=dev)
                 * 0.1).to(torch.bfloat16), make_params(g, dev))

    def step_of(fn):
        def step(carry):
            x, params = carry
            return _probe.consume(x, fn(params, x)), params
        return step

    ms = {name: _probe.time_ms(step_of(fn), make_input, dev, per=b,
                               n_long=N_LONG)
          for name, fn in (("fused_lane", nc_fused_lane.nc_stack_fused_lane),
                           ("plain", _probe.plain_stack))}
    print(f"fused-lane stack: {_probe.fmt_ms(ms['fused_lane'])} ms/volume")
    print(f"plain stack     : {_probe.fmt_ms(ms['plain'])} ms/volume")
    _probe.summary({"tool": "nc_fused_lane_probe", "batch": b,
                    "held": held, "rel": res["rel"],
                    "ms_per_volume": ms})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
