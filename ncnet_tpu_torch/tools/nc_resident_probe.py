"""Parity and composed timing of the resident NC stack against the
per-layer chain and the plain conv4d stack, with layer-prefix
differencing for attribution.

Usage::

    python -m ncnet_tpu_torch.tools.nc_resident_probe [batch_volumes] [--device cpu]

The port of ``tools/nc_resident_probe.py``.  The resident stack
(``ops/nc_fused_lane.py::nc_stack_resident``) and the per-layer chain
(``nc_stack_fused_lane``) both run the hand-written B6 kernel
(``csrc/nc_conv4d.cuh``), one launch a layer; the plain stack is
``relu(conv4d(...))`` per layer with the formulation chooser's pick (B5
for the 16 → 1 layer).  The kernels' gate (``nc_fused_lane.kernels_hold``,
arithmetic on the kernel sizes and widths) replaces the TPU tool's
compile probe: a stack outside it is refused with
``NotImplementedError`` (exit 1) before anything runs.  Parity: both kernel stacks within 5 % of the
plain stack's largest value.  Timing: ms a volume, each step consuming
its output; the prefixes ``[:n]`` run the same kernel over the first n
layers, so consecutive differences are the layers' composed costs.
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


def prefix_stack(params: List[dict], x: torch.Tensor) -> torch.Tensor:
    """The kernel (the twin on a CPU tensor) over ``params``, however
    wide its last layer."""
    return nc_fused_lane.stack_activations(params, x)[-1]


def check(params: List[dict], x: torch.Tensor) -> dict:
    """The resident stack and the per-layer chain against the plain
    stack: their outputs and relative errors."""
    ref = _probe.plain_stack(params, x)
    res = nc_fused_lane.nc_stack_resident(params, x)
    lane = nc_fused_lane.nc_stack_fused_lane(params, x)
    return {"plain": ref, "resident": res, "fused_lane": lane,
            "rel_resident": _probe.rel_err(res, ref)[1],
            "rel_fused_lane": _probe.rel_err(lane, ref)[1]}


def shape_verdict() -> dict:
    return {"held": nc_fused_lane.kernels_hold(KERNELS, CHANNELS),
            "chooser": nc_fused_lane.choose_fused_stack(
                S, S, S, S, KERNELS, CHANNELS) or "xla"}


def step_of(fn):
    def step(carry):
        x, params = carry
        return _probe.consume(x, fn(params, x)), params
    return step


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("batch", nargs="?", type=int, default=8,
                    help="volumes a timed step")
    _probe.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    b = args.batch
    print(f"device={_probe.card_line(dev)} n_volumes={b}")
    verdict = shape_verdict()
    print(f"kernels hold the stack: {verdict['held']}  chooser at {S}^4: "
          f"{verdict['chooser']}")
    if not verdict["held"]:
        print(f"NotImplementedError: the NC kernels do not serve the stack "
              f"{KERNELS}/{CHANNELS} (nc_fused_lane.kernels_hold)")
        return 1

    gen = torch.Generator(device=dev).manual_seed(0)
    params = make_params(gen, dev)
    x = (torch.randn((PARITY_BATCH, S, S, S, S, 1), generator=gen, device=dev)
         * 0.1).to(torch.bfloat16)
    res = check(params, x)
    print(f"parity: resident rel {res['rel_resident']:.3%}, per-layer rel "
          f"{res['rel_fused_lane']:.3%} (tolerance {TOLERANCE:.0%})")
    if max(res["rel_resident"], res["rel_fused_lane"]) >= TOLERANCE:
        print("FAIL: a kernel stack disagrees with the plain stack")
        return 1

    def make_input(g):
        return ((torch.randn((b, S, S, S, S, 1), generator=g, device=dev)
                 * 0.1).to(torch.bfloat16), make_params(g, dev))

    kw = dict(per=b, n_long=N_LONG)
    ms = {name: _probe.time_ms(step_of(fn), make_input, dev, **kw)
          for name, fn in (("resident", nc_fused_lane.nc_stack_resident),
                           ("per_layer", nc_fused_lane.nc_stack_fused_lane),
                           ("plain", _probe.plain_stack))}
    print(f"resident stack : {_probe.fmt_ms(ms['resident'])} ms/volume")
    print(f"per-layer chain: {_probe.fmt_ms(ms['per_layer'])} ms/volume")
    print(f"plain stack    : {_probe.fmt_ms(ms['plain'])} ms/volume")
    prev = 0.0
    for n in range(1, len(KERNELS) + 1):
        t = ms[f"prefix_{n}"] = _probe.time_ms(
            step_of(lambda p, v, n=n: prefix_stack(p[:n], v)), make_input,
            dev, **kw)
        delta = "" if t is None else f"  (+{t - prev:6.3f})"
        print(f"prefix[:{n}]    : {_probe.fmt_ms(t)} ms/volume{delta}")
        prev = t or 0.0
    _probe.summary({"tool": "nc_resident_probe", "batch": b, **verdict,
                    "rel_resident": res["rel_resident"],
                    "rel_fused_lane": res["rel_fused_lane"],
                    "ms_per_volume": ms})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
