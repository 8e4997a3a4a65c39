"""Sweep per-layer (dx, dw) gradient-formulation routings composed in the
symmetric NC stack (gradients with respect to the parameters AND the
volume: the training chain).

Usage::

    python -m ncnet_tpu_torch.tools.vjp_sweep_probe [batch] [dtype] [spec ...] [--device cpu]

    dtype: bf16, anything else f32.
    spec: name=dx0/dw0,dx1/dw1,dx2/dw2 ('-' = plain autograd for that layer)
    default: plain, the default routing, dx sweeps, dw sweeps

The port of ``tools/vjp_sweep_probe.py``.  A routed layer runs
``ops/conv4d.py::make_conv4d_same(dx_variant, dw_variant)`` (dx a conv4d
of the cotangent with the transposed weights in the ``dx`` formulation,
dW the autograd of the ``dw`` formulation); the ``plain`` row is the port's
``neigh_consensus`` with autograd through whatever route it takes (the FFT
tier at 25⁴).  The volume is born from the correlation of L2-normalized
random features (C = 1024) and each step consumes the loss and every
gradient.  A routing that fails prints its error and the exit code is 1.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from ncnet_tpu_torch.models.ncnet import resolve_device
from ncnet_tpu_torch.tools import _probe
from ncnet_tpu_torch.tools.filter_stage_probe import swap_ab

S, C = 25, 1024
KERNELS, CHANNELS = (5, 5, 5), (16, 16, 1)
DEFAULT_SWEEP = [
    ("plain", None),
    ("custom_def", [{"dx": "auto", "dw": "coutfold"}] * 3),
    ("dx_unroll", [{"dx": "unroll", "dw": "coutfold"}] * 3),
    ("dx_tapfold", [{"dx": "tapfold", "dw": "coutfold"}] * 3),
    ("dw_unroll", [{"dx": "auto", "dw": "unroll"}] * 3),
    ("dw_tapfold", [{"dx": "auto", "dw": "tapfold"}] * 3),
]


def parse_spec(s: str):
    out = []
    for part in s.split(","):
        if part == "-":
            out.append(None)
        else:
            dx, dw = part.split("/")
            out.append({"dx": dx, "dw": dw})
    return out


def routed_consensus(params: List[dict], corr: torch.Tensor,
                     routing) -> torch.Tensor:
    """The symmetric NC stack, ``NC(x) + NC(xᵀ)ᵀ`` batch-folded, with each
    layer routed by ``routing`` (a list of ``{"dx", "dw"}`` or None, plain
    autograd of ``conv4d``); ``routing=None`` is the port's
    ``neigh_consensus``."""
    from ncnet_tpu_torch.models.ncnet import neigh_consensus
    from ncnet_tpu_torch.ops.conv4d import conv4d, make_conv4d_same

    if routing is None:
        return neigh_consensus(params, corr, symmetric=True)
    if len(routing) != len(params):
        raise ValueError(f"routing has {len(routing)} entries for "
                         f"{len(params)} layers")
    b = corr.shape[0]
    x = corr[..., None]
    x = torch.cat([x, swap_ab(x)], dim=0)
    for layer, spec in zip(params, routing):
        conv = (conv4d if spec is None
                else make_conv4d_same(spec["dx"], spec["dw"]))
        x = torch.relu(conv(x, layer["w"], layer["b"]))
    y = x[..., 0]
    return y[:b] + swap_ab(y[b:])


def features_input(b: int, params, dev, s: int, c: int):
    """L2-normalized random ``(b, s, s, c)`` feature pairs and ``params``."""
    from ncnet_tpu_torch.ops.norm import feature_l2_norm

    def make_input(g):
        fa = feature_l2_norm(torch.randn((b, s, s, c), generator=g,
                                         device=dev))
        fb = feature_l2_norm(torch.randn((b, s, s, c), generator=g,
                                         device=dev))
        return fa, fb, params
    return make_input


def nudge(params, grads):
    """The parameters moved by 1e-12 of each gradient's sum, so a step
    consumes every gradient."""
    return [{k: p[k] + (g[k].float().sum() * 1e-12).to(p[k].dtype)
             for k in p} for p, g in zip(params, grads)]


def main(argv: Optional[List[str]] = None) -> int:
    from ncnet_tpu_torch.ops.correlation import correlation_4d

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("batch", nargs="?", type=int, default=8)
    ap.add_argument("dtype", nargs="?", default="f32")
    ap.add_argument("specs", nargs="*")
    _probe.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    b = args.batch
    dt = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    sweep = ([(n, parse_spec(s)) for n, s in (a.split("=") for a in args.specs)]
             or DEFAULT_SWEEP)
    params0 = _probe.init_stack(7, KERNELS, CHANNELS, dev)
    print(f"device={_probe.card_line(dev)} batch={b} dtype={args.dtype}")
    rows, failed = {}, False
    for name, routing in sweep:
        def tick(carry, routing=routing):
            fa, fb, params = carry
            leaves = [{k: t.detach().requires_grad_() for k, t in p.items()}
                      for p in params]
            with torch.enable_grad():
                corr = correlation_4d(fa, fb).to(dt).requires_grad_()
                out = routed_consensus(
                    [{k: t.to(dt) for k, t in p.items()} for p in leaves],
                    corr, routing)
                val = out.float().mean()
                flat = [t for p in leaves for t in (p["w"], p["b"])]
                *gp, gc = torch.autograd.grad(val, flat + [corr])
            fa = fa + (val * 1e-9 + gc.float().sum() * 1e-12).to(fa.dtype)
            grads = [{"w": gp[i], "b": gp[i + 1]}
                     for i in range(0, len(gp), 2)]
            return fa, fb, nudge(params, grads)

        try:
            ms = rows[name] = _probe.time_ms(
                tick, features_input(b, params0, dev, S, C), dev, n_long=4,
                reps=3)
        except Exception as e:  # noqa: BLE001 — print and go on
            rows[name], failed = f"FAILED: {str(e)[:200]}", True
            print(f"{name:14s} FAILED: {str(e)[:200]}", flush=True)
            continue
        per = "" if ms is None else f"  {ms / b:6.2f} ms/pair"
        print(f"{name:14s} {_probe.fmt_ms(ms, 8, 1)} ms/step{per}", flush=True)
    _probe.summary({"tool": "vjp_sweep_probe", "batch": b,
                    "dtype": args.dtype, "ms_per_step": rows})
    return int(failed)


if __name__ == "__main__":
    raise SystemExit(main())
