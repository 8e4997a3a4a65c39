"""Parity and timing of the NC stack's backward (B3: the B7 dW/db kernel,
its reduction and B6's transposed launch) for the PF-Pascal and the IVD
architectures.

Usage::

    python -m ncnet_tpu_torch.tools.nc_vjp_resident_probe [batch_volumes] [pf|ivd] [--device cpu]

    arch pf: 25⁴, k = 5, channels (16, 16, 1) (default); ivd: 25⁴, k = 3,
    channels (16, 1).  The kernels hold both
    (``nc_fused_lane.kernels_hold``; ``csrc/nc_conv4d_vjp.cuh``).

The port of ``tools/nc_vjp_resident_probe.py``.  In place of the TPU
tool's per-stage VMEM accounting and compile probes it prints each
layer's ``(k, C_in, C_out)`` and whether the kernels serve it
(``nc_fused_lane.layer_held``), and the training gate's verdict
(``kernels_hold``); a stack outside the gate is refused with
``NotImplementedError`` (exit 1).

  * Parity: the kernels' backward (``nc_fused_lane_vjp.stack_vjp``) against
    its twin on the same saved activations, within 1e-2 of each
    gradient's largest value (gated); the twin against plain autograd of
    the conv4d stack on raw random data (printed: boundary cells whose
    ReLU mask flips between the bf16 and f32 forwards inflate it).
  * Memory rows (the JAX tool's compiled memory analysis): on the card the
    measured peak of one fused backward (program ``nc_vjp_resident_probe``,
    tier ``resident_vjp``) and of one plain autograd backward
    (``nc_vjp_xla_ad``, tier ``xla``), recorded through
    ``observability/memory.py::record_program``.
  * Timing, ms a volume: the fused stack's forward + backward under
    autograd (``nc_stack_fused``), the backward alone
    (``nc_stack_fused_vjp``), plain autograd, and each layer's backward
    stage alone (dW, db and Γ) on staged activations.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from ncnet_tpu_torch.observability import memory as obs_memory
from ncnet_tpu_torch.ops import nc_fused_lane, nc_fused_lane_vjp as vjp
from ncnet_tpu_torch.models.ncnet import resolve_device
from ncnet_tpu_torch.tools import _probe

S = 25
ARCHS = {"pf": ((5, 5, 5), (16, 16, 1)), "ivd": ((3, 3), (16, 1))}
PARITY_BATCH = 2
TOLERANCE = 1e-2
N_LONG = 6


def layer_shapes(kernels, channels):
    c_in, out = 1, []
    for k, c_out in zip(kernels, channels):
        out.append((k, c_in, c_out))
        c_in = c_out
    return out


def make_params(gen, kernels, channels, dev) -> List[dict]:
    return _probe.normal_stack(gen, kernels, channels, dev)


def plain_vjp(params, x, g):
    """Plain autograd of the conv4d stack: ``(d_params, dx)``."""
    leaves = [{k: t.detach().requires_grad_() for k, t in p.items()}
              for p in params]
    xx = x.detach().requires_grad_()
    with torch.enable_grad():
        out = _probe.plain_stack(leaves, xx)
        flat = [t for p in leaves for t in (p["w"], p["b"])]
        grads = torch.autograd.grad(out, flat + [xx], g)
    return ([{"w": grads[i], "b": grads[i + 1]}
             for i in range(0, len(flat), 2)], grads[-1])


def flat_grads(d_params, dx) -> List[torch.Tensor]:
    return [t for p in d_params for t in (p["w"], p["b"])] + [dx]


def worst_rel(got, want) -> float:
    return max(_probe.rel_err(a, b)[1]
               for a, b in zip(flat_grads(*got), flat_grads(*want)))


def check(params: List[dict], x: torch.Tensor, g: torch.Tensor) -> dict:
    """The kernels' backward against the twin on the same activations
    (``rel_kernel``), and the twin against plain autograd
    (``rel_plain``)."""
    acts = nc_fused_lane.stack_activations(params, x)
    got = vjp.stack_vjp(params, acts, g)
    twin = vjp.stack_vjp(params, acts, g, twin=True)
    plain = plain_vjp(params, x, g)
    return {"kernel": got, "twin": twin, "plain": plain,
            "rel_kernel": worst_rel(got, twin),
            "rel_plain": worst_rel(twin, plain)}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("batch", nargs="?", type=int, default=8,
                    help="volumes a timed step")
    ap.add_argument("arch", nargs="?", default="pf", choices=sorted(ARCHS))
    _probe.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    b, kernels, channels = args.batch, *ARCHS[args.arch]
    print(f"device={_probe.card_line(dev)} n_volumes={b} arch={args.arch}")
    shapes = layer_shapes(kernels, channels)
    for li, shape in enumerate(shapes):
        print(f"  stage {li}: (k, C_in, C_out)={shape} held: "
              f"{nc_fused_lane.layer_held(*shape)}")
    gate = nc_fused_lane.kernels_hold(kernels, channels)
    chooser = nc_fused_lane.choose_fused_stack(S, S, S, S, kernels, channels)
    print(f"training gate (B3 serves the stack): {gate}  forward chooser at "
          f"{S}^4: {chooser or 'xla'}")
    if not gate:
        print(f"NotImplementedError: the NC kernels do not serve the stack "
              f"{kernels}/{channels} (nc_fused_lane.kernels_hold)")
        return 1

    gen = torch.Generator(device=dev).manual_seed(0)
    params = make_params(gen, kernels, channels, dev)
    x = (torch.randn((PARITY_BATCH, S, S, S, S, 1), generator=gen, device=dev)
         * 0.1).to(torch.bfloat16)
    g = (torch.randn((PARITY_BATCH, S, S, S, S, channels[-1]), generator=gen,
                     device=dev) * 0.1).to(torch.bfloat16)
    res = check(params, x, g)
    print(f"parity kernels vs twin (same activations): worst rel "
          f"{res['rel_kernel']:.3%} (tolerance {TOLERANCE:.0%})")
    print(f"parity twin vs plain autograd (raw random data): worst rel "
          f"{res['rel_plain']:.3%}")
    if res["rel_kernel"] > TOLERANCE:
        print("FAIL: the backward kernels disagree with their twin")
        return 1

    sig = (f"{S}x{S}x{S}x{S}|k={','.join(str(k) for k in kernels)}"
           f"|c={','.join(str(c) for c in channels)}")
    _, fused_row = _probe.measure_memory(
        lambda: vjp.nc_stack_fused_vjp(params, x, g), dev, (params, x, g))
    _, plain_row = _probe.measure_memory(
        lambda: plain_vjp(params, x, g), dev, (params, x, g))
    for program, tier, row in (("nc_vjp_resident_probe", "resident_vjp",
                                fused_row),
                               ("nc_vjp_xla_ad", "xla", plain_row)):
        if row is not None:
            obs_memory.record_program(program, sig, analysis=row, tier=tier,
                                      source="probe")
        print(_probe.memory_line(f"{program} ({tier})", row))

    def make_input(gg):
        return ((torch.randn((b, S, S, S, S, 1), generator=gg, device=dev)
                 * 0.1).to(torch.bfloat16),
                (torch.randn((b, S, S, S, S, channels[-1]), generator=gg,
                             device=dev) * 0.1).to(torch.bfloat16),
                make_params(gg, kernels, channels, dev))

    def fused_grad_step(carry):
        x, g, params = carry
        leaves = [{k: t.detach().requires_grad_() for k, t in p.items()}
                  for p in params]
        xx = x.detach().requires_grad_()
        with torch.enable_grad():
            out = nc_fused_lane.nc_stack_fused(leaves, xx)
            grads = torch.autograd.grad(
                out, [t for p in leaves for t in p.values()] + [xx], g)
        return _probe.consume(x, *grads), g, params

    def fused_direct_step(carry):
        x, g, params = carry
        d_params, dx = vjp.nc_stack_fused_vjp(params, x, g)
        return _probe.consume(x, d_params, dx), g, params

    def plain_grad_step(carry):
        x, g, params = carry
        return _probe.consume(x, *plain_vjp(params, x, g)), g, params

    kw = dict(per=b, n_long=N_LONG)
    ms = {name: _probe.time_ms(fn, make_input, dev, **kw)
          for name, fn in (("fused_fwd_bwd", fused_grad_step),
                           ("fused_bwd", fused_direct_step),
                           ("plain_fwd_bwd", plain_grad_step))}
    for key, label in (("fused_fwd_bwd", "fused fwd+bwd (autograd)"),
                       ("fused_bwd", "fused bwd alone"),
                       ("plain_fwd_bwd", "plain fwd+bwd (autograd)")):
        print(f"{label:25s}: {_probe.fmt_ms(ms[key])} ms/volume")

    # each backward stage alone on staged activations: the dX/dW split
    for li in reversed(range(len(kernels))):
        def stage_step(carry, li=li):
            x, g, params = carry
            acts = staged[li]
            gam = g if li == len(kernels) - 1 else gammas[li]
            out = (vjp.layer_vjp if dev.type == "cuda"
                   else vjp.layer_vjp_reference)(
                acts[0], acts[1], gam, params[li]["w"], need_dx=True)
            return _probe.consume(x, *out), g, params

        def stage_input(gg, li=li):
            carry = make_input(gg)
            x, g, params = carry
            a = nc_fused_lane.stack_activations(params, x)
            staged[li] = (a[li], a[li + 1])
            gammas[li] = (torch.randn(a[li + 1].shape, generator=gg,
                                      device=dev) * 0.1).to(torch.bfloat16)
            return carry

        staged, gammas = {}, {}
        t = ms[f"stage_{li}"] = _probe.time_ms(stage_step, stage_input, dev,
                                               **kw)
        print(f"  stage {li} (gz+dW+db+Γ): {_probe.fmt_ms(t)} ms/volume")
    _probe.summary({"tool": "nc_vjp_resident_probe", "arch": args.arch,
                    "batch": b, "rel_kernel": res["rel_kernel"],
                    "rel_plain": res["rel_plain"], "memory": {
                        "nc_vjp_resident_probe": fused_row,
                        "nc_vjp_xla_ad": plain_row},
                    "ms_per_volume": ms})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
