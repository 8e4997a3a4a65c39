"""Per-layer conv4d formulation timings for the PF-Pascal NC stack, and
the composed stack.

Usage::

    python -m ncnet_tpu_torch.tools.xla_layer_probe [batch] [--device cpu]

The port of ``tools/xla_layer_probe.py``: every (layer, formulation) of
the PF-Pascal stack (kernels (5, 5, 5), channels 1 → 16 → 16 → 1, bf16)
on its own (``ops/conv4d.py``'s ``unroll``, ``tapfold``, ``coutfold``,
``afold``, each a cuDNN convolution), then the composed stack through
``models/ncnet.py::neigh_consensus`` symmetric (the production path: the
tier chooser's route, the FFT tier at 25⁴) and in one pass, which
separates the layers' cost from composition.  A row that fails prints its
error and the exit code is 1.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from ncnet_tpu_torch.models.ncnet import resolve_device
from ncnet_tpu_torch.tools import _probe

S = 25
DT = torch.bfloat16
LAYERS = [("1to16", 1, 16, 5), ("16to16", 16, 16, 5), ("16to1", 16, 1, 5)]
VARIANTS = ("unroll", "tapfold", "coutfold", "afold")
N_LONG = 8


def chain(op):
    def step(carry):
        x, w = carry
        out = op(x, w)
        eps = (out.float().sum() * 1e-12).to(x.dtype)
        return x + eps, w - eps
    return step


def layer_input(b, cin, cout, k, dev):
    def make(g):
        return ((torch.randn((b, S, S, S, S, cin), generator=g, device=dev)
                 * 0.03).to(DT),
                (torch.randn((k,) * 4 + (cin, cout), generator=g, device=dev)
                 * 0.05).to(DT))
    return make


def main(argv: Optional[List[str]] = None) -> int:
    from ncnet_tpu_torch.models.ncnet import neigh_consensus
    from ncnet_tpu_torch.ops.conv4d import conv4d

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("batch", nargs="?", type=int, default=4)
    _probe.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    b = args.batch
    print(f"device={_probe.card_line(dev)} batch={b} dtype=bf16")
    rows, failed = {}, False
    with torch.no_grad():
        for name, cin, cout, k in LAYERS:
            row = []
            for v in VARIANTS:
                try:
                    ms = rows[f"{name}/{v}"] = _probe.time_ms(
                        chain(lambda x, w, v=v: conv4d(x, w, variant=v)),
                        layer_input(b, cin, cout, k, dev), dev, per=b,
                        n_long=N_LONG)
                    row.append(f"{v}={_probe.fmt_ms(ms, 6)}")
                except Exception as e:  # noqa: BLE001 — print and go on
                    rows[f"{name}/{v}"], failed = f"ERR {str(e)[:40]}", True
                    row.append(f"{v}=ERR({str(e)[:40]})")
            print(f"{name:>7}: " + "  ".join(row))

        def stack_input(g):
            corr = (torch.randn((b, S, S, S, S), generator=g, device=dev)
                    * 0.03).to(DT)
            return corr, _probe.normal_stack(g, (5, 5, 5), (16, 16, 1), dev,
                                             DT, b_scale=0)

        for label, symmetric in (("stack symmetric (production)", True),
                                 ("stack one-pass (no symmetry)", False)):
            def step(carry, symmetric=symmetric):
                corr, params = carry
                out = neigh_consensus(params, corr, symmetric=symmetric)
                return _probe.consume(corr, out), params

            ms = rows[label] = _probe.time_ms(step, stack_input, dev, per=b,
                                              n_long=N_LONG)
            print(f"  {label}: {_probe.fmt_ms(ms, 6)} ms/pair")
    _probe.summary({"tool": "xla_layer_probe", "batch": b,
                    "ms_per_pair": rows})
    return int(failed)


if __name__ == "__main__":
    raise SystemExit(main())
