"""conv4d formulation timings at the InLoc volume scale (the pooled
(1, 100, 75, 75, 100) volume of the IVD stack, 1 → 16 and 16 → 1 at
k = 3, bf16), and maxpool4d and mutual matching at that scale.

Usage::

    python -m ncnet_tpu_torch.tools.inloc_filter_probe [--device cpu]

The port of ``tools/inloc_filter_probe.py``.  Each layer runs through
``ops/conv4d.py`` with ``auto`` (the chooser's pick: ``tapfold`` for
1 → 16, B5 for 16 → 1, whose launches count in
``conv4d_pallas.launches``), ``unroll``, ``tapfold`` and ``coutfold``.
A formulation that fails prints its error and the exit code is 1.
Standalone numbers are hypotheses for composed runs: a layer's fastest
formulation alone need not make the composed filter faster.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from ncnet_tpu_torch.models.ncnet import resolve_device
from ncnet_tpu_torch.tools import _probe

# fine and pooled InLoc volumes (query 3200x2400, db 1200x1600 -> 2400x3200)
FQ, FD = (200, 150), (150, 200)
PQ, PD = (100, 75), (75, 100)
DT = torch.bfloat16
N_LONG = 4


def chain(op):
    def step(carry):
        x, w = carry
        return _probe.consume(x, op(x, w)), w
    return step


def layer_input(cin, cout, k, dev):
    def make(g):
        return ((torch.randn((1, *PQ, *PD, cin), generator=g, device=dev)
                 * 0.1).to(DT),
                (torch.randn((k,) * 4 + (cin, cout), generator=g, device=dev)
                 * 0.1).to(DT))
    return make


def corr_born_volume(fine: bool, dev):
    """Features whose correlation is the probed volume (the pipeline
    makes its volumes that way)."""
    def make(g):
        qa, qb = (FQ, FD) if fine else (PQ, PD)
        return ((torch.randn((1, *qa, 8), generator=g, device=dev)
                 * 0.2).to(DT),
                (torch.randn((1, *qb, 8), generator=g, device=dev)
                 * 0.2).to(DT))
    return make


def main(argv: Optional[List[str]] = None) -> int:
    from ncnet_tpu_torch.ops.conv4d import conv4d
    from ncnet_tpu_torch.ops.correlation import correlation_4d
    from ncnet_tpu_torch.ops.matching import mutual_matching
    from ncnet_tpu_torch.ops.pooling import maxpool4d_with_argmax

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _probe.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device={_probe.card_line(dev)} pooled {PQ}x{PD} bf16")
    rows, failed = {}, False
    with torch.no_grad():
        for name, cin, cout in (("1to16_k3", 1, 16), ("16to1_k3", 16, 1)):
            row = []
            for v in ("auto", "unroll", "tapfold", "coutfold"):
                try:
                    ms = rows[f"{name}/{v}"] = _probe.time_ms(
                        chain(lambda x, w, v=v: conv4d(x, w, variant=v)),
                        layer_input(cin, cout, 3, dev), dev, n_long=N_LONG)
                    row.append(f"{v}={_probe.fmt_ms(ms, 6, 1)}")
                except Exception as e:  # noqa: BLE001 — print and go on
                    rows[f"{name}/{v}"], failed = f"ERR {str(e)[:30]}", True
                    row.append(f"{v}=ERR({str(e)[:30]})")
            print(f"{name}: " + "  ".join(row))

        def pool_step(carry):
            fa, fb = carry
            pooled, delta = maxpool4d_with_argmax(correlation_4d(fa, fb), 2)
            return _probe.consume(fa, pooled, delta), fb

        ms = rows["corr+maxpool4d_k2_fine"] = _probe.time_ms(
            pool_step, corr_born_volume(True, dev), dev, n_long=N_LONG)
        print(f"corr+maxpool4d_k2_fine: {_probe.fmt_ms(ms, 1, 1)} ms")

        def mm_step(carry):
            fa, fb = carry
            return _probe.consume(
                fa, mutual_matching(correlation_4d(fa, fb))), fb

        ms = rows["corr+mutual_matching_pooled"] = _probe.time_ms(
            mm_step, corr_born_volume(False, dev), dev, n_long=N_LONG)
        print(f"corr+mutual_matching_pooled: {_probe.fmt_ms(ms, 1, 1)} ms")
    _probe.summary({"tool": "inloc_filter_probe", "ms": rows})
    return int(failed)


if __name__ == "__main__":
    raise SystemExit(main())
