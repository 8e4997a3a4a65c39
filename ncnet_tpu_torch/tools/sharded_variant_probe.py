"""Formulation timings at the hB-sharded filter's conv shapes.

Usage::

    python -m ncnet_tpu_torch.tools.sharded_variant_probe [--device cpu]

The port of ``tools/sharded_variant_probe.py``.  The hB-sharded path
(``parallel/spatial.py``) asks ``choose_conv4d_variant`` about shapes the
unsharded filter never has: per-shard volumes with a halo-padded hB and
``pad_hb=False`` (valid along hB).  The decision depends on shapes only,
so one card times the per-shard convolutions on inputs at exactly those
shapes: the canonical InLoc case (the pooled (1, 100, 75, 100, 75)
volume, the IVD stack at k = 3 with the tap-swap-fused first layer
1 → 32), hB = 100 sharded 8 ways: 13 local rows plus a halo of 1 on each
side.  The composed pass is L1 (1 → 32, valid along hB) → ReLU → the
halo re-pad → the two 16 → 1 twins (valid along hB) → sum, as the sharded
stack's fused branch runs it.  A combination that fails prints its error
and the exit code is 1.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch
import torch.nn.functional as F

from ncnet_tpu_torch.models.ncnet import resolve_device
from ncnet_tpu_torch.tools import _probe

DT = torch.bfloat16
# per-shard InLoc shape: hB 100 -> pad 104 -> 13 local (+2*halo(k=3)=1)
HA, WA, HB_LOC, WB = 100, 75, 13, 75
HALO = 1
K = 3
C = 16
N_LONG = 6


def make_input_of(dev):
    def make_input(g):
        def rnd(shape):
            return (torch.randn(shape, generator=g, device=dev) * 0.1).to(DT)

        return (rnd((1, HA, WA, HB_LOC + 2 * HALO, WB, 1)),
                rnd((K,) * 4 + (1, 2 * C)), rnd((K,) * 4 + (C, 1)),
                rnd((K,) * 4 + (C, 1)))
    return make_input


def make_step(v1: str, v2: str):
    from ncnet_tpu_torch.ops.conv4d import conv4d

    def step(carry):
        x, w1, w2a, w2b = carry
        y = torch.relu(conv4d(x, w1, pad_hb=False, variant=v1))
        # the sharded path re-halos between layers; one card pads the same
        # rows so L2 sees the identical shape class
        yp = F.pad(y, (0, 0, 0, 0, HALO, HALO))
        out = (torch.relu(conv4d(yp[..., :C], w2a, pad_hb=False, variant=v2))
               + torch.relu(conv4d(yp[..., C:], w2b, pad_hb=False,
                                   variant=v2)))
        return _probe.consume(x, out), w1, w2a, w2b

    return step


def auto_routing():
    from ncnet_tpu_torch.ops.conv4d import choose_conv4d_variant

    auto1 = choose_conv4d_variant(
        1, 2 * C, HB_LOC + 2 * HALO, WB, shape_a=(HA, WA), kernel=(K,) * 4,
        same_pad=False, dtype=DT, batch=1)
    auto2 = choose_conv4d_variant(
        C, 1, HB_LOC, WB, shape_a=(HA, WA), kernel=(K,) * 4,
        same_pad=False, dtype=DT, batch=1)
    return auto1, auto2


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _probe.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    auto1, auto2 = auto_routing()
    print(f"device={_probe.card_line(dev)}  auto routing: L1={auto1} "
          f"L2={auto2}")
    combos = [
        ("auto", ("auto", "auto")),
        (f"pinned auto ({auto1},{auto2})", (auto1, auto2)),
        ("L1=coutfold", ("coutfold", auto2)),
        ("L1=unroll", ("unroll", auto2)),
        ("L2=unroll", (auto1, "unroll")),
        ("L2=tapfold", (auto1, "tapfold")),
        ("both unroll", ("unroll", "unroll")),
    ]
    rows, failed = {}, False
    with torch.no_grad():
        for name, (v1, v2) in combos:
            try:
                ms = rows[name] = _probe.time_ms(
                    make_step(v1, v2), make_input_of(dev), dev,
                    n_long=N_LONG)
                print(f"{name:>28}: {_probe.fmt_ms(ms, 8)} ms/shard-pass")
            except Exception as e:  # noqa: BLE001 — print and go on
                rows[name], failed = f"ERR {str(e)[:80]}", True
                print(f"{name:>28}: ERR {str(e)[:80]}")
    _probe.summary({"tool": "sharded_variant_probe",
                    "auto": [auto1, auto2], "ms_per_shard_pass": rows})
    return int(failed)


if __name__ == "__main__":
    raise SystemExit(main())
