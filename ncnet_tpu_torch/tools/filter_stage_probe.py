"""The composed filter's stage breakdown at the PF-Pascal shape.

Usage::

    python -m ncnet_tpu_torch.tools.filter_stage_probe [batch] [--device cpu]

The port of ``tools/filter_stage_probe.py``.  Prefix differencing: the
composed filter (each volume born from the correlation of random
features, every output consumed) is timed truncated after each stage;
consecutive differences are the stages' composed costs.  The stages are
``ncnet_filter``'s with the batch-folded symmetric stack
(``models/ncnet.py``): correlation → MM → [fold 2B] L1 → L2 → L3 →
[unfold + add] → MM, each layer ``relu(conv4d(...))`` with the
formulation chooser's pick at its shape (B5 for the 16 → 1 layer, whose
launches count in ``conv4d_pallas.launches``).
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from ncnet_tpu_torch.models.ncnet import resolve_device
from ncnet_tpu_torch.tools import _probe

IMG_FEAT = 25
FEAT_C = 128
KERNELS, CHANNELS = (5, 5, 5), (16, 16, 1)
DT = torch.bfloat16
NAMES = ["corr", "+mm1", "+fold+L1", "+L2", "+L3", "+unfold", "+mm2"]
N_LONG = 8


def swap_ab(x: torch.Tensor) -> torch.Tensor:
    """``(B, hA, wA, hB, wB, ...)`` with the A and B grids swapped."""
    return x.permute(0, 3, 4, 1, 2, *range(5, x.dim()))


def make_input_of(b: int, dev: torch.device):
    def make_input(g):
        fa = torch.randn((b, IMG_FEAT, IMG_FEAT, FEAT_C), generator=g,
                         device=dev) * 0.03
        fb = torch.randn((b, IMG_FEAT, IMG_FEAT, FEAT_C), generator=g,
                         device=dev) * 0.03
        return fa, fb, _probe.normal_stack(g, KERNELS, CHANNELS, dev, DT,
                                           b_scale=0)
    return make_input


def make_prefix(n_stages: int, b: int):
    """The composed filter truncated after stage n (1 = corr, 2 = +MM,
    3 = +fold+L1, 4 = +L2, 5 = +L3, 6 = +unfold/add, 7 = +final MM)."""
    from ncnet_tpu_torch.ops.conv4d import conv4d
    from ncnet_tpu_torch.ops.correlation import correlation_4d
    from ncnet_tpu_torch.ops.matching import mutual_matching

    def step(carry):
        fa, fb, params = carry
        x = correlation_4d(fa.to(DT), fb.to(DT))
        if n_stages >= 2:
            x = mutual_matching(x)
        if n_stages >= 3:
            x = x[..., None]
            x = torch.cat([x, swap_ab(x)], dim=0)  # batch-fold: 2B volumes
        for i in range(3):
            if n_stages >= 3 + i:
                x = torch.relu(conv4d(x, params[i]["w"], params[i]["b"]))
        if n_stages >= 6:
            y = x[..., 0]
            x = y[:b] + swap_ab(y[b:])
        if n_stages >= 7:
            x = mutual_matching(x)
        return _probe.consume(fa, x), fb, params

    return step


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("batch", nargs="?", type=int, default=4)
    _probe.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    b = args.batch
    print(f"device={_probe.card_line(dev)} batch={b} dtype=bf16 "
          f"(symmetric batch-fold: convs see batch {2 * b})")
    prev, rows = 0.0, {}
    with torch.no_grad():
        for n in range(1, len(NAMES) + 1):
            ms = rows[NAMES[n - 1]] = _probe.time_ms(
                make_prefix(n, b), make_input_of(b, dev), dev, per=b,
                n_long=N_LONG)
            delta = "" if ms is None else f"   delta {ms - prev:7.3f}"
            print(f"prefix {n} ({NAMES[n - 1]:>9}): {_probe.fmt_ms(ms)} "
                  f"ms/pair{delta}")
            prev = ms or 0.0
    _probe.summary({"tool": "filter_stage_probe", "batch": b,
                    "prefix_ms_per_pair": rows})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
