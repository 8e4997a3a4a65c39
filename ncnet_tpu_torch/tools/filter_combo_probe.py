"""The composed filter timed with a formulation chosen per layer,
including the ``abfold`` formulation of this tool.

Usage::

    python -m ncnet_tpu_torch.tools.filter_combo_probe [batch] [--device cpu]

The port of ``tools/filter_combo_probe.py``: the full composed filter
(corr → MM → batch-fold → L1 → L2 → L3 → unfold → MM) with each layer's
formulation overridden, plus ``abfold`` (here only, not in
``ops/conv4d.py``): kA folded into the input channels (shift-concat) and
kWA into the output channels (a shifted sum), so the 4D convolution is one
2D convolution over (hB, wB) with kA·C_in → kWA·C_out channels (80 → 80
for the 16 → 16 layer).  ``abfold`` is first held against the ``unroll``
formulation (2e-4, f32).  A combination that fails prints its error and
the exit code is 1.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch
import torch.nn.functional as F

from ncnet_tpu_torch.models.ncnet import resolve_device
from ncnet_tpu_torch.tools import _probe
from ncnet_tpu_torch.tools.filter_stage_probe import make_input_of, swap_ab

S = 25
DT = torch.bfloat16
ABFOLD_TOLERANCE = 2e-4
N_LONG = 8

COMBOS = [
    ("baseline (tapfold,coutfold,coutfold)",
     ["tapfold", "coutfold", "coutfold"]),
    ("L2=abfold", ["tapfold", "abfold", "coutfold"]),
    ("L3=afold", ["tapfold", "coutfold", "afold"]),
    ("L2=abfold L3=afold", ["tapfold", "abfold", "afold"]),
    ("L1=abfold L2=abfold L3=afold", ["abfold", "abfold", "afold"]),
    ("L2=abfold L3=abfold", ["tapfold", "abfold", "abfold"]),
]


def conv4d_abfold(x: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """kA → input-channel fold, kWA → output-channel fold; one 2D conv."""
    b, ha, wa, hb, wb, c_in = x.shape
    ka, kwa, kb, kwb, _, c_out = weight.shape
    xp = F.pad(x, (0, 0) * 4 + (ka // 2, ka // 2))
    shifts = torch.cat([xp[:, p:p + ha] for p in range(ka)], dim=-1)
    # kernel [(r, s), (p, c), (q, o)] as OIHW: ((q, o), (p, c), r, s)
    wf = weight.permute(2, 3, 0, 4, 1, 5).reshape(kb, kwb, ka * c_in,
                                                   kwa * c_out)
    y = F.conv2d(
        shifts.reshape(b * ha * wa, hb, wb, ka * c_in).permute(0, 3, 1, 2),
        wf.permute(3, 2, 0, 1), padding=(kb // 2, kwb // 2))
    y = y.permute(0, 2, 3, 1).reshape(b, ha, wa, hb, wb, kwa * c_out)
    y = F.pad(y, (0, 0) * 3 + (kwa // 2, kwa // 2))
    out = sum(y[:, :, q:q + wa, ..., q * c_out:(q + 1) * c_out]
              for q in range(kwa))
    return out if bias is None else out + bias


def make_step(variants: List[str], b: int):
    from ncnet_tpu_torch.ops.conv4d import conv4d
    from ncnet_tpu_torch.ops.correlation import correlation_4d
    from ncnet_tpu_torch.ops.matching import mutual_matching

    def apply(i, x, params):
        v = variants[i]
        w, bias = params[i]["w"], params[i]["b"]
        if v == "abfold":
            return torch.relu(conv4d_abfold(x, w, bias))
        return torch.relu(conv4d(x, w, bias, variant=v))

    def step(carry):
        fa, fb, params = carry
        x = mutual_matching(correlation_4d(fa.to(DT), fb.to(DT)))[..., None]
        x = torch.cat([x, swap_ab(x)], dim=0)
        for i in range(3):
            x = apply(i, x, params)
        y = x[..., 0]
        x = mutual_matching(y[:b] + swap_ab(y[b:]))
        return _probe.consume(fa, x), fb, params

    return step


def check_abfold(dev: torch.device, shape=(2, 7, 7, 7, 7), c_in=16,
                 c_out=8) -> float:
    """max |abfold − unroll| in f32 on seeded inputs."""
    from ncnet_tpu_torch.ops.conv4d import conv4d

    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(shape + (c_in,), generator=g, device=dev)
    w = torch.randn((5,) * 4 + (c_in, c_out), generator=g, device=dev)
    bias = torch.randn((c_out,), generator=g, device=dev)
    ref = conv4d(x, w, bias, variant="unroll")
    got = conv4d_abfold(x, w, bias)
    return float(((got - ref).abs() / (ABFOLD_TOLERANCE + ABFOLD_TOLERANCE
                                       * ref.abs())).max())


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("batch", nargs="?", type=int, default=4)
    _probe.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    b = args.batch
    with torch.no_grad():
        ratio = check_abfold(dev)
    if ratio > 1.0:
        print(f"FAIL: abfold is off unroll by {ratio:.3g}x the tolerance "
              f"(rtol = atol = {ABFOLD_TOLERANCE})")
        return 1
    print("abfold parity OK")
    print(f"device={_probe.card_line(dev)} batch={b} dtype=bf16")
    rows, failed = {}, False
    with torch.no_grad():
        for name, variants in COMBOS:
            try:
                ms = rows[name] = _probe.time_ms(
                    make_step(variants, b), make_input_of(b, dev), dev,
                    per=b, n_long=N_LONG)
                print(f"{name:>36}: {_probe.fmt_ms(ms)} ms/pair")
            except Exception as e:  # noqa: BLE001 — print and go on
                rows[name], failed = f"ERR {str(e)[:80]}", True
                print(f"{name:>36}: ERR {str(e)[:80]}")
    _probe.summary({"tool": "filter_combo_probe", "batch": b,
                    "ms_per_pair": rows})
    return int(failed)


if __name__ == "__main__":
    raise SystemExit(main())
