"""Where the 16 → 16 NC layer's time goes: a ladder of programs that
bracket the layer from below.

Usage::

    python -m ncnet_tpu_torch.tools.xla_conv_probe [batch] [--device cpu]

The port of ``tools/xla_conv_probe.py``:

  1. ``gemm_coutfold``: the bare GEMM the ``coutfold`` conv reduces to
     (M = b·25⁴, K = 5³·16 = 2000, N = 5·16 = 80), one ``torch.matmul``;
  2. ``gemm_square``: the same FLOPs in a square-ish shape (K = 400,
     N = 400);
  3. ``conv_<variant>``: the formulations of ``ops/conv4d.py``
     (``coutfold``, ``unroll``, ``tapfold``, ``afold``), cuDNN convolutions;
  4. ``im2col_gemm``: an explicit B-side im2col, a square GEMM and the
     (p, q) shifted sum.

The GEMM rungs are context for the convolutions, not a kernel's body: if
(1) ≈ (3) the GEMM shape is the wall, if (1) ≪ (3) the convolution's
lowering is.  Times are ms a pair, every step consuming its output.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch
import torch.nn.functional as F

from ncnet_tpu_torch.models.ncnet import resolve_device
from ncnet_tpu_torch.tools import _probe
from ncnet_tpu_torch.tools.xla_layer_probe import chain

S = 25
K5 = 5
C = 16
DT = torch.bfloat16
N_LONG = 8


def im2col_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """B-side (r, s, c) im2col → square GEMM → (p, q) shifted-sum."""
    b, ha, wa, hb, wb, c = x.shape
    k = w.shape[0]
    pad = k // 2
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    patches = torch.cat([xp[:, :, :, r:r + hb, s:s + wb, :]
                         for r in range(k) for s in range(k)], dim=-1)
    w2 = w.permute(2, 3, 4, 0, 1, 5).reshape(k * k * c, k * k * c)
    y = torch.matmul(patches, w2)  # n = (p, q, o)
    y = F.pad(y, (0, 0) * 3 + (pad, pad, pad, pad))
    out = None
    for p in range(k):
        for q in range(k):
            t = (p * k + q) * c
            o = y[:, p:p + ha, q:q + wa, :, :, t:t + c]
            out = o if out is None else out + o
    return out


def main(argv: Optional[List[str]] = None) -> int:
    from ncnet_tpu_torch.ops.conv4d import conv4d

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("batch", nargs="?", type=int, default=4)
    _probe.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    b = args.batch
    print(f"device={_probe.card_line(dev)} batch={b} dtype=bfloat16")

    def vol_input(g):
        return ((torch.randn((b, S, S, S, S, C), generator=g, device=dev)
                 * 0.03).to(DT),
                (torch.randn((K5,) * 4 + (C, C), generator=g, device=dev)
                 * 0.05).to(DT))

    def gemm_input(m, k, n):
        def make(g):
            return ((torch.randn((m, k), generator=g, device=dev)
                     * 0.03).to(DT),
                    (torch.randn((k, n), generator=g, device=dev)
                     * 0.05).to(DT))
        return make

    res = {}
    m = b * S ** 4
    kw = dict(per=b, n_long=N_LONG)
    with torch.no_grad():
        res["gemm_coutfold_MK2000N80"] = _probe.time_ms(
            chain(torch.matmul), gemm_input(m, 2000, 80), dev, **kw)
        res["gemm_square_MK400N400"] = _probe.time_ms(
            chain(torch.matmul), gemm_input(m, 400, 400), dev, **kw)
        for variant in ("coutfold", "unroll", "tapfold", "afold"):
            res[f"conv_{variant}"] = _probe.time_ms(
                chain(lambda x, w, v=variant: conv4d(x, w, variant=v)),
                vol_input, dev, **kw)
        res["im2col_gemm"] = _probe.time_ms(chain(im2col_gemm), vol_input,
                                            dev, **kw)
    for k, v in sorted(res.items()):
        print(f"{k:>28}: {_probe.fmt_ms(v)} ms/pair")
    _probe.summary({"tool": "xla_conv_probe", "batch": b, "ms_per_pair": res})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
