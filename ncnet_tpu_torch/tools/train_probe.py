"""Time the composed training step across its backward-path knobs.

Usage::

    python -m ncnet_tpu_torch.tools.train_probe [batch] [dtype] [combo ...] [--device cpu]

    dtype: bf16 (the NC stack in bf16), fp32bt (an f32 volume, a bf16
    trunk), anything else f32.
    combo: name=fold,remat_filter,remat_layers,custom[,chunks] (y/n each),
    e.g. base=n,y,n,n fold=y,y,n,n fold_noremat=y,n,n,n
    default sweep: base, fold, noremat, fold_noremat

The port of ``tools/train_probe.py``: each combination builds the port's
``training/train.py::make_train_step`` with ``fold_pos_neg``,
``remat_filter``, ``remat_nc_layers``, ``nc_custom_grad`` and
``accum_chunks`` (``config.py``'s ``TrainConfig`` knobs) on the PF-Pascal
model (ResNet-101 to layer3, NC (5, 5, 5) / (16, 16, 1), random weights,
the trunk frozen) and times the whole step, the Adam update included, on
``SIZE``² pairs.  At batch 16, 400², bf16 the stack's forward takes the
FFT tier and its backward B3 (the B7 dW/db kernel, its reduction and B6's
transposed launch).  Each step consumes the loss and a parameter sum, so
neither the backward nor the update can be skipped; a combination that
fails prints its error, the sweep goes on, and the exit code is 1.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from ncnet_tpu_torch.models.ncnet import resolve_device
from ncnet_tpu_torch.tools import _probe

SIZE = 400
BACKBONE = "resnet101"
DEFAULT_COMBOS = [
    ("base", False, True, False, False, 0),
    ("fold", True, True, False, False, 0),
    ("noremat", False, False, False, False, 0),
    ("fold_noremat", True, False, False, False, 0),
]


def parse_combos(specs: List[str]):
    combos = []
    for arg in specs:
        name, spec = arg.split("=")
        parts = spec.split(",")
        fold, rf, rl, cg = [s == "y" for s in parts[:4]]
        chunks = int(parts[4]) if len(parts) > 4 else 0
        combos.append((name, fold, rf, rl, cg, chunks))
    return combos or list(DEFAULT_COMBOS)


def main(argv: Optional[List[str]] = None) -> int:
    from ncnet_tpu_torch.config import ModelConfig, TrainConfig
    from ncnet_tpu_torch.training import train as tr

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("batch", nargs="?", type=int, default=8)
    ap.add_argument("dtype", nargs="?", default="f32")
    ap.add_argument("combos", nargs="*")
    _probe.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    b = args.batch
    mcfg = ModelConfig(
        backbone=BACKBONE, ncons_kernel_sizes=(5, 5, 5),
        ncons_channels=(16, 16, 1), half_precision=args.dtype == "bf16",
        backbone_bf16=args.dtype == "fp32bt")
    tcfg = TrainConfig(model=mcfg, batch_size=b, data_parallel=False)
    state, optimizer, mcfg, _ = tr.create_train_state(tcfg, device=dev)
    print(f"device={_probe.card_line(dev)} batch={b} dtype={args.dtype} "
          f"size={SIZE}")

    results = {}
    for name, fold, rf, rl, cg, chunks in parse_combos(args.combos):
        step = tr.make_train_step(
            mcfg, optimizer, stop_backbone_grad=True, remat_nc_layers=rl,
            nc_custom_grad=cg, fold_pos_neg=fold, remat_filter=rf,
            accum_chunks=chunks)

        def tick(carry, _step=step):
            src, tgt, st = carry
            st2, loss = _step(st, {"source_image": src, "target_image": tgt})
            psum = st2.params["nc"][0]["w"].float().sum()
            src = src + (loss * 1e-9 + psum * 1e-12).to(src.dtype)
            return src, tgt, st2

        def make_input(g):
            return (torch.rand((b, SIZE, SIZE, 3), generator=g, device=dev),
                    torch.rand((b, SIZE, SIZE, 3), generator=g, device=dev),
                    state)

        try:
            ms = _probe.time_ms(tick, make_input, dev, n_long=4, reps=3)
        except Exception as e:  # noqa: BLE001 — print and go on with the sweep
            results[name] = f"FAILED: {str(e)[:300]}"
            print(f"{name:16s} FAILED: {str(e)[:300]}", flush=True)
            continue
        results[name] = ms
        rate = "" if ms is None else f"  {b / (ms * 1e-3):6.2f} pairs/s"
        print(f"{name:16s} {_probe.fmt_ms(ms, 8, 1)} ms/step{rate}",
              flush=True)
    _probe.summary({"tool": "train_probe", "batch": b, "dtype": args.dtype,
                    "size": SIZE, "ms_per_step": results})
    return int(any(isinstance(v, str) for v in results.values()))


if __name__ == "__main__":
    raise SystemExit(main())
