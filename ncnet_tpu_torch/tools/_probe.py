"""What the port's tier and stage probes share: the device argument, the
header line, timing that happens only on the card, measured memory rows,
and the seeded NC stacks the probes time.

Every probe runs on the card unless ``--device cpu`` is given (without a
GPU and without it, ``models/ncnet.py::resolve_device`` raises).  On the CPU a probe runs
its parity checks and each timed step once, so that its code is exercised,
and times nothing: :func:`time_ms` returns None and :func:`fmt_ms` prints
"not measured".  Memory rows are likewise measured only on the card
(:func:`measure_memory`, ROADMAP D9): the peak allocated over one run less
what was allocated before it, less the result, as the temp bytes.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ncnet_tpu_torch.models.ncnet import tree_leaves
from ncnet_tpu_torch.tools import _timing

#: ``(n_long, reps)`` upper bounds on every probe's timing, for a caller that
#: must finish inside a time budget (``chip_smoke.py``'s phase X); None
#: keeps each probe's own
TIMING_CAP: Optional[Tuple[int, int]] = None


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "parity checks and times nothing)")


def card_line(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    ``cpu``."""
    if dev.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "-i", str(dev.index or 0),
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return f"{torch.cuda.get_device_name(dev)}, power limit unread"


def time_ms(step_fn: Callable, make_input: Callable, dev: torch.device,
            **kw) -> Optional[float]:
    """``_timing.timeit`` of ``step_fn`` on the card; on the CPU the step
    runs once from ``make_input`` and nothing is timed (None)."""
    if dev.type != "cuda":
        step_fn(make_input(torch.Generator(device=dev).manual_seed(0)))
        return None
    if TIMING_CAP is not None:
        kw["n_long"] = max(2, min(kw.get("n_long", 6), TIMING_CAP[0]))
        kw["reps"] = max(1, min(kw.get("reps", 3), TIMING_CAP[1]))
    return _timing.timeit(step_fn, make_input, device=dev, **kw)


def fmt_ms(ms: Optional[float], width: int = 7, digits: int = 3) -> str:
    return "not measured" if ms is None else f"{ms:{width}.{digits}f}"


def nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if torch.is_tensor(t))


def measure_memory(run: Callable, dev: torch.device, args=()
                   ) -> Tuple[object, Optional[dict]]:
    """``(run(), row)``: on the card the measured ledger fields of one run
    (``argument_bytes`` of ``args``, ``output_bytes`` of the result,
    ``temp_bytes`` the peak allocated less what was allocated before and
    less the result); on the CPU ``row`` is None."""
    if dev.type != "cuda":
        return run(), None
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    out = run()
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    out_bytes = nbytes(out)
    return out, {"argument_bytes": nbytes(args), "output_bytes": out_bytes,
                 "temp_bytes": max(0, peak - before - out_bytes)}


def memory_line(name: str, row: Optional[dict]) -> str:
    if row is None:
        return f"memory {name}: none measured (the CPU was asked for)"
    return (f"memory {name}: temp {row['temp_bytes']:,} B, output "
            f"{row['output_bytes']:,} B, arguments {row['argument_bytes']:,} B")


def normal_stack(gen: torch.Generator, kernels: Sequence[int],
                 channels: Sequence[int], dev: torch.device,
                 dtype=torch.bfloat16, w_scale: float = 0.05,
                 b_scale: float = 0.1) -> List[dict]:
    """An NC stack of normal weights (``w_scale``) and biases
    (``b_scale``, 0 gives zeros) drawn on ``dev`` from ``gen``."""
    params, c_in = [], 1
    for k, c_out in zip(kernels, channels):
        w = torch.randn((k,) * 4 + (c_in, c_out), generator=gen, device=dev)
        b = (torch.randn((c_out,), generator=gen, device=dev) * b_scale
             if b_scale else torch.zeros((c_out,), device=dev))
        params.append({"w": (w * w_scale).to(dtype), "b": b.to(dtype)})
        c_in = c_out
    return params


def init_stack(seed: int, kernels: Sequence[int], channels: Sequence[int],
               dev: torch.device, dtype=torch.float32) -> List[dict]:
    """The reference Conv4d init (``ops/conv4d.py::conv4d_init``) of a
    stack from a seeded CPU generator, moved to ``dev``."""
    from ncnet_tpu_torch.ops.conv4d import conv4d_init

    gen = torch.Generator().manual_seed(seed)
    params, c_in = [], 1
    for k, c_out in zip(kernels, channels):
        w, b = conv4d_init(gen, k, c_in, c_out)
        params.append({"w": w.to(dev, dtype), "b": b.to(dev, dtype)})
        c_in = c_out
    return params


def plain_stack(params: List[dict], x: torch.Tensor) -> torch.Tensor:
    """``relu(conv4d(x, w, b))`` layer by layer, each layer's formulation
    from the chooser (``variant="auto"``: B5 for a small-C_out layer)."""
    from ncnet_tpu_torch.ops.conv4d import conv4d

    for layer in params:
        x = torch.relu(conv4d(x, layer["w"], layer["b"]))
    return x


def rel_err(got: torch.Tensor, want: torch.Tensor) -> Tuple[float, float]:
    """``(max |got − want|, that over max |want|)`` in f32."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    return err, err / max(1e-6, float(want.abs().max()))


def consume(x: torch.Tensor, *outs) -> torch.Tensor:
    """``x`` nudged by 1e-12 of the sum of every output, so each timed step
    depends on the last and on everything it computed."""
    eps = sum(t.float().sum() for o in outs for t in tree_leaves(o)
              if torch.is_tensor(t))
    return x + (eps * 1e-12).to(x.dtype)


def summary(doc: dict) -> None:
    """The probe's numbers as one ``summary {json}`` line."""
    print("summary " + json.dumps(doc, sort_keys=True, default=str),
          flush=True)
