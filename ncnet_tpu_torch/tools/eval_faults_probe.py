"""Every NC tier the port offers at a resident-eligible shape, held
against the plain stack, and a device failure injected into a dispatch
retried on the same tier.

Usage::

    python -m ncnet_tpu_torch.tools.eval_faults_probe [side] [--device cpu]

    side: the square volume side, default 25 (the PF-Pascal shape class).

The port of ``tools/eval_faults_probe.py``.  The JAX tool walks the
runtime tier ladder (``demote_fused_tier``, ``ResilientJit.retrace``); the
port has no runtime demotion (ROADMAP D4: the route is decided from
shapes before any launch), so this probe does two things instead:

  * it runs every tier by calling its stack function: the resident stack
    and the per-layer chain (B6, ``ops/nc_fused_lane.py``), the FFT tier
    (``ops/conv4d_fft.py::nc_stack_fft``) and the plain formulation stack
    (``relu(conv4d(...))`` per layer), holding each within 0.1 of the
    plain stack (the JAX tool's bound; the input is scaled by 0.1, as the
    sibling probes scale theirs, so that the outputs stay where 0.1 is
    several bf16 ulps) and printing each error;
  * it injects a device failure through ``utils/faults.py`` into the
    second of three dispatches (the chooser's route,
    ``nc_fused_lane.fused_stack_forward``), retried by the eval loop's
    ``evaluation/resilience.py::run_isolated``: the retry runs the same
    tier as call 1 (``last_selected_tier``) and its output is bit-equal
    to call 1's.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from ncnet_tpu_torch.ops import nc_fused_lane
from ncnet_tpu_torch.ops.conv4d_fft import nc_stack_fft
from ncnet_tpu_torch.models.ncnet import resolve_device
from ncnet_tpu_torch.tools import _probe

KERNELS, CHANNELS = (5, 5, 5), (16, 16, 1)
TOLERANCE = 0.1
# the input's scale, the sibling probes' (nc_resident_probe): outputs of
# a few units, where the bound is several bf16 ulps (an unscaled input
# gives outputs past 16, where one bf16 ulp is 0.125)
X_SCALE = 0.1

TIERS = {
    "resident": nc_fused_lane.nc_stack_resident,
    "fused_lane": nc_fused_lane.nc_stack_fused_lane,
    "fft": nc_stack_fft,
    "xla": _probe.plain_stack,
}


def run_tiers(params: List[dict], x: torch.Tensor) -> dict:
    """Each tier's output (f32) and its max |diff| from the plain stack."""
    with torch.no_grad():
        outs = {t: fn(params, x).float() for t, fn in TIERS.items()}
    ref = outs["xla"]
    return {"outputs": outs,
            "errors": {t: float((o - ref).abs().max())
                       for t, o in outs.items()}}


def retry_check(params: List[dict], x: torch.Tensor) -> dict:
    """Three dispatches through the chooser's route with a device failure
    injected into the second, retried by ``run_isolated``."""
    from ncnet_tpu_torch.evaluation.resilience import FaultPolicy, run_isolated
    from ncnet_tpu_torch.utils import faults

    def dispatch():
        faults.device_error_hook("eval_faults_probe")
        with torch.no_grad():
            out = nc_fused_lane.fused_stack_forward(params, x)
        return out, nc_fused_lane.last_selected_tier()

    kinds = []
    faults.install(faults.FaultPlan(device_fail_calls=(2,)))
    try:
        first, start = dispatch()  # call 1: fine
        ok, (retried, tier) = run_isolated(
            "probe", dispatch,  # call 2 fails, call 3 is the retry
            policy=FaultPolicy(retries=1, backoff_s=0.0, quarantine=False),
            on_failure=lambda e, kind: kinds.append(kind))
    finally:
        faults.clear()
    return {"start": start, "retry_tier": tier, "failure_kinds": kinds,
            "bit_equal": bool(torch.equal(first, retried)),
            "output": first}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("side", nargs="?", type=int, default=25)
    _probe.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    s = args.side
    print(f"device={_probe.card_line(dev)} S={s}")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = _probe.normal_stack(gen, KERNELS, CHANNELS, dev)
    x = (torch.randn((1, s, s, s, s, 1), generator=gen, device=dev)
         * X_SCALE).to(torch.bfloat16)
    chooser = nc_fused_lane.choose_fused_stack(s, s, s, s, KERNELS, CHANNELS)
    print(f"chooser: {chooser or 'xla'} (every tier runs below)")
    res = run_tiers(params, x)
    for t, err in res["errors"].items():
        print(f"parity {t} vs xla: max|diff|={err:.3e}")
    bad = [t for t, e in res["errors"].items() if not e < TOLERANCE]
    if bad:
        print(f"FAIL: tier(s) {bad} diverged from the plain stack")
        return 1

    rc = retry_check(params, x)
    print(f"recovery: started on '{rc['start']}', failure "
          f"{rc['failure_kinds']}, retry ran '{rc['retry_tier']}', "
          f"bit-equal to call 1: {rc['bit_equal']}")
    if rc["failure_kinds"] != ["device"] or rc["retry_tier"] != rc["start"] \
            or not rc["bit_equal"]:
        print("FAIL: the injected failure did not fire once, or the retry "
              "ran another tier or another output")
        return 1
    _probe.summary({"tool": "eval_faults_probe", "side": s,
                    "chooser": chooser or "xla", "errors": res["errors"],
                    **{k: v for k, v in rc.items() if k != "output"}})
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
