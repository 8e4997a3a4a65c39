"""Convert a trained dense checkpoint to rank-R CP factors, the port of the
root ``tools/cp_decompose.py``.

Loads a checkpoint (``models/checkpoint.py::load_params``: a reference
``.pth.tar``, a native directory or a ``fit`` root), attaches a ``"cp"``
factor dict beside every NC layer's dense ``"w"``/``"b"``
(``ops/cp_als.py::decompose_stack``: HOSVD init and ALS refinement), and
writes a native checkpoint.  The dense kernels stay, so the converted
checkpoint still serves every other tier.  Fine-tuning the factors with
the trunk frozen (``cli/train.py --finetune_cp_rank R``) recovers the
accuracy a low rank loses; it does this conversion in memory.

    python -m ncnet_tpu_torch.tools.cp_decompose --checkpoint trained_models/ckpt \\
        --out trained_models/ckpt_cp --rank 16 [--iters 60] [--json]

Runs on the host (numpy).  Exit codes: 0 = converted (per-layer relative
errors reported), 2 = usage or input error.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

from ncnet_tpu_torch.ops.cp_als import DEFAULT_ALS_ITERS, decompose_stack


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", required=True,
                    help="trained checkpoint (models/checkpoint.py)")
    ap.add_argument("--out", required=True,
                    help="output checkpoint dir (config + params with CP "
                         "factors attached)")
    ap.add_argument("--rank", type=int, default=None,
                    help="CP rank (default: ops/conv4d_cp.DEFAULT_CP_RANK)")
    ap.add_argument("--iters", type=int, default=DEFAULT_ALS_ITERS,
                    help="ALS refinement sweeps")
    ap.add_argument("--json", action="store_true",
                    help="emit a machine-readable summary line")
    args = ap.parse_args(argv)

    from ncnet_tpu_torch.config import ModelConfig
    from ncnet_tpu_torch.models.checkpoint import load_params, save_params
    from ncnet_tpu_torch.ops.conv4d_cp import DEFAULT_CP_RANK

    rank = args.rank if args.rank is not None else DEFAULT_CP_RANK
    if rank < 1:
        sys.stderr.write(f"--rank must be >= 1, got {rank}\n")
        return 2
    try:
        config, params = load_params(args.checkpoint, ModelConfig())
    except (OSError, ValueError) as e:
        sys.stderr.write(f"cannot load checkpoint {args.checkpoint!r}: {e}\n")
        return 2
    params = dict(params)
    params["nc"], errs = decompose_stack(params["nc"], rank, iters=args.iters)
    save_params(args.out, config, params)
    if args.json:
        print(json.dumps({"rank": rank, "iters": args.iters,
                          "rel_errs": errs, "out": args.out}))
    else:
        print(f"rank={rank} iters={args.iters}")
        for i, err in enumerate(errs):
            print(f"  nc layer {i}: relative reconstruction error {err:.4f}")
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
