"""Stage-isolated timings of the InLoc-resolution matcher on the card.

Usage::

    python -m ncnet_tpu_torch.tools.inloc_stage_probe [--device cpu]

The port of ``tools/inloc_stage_probe.py``: each stage timed on its own
at the real InLoc shapes (a 4032 × 3024 query and a 1200 × 1600 cutout,
both resized to a longest side of 3200 with k = 2 quantization; the IVD
model, NC (3, 3) / (16, 1), bf16 trunk and stack), so the per-pair device
total can be attributed stage by stage:

  1. the cutout's preprocessing (uint8 → ImageNet normalization → the
     quantized resize);
  2. the trunk on the cutout (the query's is shared by its cutouts);
  3. the fine correlation of bf16 features;
  4. the filter: maxpool4d (k = 2), mutual matching, the NC stack (the
     tap-swap chain on B6 at this rectangular volume), mutual matching;
  5. match extraction in both directions with softmax on the pooled
     volume, the relocalization offsets included.

Each step consumes every output it means to time (the filter's offsets
and the matches' coordinates too), and the filter's volume is born from a
correlation of random features, as in the pipeline.
"""

from __future__ import annotations

import argparse
import warnings
from typing import List, Optional

import torch

from ncnet_tpu_torch.models.ncnet import resolve_device
from ncnet_tpu_torch.tools import _probe

QUERY_HW, DB_HW, IMAGE_SIZE, K_SIZE = (4032, 3024), (1200, 1600), 3200, 2
BACKBONE = "resnet101"
FEAT_C, ANCHOR_C = 1024, 8


def shapes():
    """(query, db) resized shapes, their fine feature grids and the pooled
    grids."""
    from ncnet_tpu_torch.evaluation.inloc import quantized_resize_shape

    q = quantized_resize_shape(*QUERY_HW, IMAGE_SIZE, K_SIZE)
    d = quantized_resize_shape(*DB_HW, IMAGE_SIZE, K_SIZE)
    fq, fd = (q[0] // 16, q[1] // 16), (d[0] // 16, d[1] // 16)
    return q, d, fq, fd, (fq[0] // K_SIZE, fq[1] // K_SIZE), \
        (fd[0] // K_SIZE, fd[1] // K_SIZE)


def main(argv: Optional[List[str]] = None) -> int:
    from ncnet_tpu_torch.config import ModelConfig
    from ncnet_tpu_torch.models.ncnet import (
        extract_features,
        init_ncnet,
        ncnet_filter,
        params_to,
    )
    from ncnet_tpu_torch.ops.correlation import correlation_4d
    from ncnet_tpu_torch.ops.image import (
        normalize_imagenet,
        resize_bilinear_align_corners,
    )
    from ncnet_tpu_torch.ops.matching import corr_to_matches

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _probe.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = ModelConfig(backbone=BACKBONE, ncons_kernel_sizes=(3, 3),
                      ncons_channels=(16, 1), half_precision=True,
                      backbone_bf16=True, relocalization_k_size=K_SIZE)
    (qh, qw), (dh, dw), fq, fd, pq, pd = shapes()
    print(f"device={_probe.card_line(dev)}  query {qh}x{qw} -> fine {fq} "
          f"pooled {pq}; db {dh}x{dw} -> fine {fd} pooled {pd}")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # a random trunk, on purpose
        params = params_to(init_ncnet(cfg, 0), dev)
    res = {}

    def chain1(op):
        def step(x):
            return _probe.consume(x, op(x))
        return step

    with torch.no_grad():
        # 1. the cutout's preprocessing
        def prep_in(g):
            return torch.randint(0, 255, (1, *DB_HW, 3), generator=g,
                                 device=dev, dtype=torch.uint8)

        def prep(img):
            out = resize_bilinear_align_corners(normalize_imagenet(img), dh, dw)
            return img + (out.sum() * 1e-12).to(torch.uint8)

        res["preprocess_db"] = _probe.time_ms(prep, prep_in, dev)

        # 2. the trunk on the cutout
        def bb_in(g):
            return torch.rand((1, dh, dw, 3), generator=g, device=dev) * 2 - 1

        res["backbone_db"] = _probe.time_ms(
            chain1(lambda x: extract_features(cfg, params, x)), bb_in, dev)

        # 3. the fine correlation of bf16 features
        def corr_in(g):
            return ((torch.randn((1, *fq, FEAT_C), generator=g, device=dev)
                     * 0.03).to(torch.bfloat16),
                    (torch.randn((1, *fd, FEAT_C), generator=g, device=dev)
                     * 0.03).to(torch.bfloat16))

        def corr_step(carry):
            a, b = carry
            return _probe.consume(a, correlation_4d(a, b)), b

        res["correlation_fine"] = _probe.time_ms(corr_step, corr_in, dev)

        # 4. the filter on a volume born from a correlation
        def vol_in(g):
            return ((torch.randn((1, *fq, ANCHOR_C), generator=g, device=dev)
                     * 0.2).to(torch.bfloat16),
                    (torch.randn((1, *fd, ANCHOR_C), generator=g, device=dev)
                     * 0.2).to(torch.bfloat16))

        def filter_step(carry):
            fa, fb = carry
            out = ncnet_filter(cfg, params, correlation_4d(fa, fb))
            return _probe.consume(fa, out.corr, out.delta4d), fb

        res["filter_pool_mm_nc"] = _probe.time_ms(filter_step, vol_in, dev)

        # 5. match extraction, both directions, softmax, pooled volume
        def pooled_in(g):
            corr = torch.randn((1, *pq, *pd), generator=g, device=dev) * 0.03
            delta = tuple(torch.randint(0, 2, (1, *pq, *pd), generator=g,
                                        device=dev, dtype=torch.int32)
                          for _ in range(4))
            return corr, delta

        def extract_step(carry):
            corr, delta = carry
            ms = [corr_to_matches(corr, delta4d=delta, k_size=K_SIZE,
                                  do_softmax=True, scale="positive",
                                  invert_matching_direction=inv)
                  for inv in (False, True)]
            return _probe.consume(corr, [v for m in ms for v in (
                m.xA, m.yA, m.xB, m.yB, m.score)]), delta

        res["extract_both_dirs"] = _probe.time_ms(extract_step, pooled_in,
                                                  dev)

    for k, v in res.items():
        print(f"{k:>20}: {_probe.fmt_ms(v, 7, 1)} ms")
    total = (None if any(v is None for v in res.values())
             else sum(res.values()))
    print(f"{'sum of stages':>20}: {_probe.fmt_ms(total, 7, 1)} ms")
    _probe.summary({"tool": "inloc_stage_probe", "fine": [fq, fd],
                    "pooled": [pq, pd], "stage_ms": res, "sum_ms": total})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
