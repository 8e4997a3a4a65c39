"""The InLoc match table: the port of the post-forward half of
``ncnet_tpu/evaluation/inloc.py`` (``match_capacity``, ``recenter``,
``extract_match_table``).

Reference behaviour (``eval_inloc.py``): both-direction
``corr_to_matches`` with ``scale='positive'`` and softmax (:151-158), the
[0, 1] grid coordinates recentred onto cell centres (:179-189), and a
fixed-capacity table of N = (S/16/k)·floor((S/16/k)·3/4) rows, doubled for
both directions (:116-118).  The rest of the InLoc evaluation (the loop,
the host-side sort and dedup, the ``.mat`` files) is not ported yet.
"""

from __future__ import annotations

import math

import torch

from ncnet_tpu_torch.ops.matching import Matches, corr_to_matches

FEATURE_STRIDE = 16  # backbone stride: scale_factor 0.0625 (eval_inloc.py:77)


def match_capacity(image_size: int, k_size: int, both_directions: bool) -> int:
    """Fixed row capacity of the per-pair match table (eval_inloc.py:116-118),
    for the reference's 3:4 portrait aspect."""
    side = image_size / FEATURE_STRIDE / k_size
    n = int(side * math.floor(side * 3 / 4))
    return 2 * n if both_directions else n


def recenter(coord, n: int):
    """[0, 1] grid-endpoint coordinate → cell-centre coordinate on an
    ``n``-cell axis (eval_inloc.py:179-189): x·(n−1)/n + 0.5/n."""
    return coord * (n - 1) / n + 0.5 / n


def extract_match_table(out, *, k_size: int, do_softmax: bool,
                        both_directions: bool,
                        flip_direction: bool = False) -> torch.Tensor:
    """Filtered ``NCNetOutput`` → stacked ``(5, N)`` float32 match table
    (xA, yA, xB, yB, score), cell-centre recentred: the B→A direction
    unless ``flip_direction``, both (B→A first) with ``both_directions``.
    The volume is read in float32."""
    corr, delta4d = out.corr.to(torch.float32), out.delta4d
    fs1, fs2, fs3, fs4 = corr.shape[1:]
    k = max(k_size, 1)
    ms = []
    if both_directions or not flip_direction:
        ms.append(corr_to_matches(corr, delta4d=delta4d, k_size=k,
                                  do_softmax=do_softmax, scale="positive"))
    if both_directions or flip_direction:
        ms.append(corr_to_matches(corr, delta4d=delta4d, k_size=k,
                                  do_softmax=do_softmax, scale="positive",
                                  invert_matching_direction=True))
    xa, ya, xb, yb, score = (torch.cat([getattr(m, f) for m in ms], dim=1)
                             for f in Matches._fields)
    ya = recenter(ya, fs1 * k)
    xa = recenter(xa, fs2 * k)
    yb = recenter(yb, fs3 * k)
    xb = recenter(xb, fs4 * k)
    return torch.stack([v.to(torch.float32).reshape(-1)
                        for v in (xa, ya, xb, yb, score)])

