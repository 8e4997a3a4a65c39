"""4D max-pooling with argmax decomposition ("relocalization").

The port of ``ncnet_tpu/ops/pooling.py``.  NCNet's long-context trick
(reference ``lib/model.py:177-191``): correlate at k× grid resolution,
max-pool the 4D volume by k (k⁴× fewer cells) while remembering where in
each k⁴ box the maximum sat, filter the pooled volume, and add the offsets
back at match extraction (``ops/matching.py::corr_to_matches``).  One
reshape, permute and argmax; ``torch.argmax`` returns the first maximal
index, as ``jnp.argmax`` does, so a box with tied values gives the same
offsets in both packages.
"""

from __future__ import annotations

from typing import Tuple

import torch


def maxpool4d_with_argmax(corr: torch.Tensor, k: int
                          ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Pool ``(B, hA, wA, hB, wB)`` by ``k`` along all four spatial dims.

    Returns ``pooled`` ``(B, hA/k, wA/k, hB/k, wB/k)`` (the input's dtype)
    and the int32 offsets ``(di, dj, dk, dl)`` of each box's maximum,
    shaped like ``pooled``, linearized as ``((di·k + dj)·k + dk)·k + dl``
    (the reference decodes it by repeated fmod/div, model.py:186-189)."""
    b, ha, wa, hb, wb = corr.shape
    if ha % k or wa % k or hb % k or wb % k:
        raise ValueError(
            f"volume dims {tuple(corr.shape[1:])} must be divisible by k={k}")
    v = corr.reshape(b, ha // k, k, wa // k, k, hb // k, k, wb // k, k)
    # the four intra-box dims to the back, in (di, dj, dk, dl) order
    v = v.permute(0, 1, 3, 5, 7, 2, 4, 6, 8).reshape(
        b, ha // k, wa // k, hb // k, wb // k, k ** 4)
    idx = torch.argmax(v, dim=-1, keepdim=True)
    pooled = torch.gather(v, -1, idx)[..., 0]
    # int32 before the decode: the int64 index of a 100⁴ volume is 8 bytes
    # a cell for each of the four offsets
    idx = idx[..., 0].to(torch.int32)
    dl = idx % k
    dk = (idx // k) % k
    dj = (idx // (k * k)) % k
    di = idx // (k * k * k)
    return pooled, (di, dj, dk, dl)
