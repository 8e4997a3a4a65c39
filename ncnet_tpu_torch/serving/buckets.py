"""Padded shape buckets: the bounded-jit-cache discipline for serving.

Variable-resolution queries cannot each get their own compiled program — a
jit cache keyed by raw shapes grows without bound under adversarial (or
merely diverse) traffic, and every new shape pays a full trace+compile on
the serving hot path.  The bucketer maps each incoming ``(H, W)`` to the
smallest padded bucket shape that holds it (round up to a multiple, capped
at ``max_side``), and bounds the number of DISTINCT pair buckets the
service will ever compile (``max_buckets``): a request whose bucket would
exceed the bound is shed with a classified ``Overloaded(reason=
"bucket_capacity")`` instead of silently compiling program #41.

Padding is with zero bytes (black pixels).  Matching over a padded pair is
well-defined — the backbone/correlation see the padding as content — and
match coordinates come back normalized over the PADDED grid; callers that
need original-image coordinates rescale by ``orig/bucket`` (documented in
the README "Serving" section).  The demo-shaped workload (fixed 400² pairs)
always lands in one bucket and never pads.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Set, Tuple

import numpy as np

from ncnet_tpu_torch.serving.request import Bucket, Overloaded


class ShapeBucketer:
    """Thread-safe shape→bucket mapper with a bounded bucket set.

    ``multiple``: pad H and W up to this granularity (feature stride is 16,
    so 64 keeps feature-grid waste under 4 cells per axis).  ``fixed``:
    optional explicit per-side bucket ladder ``[(h, w), ...]`` — the
    smallest fixed shape that fits is used and the round-up rule is off
    (production serving pins its ladder; the round-up rule is the
    zero-config default).  ``max_buckets`` bounds DISTINCT (src, tgt) pair
    buckets ever admitted — the compiled-program budget.
    """

    def __init__(self, multiple: int = 64, max_side: int = 1024,
                 max_buckets: int = 4,
                 fixed: Optional[Sequence[Tuple[int, int]]] = None):
        if multiple < 1 or max_side < multiple or max_buckets < 1:
            raise ValueError(
                f"bad bucketer knobs: multiple={multiple} "
                f"max_side={max_side} max_buckets={max_buckets}"
            )
        self.multiple = int(multiple)
        self.max_side = int(max_side)
        self.max_buckets = int(max_buckets)
        self.fixed = (sorted((int(h), int(w)) for h, w in fixed)
                      if fixed else None)
        self._seen: Set[Bucket] = set()
        self._lock = threading.Lock()

    def _side(self, h: int, w: int) -> Optional[Tuple[int, int]]:
        if self.fixed is not None:
            for bh, bw in self.fixed:
                if h <= bh and w <= bw:
                    return (bh, bw)
            return None
        if h > self.max_side or w > self.max_side:
            return None
        m = self.multiple
        return (-(-h // m) * m, -(-w // m) * m)

    def peek(self, src_hw: Tuple[int, int],
             tgt_hw: Tuple[int, int]) -> Bucket:
        """The pair bucket for one request WITHOUT consuming budget.
        Raises :class:`Overloaded` with reason ``unservable_shape`` (too
        large for any bucket — a retry can never help) or
        ``bucket_capacity`` (a NEW bucket would exceed the
        compiled-program budget; retry with a ladder shape).  Peek and
        :meth:`commit` are split so admission can still SHED the request
        (queue full, client cap) after bucketing without permanently
        burning one of the ``max_buckets`` slots on work that never ran."""
        sb = self._side(*src_hw)
        tb = self._side(*tgt_hw)
        if sb is None or tb is None:
            raise Overloaded(
                f"shape {src_hw}/{tgt_hw} exceeds every serving bucket "
                f"(max side {self.max_side})", reason="unservable_shape",
            )
        bucket: Bucket = (sb, tb)
        with self._lock:
            if bucket not in self._seen and \
                    len(self._seen) >= self.max_buckets:
                raise Overloaded(
                    f"bucket {bucket} would exceed the compiled-program "
                    f"budget ({self.max_buckets} buckets in use)",
                    reason="bucket_capacity",
                )
        return bucket

    def commit(self, bucket: Bucket) -> None:
        """Consume a budget slot for an ADMITTED request's bucket (the
        capacity re-check closes the peek/commit race for callers that do
        not serialize the two under their own lock)."""
        with self._lock:
            if bucket not in self._seen:
                if len(self._seen) >= self.max_buckets:
                    raise Overloaded(
                        f"bucket {bucket} would exceed the compiled-"
                        f"program budget ({self.max_buckets} in use)",
                        reason="bucket_capacity",
                    )
                self._seen.add(bucket)

    def bucket_for(self, src_hw: Tuple[int, int],
                   tgt_hw: Tuple[int, int]) -> Bucket:
        """peek + commit in one step (warmup, standalone callers)."""
        b = self.peek(src_hw, tgt_hw)
        self.commit(b)
        return b

    # warmup pre-registration is the same operation now that budget is
    # tracked per BUCKET, not per request
    register = bucket_for

    @property
    def buckets(self) -> List[Bucket]:
        with self._lock:
            return sorted(self._seen)


def pad_to_bucket(imgs: Sequence[Optional[np.ndarray]], hw: Tuple[int, int]
                  ) -> np.ndarray:
    """Stack ``(H, W, 3)`` uint8 images into one zero-padded
    ``(B, bh, bw, 3)`` batch at the bucket shape.  ``None`` entries are
    batch-dimension padding (all-zero rows — the service pads coalesced
    batches up to a power-of-two ladder so the batch dim cannot multiply
    the compiled-program budget)."""
    bh, bw = hw
    out = np.zeros((len(imgs), bh, bw, 3), dtype=np.uint8)
    for i, img in enumerate(imgs):
        if img is None:
            continue
        h, w = img.shape[:2]
        out[i, :h, :w] = img
    return out
