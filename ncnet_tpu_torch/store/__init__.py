"""The port's own copy of what it needs from ``ncnet_tpu/store/``.

Only :func:`content_digest` so far (``ncnet_tpu/store/feature_store.py``):
the tracked serving path keys its memo of source features by it.  The
persistent feature store itself is not ported yet.
"""

from __future__ import annotations

import hashlib

import numpy as np


def content_digest(array: np.ndarray) -> str:
    """Content address of one array: sha256 over its dtype, shape and raw
    bytes, the first 32 hex digits (the JAX package's digest, bit for
    bit)."""
    a = np.ascontiguousarray(array)
    h = hashlib.sha256()
    h.update(str(a.dtype.str).encode())
    h.update(str(tuple(a.shape)).encode())
    h.update(a.tobytes())
    return h.hexdigest()[:32]
