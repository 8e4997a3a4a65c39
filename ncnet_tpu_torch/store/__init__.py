"""Persistent database-side feature store, the port of ``ncnet_tpu/store/``.

Public surface: :class:`FeatureStore` (verified reads, two-phase atomic
commits, fail-open degradation, LRU eviction, generation GC) and the key
helpers :func:`content_digest` / :func:`backbone_fingerprint` /
:func:`weights_digest` / :func:`coarse_fingerprint`; see
``feature_store.py``.
"""

from ncnet_tpu_torch.store.feature_store import (  # noqa: F401
    SCHEMA_VERSION,
    STORE_DEGRADED,
    STORE_OK,
    FeatureStore,
    backbone_fingerprint,
    coarse_fingerprint,
    content_digest,
    weights_digest,
)

__all__ = [
    "SCHEMA_VERSION",
    "STORE_DEGRADED",
    "STORE_OK",
    "FeatureStore",
    "backbone_fingerprint",
    "coarse_fingerprint",
    "content_digest",
    "weights_digest",
]
