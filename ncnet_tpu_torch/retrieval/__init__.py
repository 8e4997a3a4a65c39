"""Shard-replicated coarse-volume retrieval: the scatter-gather shortlist
tier in front of fine matching, the port of ``ncnet_tpu/retrieval/``.

The tier is numpy and host code in both packages: the card's work on its
path is the trunk that extracts the coarse volumes and a query's
descriptor, and the fine matching of the shortlisted pairs.  Scoring stays
numpy, so an answer is bit-equal to the JAX package's on the same
volumes, and the wire is the same byte for byte, so a pod may mix shard
hosts and coordinators of both packages.

A query's pooled coarse descriptor fans out to shard hosts; each host
scores its rendezvous-assigned panos' cached coarse volumes (the feature
store's verified-read / quarantine / recompute ladder, one
``coarse_fingerprint`` generation per extractor+factor) and the
coordinator gathers a global top-k shortlist.  Replication R means a dead
shard loses capacity, not coverage; every answer carries a ``coverage``
fraction with outcome-total semantics — below ``min_coverage`` it is
DEGRADED or shed, never silently truncated.

Modules:

  * ``assignment`` — rendezvous (HRW) pano→shard placement, a pure
    function every tier derives identically;
  * ``scoring``    — coarse-volume formats + max-cosine scoring + the
    model-free ``raw`` extractor (CPU chaos path);
  * ``index``      — durable pano→digest manifests and the single-process
    ``local_shortlist`` (the InLoc in-system path);
  * ``wire``       — ``POST /retrieve`` on the NCMW framing with
    checksum-sealed answers;
  * ``shard``      — one shard host's service + introspection plane;
  * ``coordinator`` — the scatter-gather front: failover, hedging,
    probe/resurrection, coverage accounting.
"""

from ncnet_tpu_torch.retrieval.assignment import (
    assignment_table,
    rendezvous_score,
    replica_shards,
)
from ncnet_tpu_torch.retrieval.coordinator import (
    RetrievalConfig,
    RetrievalCoordinator,
    ShardBackend,
    build_retrieval_document,
    retrieval_metrics_families,
)
from ncnet_tpu_torch.retrieval.index import (
    INDEX_SCHEMA,
    load_index_manifests,
    local_shortlist,
    write_index_manifest,
)
from ncnet_tpu_torch.retrieval.scoring import (
    coarse_volume_from_features,
    pooled_descriptor,
    raw_coarse_volume,
    score_coarse_volume,
    top_k,
)
from ncnet_tpu_torch.retrieval.shard import (
    RETRIEVAL_DOC_SCHEMA,
    ShardIntrospectionServer,
    ShardService,
    shard_metrics_families,
)
from ncnet_tpu_torch.retrieval.wire import (
    RETRIEVE_CONTENT_TYPE,
    RetrieveClient,
    decode_retrieve_request,
    decode_retrieve_response,
    encode_retrieve_request,
    encode_retrieve_response,
    serve_retrieve,
)

__all__ = [
    "INDEX_SCHEMA",
    "RETRIEVAL_DOC_SCHEMA",
    "RETRIEVE_CONTENT_TYPE",
    "RetrievalConfig",
    "RetrievalCoordinator",
    "RetrieveClient",
    "ShardBackend",
    "ShardIntrospectionServer",
    "ShardService",
    "assignment_table",
    "build_retrieval_document",
    "coarse_volume_from_features",
    "decode_retrieve_request",
    "decode_retrieve_response",
    "encode_retrieve_request",
    "encode_retrieve_response",
    "load_index_manifests",
    "local_shortlist",
    "pooled_descriptor",
    "raw_coarse_volume",
    "rendezvous_score",
    "replica_shards",
    "retrieval_metrics_families",
    "score_coarse_volume",
    "serve_retrieve",
    "shard_metrics_families",
    "top_k",
    "write_index_manifest",
]
