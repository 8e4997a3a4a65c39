"""Resident match serving, the port of ``ncnet_tpu/serving/``: one serving
process.

Continuous batching into padded shape buckets, a replica pool (one engine
per CUDA device) with health-scored routing, replica failover, quarantine
and resurrection probes, elastic admission control with classified
``Overloaded`` shedding and retry-after hints, per-request deadlines at
admission, dequeue and fetch, budgeted retries, SIGTERM drain, a
STARTING/READY/DEGRADED/DRAINING/STOPPED health machine, streaming tracked
sessions, and the persistent feature store behind the engine.  The network
plane (wire, introspection, router, rollout) comes in a later slice
(ROADMAP A12).
"""

from ncnet_tpu_torch.serving.admission import AdmissionController  # noqa: F401
from ncnet_tpu_torch.serving.buckets import ShapeBucketer, pad_to_bucket  # noqa: F401
from ncnet_tpu_torch.serving.engine import BatchMatchEngine  # noqa: F401
from ncnet_tpu_torch.serving.health import (  # noqa: F401
    ADMITTING,
    DEGRADED,
    DRAINING,
    HEALTH_DOC_SCHEMA,
    READY,
    STARTING,
    STOPPED,
    HealthMachine,
    build_health_document,
)
from ncnet_tpu_torch.serving.replica import (  # noqa: F401
    REPLICA_DEAD,
    REPLICA_READY,
    Replica,
    ReplicaPool,
)
from ncnet_tpu_torch.serving.request import (  # noqa: F401
    TERMINAL_OUTCOMES,
    DeadlineExceeded,
    MatchFuture,
    MatchRequest,
    MatchResult,
    Overloaded,
    RequestQuarantined,
    ServeError,
    bucket_label,
)
from ncnet_tpu_torch.serving.service import MatchService, ServingConfig  # noqa: F401
from ncnet_tpu_torch.serving.slo import SLOTracker  # noqa: F401
from ncnet_tpu_torch.serving.stream import (  # noqa: F401
    StreamFrameResult,
    StreamSession,
    StreamTable,
    run_stream_load,
    stream_schedule,
)

__all__ = [
    "ADMITTING",
    "AdmissionController",
    "BatchMatchEngine",
    "DEGRADED",
    "DRAINING",
    "DeadlineExceeded",
    "HEALTH_DOC_SCHEMA",
    "HealthMachine",
    "MatchFuture",
    "MatchRequest",
    "MatchResult",
    "MatchService",
    "Overloaded",
    "READY",
    "REPLICA_DEAD",
    "REPLICA_READY",
    "Replica",
    "ReplicaPool",
    "RequestQuarantined",
    "SLOTracker",
    "STARTING",
    "STOPPED",
    "ServeError",
    "ServingConfig",
    "ShapeBucketer",
    "StreamFrameResult",
    "StreamSession",
    "StreamTable",
    "TERMINAL_OUTCOMES",
    "bucket_label",
    "build_health_document",
    "pad_to_bucket",
    "run_stream_load",
    "stream_schedule",
]
