"""Resident match serving, the port of ``ncnet_tpu/serving/``: one serving
process.

Continuous batching into padded shape buckets, a replica pool (one engine
per CUDA device) with health-scored routing, replica failover, quarantine
and resurrection probes, elastic admission control with classified
``Overloaded`` shedding and retry-after hints, per-request deadlines at
admission, dequeue and fetch, budgeted retries, SIGTERM drain, a
STARTING/READY/DEGRADED/DRAINING/STOPPED health machine, streaming tracked
sessions, and the persistent feature store behind the engine.  On top of
the single-process service sits the network plane: a versioned wire data
plane (``wire.py`` + ``POST /match`` on the introspection server,
``introspect.py``: ``/metrics``, ``/healthz``, ``/statusz``, ``/rollout``),
a fronting ``MatchRouter`` (``router.py``) over per-host backends of
either package, and the quality-gated live rollout (``rollout.py``).
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
from ncnet_tpu_torch.serving.introspect import IntrospectionServer  # noqa: F401
from ncnet_tpu_torch.serving.replica import (  # noqa: F401
    REPLICA_DEAD,
    REPLICA_DRAINING,
    REPLICA_READY,
    Replica,
    ReplicaPool,
)
from ncnet_tpu_torch.serving.rollout import (  # noqa: F401
    ROLLOUT_CANARY,
    ROLLOUT_COMPLETE,
    ROLLOUT_IDLE,
    ROLLOUT_PROMOTING,
    ROLLOUT_ROLLED_BACK,
    ROLLOUT_ROLLING_BACK,
    ROLLOUT_STAGING,
    RolloutConfig,
    RolloutController,
    RolloutRefused,
    read_rollout_state,
    resolve_serving_checkpoint,
    write_rollout_state,
)
from ncnet_tpu_torch.serving.router import (  # noqa: F401
    BACKEND_DEAD,
    BACKEND_DRAINING,
    BACKEND_READY,
    ROUTER_DOC_SCHEMA,
    Backend,
    MatchRouter,
    RouterConfig,
    build_router_document,
)
from ncnet_tpu_torch.serving.wire import (  # noqa: F401
    WIRE_SCHEMA,
    MatchClient,
    WireError,
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
    "BACKEND_DEAD",
    "BACKEND_DRAINING",
    "BACKEND_READY",
    "Backend",
    "BatchMatchEngine",
    "DEGRADED",
    "DRAINING",
    "DeadlineExceeded",
    "HEALTH_DOC_SCHEMA",
    "HealthMachine",
    "IntrospectionServer",
    "MatchClient",
    "MatchFuture",
    "MatchRequest",
    "MatchResult",
    "MatchRouter",
    "MatchService",
    "Overloaded",
    "READY",
    "REPLICA_DEAD",
    "REPLICA_DRAINING",
    "REPLICA_READY",
    "ROLLOUT_CANARY",
    "ROLLOUT_COMPLETE",
    "ROLLOUT_IDLE",
    "ROLLOUT_PROMOTING",
    "ROLLOUT_ROLLED_BACK",
    "ROLLOUT_ROLLING_BACK",
    "ROLLOUT_STAGING",
    "ROUTER_DOC_SCHEMA",
    "Replica",
    "ReplicaPool",
    "RequestQuarantined",
    "RolloutConfig",
    "RolloutController",
    "RolloutRefused",
    "RouterConfig",
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
    "WIRE_SCHEMA",
    "WireError",
    "bucket_label",
    "build_health_document",
    "build_router_document",
    "pad_to_bucket",
    "read_rollout_state",
    "resolve_serving_checkpoint",
    "run_stream_load",
    "stream_schedule",
    "write_rollout_state",
]
