"""Observability of the port: the event log, the leveled logger, metrics,
span tracing, the perf store, and the in-graph match-quality signals.

The JAX package's ``observability/__init__.py`` names, for the modules
ported so far (its ``device`` and ``memory`` modules and the host half of
``quality`` are not ported yet).
"""

from ncnet_tpu_torch.observability.events import (  # noqa: F401
    SCHEMA_VERSION,
    EventLog,
    bound,
    emit,
    get_global_sink,
    git_revision,
    make_run_id,
    replay_events,
    run_envelope,
    set_global_sink,
)
from ncnet_tpu_torch.observability.logging import (  # noqa: F401
    LOG_LEVEL_ENV,
    Logger,
    get_logger,
)
from ncnet_tpu_torch.observability.metrics import (  # noqa: F401
    PEAK_BF16_TFLOPS,
    PEAK_HBM_GBPS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Timer,
    device_peak_tflops,
    filter_flops,
    train_step_flops,
)
from ncnet_tpu_torch.observability.perfstore import (  # noqa: F401
    PerfStore,
    check_regressions,
    maybe_record,
    metric_direction,
    resolve_store_path,
)
from ncnet_tpu_torch.observability.quality import (  # noqa: F401
    QUALITY_SIGNALS,
    quality_signals,
    quality_table,
)
from ncnet_tpu_torch.observability.tracing import (  # noqa: F401
    current_span_id,
    span,
    traced,
)

__all__ = [
    "SCHEMA_VERSION",
    "EventLog",
    "bound",
    "emit",
    "get_global_sink",
    "git_revision",
    "make_run_id",
    "replay_events",
    "run_envelope",
    "set_global_sink",
    "LOG_LEVEL_ENV",
    "Logger",
    "get_logger",
    "PEAK_BF16_TFLOPS",
    "PEAK_HBM_GBPS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Timer",
    "device_peak_tflops",
    "filter_flops",
    "train_step_flops",
    "current_span_id",
    "span",
    "traced",
    "QUALITY_SIGNALS",
    "quality_signals",
    "quality_table",
    "PerfStore",
    "check_regressions",
    "maybe_record",
    "metric_direction",
    "resolve_store_path",
]
