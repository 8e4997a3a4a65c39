"""Observability of the port: the event log, the leveled logger, metrics,
span tracing, the perf store, the match-quality signals, and the device
and memory planes (``observability/device.py``, ``memory.py``).

The JAX package's ``observability/__init__.py`` names, for the parts
ported so far (the quality drift gate, the program ledger and the
exporters are not ported yet).
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
    DIGEST_BINS,
    QUALITY_SIGNALS,
    SIGNAL_RANGE,
    active_tier,
    emit_quality,
    quality_signals,
    quality_table,
    spearman,
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
    "DIGEST_BINS",
    "QUALITY_SIGNALS",
    "SIGNAL_RANGE",
    "active_tier",
    "emit_quality",
    "quality_signals",
    "quality_table",
    "spearman",
    "PerfStore",
    "check_regressions",
    "maybe_record",
    "metric_direction",
    "resolve_store_path",
]
