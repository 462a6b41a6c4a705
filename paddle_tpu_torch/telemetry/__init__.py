"""Telemetry of the port: the metrics registry and its sinks.  Span
tracing (``paddle_tpu/telemetry/tracing.py``) is a later slice."""

from paddle_tpu_torch.telemetry.registry import (  # noqa: F401
    SCHEMA,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_default_registry,
    host_index,
    safe_inc,
    swallow,
)
from paddle_tpu_torch.telemetry.sinks import (  # noqa: F401
    JsonlSink,
    MemorySink,
    json_default,
)
