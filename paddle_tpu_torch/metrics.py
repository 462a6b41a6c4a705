"""The user-facing metrics facade of the port (the surface of
``paddle_tpu/metrics.py`` that the serving engine and CLI use)::

    from paddle_tpu_torch import metrics
    metrics.configure(jsonl="serve.metrics.jsonl")
"""

from __future__ import annotations

from paddle_tpu_torch.telemetry import (  # noqa: F401
    JsonlSink,
    MemorySink,
    MetricsRegistry,
    get_default_registry,
)


def get_registry() -> MetricsRegistry:
    """The process-global registry every built-in instrument uses."""
    return get_default_registry()


def configure(jsonl: str, registry: MetricsRegistry | None = None):
    """Attach a JSONL sink for ``jsonl`` to the (default) registry,
    once per path; returns the sink."""
    reg = registry or get_default_registry()
    for s in reg.sinks:
        if getattr(s, "path", None) == jsonl:
            return s
    sink = JsonlSink(jsonl)
    reg.add_sink(sink)
    return sink
