from repro_torch.monitoring.metrics import (
    LATENCY_BUCKETS, Counter, Gauge, Histogram, MetricsRegistry, Timer,
)
from repro_torch.monitoring.trace import (
    DEFAULT_SLO_TARGETS, SLORecorder, SLOTarget, Span, SpanEvent, Tracer,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "LATENCY_BUCKETS", "MetricsRegistry",
    "Timer",
    "DEFAULT_SLO_TARGETS", "SLORecorder", "SLOTarget", "Span", "SpanEvent",
    "Tracer",
]
