from repro_torch.monitoring.metrics import (
    LATENCY_BUCKETS, Counter, Gauge, Histogram, MetricsRegistry, Timer,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "LATENCY_BUCKETS", "MetricsRegistry",
    "Timer",
]
