"""Host-side tracing and metrics for the join pipeline (copies of
``repro.obs.trace`` and ``repro.obs.metrics``)."""
from repro_torch.obs import metrics, trace
from repro_torch.obs.metrics import (LATENCY_BUCKETS, POW2_BUCKETS, Counter,
                                     Gauge, Histogram, Metrics,
                                     compile_count, enable_compile_counter)
from repro_torch.obs.trace import (NOOP_TRACER, Span, Tracer, disable,
                                   enable, env_trace_enabled, env_trace_path,
                                   tracer, tracing)

__all__ = [
    "metrics", "trace",
    "Counter", "Gauge", "Histogram", "Metrics",
    "POW2_BUCKETS", "LATENCY_BUCKETS", "compile_count",
    "enable_compile_counter",
    "Span", "Tracer", "NOOP_TRACER", "tracer", "enable", "disable",
    "tracing", "env_trace_enabled", "env_trace_path",
]
