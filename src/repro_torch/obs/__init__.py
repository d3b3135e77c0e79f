"""Observability substrate: span tracer, latency histograms and the
Prometheus formatter. Pure stdlib."""
from repro_torch.obs.hist import DEFAULT_BUCKETS, Histogram, TenantHistograms
from repro_torch.obs.metrics import (METRIC_HELP, escape_label_value,
                                     format_value, render_prometheus,
                                     render_series)
from repro_torch.obs.tracing import (TRACER, NullTracer, Tracer, get_tracer,
                                     set_tracer, trace_to)

__all__ = [
    "DEFAULT_BUCKETS", "Histogram", "TenantHistograms",
    "METRIC_HELP", "escape_label_value", "format_value",
    "render_prometheus", "render_series",
    "TRACER", "NullTracer", "Tracer", "get_tracer", "set_tracer",
    "trace_to",
]
