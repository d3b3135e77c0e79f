"""Observability substrate: metrics registry, span tracer, latency
histograms, the time-series store and the fabric watchdog. Pure stdlib."""
from repro_torch.obs.hist import DEFAULT_BUCKETS, Histogram, TenantHistograms
from repro_torch.obs.metrics import (METRIC_HELP, MetricsRegistry,
                                     escape_label_value, format_value,
                                     parse_prometheus_text, parse_series_key,
                                     render_prometheus, render_series)
from repro_torch.obs.tracing import (TRACER, NullTracer, Tracer, get_tracer,
                                     set_tracer, trace_to)
from repro_torch.obs.timeseries import SeriesStore, series_key
from repro_torch.obs.slo import (Alert, AlertEngine, AlertRule, AbsenceRule,
                                 AdmitWaitSloRule, BurnRateRule,
                                 ConservationDriftRule, FabricWatchdog,
                                 JainFloorRule, ParkedLeakRule, SloSpec,
                                 ThresholdRule, default_rules,
                                 read_scrape_sequence, window_mature)

__all__ = [
    "DEFAULT_BUCKETS", "Histogram", "TenantHistograms",
    "METRIC_HELP", "MetricsRegistry", "escape_label_value", "format_value",
    "parse_prometheus_text", "parse_series_key", "render_prometheus",
    "render_series",
    "TRACER", "NullTracer", "Tracer", "get_tracer", "set_tracer",
    "trace_to",
    "SeriesStore", "series_key",
    "Alert", "AlertEngine", "AlertRule", "AbsenceRule", "AdmitWaitSloRule",
    "BurnRateRule", "ConservationDriftRule", "FabricWatchdog",
    "JainFloorRule", "ParkedLeakRule", "SloSpec", "ThresholdRule",
    "default_rules", "read_scrape_sequence", "window_mature",
]
