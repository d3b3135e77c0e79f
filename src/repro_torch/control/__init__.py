"""repro_torch.control — the NetKernel management plane.

Observe per-tenant rates, run a congestion-control policy over a shared
bottleneck, and push allocations back into the schedulers' token buckets
(the paper's use case 2), on per-tenant objects or, with
``backend="vectorized"``, on the flat arrays of ``control/vectorized.py``.
Placement and the fluid simulator come with later slices of the port.
"""
from repro_torch.control.congestion import (
    Aimd, CongestionControl, Dctcp, WaterFill, max_min_fair,
)
from repro_torch.control.controller import RateController
from repro_torch.control.telemetry import (
    SchedulerTelemetry, TenantObs, format_prometheus, merge_obs,
)

__all__ = [
    "Aimd", "CongestionControl", "Dctcp", "WaterFill", "max_min_fair",
    "RateController", "SchedulerTelemetry", "TenantObs",
    "format_prometheus", "merge_obs",
]
