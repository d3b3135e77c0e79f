"""repro_torch.control — the NetKernel management plane.

Once the network stack is part of the infrastructure (CoreEngine meters
every CommOp, token buckets shape every tenant), the operator can close the
loop: observe per-tenant rates, run a congestion-control policy over a
shared bottleneck, and push allocations back into the dataplane — the
paper's use case 2 (distributed congestion control / fair bandwidth
sharing, Figs. 21-22) as a subsystem — on per-tenant objects or, with
``backend="vectorized"``, on the flat arrays of ``control/vectorized.py``.
``placement.py`` closes the second loop: where tenants run on a cluster.
"""
from repro_torch.control.congestion import (
    Aimd, CongestionControl, Dctcp, WaterFill, max_min_fair,
)
from repro_torch.control.controller import RateController
from repro_torch.control.placement import (
    PLACEMENT_POLICIES, ClusterView, Consolidate, PlacementController,
    PlacementPlan, PlacementPolicy, PlannedMove, SpreadHot, make_policy,
)
from repro_torch.control.sim import SharedBottleneckSim, SimResult, SimTenant
from repro_torch.control.telemetry import (
    EngineTelemetry, SchedulerTelemetry, TenantObs, format_prometheus,
    merge_obs,
)

__all__ = [
    "Aimd", "CongestionControl", "Dctcp", "WaterFill", "max_min_fair",
    "RateController",
    "PLACEMENT_POLICIES", "ClusterView", "Consolidate",
    "PlacementController", "PlacementPlan", "PlacementPolicy",
    "PlannedMove", "SpreadHot", "make_policy",
    "SharedBottleneckSim", "SimResult", "SimTenant",
    "EngineTelemetry", "SchedulerTelemetry", "TenantObs",
    "format_prometheus", "merge_obs",
]
