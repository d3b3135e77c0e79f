"""The stack-module fabric: one tenant-lifecycle protocol for every plane.

NetKernel's core claim is that the network stack is a *module* behind a
uniform, swappable interface. This package is that interface for tenant
lifecycle: the serving plane's ``ServeEngine``/scheduler, the bytes
plane's ``CoreEngine`` and a model-free test double implement
``StackModule``, and the cluster and placement layers move, fold,
conserve, suspend, resume, checkpoint and restore tenants through it
without naming a concrete engine class. ``StackPlane`` groups one
module per engine slot with their shared ``ConservationLedger``;
``FabricSnapshot`` is the whole fabric as one versioned value.
"""
from repro_torch.fabric.checkpoint import (
    FABRIC_SNAPSHOT_VERSION, FabricSnapshot, ModuleSnapshot, PlaneSnapshot,
)
from repro_torch.fabric.module import (
    ConservationLedger, SchedulerServeModule, StackModule, StackPlane,
    TenantLoad, TenantState,
)

__all__ = [
    "FABRIC_SNAPSHOT_VERSION", "FabricSnapshot", "ModuleSnapshot",
    "PlaneSnapshot", "ConservationLedger", "SchedulerServeModule",
    "StackModule", "StackPlane", "TenantLoad", "TenantState",
]
