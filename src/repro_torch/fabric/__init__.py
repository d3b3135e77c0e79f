"""The stack-module fabric: one tenant-lifecycle protocol for every plane.

NetKernel's core claim is that the network stack is a *module* behind a
uniform, swappable interface. This package is that interface for tenant
lifecycle: the serving plane's ``ServeEngine``/scheduler and the bytes
plane's ``CoreEngine`` implement ``StackModule``, and tenants are moved,
folded, conserved, suspended and resumed through it without naming a
concrete engine class. The cluster planes and fabric checkpoints come with
a later slice.
"""
from repro_torch.fabric.module import (
    ConservationLedger, SchedulerServeModule, StackModule, TenantLoad,
    TenantState,
)

__all__ = [
    "ConservationLedger", "SchedulerServeModule", "StackModule",
    "TenantLoad", "TenantState",
]
