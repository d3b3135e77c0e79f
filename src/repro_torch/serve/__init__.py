"""Multi-tenant serving on the port: the scheduler and the engine. The
cluster, replay and multiplex layers come with later slices."""
from repro_torch.serve.engine import ServeEngine, Slot
from repro_torch.serve.scheduler import Request, TenantScheduler

__all__ = ["ServeEngine", "Slot", "Request", "TenantScheduler"]
