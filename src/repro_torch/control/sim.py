"""Virtual-time harness: tenants offering load through enforced CoreEngines.

The management plane's testbed (and the paper-Fig. 21/22 benchmark driver).
Tenants are open-loop senders — each tick they offer ``demand * dt`` bytes
of ``shm_move`` CommOps through their engine(s), misbehaving or not; the
engines' token buckets admit what fits and meter the shortfall; the
RateController closes the loop every ``control_every`` ticks. Everything
runs on a simulated clock, so runs are deterministic and take milliseconds.

``demand`` may be a constant (bytes/s) or a ``f(t) -> bytes/s`` callable for
time-varying load (bursts, idle periods, the work-conserving scenarios).

``backend="vectorized"`` runs the controller on the flat-array plane: its
telemetry banks and one water-fill kernel launch per tick on ``device``
(``cuda`` unless ``"cpu"`` is passed, an error without a card).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.control.congestion import (
    CongestionControl, WaterFill, max_min_fair,
)
from repro_torch.control.controller import RateController
from repro_torch.core.engine import CoreEngine

Demand = Union[float, Callable[[float], float]]


class _Payload:
    """Duck-typed array stand-in: bytes on the wire, nothing in memory."""

    __slots__ = ("shape",)
    dtype = np.uint8

    def __init__(self, n: int):
        self.shape = (int(n),)


@dataclass
class SimTenant:
    tenant_id: int
    demand: Demand                    # offered bytes/s (constant or f(t))
    weight: float = 1.0
    # fraction of this tenant's traffic entering each engine; None = even
    engine_split: Optional[Sequence[float]] = None

    def offered_at(self, t: float) -> float:
        d = self.demand(t) if callable(self.demand) else self.demand
        return max(float(d), 0.0)


@dataclass
class SimResult:
    dt: float
    times: List[float]
    served_cum: Dict[int, List[float]]      # cumulative in-rate bytes
    offered_cum: Dict[int, List[float]]
    allocations: List[Dict[int, float]]     # controller history

    def served_rate(self, tenant_id: int, frac_from: float = 0.5,
                    frac_to: float = 1.0) -> float:
        """Mean served rate over a window given as fractions of the run."""
        cum = self.served_cum[tenant_id]
        i = min(int(len(cum) * frac_from), len(cum) - 1)
        j = min(int(len(cum) * frac_to) - 1, len(cum) - 1)
        if j <= i:
            return 0.0
        return (cum[j] - cum[i]) / ((j - i) * self.dt)

    def total_served_rate(self, frac_from: float = 0.5,
                          frac_to: float = 1.0) -> float:
        return sum(self.served_rate(t, frac_from, frac_to)
                   for t in self.served_cum)


class SharedBottleneckSim:
    """N tenants x M engines sharing one bottleneck under a RateController."""

    def __init__(self, tenants: Sequence[SimTenant], capacity: float,
                 *, n_engines: int = 1,
                 algo: Optional[CongestionControl] = None,
                 dt: float = 0.05, control_every: int = 4,
                 axes: Tuple[str, ...] = ("pod",),
                 alpha: float = 0.5, burst_s: float = 0.25,
                 push_mode: str = "full", delta_tol: float = 0.05,
                 backend: str = "object", device=None):
        self.tenants = list(tenants)
        self.capacity = float(capacity)
        self.dt = dt
        self.control_every = control_every
        self.axes = axes
        self.engines = [CoreEngine(enforcement="account")
                        for _ in range(n_engines)]
        if algo is None:
            algo = WaterFill({t.tenant_id: t.weight for t in self.tenants},
                             min_rate=capacity * 1e-3, backend=backend,
                             device=device)
        self.controller = RateController(capacity, algo=algo, alpha=alpha,
                                         burst_s=burst_s,
                                         push_mode=push_mode,
                                         delta_tol=delta_tol,
                                         backend=backend)
        for eng in self.engines:
            self.controller.attach_engine(eng, axes)
        self._elapsed = 0.0

    def _splits(self, tenant: SimTenant) -> Sequence[float]:
        if tenant.engine_split is not None:
            return tenant.engine_split
        return [1.0 / len(self.engines)] * len(self.engines)

    def _served(self, tenant_id: int) -> float:
        return sum(e.total_bytes(tenant_id) - e.deferred_bytes(tenant_id)
                   for e in self.engines)

    def _offered(self, tenant_id: int) -> float:
        return sum(e.total_bytes(tenant_id) for e in self.engines)

    def run(self, duration: float) -> SimResult:
        steps = max(int(round(duration / self.dt)), 1)
        res = SimResult(dt=self.dt, times=[],
                        served_cum={t.tenant_id: [] for t in self.tenants},
                        offered_cum={t.tenant_id: [] for t in self.tenants},
                        allocations=self.controller.history)
        for k in range(steps):
            now = self._elapsed + (k + 1) * self.dt
            for tenant in self.tenants:
                want = tenant.offered_at(now) * self.dt
                for eng, frac in zip(self.engines, self._splits(tenant)):
                    n = int(round(want * frac))
                    if n > 0:
                        eng.dispatch("shm_move", _Payload(n), self.axes,
                                     tenant_id=tenant.tenant_id, now=now)
            if (k + 1) % self.control_every == 0:
                self.controller.tick(now)
            res.times.append(now)
            for tenant in self.tenants:
                res.served_cum[tenant.tenant_id].append(
                    self._served(tenant.tenant_id))
                res.offered_cum[tenant.tenant_id].append(
                    self._offered(tenant.tenant_id))
        self._elapsed += steps * self.dt
        return res

    def fair_reference(self) -> Dict[int, float]:
        """The weighted max-min fair allocation of the *final* demands —
        what a converged controller should be serving."""
        t_end = self._elapsed if self._elapsed > 0 else 0.0
        demands = {t.tenant_id: t.offered_at(t_end) for t in self.tenants}
        weights = {t.tenant_id: t.weight for t in self.tenants}
        return max_min_fair(self.capacity, demands, weights)
