"""Pluggable congestion-control algorithms for shared bottlenecks.

Each algorithm maps one control interval's observations (per-tenant
``TenantObs``) plus the bottleneck capacity to per-tenant rate allocations.
Three families, mirroring what operators actually deploy:

  * ``WaterFill`` — weighted max-min fair progressive filling. Backlogged
    tenants are treated as infinitely greedy and split the residual after
    satisfied tenants take their (measured) demand. Converges in one or two
    intervals; the paper's Fig. 21/22 "enforce fair sharing" policy.
  * ``Aimd`` — TCP-style additive-increase / multiplicative-decrease on the
    aggregate congestion signal. No demand estimation needed; converges to
    fair shares the classic sawtooth way.
  * ``Dctcp`` — multiplicative decrease proportional to an EWMA of the
    *fraction* of traffic deferred (the analogue of ECN marking fraction
    driven by queue depth), so the backoff is graded, not binary.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

from repro_torch.control.telemetry import TenantObs
from repro_torch.control.vectorized import check_backend, waterfill_allocate
from repro_torch.device import resolve_device

INF = math.inf


def max_min_fair(capacity: float, demands: Mapping[int, float],
                 weights: Optional[Mapping[int, float]] = None
                 ) -> Dict[int, float]:
    """Weighted max-min fair allocation by progressive filling.

    Tenants whose demand is below their weighted fair share are fully
    satisfied; the freed capacity is re-divided among the rest (water
    filling). ``inf`` demand = greedy. Allocations sum to at most
    ``capacity`` and exactly to ``capacity`` when demand is sufficient.
    """
    if capacity <= 0 or not demands:
        return {t: 0.0 for t in demands}
    w = {t: (weights.get(t, 1.0) if weights else 1.0) for t in demands}
    alloc = {t: 0.0 for t in demands}
    active = {t for t, d in demands.items() if d > 0 and w[t] > 0}
    remaining = float(capacity)
    # maintained incrementally as tenants are satisfied: each round is
    # O(active), not O(active^2) across rounds
    wsum = sum(w[t] for t in active)
    while active and remaining > 1e-12 and wsum > 1e-300:
        share = remaining / wsum            # capacity per unit weight
        satisfied = {t for t in active if demands[t] <= w[t] * share + 1e-12}
        if not satisfied:
            # everyone is greedy at this water level: split and finish
            for t in active:
                alloc[t] += w[t] * share
            remaining = 0.0
            break
        for t in satisfied:
            alloc[t] = float(demands[t])
            remaining -= demands[t]
            wsum -= w[t]
        active -= satisfied
    return alloc


class CongestionControl:
    """Base: ``allocate(obs, capacity) -> {tenant: rate}``. Stateful —
    algorithms carry per-tenant rates between control intervals."""

    def allocate(self, obs: Dict[int, TenantObs],
                 capacity: float) -> Dict[int, float]:
        raise NotImplementedError

    def reset(self) -> None:
        pass


class WaterFill(CongestionControl):
    """Measured-demand weighted max-min fairness.

    A tenant that experienced deferral (or has queue depth) is backlogged —
    its true demand is unknown, only that it exceeds its allocation — so it
    bids ``inf`` and receives a fair share of the residual. A satisfied
    tenant bids its observed offered rate times ``headroom`` so its
    allocation can track demand growth between intervals.

    ``backend="vectorized"`` runs the fill as one launch of the water-fill
    kernel (``waterfill_allocate``) on ``device`` (``cuda`` unless
    ``"cpu"`` is passed) instead of the scalar loop — same allocations
    within 1e-6 x capacity, flat cost per tenant.
    """

    def __init__(self, weights: Optional[Mapping[int, float]] = None,
                 headroom: float = 1.25, min_rate: float = 0.0,
                 backend: str = "object", device=None):
        self.weights = dict(weights or {})
        self.headroom = headroom
        self.min_rate = min_rate
        self.backend = check_backend(backend)
        self.device = resolve_device(device) if backend == "vectorized" \
            else None

    def allocate(self, obs, capacity):
        # deferral is EWMA-smoothed, so it decays toward zero but never
        # reaches it after a tenant goes quiet; judge it against a noise
        # floor relative to the fair share or the idle tenant would keep
        # bidding inf and pin capacity it no longer uses
        eps = 1e-3 * capacity / max(len(obs), 1)
        demands = {t: (INF if (o.deferred > eps or o.queue > 0)
                       else o.offered * self.headroom)
                   for t, o in obs.items()}
        if self.backend == "vectorized":
            alloc = waterfill_allocate(demands, capacity, self.weights,
                                       device=self.device)
        else:
            alloc = max_min_fair(capacity, demands, self.weights)
        if self.min_rate > 0:
            alloc = {t: max(r, self.min_rate) for t, r in alloc.items()}
        return alloc


class Aimd(CongestionControl):
    """Additive increase, multiplicative decrease on aggregate overload.

    Congestion signal: total offered load exceeding ``utilization`` of
    capacity. While uncongested every tenant's rate grows by ``increase``
    units/s per interval; on congestion every rate is cut by ``decrease``.
    """

    def __init__(self, increase: float, decrease: float = 0.5,
                 utilization: float = 0.95, min_rate: float = 1.0):
        assert 0.0 < decrease < 1.0
        self.increase = increase
        self.decrease = decrease
        self.utilization = utilization
        self.min_rate = min_rate
        self.rates: Dict[int, float] = {}

    def allocate(self, obs, capacity):
        total_offered = sum(o.offered for o in obs.values())
        congested = total_offered > self.utilization * capacity
        for t, o in obs.items():
            r = self.rates.get(t, capacity / max(len(obs), 1))
            if congested:
                r = max(r * self.decrease, self.min_rate)
            else:
                r = min(r + self.increase, capacity)
            self.rates[t] = r
        return dict(self.rates)

    def reset(self):
        self.rates.clear()


class Dctcp(CongestionControl):
    """DCTCP-style graded backoff from the deferral ("marking") fraction.

    Per tenant, ``alpha`` is an EWMA (gain ``g``) of the fraction of offered
    traffic that was deferred this interval — the stand-in for the fraction
    of packets ECN-marked beyond the queue threshold K. Rates back off by
    ``alpha/2`` when marked, else grow additively: small standing queues get
    gentle corrections instead of AIMD's halving.
    """

    def __init__(self, increase: float, g: float = 0.125,
                 min_rate: float = 1.0, mark_threshold: float = 0.0):
        self.increase = increase
        self.g = g
        self.min_rate = min_rate
        self.mark_threshold = mark_threshold
        self.alpha: Dict[int, float] = {}
        self.rates: Dict[int, float] = {}

    def allocate(self, obs, capacity):
        for t, o in obs.items():
            frac = 0.0
            if o.offered > 1e-12:
                frac = max(o.deferred - self.mark_threshold, 0.0) / o.offered
            a = (1.0 - self.g) * self.alpha.get(t, 0.0) + self.g * frac
            self.alpha[t] = a
            r = self.rates.get(t, capacity / max(len(obs), 1))
            if frac > 0.0:
                r = max(r * (1.0 - a / 2.0), self.min_rate)
            else:
                r = min(r + self.increase, capacity)
            self.rates[t] = r
        return dict(self.rates)

    def reset(self):
        self.alpha.clear()
        self.rates.clear()
