"""Telemetry: TenantScheduler counters -> per-tenant rate signals.

The management plane's eyes. Successive snapshots of a scheduler's
cumulative served-token counters become EWMA-smoothed per-tenant rates,
with the queue depth beside them — the observation a congestion-control
algorithm needs. ``backend="vectorized"`` keeps the EWMA state in the flat
arrays of ``control/vectorized.py::TelemetryBank``. The bytes-plane
``EngineTelemetry`` (CoreEngine ledgers) comes with a later slice of the
port.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.control.vectorized import TelemetryBank, check_backend
from repro_torch.obs import tracing
from repro_torch.obs.metrics import render_prometheus


def format_prometheus(counters: Dict[str, float]) -> str:
    """Render a ``counters()`` dict in Prometheus text format — the one
    formatter every exporter (telemetry, controller, cluster) shares.
    Delegates to :func:`repro_torch.obs.metrics.render_prometheus`, which emits
    ``# HELP``/``# TYPE`` lines, escapes label values and renders
    ``+Inf``/``NaN`` per the exposition-format rules."""
    return render_prometheus(counters)


@dataclass
class TenantObs:
    """One control interval's view of one tenant (units/s; units = bytes
    for engine bottlenecks, tokens for serving bottlenecks)."""

    rate: float = 0.0        # served (in-allocation) rate
    offered: float = 0.0     # served + deferred: what the tenant asked for
    deferred: float = 0.0    # over-allocation shortfall rate
    queue: float = 0.0       # instantaneous queue depth (units)

    @property
    def backlogged(self) -> bool:
        return self.deferred > 1e-9 or self.queue > 1e-9

    def merge(self, other: "TenantObs") -> "TenantObs":
        return TenantObs(rate=self.rate + other.rate,
                         offered=self.offered + other.offered,
                         deferred=self.deferred + other.deferred,
                         queue=self.queue + other.queue)


class _Ewma:
    def __init__(self, alpha: float):
        self.alpha = alpha
        self.value: Optional[float] = None

    def update(self, sample: float) -> float:
        if self.value is None:
            self.value = float(sample)
        else:
            self.value = self.alpha * float(sample) \
                + (1.0 - self.alpha) * self.value
        return self.value


class SchedulerTelemetry:
    """Per-tenant rate signals over a TenantScheduler: served tokens/s +
    queue depth.

    ``served_tokens`` is treated with Prometheus counter discipline: a
    tenant whose cumulative counter *decreased* (or vanished) since the last
    sample was exported/reset behind our back — live migration folds a
    tenant's ledger out of the source scheduler mid-run — so its EWMA is
    reset and the new counter value becomes the baseline instead of being
    read as a hugely negative rate.

    ``backend="vectorized"`` keeps the EWMA state in flat arrays
    (:class:`repro_torch.control.vectorized.TelemetryBank`) instead of
    per-tenant ``_Ewma`` objects — same observations, flat cost.
    """

    def __init__(self, scheduler, alpha: float = 0.5,
                 backend: str = "object"):
        """``scheduler``: a live TenantScheduler; ``alpha``: EWMA gain in
        (0, 1] — 1.0 = no smoothing, use the raw per-interval rate."""
        self.scheduler = scheduler
        self.alpha = alpha
        self.backend = check_backend(backend)
        self._prev_served: Dict[int, int] = {}
        self._prev_t: Optional[float] = None
        self._ewma: Dict[int, _Ewma] = {}
        self._bank = TelemetryBank(alpha) if backend == "vectorized" \
            else None
        self.obs: Dict[int, TenantObs] = {}
        self.updates = 0

    def evict_tenant(self, tenant: int) -> None:
        """Forget a departed tenant's EWMA/baseline state. Without this,
        the EWMA map kept entries for dropped or migrated-away tenants
        forever (the eviction leak)."""
        self._prev_served.pop(tenant, None)
        self._ewma.pop(tenant, None)
        self.obs.pop(tenant, None)
        if self._bank is not None:
            self._bank.evict(tenant)

    def tracked_tenants(self) -> set:
        """Tenants with live EWMA/baseline state (leak regression hook)."""
        if self._bank is not None:
            return set(self._bank.tenants())
        return set(self._prev_served) | set(self._ewma)

    def update(self, now: Optional[float] = None) -> Dict[int, TenantObs]:
        """Sample the scheduler's ledgers at time ``now`` (seconds; defaults
        to the wall clock) and return per-tenant ``TenantObs`` in tokens/s
        (rates) and tokens (queue depth)."""
        now = time.monotonic() if now is None else now
        served = dict(self.scheduler.served_tokens)
        queues = {t: float(self.scheduler.pending(t))
                  for t in self.scheduler.queues}
        if self._prev_t is None or now <= self._prev_t:
            self._prev_served, self._prev_t = served, now
            if self._bank is not None:
                self._bank.baseline(served)
            self.obs = {t: TenantObs(queue=queues.get(t, 0.0))
                        for t in set(served) | set(queues)}
            return self.obs
        dt = now - self._prev_t
        self.obs = {}
        if self._bank is not None:
            union = set(served) | set(self._prev_served) | set(queues)
            tenants, offs, _dfrs, reset = self._bank.update(
                served, dt, extra=queues)
            for i, t in enumerate(tenants):
                if t not in union:
                    continue
                if reset[i]:
                    if t in served or t in queues:
                        self.obs[t] = TenantObs(queue=queues.get(t, 0.0))
                    continue
                r = float(offs[i])
                self.obs[t] = TenantObs(rate=r, offered=r,
                                        queue=queues.get(t, 0.0))
        else:
            for t in set(served) | set(self._prev_served) | set(queues):
                raw = served.get(t, 0) - self._prev_served.get(t, 0)
                if raw < 0 or (t not in served and t in self._prev_served):
                    # counter reset: tenant migrated/dropped; rebaseline
                    self._ewma.pop(t, None)
                    if t in served or t in queues:
                        self.obs[t] = TenantObs(queue=queues.get(t, 0.0))
                    continue
                r = self._ewma.setdefault(t, _Ewma(self.alpha)) \
                    .update(raw / dt)
                q = queues.get(t, 0.0)
                self.obs[t] = TenantObs(rate=r, offered=r, queue=q)
        self._prev_served, self._prev_t = served, now
        self.updates += 1
        if tracing.TRACER.enabled:
            tracing.TRACER.instant("telemetry", "telemetry.tick", now,
                                   plane="serve", tenants=len(self.obs))
        return self.obs

    def counters(self) -> Dict[str, float]:
        out: Dict[str, float] = {
            'telemetry_updates_total{plane="serve"}': self.updates}
        for t, n in sorted(self.scheduler.served_tokens.items()):
            out[f'nk_served_tokens_total{{tenant="{t}"}}'] = n
        for t, o in sorted(self.obs.items()):
            out[f'nk_served_tokens_per_s{{tenant="{t}"}}'] = o.rate
            out[f'nk_queue_depth{{tenant="{t}"}}'] = o.queue
        for t, row in sorted(self.scheduler.ledger().items()):
            out[f'nk_admitted_requests_total{{tenant="{t}"}}'] = \
                row["admitted_requests"]
            out[f'nk_deferred_polls_total{{tenant="{t}"}}'] = \
                row["deferred_polls"]
            out[f'nk_mean_admit_wait_s{{tenant="{t}"}}'] = \
                row["mean_admit_wait_s"]
        return out

    def export_prometheus(self) -> str:
        return format_prometheus(self.counters())


def merge_obs(per_source: List[Dict[int, TenantObs]]) -> Dict[int, TenantObs]:
    """Sum observations across sources (the distributed case: one tenant's
    traffic through several engines sharing the bottleneck)."""
    out: Dict[int, TenantObs] = {}
    for obs in per_source:
        for t, o in obs.items():
            out[t] = out[t].merge(o) if t in out else o
    return out
