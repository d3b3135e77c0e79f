"""Telemetry: CoreEngine/TenantScheduler counters -> per-tenant rate signals.

The management plane's eyes. A CoreEngine already meters every CommOp in its
ledger (offered bytes) and — with enforcement on — the over-rate shortfall in
``deferred``. This module turns successive snapshots of those cumulative
counters into EWMA-smoothed per-(tenant, axis) rates:

    served   = offered - deferred        (bytes/s actually admitted in-rate)
    deferred > 0                         (the tenant is backlogged: it wants
                                          more than its current allocation)

which is exactly the observation a congestion-control algorithm needs. The
same interface wraps a TenantScheduler (served decode tokens + queue depth)
so one controller implementation manages both the collective-bytes and the
serving-tokens bottlenecks. ``backend="vectorized"`` keeps the EWMA state in
the flat arrays of ``control/vectorized.py::TelemetryBank``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

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


class EngineTelemetry:
    """EWMA per-(tenant, axes) rate estimates from one CoreEngine's ledger.

    ``axes_filter`` restricts accounting to CommOps whose axes intersect the
    bottleneck's axes (None = count everything), so one engine can feed
    several controllers, each watching its own shared resource.

    Cumulative counters get Prometheus counter discipline: a tenant whose
    offered/deferred counter decreased or vanished since the last sample
    was exported/reset behind our back (live migration folds its ledger
    out of this engine), so its EWMA resets and the new value becomes the
    baseline instead of being read as a hugely negative rate.

    ``backend="vectorized"`` keeps the EWMA state in flat arrays
    (:class:`repro_torch.control.vectorized.TelemetryBank`) instead of
    per-tenant ``_Ewma`` objects — same observations, flat cost.
    """

    def __init__(self, engine, alpha: float = 0.5,
                 axes_filter: Optional[Iterable[str]] = None,
                 backend: str = "object"):
        self.engine = engine
        self.alpha = alpha
        self.axes_filter = None if axes_filter is None else set(axes_filter)
        self.backend = check_backend(backend)
        self._prev_offered: Dict[int, int] = {}
        self._prev_deferred: Dict[int, int] = {}
        self._prev_t: Optional[float] = None
        self._offered_ewma: Dict[int, _Ewma] = {}
        self._deferred_ewma: Dict[int, _Ewma] = {}
        self._bank = TelemetryBank(alpha) if backend == "vectorized" \
            else None
        self.obs: Dict[int, TenantObs] = {}
        self.updates = 0

    def evict_tenant(self, tenant: int) -> None:
        """Forget a departed tenant's EWMA/baseline state. Without this,
        ``_offered_ewma``/``_deferred_ewma`` entries for dropped or
        migrated-away tenants lived forever (the eviction leak)."""
        self._prev_offered.pop(tenant, None)
        self._prev_deferred.pop(tenant, None)
        self._offered_ewma.pop(tenant, None)
        self._deferred_ewma.pop(tenant, None)
        self.obs.pop(tenant, None)
        if self._bank is not None:
            self._bank.evict(tenant)

    def tracked_tenants(self) -> set:
        """Tenants with live EWMA/baseline state (leak regression hook)."""
        if self._bank is not None:
            return set(self._bank.tenants())
        return (set(self._prev_offered) | set(self._offered_ewma)
                | set(self._deferred_ewma))

    def _axes_match(self, axes: Tuple[str, ...]) -> bool:
        if self.axes_filter is None:
            return True
        return not self.axes_filter.isdisjoint(axes) or not axes

    def _cumulative(self) -> Tuple[Dict[int, int], Dict[int, int]]:
        ledger, deferred_raw = self.engine.snapshot()
        offered: Dict[int, int] = {}
        deferred: Dict[int, int] = {}
        for (t, _verb, axes), (_ops, nbytes) in ledger.items():
            if self._axes_match(axes):
                offered[t] = offered.get(t, 0) + nbytes
        for (t, axes), (_ops, nbytes) in deferred_raw.items():
            if self._axes_match(axes):
                deferred[t] = deferred.get(t, 0) + nbytes
        return offered, deferred

    def update(self, now: Optional[float] = None) -> Dict[int, TenantObs]:
        """Sample the engine ledger at time ``now`` (seconds; defaults to
        the wall clock) and return per-tenant ``TenantObs`` in bytes/s."""
        now = time.monotonic() if now is None else now
        offered, deferred = self._cumulative()
        if self._prev_t is None or now <= self._prev_t:
            # first sample (or time stood still): establish the baseline
            self._prev_offered, self._prev_deferred = offered, deferred
            self._prev_t = now
            if self._bank is not None:
                self._bank.baseline(offered, deferred)
            self.obs = {t: TenantObs() for t in offered}
            return self.obs
        dt = now - self._prev_t
        self.obs = {}
        if self._bank is not None:
            union = set(offered) | set(self._prev_offered)
            tenants, offs, dfrs, reset = self._bank.update(
                offered, dt, deferred=deferred)
            for i, t in enumerate(tenants):
                if t not in union:
                    continue
                if reset[i]:
                    if t in offered:
                        self.obs[t] = TenantObs()
                    continue
                off, dfr = float(offs[i]), float(dfrs[i])
                self.obs[t] = TenantObs(rate=max(off - dfr, 0.0),
                                        offered=off, deferred=dfr)
        else:
            for t in set(offered) | set(self._prev_offered):
                d_off = (offered.get(t, 0)
                         - self._prev_offered.get(t, 0)) / dt
                d_def = (deferred.get(t, 0)
                         - self._prev_deferred.get(t, 0)) / dt
                vanished = t not in offered and t in self._prev_offered
                if d_off < 0 or d_def < 0 or vanished:
                    # counter reset (migration fold / crash wipe):
                    # rebaseline instead of reading a negative rate
                    self._offered_ewma.pop(t, None)
                    self._deferred_ewma.pop(t, None)
                    if t in offered:
                        self.obs[t] = TenantObs()
                    continue
                off = self._offered_ewma.setdefault(t, _Ewma(self.alpha)) \
                    .update(d_off)
                dfr = self._deferred_ewma.setdefault(t, _Ewma(self.alpha)) \
                    .update(d_def)
                dfr = min(dfr, off)
                self.obs[t] = TenantObs(rate=max(off - dfr, 0.0),
                                        offered=off, deferred=dfr)
        self._prev_offered, self._prev_deferred = offered, deferred
        self._prev_t = now
        self.updates += 1
        if tracing.TRACER.enabled:
            tracing.TRACER.instant("telemetry", "telemetry.tick", now,
                                   plane="bytes", tenants=len(self.obs))
        return self.obs

    # -- exportable counters ------------------------------------------------
    def counters(self) -> Dict[str, float]:
        ledger, deferred = self.engine.snapshot()
        out: Dict[str, float] = {
            'telemetry_updates_total{plane="bytes"}': self.updates}
        for (t, _verb, axes), (_ops, nbytes) in sorted(ledger.items()):
            if self._axes_match(axes):
                key = f'tenant="{t}",axes="{"+".join(axes) or "none"}"'
                out[f"nk_offered_bytes_total{{{key}}}"] = \
                    out.get(f"nk_offered_bytes_total{{{key}}}", 0) + nbytes
        for (t, axes), (_ops, nbytes) in sorted(deferred.items()):
            if self._axes_match(axes):
                key = f'tenant="{t}",axes="{"+".join(axes) or "none"}"'
                out[f"nk_deferred_bytes_total{{{key}}}"] = \
                    out.get(f"nk_deferred_bytes_total{{{key}}}", 0) + nbytes
        for t, o in sorted(self.obs.items()):
            out[f'nk_served_bytes_per_s{{tenant="{t}"}}'] = o.rate
        return out

    def export_prometheus(self) -> str:
        return format_prometheus(self.counters())


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
