"""RateController: the closed loop from observed traffic to enforced rates.

One controller owns one shared bottleneck (capacity in units/s) and any
number of enforcement points that draw from it:

  * CoreEngines (possibly several — the distributed case: engines on
    different hosts whose tenants share one cross-pod fabric). Per tick the
    controller merges per-engine telemetry, runs the congestion-control
    algorithm on the merged view, then splits each tenant's global
    allocation across engines in proportion to where that tenant's traffic
    actually showed up (with a small probe floor so an idle engine can
    discover demand).
  * TenantSchedulers (serving bottleneck in tokens/s): allocations are
    split the same way and pushed into the schedulers' admission buckets
    mid-run, preserving each bucket's capacity (requests admit whole).

Rates are pushed with ``update_tenant_rate``/``set_rate`` so live token
balances survive the update — a controller tick must not reopen a fresh
burst for a tenant it is trying to throttle.

``push_mode="delta"`` makes the push phase delta-based: only tenants whose
per-point target moved beyond ``delta_tol`` (relative) since the last issued
push get a call, so steady-state chatter is O(changed tenants), not
O(tenants x enforcement points). ``push_calls``/``push_skipped`` count both
sides and are exported as Prometheus counters.
"""
from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.control.congestion import CongestionControl, WaterFill
from repro_torch.control.telemetry import (
    EngineTelemetry, SchedulerTelemetry, TenantObs, format_prometheus,
    merge_obs,
)
from repro_torch.control.vectorized import check_backend
from repro_torch.obs import tracing

_PROBE_FRAC = 0.02     # idle-enforcement-point floor, fraction of allocation


class RateController:
    """Distributed congestion control for one shared bottleneck."""

    def __init__(self, capacity: float,
                 algo: Optional[CongestionControl] = None,
                 weights: Optional[Dict[int, float]] = None,
                 alpha: float = 0.5, burst_s: float = 0.25,
                 push_mode: str = "full", delta_tol: float = 0.05,
                 refresh_every: int = 32, backend: str = "object",
                 device=None):
        """``capacity``: the ONE shared bottleneck in units/s — bytes/s
        when the enforcement points are CoreEngines, tokens/s when they
        are TenantSchedulers (don't mix units under one controller).
        ``weights``: per-tenant fair-share weights for the default
        WaterFill ``algo``. ``alpha``: telemetry EWMA gain in (0, 1].
        ``burst_s``: pushed bucket burst for CoreEngine points, in
        seconds' worth of the allocated rate (schedulers keep their own
        bucket capacity). ``delta_tol``: relative move that makes a target
        worth pushing in delta mode; ``refresh_every``: ticks between
        delta-mode full re-pushes (soft-state bound). ``backend``:
        "object" keeps per-tenant control state in Python objects,
        "vectorized" in flat arrays (telemetry EWMA banks + the water-fill
        kernel) — same allocations, flat cost per tenant. ``device``: where
        the vectorized water-fill runs (``cuda`` unless ``"cpu"``)."""
        if push_mode not in ("full", "delta"):
            raise ValueError(f"push_mode must be 'full' or 'delta', "
                             f"got {push_mode!r}")
        self.capacity = float(capacity)
        self.backend = check_backend(backend)
        self.algo = algo if algo is not None \
            else WaterFill(weights, backend=backend, device=device)
        self.alpha = alpha
        self.burst_s = burst_s
        # delta mode: only tenants whose per-point allocation moved beyond
        # delta_tol (relative) get a set_rate call — O(changed) control-plane
        # chatter per tick instead of O(tenants x points)
        self.push_mode = push_mode
        self.delta_tol = float(delta_tol)
        # soft-state refresh: every refresh_every ticks delta mode pushes
        # everything anyway, bounding how long a skipped push can diverge
        # from an enforcement point that was reset behind our back
        # (drop_tenant, set_rate(None), a restarted scheduler)
        self.refresh_every = max(int(refresh_every), 1)
        self._last_push: Dict[Tuple[str, int, int], float] = {}
        self.push_calls = 0
        self.push_skipped = 0
        self._engines: List[Tuple[object, EngineTelemetry]] = []
        self._schedulers: List[Tuple[object, SchedulerTelemetry]] = []
        self.allocations: Dict[int, float] = {}
        self.history: List[Dict[int, float]] = []
        self.ticks = 0
        self.tick_calls = 0
        self.tick_seconds_total = 0.0
        self.last_tenants = 0

    # -- wiring -------------------------------------------------------------
    def attach_engine(self, engine, axes: Optional[Iterable[str]] = None):
        """Add a CoreEngine enforcement point (bytes/s bottleneck).
        ``axes``: restrict telemetry to CommOps intersecting these mesh
        axes (None = meter everything). Returns self for chaining."""
        self._engines.append(
            (engine, EngineTelemetry(engine, self.alpha, axes,
                                     backend=self.backend)))
        return self

    def attach_scheduler(self, scheduler):
        """Add a TenantScheduler enforcement point (tokens/s bottleneck).
        Several schedulers may share this controller's one ``capacity`` —
        the multi-engine cluster case. Returns self for chaining."""
        self._schedulers.append(
            (scheduler, SchedulerTelemetry(scheduler, self.alpha,
                                           backend=self.backend)))
        return self

    def detach_scheduler(self, scheduler) -> None:
        """Remove a TenantScheduler enforcement point (live stack swap:
        the retiring module's scheduler must stop receiving pushes).

        Also forgets the delta-push history of every *scheduler* point:
        detaching shifts the remaining schedulers' indices, so keyed
        ``_last_push`` entries would attribute stale targets to the wrong
        point. Unknown schedulers are ignored (idempotent)."""
        kept = [(s, tel) for s, tel in self._schedulers
                if s is not scheduler]
        if len(kept) == len(self._schedulers):
            return
        self._schedulers[:] = kept
        for key in [k for k in self._last_push if k[0] == "scheduler"]:
            del self._last_push[key]

    def invalidate_tenant(self, tenant: int) -> None:
        """Forget delta-push history for one tenant: the next tick pushes
        its rate to *every* enforcement point regardless of ``delta_tol``.

        Required around live migration: moving a tenant resets enforcement
        state (the source drops its bucket, the destination imports a
        transferred one) that ``_last_push`` knows nothing about — without
        invalidation, delta mode would judge the new target "unchanged" and
        skip the push and leave a stale rate in force at cluster scale."""
        for key in [k for k in self._last_push if k[2] == tenant]:
            del self._last_push[key]

    def evict_tenant(self, tenant: int) -> None:
        """Drop a departed tenant's control state from every enforcement
        point that no longer holds it (telemetry EWMA + counter baseline
        + push history + allocation) — without it, telemetry EWMA maps
        grew one entry per tenant that ever existed. Points that still
        hold the tenant (migration source that only moved one of two
        planes, say) keep their live telemetry untouched."""
        self.invalidate_tenant(tenant)
        anywhere = False
        for engine, tel in self._engines:
            holds = getattr(engine, "has_tenant", None)
            if holds is not None and holds(tenant):
                anywhere = True
            else:
                tel.evict_tenant(tenant)
        for scheduler, tel in self._schedulers:
            if tenant in getattr(scheduler, "queues", {}):
                anywhere = True
            else:
                tel.evict_tenant(tenant)
        if not anywhere:
            self.allocations.pop(tenant, None)

    # -- observation --------------------------------------------------------
    def observe(self, now: Optional[float] = None) -> Dict[int, TenantObs]:
        """Sample every attached enforcement point at time ``now`` (seconds)
        and return the merged per-tenant view (units/s summed across
        points — one tenant's traffic through several engines)."""
        per_source = [tel.update(now) for _, tel in self._engines]
        per_source += [tel.update(now) for _, tel in self._schedulers]
        return merge_obs(per_source)

    # -- the loop body ------------------------------------------------------
    def tick(self, now: Optional[float] = None) -> Dict[int, float]:
        """One control interval: observe -> allocate -> push.

        ``now``: seconds (virtual or wall clock; defaults to wall clock).
        Returns the global per-tenant allocations in units/s ({} until the
        first interval with a usable rate signal)."""
        t0 = time.perf_counter()
        now = time.monotonic() if now is None else now
        merged = self.observe(now)
        self.tick_calls += 1
        self.last_tenants = len(merged)
        if not merged or not any(o.offered > 0 or o.queue > 0
                                 for o in merged.values()):
            # no rate signal yet (first tick only baselines the counters):
            # pushing allocations computed from zeros would stall everyone
            self.tick_seconds_total += time.perf_counter() - t0
            return {}
        self.allocations = self.algo.allocate(merged, self.capacity)
        calls_before = self.push_calls
        self._push(now)
        if tracing.TRACER.enabled:
            tracing.TRACER.instant(
                "controller", "rate.push", now,
                tenants=len(self.allocations),
                calls=self.push_calls - calls_before)
        self.history.append(dict(self.allocations))
        self.ticks += 1
        self.tick_seconds_total += time.perf_counter() - t0
        return self.allocations

    def _changed(self, kind: str, idx: int, tenant: int, rate: float) -> bool:
        """Delta gate: has this (enforcement point, tenant) target moved
        beyond tolerance since the last push we actually issued?"""
        if self.push_mode != "delta":
            return True
        prev = self._last_push.get((kind, idx, tenant))
        if prev is None:
            return True
        return abs(rate - prev) > self.delta_tol * max(abs(prev), 1e-9)

    def _push(self, now: float) -> None:
        if self.push_mode == "delta" and \
                self.ticks % self.refresh_every == self.refresh_every - 1:
            self._last_push.clear()        # periodic full refresh
        for tenant, rate in self.allocations.items():
            burst = max(rate * self.burst_s, 1.0)
            for i, ((engine, _tel), share) in enumerate(zip(
                    self._engines, self._shares(tenant, self._engines))):
                if self._changed("engine", i, tenant, rate * share):
                    engine.update_tenant_rate(tenant, rate * share,
                                              burst * share, now)
                    self._last_push[("engine", i, tenant)] = rate * share
                    self.push_calls += 1
                else:
                    self.push_skipped += 1
            # schedulers keep their bucket capacity: requests are admitted
            # whole, so shrinking burst below one request's token cost would
            # head-of-line-block the queue forever
            for i, ((scheduler, _tel), share) in enumerate(zip(
                    self._schedulers, self._shares(tenant, self._schedulers))):
                if self._changed("scheduler", i, tenant, rate * share):
                    scheduler.set_rate(tenant, rate * share, None, now)
                    self._last_push[("scheduler", i, tenant)] = rate * share
                    self.push_calls += 1
                else:
                    self.push_skipped += 1

    @staticmethod
    def _shares(tenant: int, points) -> List[float]:
        """Split one tenant's allocation across enforcement points in
        proportion to where its demand showed up (offered rate + queue)."""
        n = len(points)
        if n == 0:
            return []
        demand = [tel.obs.get(tenant, TenantObs()).offered
                  + tel.obs.get(tenant, TenantObs()).queue
                  for _, tel in points]
        total = sum(demand)
        if total <= 1e-12:
            return [1.0 / n] * n
        # probe floor: a point this tenant is quiet on still gets a sliver
        # so demand arriving there is admitted and becomes visible next tick
        floor = _PROBE_FRAC / n
        raw = [max(d / total, floor) for d in demand]
        norm = sum(raw)
        return [r / norm for r in raw]

    # -- reporting ----------------------------------------------------------
    def counters(self) -> Dict[str, float]:
        out: Dict[str, float] = {"controller_ticks_total": self.ticks,
                                 "controller_capacity": self.capacity,
                                 "controller_push_calls_total":
                                     self.push_calls,
                                 "controller_push_skipped_total":
                                     self.push_skipped,
                                 "nk_control_ticks_total": self.tick_calls,
                                 "nk_control_tick_seconds_total":
                                     self.tick_seconds_total,
                                 "nk_control_tenants":
                                     float(self.last_tenants)}
        for t, r in sorted(self.allocations.items()):
            out[f'nk_allocated_rate{{tenant="{t}"}}'] = r
        for _, tel in self._engines + self._schedulers:
            for k, v in tel.counters().items():
                # labeled totals end in '}', so match on the metric name
                out[k] = out.get(k, 0) + v if "_total" in k else v
        return out

    def export_prometheus(self) -> str:
        return format_prometheus(self.counters())
