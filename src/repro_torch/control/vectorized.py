"""Vectorized control plane: one fused tick over the whole tenant population.

The counterpart of ``repro/control/vectorized.py``. The object control
plane (``TokenBucket`` instances in dicts, ``_Ewma`` objects per tenant,
``max_min_fair`` over dicts) walks Python objects every tick; this module
keeps the hot per-tenant control state in flat arrays keyed by a dense
tenant index:

  * ``TenantIndex`` — tenant id -> dense slot, stable under migration,
    with ``compact()`` for defragmentation after churn.
  * ``BucketStore`` + ``StoreBucket`` — every tenant's token-bucket
    level/rate/capacity/updated as four float64 arrays; ``StoreBucket`` is
    the per-tenant view implementing the exact ``TokenBucket`` interface
    (``TenantScheduler(bucket_backend="vectorized")``).
  * ``TelemetryBank`` — EWMA offered/deferred rates as flat arrays with
    Prometheus counter discipline; the array backend behind
    ``SchedulerTelemetry(backend="vectorized")``.
  * ``VectorizedControlPlane`` — the fused tick: bucket refill + admission
    headroom + EWMA update + weighted max-min water-fill as one step of
    float64 tensor operations on the plane's device, the water-fill being
    one launch of the hand-written kernel (``kernels/waterfill.py``).

Numerics: the facade state (buckets, telemetry banks) is numpy float64 on
the host, op for op the object backend's arithmetic, so the equivalence
tests can demand bit-identical results. The fused tick runs in float64 so
allocations agree with the scalar ``max_min_fair`` within 1e-6 x capacity
even at 100k tenants.

Two differences from the reference, both in the water-fill:

  * The tick's bisection is the kernel's, whose upper bracket clamps the
    smallest weight at 1e-30 where the reference's inline loop clamps at
    1e-300: the two differ only for weights below 1e-30.
  * ``waterfill_allocate`` defaults to ``impl="kernel"`` (bisection) where
    the reference defaults to the exact sort (``impl="ref"``); both agree
    within 1e-6 x capacity (ROADMAP, P4).
"""
from __future__ import annotations

import math
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.waterfill import water_fill

__all__ = [
    "TenantIndex", "BucketStore", "StoreBucket", "TelemetryBank",
    "VectorizedControlPlane", "fused_tick", "waterfill_allocate",
    "BACKENDS", "check_backend",
]

BACKENDS = ("object", "vectorized")


def check_backend(backend: str) -> str:
    """Validate a control-plane ``backend`` knob: ``"object"`` (per-tenant
    Python objects) or ``"vectorized"`` (the flat arrays of this module)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, "
                         f"got {backend!r}")
    return backend


# ---------------------------------------------------------------------------
# Tenant index: id -> dense slot
# ---------------------------------------------------------------------------


class TenantIndex:
    """Dense tenant-id -> slot mapping, stable under migration.

    ``add`` reuses freed slots (LIFO) before growing, ``drop`` frees a
    slot without disturbing any other tenant's slot — a tenant that
    migrates away and back may land on a different slot, but tenants that
    stayed never move, so array state keyed by slot survives arbitrary
    churn. ``compact()`` defragments after heavy churn and returns the
    old-slot -> new-slot map so array owners can gather their state.
    """

    def __init__(self):
        self._slots: Dict[int, int] = {}
        self._ids: List[int] = []          # slot -> tenant id, -1 = free
        self._free: List[int] = []

    def __len__(self) -> int:
        return len(self._slots)

    def __contains__(self, tenant: int) -> bool:
        return tenant in self._slots

    @property
    def size(self) -> int:
        """Allocated slot count (>= len(self); arrays are sized to this)."""
        return len(self._ids)

    def slot(self, tenant: int) -> int:
        return self._slots[tenant]

    def get(self, tenant: int) -> Optional[int]:
        return self._slots.get(tenant)

    def tenant_at(self, slot: int) -> int:
        """Tenant id occupying ``slot`` (-1 if free)."""
        return self._ids[slot]

    def items(self):
        """(tenant, slot) pairs in slot order."""
        return ((t, s) for s, t in enumerate(self._ids) if t >= 0)

    def tenants(self) -> List[int]:
        return [t for t in self._ids if t >= 0]

    def add(self, tenant: int) -> int:
        """Assign a slot (idempotent: an already-indexed tenant keeps its
        slot). Freed slots are reused before the index grows."""
        if tenant in self._slots:
            return self._slots[tenant]
        if self._free:
            slot = self._free.pop()
            self._ids[slot] = tenant
        else:
            slot = len(self._ids)
            self._ids.append(tenant)
        self._slots[tenant] = slot
        return slot

    def drop(self, tenant: int) -> int:
        """Free a tenant's slot (returns it). Other tenants never move."""
        slot = self._slots.pop(tenant)
        self._ids[slot] = -1
        self._free.append(slot)
        return slot

    def compact(self) -> Dict[int, int]:
        """Defragment: re-number slots densely (preserving slot order) and
        return {old_slot: new_slot} for array owners to gather with."""
        remap: Dict[int, int] = {}
        ids: List[int] = []
        for old, t in enumerate(self._ids):
            if t < 0:
                continue
            remap[old] = len(ids)
            self._slots[t] = len(ids)
            ids.append(t)
        self._ids = ids
        self._free = []
        return remap


def _grown(arr: np.ndarray, size: int, fill: float) -> np.ndarray:
    if arr.shape[0] >= size:
        return arr
    new = np.full(max(size, 2 * arr.shape[0]), fill, dtype=arr.dtype)
    new[:arr.shape[0]] = arr
    return new


def _gather(arr: np.ndarray, remap: Dict[int, int], fill: float
            ) -> np.ndarray:
    out = np.full(len(remap), fill, dtype=arr.dtype)
    for old, new in remap.items():
        out[new] = arr[old]
    return out


# ---------------------------------------------------------------------------
# Bucket store: every tenant's token bucket as four flat arrays
# ---------------------------------------------------------------------------


class BucketStore:
    """TokenBucket state (rate, capacity, tokens, updated) as flat float64
    arrays keyed by a ``TenantIndex``.

    Per-tenant access goes through :class:`StoreBucket` views that
    implement the exact ``TokenBucket`` interface (consume / drain /
    wait_time / set_rate / snapshot, plus attribute assignment), so the
    scheduler and the TenantState migration/checkpoint wire format never
    see the difference. Population-wide operations (``refill_all``,
    ``wait_times``) are single numpy expressions.
    """

    def __init__(self):
        self.index = TenantIndex()
        self.rate = np.zeros(0)
        self.capacity = np.zeros(0)
        self.tokens = np.zeros(0)
        self.updated = np.zeros(0)

    def __len__(self) -> int:
        return len(self.index)

    def __contains__(self, tenant: int) -> bool:
        return tenant in self.index

    def _ensure(self, size: int) -> None:
        self.rate = _grown(self.rate, size, 0.0)
        self.capacity = _grown(self.capacity, size, 0.0)
        self.tokens = _grown(self.tokens, size, 0.0)
        self.updated = _grown(self.updated, size, 0.0)

    def add(self, tenant: int, rate: float, capacity: float) -> "StoreBucket":
        """Register (or reset) a tenant's bucket: full at ``capacity``,
        refilling at ``rate`` — the ``TokenBucket(rate, capacity)``
        constructor semantics."""
        slot = self.index.add(tenant)
        self._ensure(self.index.size)
        self.rate[slot] = float(rate)
        self.capacity[slot] = float(capacity)
        self.tokens[slot] = float(capacity)
        self.updated[slot] = 0.0
        return StoreBucket(self, tenant)

    def restore(self, tenant: int, state: Dict[str, float],
                now: Optional[float] = None) -> "StoreBucket":
        """``TokenBucket.restore`` onto the array backend: rebuild from a
        ``snapshot()`` dict, anchored at ``now`` (None keeps the
        snapshot's own timestamp)."""
        b = self.add(tenant, state["rate"], state["capacity"])
        slot = self.index.slot(tenant)
        self.tokens[slot] = min(float(state["tokens"]), self.capacity[slot])
        self.updated[slot] = float(state.get("updated", 0.0)) if now is None \
            else float(now)
        return b

    def drop(self, tenant: int) -> None:
        if tenant in self.index:
            slot = self.index.drop(tenant)
            self.rate[slot] = self.capacity[slot] = 0.0
            self.tokens[slot] = self.updated[slot] = 0.0

    def view(self, tenant: int) -> "StoreBucket":
        if tenant not in self.index:
            raise KeyError(tenant)
        return StoreBucket(self, tenant)

    def compact(self) -> None:
        remap = self.index.compact()
        for name in ("rate", "capacity", "tokens", "updated"):
            setattr(self, name, _gather(getattr(self, name), remap, 0.0))

    # -- population-wide batched operations ---------------------------------
    def refill_all(self, now: float) -> None:
        """Settle every bucket's balance at ``now`` in one expression."""
        dt = np.maximum(now - self.updated, 0.0)
        np.minimum(self.capacity, self.tokens + dt * self.rate,
                   out=self.tokens)
        np.maximum(self.updated, now, out=self.updated)

    def wait_times(self, costs: np.ndarray,
                   now: Optional[float] = None) -> np.ndarray:
        """Vectorized ``wait_time``: seconds until each slot could cover
        ``costs`` (0 when already admissible, inf when rate is 0)."""
        if now is not None:
            self.refill_all(now)
        short = np.maximum(costs - self.tokens, 0.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            wait = np.where(short <= 0.0, 0.0, short / self.rate)
        return np.where((short > 0.0) & (self.rate <= 0.0), np.inf, wait)


class StoreBucket:
    """Per-tenant ``TokenBucket``-interface view over a ``BucketStore``.

    Every method mirrors ``repro_torch.core.engine.TokenBucket`` operation for
    operation in float64, so an arbitrary interleaving of consume / drain
    / wait_time / set_rate / snapshot produces identical results on either
    backend — the property the equivalence suite pins.
    """

    __slots__ = ("store", "tenant_id")

    def __init__(self, store: BucketStore, tenant_id: int):
        self.store = store
        self.tenant_id = tenant_id

    @property
    def _slot(self) -> int:
        return self.store.index.slot(self.tenant_id)

    # TokenBucket exposes plain attributes; mirror them as properties so
    # existing call sites (scheduler set_rate adjusting capacity/updated)
    # keep working against the array backend.
    @property
    def rate(self) -> float:
        return float(self.store.rate[self._slot])

    @rate.setter
    def rate(self, v: float) -> None:
        self.store.rate[self._slot] = float(v)

    @property
    def capacity(self) -> float:
        return float(self.store.capacity[self._slot])

    @capacity.setter
    def capacity(self, v: float) -> None:
        self.store.capacity[self._slot] = float(v)

    @property
    def tokens(self) -> float:
        return float(self.store.tokens[self._slot])

    @tokens.setter
    def tokens(self, v: float) -> None:
        self.store.tokens[self._slot] = float(v)

    @property
    def updated(self) -> float:
        return float(self.store.updated[self._slot])

    @updated.setter
    def updated(self, v: float) -> None:
        self.store.updated[self._slot] = float(v)

    def _refill(self, now: float) -> None:
        s = self._slot
        st = self.store
        if now > st.updated[s]:
            st.tokens[s] = min(st.capacity[s], st.tokens[s]
                               + (now - st.updated[s]) * st.rate[s])
            st.updated[s] = now

    def consume(self, n: float, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        self._refill(now)
        s = self._slot
        if self.store.tokens[s] >= n:
            self.store.tokens[s] -= n
            return True
        return False

    def drain(self, n: float, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        self._refill(now)
        s = self._slot
        take = min(float(n), max(float(self.store.tokens[s]), 0.0))
        self.store.tokens[s] -= take
        return take

    def wait_time(self, n: float, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        self._refill(now)
        s = self._slot
        if self.store.tokens[s] >= n:
            return 0.0
        if self.store.rate[s] <= 0.0:
            return float("inf")
        return float((n - self.store.tokens[s]) / self.store.rate[s])

    def set_rate(self, rate: float, burst: Optional[float] = None,
                 now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        self._refill(now)
        s = self._slot
        self.store.rate[s] = float(rate)
        if burst is not None:
            self.store.capacity[s] = float(burst)
            self.store.tokens[s] = min(self.store.tokens[s],
                                       self.store.capacity[s])

    def snapshot(self, now: Optional[float] = None) -> Dict[str, float]:
        if now is not None:
            self._refill(now)
        s = self._slot
        return {"rate": float(self.store.rate[s]),
                "capacity": float(self.store.capacity[s]),
                "tokens": float(self.store.tokens[s]),
                "updated": float(self.store.updated[s])}


# ---------------------------------------------------------------------------
# Telemetry bank: EWMA offered/deferred rates as flat arrays
# ---------------------------------------------------------------------------


class TelemetryBank:
    """EWMA rate state for a telemetry source as flat float64 arrays.

    Tracks, per tenant slot: the EWMA offered and deferred rates (NaN =
    no sample yet) and the previous cumulative counter baselines.
    ``update`` applies one sampling interval with Prometheus counter
    discipline — a cumulative counter that decreased or vanished since
    the last sample was reset behind our back (migration fold, crash
    wipe), so the tenant rebaselines instead of reading a negative rate.
    ``evict`` drops a departed tenant's state entirely: the fix for the
    EWMA-entry leak where dropped/migrated-away tenants kept their
    ``_offered_ewma``/``_deferred_ewma`` entries forever.
    """

    def __init__(self, alpha: float):
        self.alpha = float(alpha)
        self.index = TenantIndex()
        self.ewma_off = np.zeros(0)
        self.ewma_def = np.zeros(0)
        self.prev_off = np.zeros(0)
        self.prev_def = np.zeros(0)
        self.known = np.zeros(0, dtype=bool)   # baseline established

    def _ensure(self, size: int) -> None:
        self.ewma_off = _grown(self.ewma_off, size, np.nan)
        self.ewma_def = _grown(self.ewma_def, size, np.nan)
        self.prev_off = _grown(self.prev_off, size, 0.0)
        self.prev_def = _grown(self.prev_def, size, 0.0)
        self.known = _grown(self.known, size, False)

    def evict(self, tenant: int) -> None:
        """Forget a departed tenant entirely (slot freed for reuse)."""
        if tenant in self.index:
            slot = self.index.drop(tenant)
            self.ewma_off[slot] = self.ewma_def[slot] = np.nan
            self.prev_off[slot] = self.prev_def[slot] = 0.0
            self.known[slot] = False

    def tenants(self) -> List[int]:
        return self.index.tenants()

    def baseline(self, offered: Dict[int, float],
                 deferred: Optional[Dict[int, float]] = None) -> None:
        """First sample (or time stood still): establish counter baselines
        without producing rates."""
        deferred = deferred or {}
        for t in set(offered) | set(deferred):
            slot = self.index.add(t)
            self._ensure(self.index.size)
            self.prev_off[slot] = float(offered.get(t, 0))
            self.prev_def[slot] = float(deferred.get(t, 0))
            self.known[slot] = True

    def update(self, offered: Dict[int, float], dt: float,
               deferred: Optional[Dict[int, float]] = None,
               extra: Optional[Iterable[int]] = None,
               ) -> Tuple[List[int], np.ndarray, np.ndarray, np.ndarray]:
        """One sampling interval.

        Returns ``(tenants, off, dfr, reset)`` aligned lists/arrays: the
        EWMA offered and deferred rates for every tenant in the union of
        current counters, tracked state and ``extra`` (queue-only
        tenants), plus a ``reset`` mask for tenants that rebaselined
        this interval (their rates are NaN: report queue-only obs, like
        the object backend). Counter baselines default to 0 for tenants
        never sampled — the object backends' ``prev.get(t, 0)``.
        Tenants whose counters vanished are evicted.
        """
        deferred = deferred or {}
        tracked = set(self.index.tenants())
        tenants = sorted(set(offered) | set(deferred) | tracked
                         | set(extra or ()))
        n = len(tenants)
        cur_off = np.empty(n)
        cur_def = np.empty(n)
        seen = np.empty(n, dtype=bool)
        slots = np.empty(n, dtype=np.int64)
        for i, t in enumerate(tenants):
            slot = self.index.add(t)
            self._ensure(self.index.size)
            slots[i] = slot
            cur_off[i] = float(offered.get(t, 0))
            cur_def[i] = float(deferred.get(t, 0))
            seen[i] = t in offered or t in deferred
        self._ensure(self.index.size)
        known = self.known[slots]
        d_off = (cur_off - self.prev_off[slots]) / dt
        d_def = (cur_def - self.prev_def[slots]) / dt
        # counter discipline: decreased or vanished => reset, rebaseline
        reset = (d_off < 0) | (d_def < 0) | (known & ~seen)
        prev_off = self.ewma_off[slots]
        prev_def_ewma = self.ewma_def[slots]
        a = self.alpha
        off = np.where(np.isnan(prev_off), d_off,
                       a * d_off + (1.0 - a) * prev_off)
        dfr = np.where(np.isnan(prev_def_ewma), d_def,
                       a * d_def + (1.0 - a) * prev_def_ewma)
        off = np.where(reset, np.nan, off)
        dfr = np.where(reset, np.nan, dfr)
        self.ewma_off[slots] = off
        self.ewma_def[slots] = dfr
        self.prev_off[slots] = cur_off
        self.prev_def[slots] = cur_def
        self.known[slots] = seen
        for i, t in enumerate(tenants):
            if reset[i] and not seen[i]:
                self.evict(t)
        return tenants, off, np.minimum(dfr, off), reset


# ---------------------------------------------------------------------------
# The fused tick
# ---------------------------------------------------------------------------


def fused_tick(level, brate, bcap, updated, ewma_off, ewma_def, prev_off,
               prev_def, weight, active, samples, params, *, iters: int,
               scheduler_buckets: bool):
    """One control interval over every slot, as float64 tensor operations
    on the inputs' device (the reference's ``_fused_tick_impl``).

    ``samples`` is the (3, slots) stack [cur_off; cur_def; queue] and
    ``params`` the packed scalar vector [now, prev_t, alpha, capacity,
    headroom, min_rate, burst_s]. Returns ``(level, brate, bcap, updated,
    ewma_off, ewma_def, prev_off, prev_def, alloc, water_level)``. The
    water-fill is one ``kernels.waterfill.water_fill`` call (the kernel on
    the card, its plain version on the CPU)."""
    cur_off, cur_def, queue = samples[0], samples[1], samples[2]
    now, prev_t, alpha, capacity = params[0], params[1], params[2], \
        params[3]
    headroom, min_rate, burst_s = params[4], params[5], params[6]
    dt = now - prev_t
    # -- EWMA telemetry update (counter discipline: reset => rebaseline) --
    d_off = (cur_off - prev_off) / dt
    d_def = (cur_def - prev_def) / dt
    reset = (d_off < 0) | (d_def < 0)
    off = torch.where(torch.isnan(ewma_off), d_off,
                      alpha * d_off + (1.0 - alpha) * ewma_off)
    dfr = torch.where(torch.isnan(ewma_def), d_def,
                      alpha * d_def + (1.0 - alpha) * ewma_def)
    gone = reset | ~active
    off = torch.where(gone, math.nan, off)
    dfr = torch.where(gone, math.nan, dfr)
    dfr_obs = torch.minimum(dfr, off)
    # -- demands: admission headroom vs backlog (WaterFill semantics) -----
    n_active = active.sum().clamp_min(1)
    eps = 1e-3 * capacity / n_active
    backlogged = (dfr_obs > eps) | (queue > 0)
    d = torch.where(backlogged, math.inf, off * headroom)
    live = active & (d > 0)
    d = torch.where(live, d, 0.0)
    w = torch.where(live, weight, 0.0)
    # -- weighted max-min water-fill: one kernel launch. d and w are
    # masked already, so the kernel's active set is exactly w > 0 --------
    alloc, lvl = water_fill(d, w, params[3:4], iters=iters)
    alloc = torch.where(active & (min_rate > 0),
                        torch.maximum(alloc, min_rate), alloc)
    # tenants whose counters reset report queue-only obs: no allocation
    # change this interval (matches the object backend's rebaseline)
    alloc = torch.where(reset & active & (queue <= 0), 0.0, alloc)
    # -- bucket retarget: settle at the old rate, then push the new one ---
    level = torch.minimum(bcap, level + (now - updated).clamp_min(0.0)
                          * brate)
    push = active & (w > 0)
    brate2 = torch.where(push, alloc, brate)
    if scheduler_buckets:
        # scheduler.set_rate(burst=None): keep >= 1s of burst so a raised
        # rate can still cover one whole request
        bcap2 = torch.where(push, torch.maximum(bcap, alloc), bcap)
    else:
        # engine.update_tenant_rate: burst = burst_s worth of rate, >= 1
        bcap2 = torch.where(push, (alloc * burst_s).clamp_min(1.0), bcap)
    level = torch.minimum(level, bcap2)
    updated2 = torch.where(active, now, updated)
    return (level, brate2, bcap2, updated2, off, dfr, cur_off, cur_def,
            alloc, lvl)


class VectorizedControlPlane:
    """Whole-population control state + the fused control tick.

    One instance owns the hot per-tenant control state as flat float64
    arrays keyed by a :class:`TenantIndex`: bucket level / rate /
    capacity / updated, EWMA offered & deferred rates, previous
    cumulative counter baselines and WFQ weights. ``tick`` consumes one
    interval's cumulative counters (slot-aligned numpy arrays) and runs
    refill + EWMA + admission headroom + water-fill + bucket retarget as
    one ``fused_tick`` on ``device`` (``cuda`` unless ``"cpu"`` is
    passed), returning the per-slot allocations.

    Between ticks the state stays on the device; host mutations (add,
    drop, restore) work on the numpy arrays, which ``_sync_host`` refreshes
    first. ``export_tenant``/``snapshot_tenant``/``restore_tenant`` move
    one tenant through the ``{rate, capacity, tokens, updated}`` bucket
    wire format the object ``TokenBucket`` uses — the same dicts as the
    reference's plane, so state crosses between the two packages.
    """

    STATE_ARRAYS = ("level", "brate", "bcap", "updated", "ewma_off",
                    "ewma_def", "prev_off", "prev_def", "weight")

    def __init__(self, capacity: float, *, alpha: float = 0.5,
                 headroom: float = 1.25, min_rate: float = 0.0,
                 burst_s: float = 0.25, iters: int = 48,
                 scheduler_buckets: bool = True, device=None):
        self.capacity = float(capacity)
        self.alpha = float(alpha)
        self.headroom = float(headroom)
        self.min_rate = float(min_rate)
        self.burst_s = float(burst_s)
        self.iters = int(iters)
        self.scheduler_buckets = bool(scheduler_buckets)
        self.device = resolve_device(device)
        self.index = TenantIndex()
        self.level = np.zeros(0)
        self.brate = np.zeros(0)
        self.bcap = np.zeros(0)
        self.updated = np.zeros(0)
        self.ewma_off = np.zeros(0)
        self.ewma_def = np.zeros(0)
        self.prev_off = np.zeros(0)
        self.prev_def = np.zeros(0)
        self.weight = np.zeros(0)
        self.active = np.zeros(0, dtype=bool)
        self.prev_t: Optional[float] = None
        self.last_alloc = np.zeros(0)
        self.last_level = 0.0
        self.ticks = 0
        self.tick_seconds_total = 0.0
        # When _device is set, its tensors are authoritative (state stays
        # device-resident across ticks — host copies are the slow path);
        # _sync_host() pulls them back before any host access.
        self._device: Optional[dict] = None

    def _sync_host(self) -> None:
        if self._device is None:
            return
        dev, self._device = self._device, None
        for name in self.STATE_ARRAYS:
            arr = dev[name].cpu().numpy()
            getattr(self, name)[:arr.shape[0]] = arr
    # -- tenant lifecycle ----------------------------------------------------
    def _ensure(self, size: int) -> None:
        if self.level.shape[0] >= size:
            return
        for name in self.STATE_ARRAYS:
            fill = np.nan if name.startswith("ewma") else 0.0
            setattr(self, name, _grown(getattr(self, name), size, fill))
        self.active = _grown(self.active, size, False)
        self.last_alloc = _grown(self.last_alloc, size, 0.0)
        self._device = None

    def add_tenant(self, tenant: int, weight: float = 1.0,
                   rate: float = 0.0, burst: Optional[float] = None) -> int:
        """Register a tenant; returns its slot. ``rate``/``burst`` seed
        the bucket (full at ``burst``, defaulting to 1 s of rate)."""
        self._sync_host()
        slot = self.index.add(tenant)
        self._ensure(self.index.size)
        cap = float(burst if burst is not None else max(rate, 1.0))
        self.weight[slot] = float(weight)
        self.brate[slot] = float(rate)
        self.bcap[slot] = cap
        self.level[slot] = cap
        self.updated[slot] = 0.0
        self.ewma_off[slot] = self.ewma_def[slot] = np.nan
        self.prev_off[slot] = self.prev_def[slot] = 0.0
        self.active[slot] = True
        self.last_alloc[slot] = 0.0
        self._device = None
        return slot

    def drop_tenant(self, tenant: int) -> None:
        """Evict a tenant entirely: EWMA state, counter baselines and
        bucket are gone; the slot is freed for reuse."""
        if tenant not in self.index:
            return
        self._sync_host()
        slot = self.index.drop(tenant)
        self.active[slot] = False
        self.weight[slot] = self.brate[slot] = self.bcap[slot] = 0.0
        self.level[slot] = self.updated[slot] = 0.0
        self.ewma_off[slot] = self.ewma_def[slot] = np.nan
        self.prev_off[slot] = self.prev_def[slot] = 0.0
        self.last_alloc[slot] = 0.0
        self._device = None

    def compact(self) -> None:
        """Defragment slots after churn (array state is gathered along)."""
        self._sync_host()
        remap = self.index.compact()
        for name in self.STATE_ARRAYS + ("last_alloc",):
            fill = np.nan if name.startswith("ewma") else 0.0
            setattr(self, name, _gather(getattr(self, name), remap, fill))
        self.active = np.ones(len(remap), dtype=bool)
        self._device = None

    # -- TenantState round-trip ---------------------------------------------
    def snapshot_tenant(self, tenant: int,
                        now: Optional[float] = None) -> Dict[str, object]:
        """Non-destructive per-tenant state in the shared wire format:
        ``bucket`` is a ``TokenBucket.snapshot`` dict, ``weight``/EWMA
        ride alongside. Round-trips through ``restore_tenant`` and
        through the object backend's ``TokenBucket.restore``."""
        self._sync_host()
        slot = self.index.slot(tenant)
        if now is not None and now > self.updated[slot]:
            self.level[slot] = min(
                self.bcap[slot],
                self.level[slot] + (now - self.updated[slot])
                * self.brate[slot])
            self.updated[slot] = now
            self._device = None
        return {
            "bucket": {"rate": float(self.brate[slot]),
                       "capacity": float(self.bcap[slot]),
                       "tokens": float(self.level[slot]),
                       "updated": float(self.updated[slot])},
            "weight": float(self.weight[slot]),
            "ewma_offered": float(self.ewma_off[slot]),
            "ewma_deferred": float(self.ewma_def[slot]),
            "prev_offered": float(self.prev_off[slot]),
            "prev_deferred": float(self.prev_def[slot]),
        }

    def export_tenant(self, tenant: int,
                      now: Optional[float] = None) -> Dict[str, object]:
        """Destructive ``snapshot_tenant``: the migration source half."""
        state = self.snapshot_tenant(tenant, now)
        self.drop_tenant(tenant)
        return state

    def restore_tenant(self, tenant: int, state: Dict[str, object],
                       now: Optional[float] = None) -> None:
        """Install an exported/snapshotted tenant (refused on a live
        slot — restore requires a quiesced destination)."""
        if tenant in self.index:
            raise ValueError(f"tenant {tenant} already live in the "
                             f"vectorized control plane")
        slot = self.add_tenant(tenant, weight=state.get("weight", 1.0))
        b = state["bucket"]
        self.brate[slot] = float(b["rate"])
        self.bcap[slot] = float(b["capacity"])
        self.level[slot] = min(float(b["tokens"]), float(b["capacity"]))
        self.updated[slot] = float(b.get("updated", 0.0)) if now is None \
            else float(now)
        self.ewma_off[slot] = float(state.get("ewma_offered", np.nan))
        self.ewma_def[slot] = float(state.get("ewma_deferred", np.nan))
        self.prev_off[slot] = float(state.get("prev_offered", 0.0))
        self.prev_def[slot] = float(state.get("prev_deferred", 0.0))
        self._device = None

    # -- the fused tick ------------------------------------------------------
    def _device_state(self) -> dict:
        """Device tensors of the state arrays (rebuilt after host mutation).

        Sliced to ``index.size``: the host arrays carry doubling-growth
        slack for O(1) amortized add, but every slot a tenant can occupy
        is below ``size``, so the fused tick never needs the tail."""
        if self._device is None:
            n = self.index.size
            self._device = {
                name: torch.tensor(getattr(self, name)[:n],
                                   device=self.device)
                for name in self.STATE_ARRAYS}
            self._device["active"] = torch.tensor(self.active[:n],
                                                  device=self.device)
        return self._device

    def state_bytes(self) -> int:
        """Bytes of control state touched per tick: the device-resident
        state arrays (sliced to the live slot range, matching what the
        fused tick actually reads) plus the per-tick sample stack."""
        n = self.index.size
        state = sum(getattr(self, nm)[:n].nbytes
                    for nm in self.STATE_ARRAYS)
        samples = 3 * n * 8                    # cur_off, cur_def, queue
        return state + self.active[:n].nbytes + samples

    def tick(self, offered: np.ndarray,
             deferred: Optional[np.ndarray] = None,
             queue: Optional[np.ndarray] = None,
             now: Optional[float] = None) -> Optional[np.ndarray]:
        """One fused control interval over the whole population.

        ``offered``/``deferred`` are slot-aligned cumulative counters
        (units ever served / ever deferred per slot), ``queue`` the
        instantaneous per-slot backlog. The first call establishes the
        counter baseline and returns None — exactly the object
        controller's warm-up tick. Subsequent calls return the per-slot
        allocation array (units/s; 0 for inactive slots).
        """
        t0 = time.perf_counter()
        now = time.monotonic() if now is None else float(now)
        n = self.index.size
        offered = np.asarray(offered, dtype=np.float64)
        deferred = np.zeros(n) if deferred is None \
            else np.asarray(deferred, dtype=np.float64)
        queue = np.zeros(n) if queue is None \
            else np.asarray(queue, dtype=np.float64)
        if offered.shape[0] != n:
            raise ValueError(f"offered has {offered.shape[0]} slots, "
                             f"index has {n}")
        if self.prev_t is None or now <= self.prev_t:
            self._sync_host()
            self.prev_off[:n] = offered
            self.prev_def[:n] = deferred
            self.prev_t = now
            self._device = None
            self.ticks += 1
            self.tick_seconds_total += time.perf_counter() - t0
            return None
        dev = self._device_state()
        # one (3, slots) sample stack + one packed scalar vector: exactly
        # two host->device copies per tick, whatever the population
        samples = torch.tensor(np.stack([offered, deferred, queue]),
                               device=self.device)
        params = torch.tensor([now, self.prev_t, self.alpha, self.capacity,
                               self.headroom, self.min_rate, self.burst_s],
                              dtype=torch.float64, device=self.device)
        (level, brate, bcap, updated, off, dfr, prev_off, prev_def,
         alloc, lvl) = fused_tick(
            dev["level"], dev["brate"], dev["bcap"], dev["updated"],
            dev["ewma_off"], dev["ewma_def"], dev["prev_off"],
            dev["prev_def"], dev["weight"], dev["active"], samples, params,
            iters=self.iters, scheduler_buckets=self.scheduler_buckets)
        # state stays device-resident across ticks; the host arrays
        # refresh lazily on demand (facade access, snapshot, migration)
        self._device = {"level": level, "brate": brate, "bcap": bcap,
                        "updated": updated, "ewma_off": off,
                        "ewma_def": dfr, "prev_off": prev_off,
                        "prev_def": prev_def, "weight": dev["weight"],
                        "active": dev["active"]}
        # one device->host copy: the allocations with the level behind them
        host = torch.cat([alloc, lvl.reshape(1)]).cpu().numpy()
        alloc_np = host[:n].copy()
        self.prev_t = now
        self.last_alloc = alloc_np
        self.last_level = float(host[n])
        self.ticks += 1
        self.tick_seconds_total += time.perf_counter() - t0
        return alloc_np

    def allocations(self) -> Dict[int, float]:
        """The last tick's allocations as a {tenant: rate} dict (the
        object-API view; the array form is ``last_alloc``)."""
        return {t: float(self.last_alloc[s]) for t, s in self.index.items()}

    def obs(self) -> Dict[int, "TenantObs"]:
        """The last tick's telemetry view as TenantObs (facade export)."""
        from repro_torch.control.telemetry import TenantObs
        self._sync_host()
        out = {}
        for t, s in self.index.items():
            off = float(self.ewma_off[s])
            dfr = float(self.ewma_def[s])
            if np.isnan(off):
                out[t] = TenantObs()
                continue
            dfr = 0.0 if np.isnan(dfr) else min(dfr, off)
            out[t] = TenantObs(rate=max(off - dfr, 0.0), offered=off,
                               deferred=dfr)
        return out

    def counters(self) -> Dict[str, float]:
        return {
            "nk_control_ticks_total": self.ticks,
            "nk_control_tick_seconds_total": self.tick_seconds_total,
            "nk_control_tenants": float(len(self.index)),
        }


# ---------------------------------------------------------------------------
# WaterFill facade entry point
# ---------------------------------------------------------------------------


def waterfill_allocate(demands: Dict[int, float], capacity: float,
                       weights: Optional[Dict[int, float]] = None,
                       impl: str = "kernel", device=None
                       ) -> Dict[int, float]:
    """``max_min_fair`` on the array backend: dict in, dict out.

    Builds flat float64 demand/weight tensors on ``device`` (``cuda``
    unless ``"cpu"`` is passed) and runs ``kernels.ops.water_fill``:
    ``impl="kernel"`` the bisection kernel (its plain version on the CPU),
    ``impl="ref"`` the exact sort-based fill. Allocations agree with the
    scalar implementation within 1e-6 x capacity. ``inf`` demand = greedy.
    """
    if capacity <= 0 or not demands:
        return {t: 0.0 for t in demands}
    dev = resolve_device(device)
    tenants = sorted(demands)
    d = torch.tensor([float(demands[t]) for t in tenants],
                     dtype=torch.float64, device=dev)
    w = torch.tensor([float(weights.get(t, 1.0)) if weights else 1.0
                      for t in tenants], dtype=torch.float64, device=dev)
    alloc = ops.water_fill(d, w, float(capacity), impl=impl).cpu().numpy()
    out: Dict[int, float] = {}
    for i, t in enumerate(tenants):
        # satisfied tenants get their demand *exactly* (the object
        # backend's contract); the array result is within tolerance, so
        # snap to the demand when the fill reached it
        a = float(alloc[i])
        dt_ = float(demands[t])
        if np.isfinite(dt_) and abs(a - dt_) <= 1e-9 * max(abs(dt_), 1.0):
            a = dt_
        out[t] = a
    return out
