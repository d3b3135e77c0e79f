"""Multiplexing economics: the paper's use case 1, in chips.

The counterpart of ``repro/serve/multiplex.py``, carried over whole: the
``Trace`` vocabulary the replay harness and the fairness checks share.

The paper's Table 2: 3 bursty application gateways each peak-provisioned at
4 cores are served by one 5-core NSM + 1-core CoreEngine — 9 cores instead
of 12, and in general >40% core savings across a fleet of bursty tenants.

Here the shared resource is decode capacity (tokens/s per chip-group).
``chip_accounting`` compares:
  dedicated :  sum_i ceil(peak_i / cap)      (per-tenant peak provisioning)
  shared    :  ceil(peak_t sum_i(load_i(t)) / cap) + engine overhead
on bursty traces (anti-correlated bursts, like the paper's AGs serving
different customer populations). ``serve/replay.py`` replays the same
traces through a real ServeEngine to show per-tenant RPS is preserved.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.control.congestion import max_min_fair


@dataclass
class Trace:
    """Per-tenant load in requests/s over time (1 value per interval)."""

    loads: np.ndarray     # (tenants, T)

    @property
    def peaks(self) -> np.ndarray:
        return self.loads.max(axis=1)

    @property
    def aggregate_peak(self) -> float:
        return float(self.loads.sum(axis=0).max())


def bursty_trace(n_tenants: int, intervals: int = 60, seed: int = 0,
                 base: float = 8.0, burst: float = 40.0,
                 burst_prob: float = 0.08) -> Trace:
    """Bursty, mostly-idle tenants (paper Fig. 7: AG utilization is very low
    most of the time, with short uncorrelated bursts)."""
    rng = np.random.default_rng(seed)
    loads = rng.gamma(2.0, base / 2.0, size=(n_tenants, intervals))
    bursts = rng.random((n_tenants, intervals)) < burst_prob
    loads = loads + bursts * rng.gamma(2.0, burst / 2.0,
                                       size=(n_tenants, intervals))
    # stagger burst phases so tenants are not synchronized
    for i in range(n_tenants):
        loads[i] = np.roll(loads[i], rng.integers(0, intervals))
    return Trace(loads=loads)


def steady_trace(n_tenants: int, intervals: int = 60,
                 rps: float = 10.0) -> Trace:
    """Constant equal demand — the steady-state control-plane baseline
    (delta-push should go near-silent on this one)."""
    return Trace(loads=np.full((n_tenants, intervals), float(rps)))


def adversarial_trace(n_tenants: int, intervals: int = 60,
                      base: float = 8.0, hog_factor: float = 10.0,
                      hog: int = -1) -> Trace:
    """In-budget tenants at a constant trickle plus one misbehaver offering
    ``hog_factor`` times the whole fleet's base load (paper Fig. 22: the
    10x-overloading VM must not hurt its neighbours)."""
    loads = np.full((n_tenants, intervals), float(base))
    loads[hog] = hog_factor * base * n_tenants
    return Trace(loads=loads)


def correlated_burst_trace(n_tenants: int, intervals: int = 60,
                           seed: int = 0, base: float = 4.0,
                           burst: float = 30.0, period: int = 12,
                           width: int = 3) -> Trace:
    """All tenants burst *together* (one customer population): the worst
    case for multiplexing economics and the stress case for fairness —
    every burst is contested."""
    rng = np.random.default_rng(seed)
    loads = rng.gamma(2.0, base / 2.0, size=(n_tenants, intervals))
    for k in range(0, intervals, period):
        loads[:, k:k + width] += burst
    return Trace(loads=loads)


def ramp_trace(n_tenants: int, intervals: int = 60,
               base: float = 6.0, peak: float = 40.0,
               ramper: int = 0) -> Trace:
    """One tenant ramps linearly from idle to ``peak`` while the rest hold
    a constant base load — exercises controller tracking (allocations must
    follow the ramp, so delta-push stays busy here)."""
    loads = np.full((n_tenants, intervals), float(base))
    loads[ramper] = np.linspace(0.0, peak, intervals)
    return Trace(loads=loads)


def idle_window_trace(n_tenants: int, intervals: int = 60,
                      base: float = 3.0, idle_level: float = 0.2,
                      idle_start: Optional[int] = None,
                      idle_end: Optional[int] = None) -> Trace:
    """Every tenant busy at ``base``, then a shared idle window at
    ``idle_level`` (a trickle, not silence — tenants stay placeable),
    then busy again. The consolidation story: during the window the whole
    fleet fits one engine, so a closed placement loop should pack tenants
    together and park the rest of the cluster (cores saved), waking it
    when load returns."""
    idle_start = intervals // 3 if idle_start is None else idle_start
    idle_end = 2 * intervals // 3 if idle_end is None else idle_end
    loads = np.full((n_tenants, intervals), float(base))
    loads[:, idle_start:idle_end] = float(idle_level)
    return Trace(loads=loads)


def hotspot_trace(n_tenants: int, intervals: int = 60,
                  base: float = 1.0, hog_factor: float = 10.0,
                  hog: int = -1, onset: Optional[int] = None) -> Trace:
    """Everyone equal until ``onset``, then one tenant turns into a
    ``hog_factor``x-the-fleet misbehaver — the hotspot *develops* mid-run
    (unlike ``adversarial_trace``, which is hot from interval 0), so a
    placement loop has to detect the heating engine and migrate the hog
    away on its own."""
    onset = intervals // 3 if onset is None else onset
    loads = np.full((n_tenants, intervals), float(base))
    loads[hog, onset:] = hog_factor * base * n_tenants
    return Trace(loads=loads)


TRACES = {
    "bursty": bursty_trace,
    "steady": steady_trace,
    "adversarial": adversarial_trace,
    "correlated": correlated_burst_trace,
    "ramp": ramp_trace,
    "idle_window": idle_window_trace,
    "hotspot": hotspot_trace,
}


def chip_accounting(trace: Trace, cap_per_chip: float,
                    engine_overhead_chips: int = 1) -> Dict:
    """Chips needed: dedicated per-tenant peaks vs one shared engine."""
    dedicated = int(sum(math.ceil(p / cap_per_chip) for p in trace.peaks))
    shared = int(math.ceil(trace.aggregate_peak / cap_per_chip)) \
        + engine_overhead_chips
    return {
        "tenants": int(trace.loads.shape[0]),
        "dedicated_chips": dedicated,
        "shared_chips": shared,
        "savings_frac": 1.0 - shared / max(dedicated, 1),
        "aggregate_peak": trace.aggregate_peak,
        "sum_of_peaks": float(trace.peaks.sum()),
    }


def paper_table2_analog(n_tenants: int = 16, seed: int = 0,
                        cap_per_chip: float = 50.0) -> Dict:
    """The fleet-level claim: >40% savings at equal served load."""
    t = bursty_trace(n_tenants, seed=seed)
    return chip_accounting(t, cap_per_chip)


# ---------------------------------------------------------------------------
# Fairness-aware replay (management-plane view of the shared engine)
# ---------------------------------------------------------------------------


def jain_index(xs: Sequence[float]) -> float:
    """Jain's fairness index: 1.0 = perfectly equal, 1/n = one hog.

    ``xs``: per-tenant rates (any shared unit — tokens/s, bytes/s).
    Degenerate idle intervals are *defined* as perfectly fair: an empty or
    all-zero vector returns 1.0, and non-finite entries (the NaN a 0/0
    rate computation produces for an idle tenant) are treated as 0.0
    instead of poisoning the index into NaN.

    >>> jain_index([2.0, 2.0, 2.0])
    1.0
    >>> jain_index([0.0, 0.0, 0.0])
    1.0
    >>> jain_index([])
    1.0
    >>> round(jain_index([float("nan"), 3.0]), 3)
    0.5
    """
    xs = [float(x) if math.isfinite(x) else 0.0 for x in xs]
    n = len(xs)
    sq = sum(x * x for x in xs)
    if n == 0 or sq <= 0:
        return 1.0
    return sum(xs) ** 2 / (n * sq)


def fair_replay(trace: Trace, capacity: float,
                weights: Optional[Dict[int, float]] = None,
                rate_caps: Optional[Dict[int, float]] = None,
                interval_s: float = 1.0) -> Dict:
    """Replay a load trace through a weighted max-min fair shared engine.

    Fluid-flow model of what the RateController enforces on a real
    deployment: per interval, each tenant demands its offered load plus any
    backlog carried from earlier intervals; the bottleneck ``capacity``
    (requests/s) is divided weighted-max-min-fair; unserved demand queues.
    ``rate_caps`` bounds individual tenants (Fig. 21 hard caps) — capacity a
    capped tenant cannot use is re-filled to the others (work conservation).
    """
    loads = trace.loads
    n, T = loads.shape
    served = np.zeros((n, T))
    backlog = np.zeros(n)
    backlogged_jain: List[float] = []
    for t in range(T):
        demand = {i: loads[i, t] * interval_s + backlog[i] for i in range(n)}
        if rate_caps:
            demand = {i: min(d, rate_caps.get(i, math.inf) * interval_s)
                      for i, d in demand.items()}
        alloc = max_min_fair(capacity * interval_s, demand, weights)
        for i in range(n):
            served[i, t] = alloc[i] / interval_s
            backlog[i] = max(backlog[i] + loads[i, t] * interval_s
                             - alloc[i], 0.0)
        contested = [i for i in range(n) if demand[i] > alloc[i] + 1e-9]
        if len(contested) >= 2:
            w = weights or {}
            backlogged_jain.append(jain_index(
                [served[i, t] / w.get(i, 1.0) for i in contested]))
    total = float(served.sum()) * interval_s
    offered = float(loads.sum()) * interval_s
    return {
        "served": served,
        "per_tenant_served": served.sum(axis=1) * interval_s,
        "utilization": total / (capacity * T * interval_s),
        "served_frac": total / max(offered, 1e-12),
        "jain_backlogged": (float(np.mean(backlogged_jain))
                            if backlogged_jain else 1.0),
        "backlog_final": backlog,
    }
