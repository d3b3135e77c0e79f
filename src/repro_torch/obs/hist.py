"""Fixed-bucket latency histograms with quantile estimation.

The fabric needs tail latency per tenant (admit wait, TTFT, e2e) without
keeping every sample: a ``Histogram`` is a fixed vector of log-spaced
bucket counts, cheap to observe into, cheap to merge (tenant migration
carries the counts in the ``TenantState`` payload), and good enough for
p50/p95/p99 — a quantile estimate is always the upper edge of the bucket
the quantile falls in, so it brackets the true sample quantile within one
bucket width (the property test in ``tests/test_obs.py``).

Default buckets span 1 ms .. 100 s with growth 10^(1/8) ≈ 1.33 — eight
buckets per decade, 41 edges — wide enough for the replay's virtual-clock
waits and the wall-clock benches alike. Stdlib only.
"""
from __future__ import annotations

import functools
import itertools
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# 1e-3 .. 1e2, 8 buckets/decade: 10**(-3 + k/8) for k = 0..40
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(
    10.0 ** (-3.0 + k / 8.0) for k in range(41))


class Histogram:
    """Cumulative-export histogram over fixed upper-edge buckets.

    ``counts[i]`` is the number of samples with ``value <= edges[i]``
    minus those counted by earlier buckets (i.e. stored non-cumulative,
    exported cumulative per the Prometheus text format); ``overflow``
    holds samples above the last edge (the ``+Inf`` bucket).
    """

    __slots__ = ("edges", "counts", "overflow", "total", "sum", "min", "max")

    def __init__(self, edges: Optional[Sequence[float]] = None):
        self.edges: Tuple[float, ...] = tuple(edges if edges is not None
                                              else DEFAULT_BUCKETS)
        if list(self.edges) != sorted(self.edges) or len(self.edges) < 1:
            raise ValueError("bucket edges must be sorted and non-empty")
        self.counts: List[int] = [0] * len(self.edges)
        self.overflow = 0
        self.total = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    # -- recording ----------------------------------------------------------
    def observe(self, value: float) -> None:
        v = float(value)
        self.total += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        i = self._bucket_index(v)
        if i is None:
            self.overflow += 1
        else:
            self.counts[i] += 1

    def _bucket_index(self, v: float) -> Optional[int]:
        """Smallest i with v <= edges[i], or None for the +Inf bucket."""
        lo, hi = 0, len(self.edges)
        if v > self.edges[-1]:
            return None
        while lo < hi:
            mid = (lo + hi) // 2
            if v <= self.edges[mid]:
                hi = mid
            else:
                lo = mid + 1
        return lo

    # -- queries ------------------------------------------------------------
    @property
    def mean(self) -> float:
        return self.sum / self.total if self.total else 0.0

    def quantile(self, q: float) -> float:
        """Upper edge of the bucket holding quantile ``q`` (0..1); the
        last observed max for the overflow bucket, 0.0 when empty."""
        lo, hi = self.quantile_bounds(q)
        return hi

    def quantile_bounds(self, q: float) -> Tuple[float, float]:
        """(lower, upper) bucket edges bracketing quantile ``q``: the true
        sample quantile lies in (lower, upper]. Overflow samples report
        ``(last_edge, observed max)``."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("q must be in [0, 1]")
        if self.total == 0:
            return 0.0, 0.0
        # rank of the q-th sample, 1-based ceil as in numpy's 'inverted_cdf'
        rank = max(1, math.ceil(q * self.total))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                lower = self.edges[i - 1] if i else 0.0
                return lower, self.edges[i]
        # quantile falls in the overflow bucket
        return self.edges[-1], (self.max if self.max > -math.inf
                                else math.inf)

    # -- merge / snapshot ---------------------------------------------------
    def merge(self, other: "Histogram") -> None:
        if other.edges != self.edges:
            raise ValueError("cannot merge histograms with different edges")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.overflow += other.overflow
        self.total += other.total
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    def copy(self) -> "Histogram":
        h = Histogram(self.edges)
        h.counts = list(self.counts)
        h.overflow = self.overflow
        h.total = self.total
        h.sum = self.sum
        h.min = self.min
        h.max = self.max
        return h

    def since(self, snapshot: "Histogram") -> "Histogram":
        """The histogram of samples observed after ``snapshot`` was taken
        (both must share edges) — how the replay windows its reports."""
        if snapshot.edges != self.edges:
            raise ValueError("snapshot has different edges")
        h = Histogram(self.edges)
        h.counts = [a - b for a, b in zip(self.counts, snapshot.counts)]
        h.overflow = self.overflow - snapshot.overflow
        h.total = self.total - snapshot.total
        h.sum = self.sum - snapshot.sum
        # min/max are lifetime extrema; keep current ones (conservative)
        h.min = self.min
        h.max = self.max
        return h

    # -- wire formats -------------------------------------------------------
    def to_payload(self) -> dict:
        """Plain-dict form carried inside a ``TenantState`` payload."""
        return {"edges": list(self.edges), "counts": list(self.counts),
                "overflow": self.overflow, "total": self.total,
                "sum": self.sum, "min": self.min, "max": self.max}

    @classmethod
    def from_payload(cls, payload: dict) -> "Histogram":
        h = cls(payload["edges"])
        h.counts = list(payload["counts"])
        h.overflow = int(payload["overflow"])
        h.total = int(payload["total"])
        h.sum = float(payload["sum"])
        h.min = float(payload["min"])
        h.max = float(payload["max"])
        return h

    def counters(self, name: str, **labels) -> Dict[str, float]:
        """Prometheus histogram samples: cumulative ``_bucket{le=...}``
        plus ``_sum`` and ``_count``, with any extra labels attached."""
        buckets, inf, sum_key, count_key = _series_keys(
            name, tuple(sorted(labels.items())), self.edges)
        out = dict(zip(buckets, map(float, itertools.accumulate(
            self.counts))))
        out[inf] = float(self.total)
        out[sum_key] = self.sum
        out[count_key] = float(self.total)
        return out


@functools.lru_cache(maxsize=4096)
def _series_keys(name: str, labels: Tuple[Tuple[str, object], ...],
                 edges: Tuple[float, ...]):
    """The series strings of one histogram's samples: one ``_bucket`` key
    per edge, the ``+Inf`` bucket, ``_sum`` and ``_count``. Memoized: a
    watchdog scrapes the same histograms every tick."""
    from repro_torch.obs.metrics import escape_label_value
    base = ",".join(f'{k}="{escape_label_value(v)}"' for k, v in labels)
    sep = "," if base else ""
    buckets = tuple(f'{name}_bucket{{{base}{sep}le="{format(edge, ".6g")}"}}'
                    for edge in edges)
    return (buckets, f'{name}_bucket{{{base}{sep}le="+Inf"}}',
            f"{name}_sum{{{base}}}" if base else f"{name}_sum",
            f"{name}_count{{{base}}}" if base else f"{name}_count")


class TenantHistograms:
    """A family of per-tenant histograms for one latency metric."""

    def __init__(self, name: str,
                 edges: Optional[Sequence[float]] = None):
        self.name = name
        self.edges = tuple(edges if edges is not None else DEFAULT_BUCKETS)
        self.per_tenant: Dict[str, Histogram] = {}

    def observe(self, tenant: str, value: float) -> None:
        h = self.per_tenant.get(tenant)
        if h is None:
            h = self.per_tenant[tenant] = Histogram(self.edges)
        h.observe(value)

    def get(self, tenant: str) -> Histogram:
        return self.per_tenant.get(tenant) or Histogram(self.edges)

    def pop(self, tenant: str) -> Optional[Histogram]:
        return self.per_tenant.pop(tenant, None)

    def absorb(self, tenant: str, hist: Histogram) -> None:
        """Merge a migrated-in histogram into the tenant's local one."""
        h = self.per_tenant.get(tenant)
        if h is None:
            self.per_tenant[tenant] = hist.copy()
        else:
            h.merge(hist)

    def merged(self, other: "TenantHistograms") -> "TenantHistograms":
        out = TenantHistograms(self.name, self.edges)
        for src in (self, other):
            for t, h in src.per_tenant.items():
                out.absorb(t, h)
        return out

    def counters(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for t in sorted(self.per_tenant):
            out.update(self.per_tenant[t].counters(self.name, tenant=t))
        return out
