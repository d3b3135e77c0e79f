"""SeriesStore: a bounded ring of scrapes, queried as time series.

The counterpart of ``repro/obs/timeseries.py``. A single scrape of the
``MetricsRegistry`` holds lifetime totals only: no rates, no history. This
module is the retention layer the watchdog (``obs/slo.py``) evaluates
against:

  * ``SeriesStore.ingest`` accepts a whole scrape — exposition text, a
    ``registry.collect()`` dict keyed by ``Series`` tuples, or a flat
    ``counters()`` dict keyed by series strings — stamped with the scrape
    time. Retention is bounded: only the last ``retention`` scrapes are
    kept, older points are dropped per series.
  * ``rate()`` / ``increase()`` are **counter-reset aware** with the exact
    semantics ``SchedulerTelemetry`` already uses on the live path: a
    sample that *decreased* (or a series that vanished and came back)
    means the counter was reset behind our back — live migration folds a
    tenant's ledger out of the source scheduler, a stack hot-swap replaces
    the scheduler wholesale — so the new value becomes the baseline and
    the drop contributes **zero**, never a negative rate. Concretely:
    ``increase`` is the sum of positive adjacent deltas over the window.
  * ``quantile_over_time()`` re-derives a windowed latency quantile from
    exported cumulative ``_bucket`` series: per-bucket reset-aware
    increases over the window, then the same upper-edge rule as
    ``obs/hist.py``'s ``Histogram.quantile`` (rank = max(1, ceil(q*total)),
    answer = the first bucket edge whose cumulative count reaches it).

Unlike Prometheus's ``rate()``, no extrapolation: ``rate`` divides the
windowed increase by the elapsed time between the first and last sample
actually in the window — deterministic, and exact for the two-scrape diff
``tools/nk_top.py`` renders. Stdlib only.
"""
from __future__ import annotations

import bisect
import math
from typing import Dict, List, Mapping, Optional, Tuple, Union

from repro_torch.obs.metrics import (Labels, Series,
                                     parse_prometheus_text, parse_series_key)

ScrapeLike = Union[str, Mapping[Series, float], Mapping[str, float]]


def series_key(name: str, **labels) -> Series:
    """The ``Series`` tuple for ``name`` + labels — the key every
    ``SeriesStore`` query takes."""
    return name, tuple(sorted((k, str(v)) for k, v in labels.items()))


def _as_series_dict(scrape: ScrapeLike) -> Dict[Series, float]:
    if isinstance(scrape, str):
        return parse_prometheus_text(scrape)
    out: Dict[Series, float] = {}
    for k, v in scrape.items():
        out[k if isinstance(k, tuple) else parse_series_key(k)] = float(v)
    return out


class SeriesStore:
    """Bounded per-series sample history over periodic scrapes.

    ``retention`` bounds memory by *scrape count*: once more than
    ``retention`` scrapes have been ingested, the oldest falls off and
    every series drops its points from before the oldest retained scrape.
    """

    def __init__(self, retention: int = 512):
        if retention < 2:
            raise ValueError("retention must be >= 2 (rates need a pair)")
        self.retention = int(retention)
        self._times: List[float] = []
        self._data: Dict[Series, List[Tuple[float, float]]] = {}
        self._by_name: Dict[str, List[Series]] = {}   # name -> its series
        # ``_bucket`` name -> {non-``le`` labels: [(edge, series), ...]},
        # built on a query, dropped when the name's series set changes
        self._buckets: Dict[str, Dict[Labels, List[Tuple[float, Series]]]]\
            = {}
        self.scrapes = 0              # lifetime scrapes ingested
        # the last scrape's series, in order, and their point lists
        self._last_keys: List[Series] = []
        self._last_pts: List[List[Tuple[float, float]]] = []

    # -- ingest -------------------------------------------------------------
    def ingest(self, scrape: ScrapeLike, ts: float) -> None:
        """Add one scrape stamped ``ts`` (seconds; must be strictly after
        the previous scrape — the watchdog runs on a monotonic clock)."""
        t = float(ts)
        if self._times and t <= self._times[-1]:
            raise ValueError(
                f"scrape at ts {t} is not after the previous scrape at "
                f"{self._times[-1]}")
        # a registry.collect() dict is keyed by Series already (and so
        # holds each series once): take it as it is. Values are floats
        # before anything is stored, so a bad one changes nothing
        if isinstance(scrape, dict) and set(map(type, scrape)) <= {tuple}:
            keys, values = list(scrape), list(map(float, scrape.values()))
        else:
            parsed = _as_series_dict(scrape)
            keys, values = list(parsed), list(parsed.values())
        data = self._data
        if keys == self._last_keys:
            # the previous scrape's series again, each still held (its
            # newest point is the newest scrape's): append in order,
            # without a lookup each
            for pts, v in zip(self._last_pts, values):
                pts.append((t, v))
        else:
            pts_of = []
            for series, v in zip(keys, values):
                pts = data.get(series)
                if pts is None:
                    pts = data[series] = []
                    self._by_name.setdefault(series[0], []).append(series)
                    self._buckets.pop(series[0], None)
                pts.append((t, v))
                pts_of.append(pts)
            self._last_keys, self._last_pts = keys, pts_of
        self._times.append(t)
        self.scrapes += 1
        if len(self._times) > self.retention:
            del self._times[: len(self._times) - self.retention]
            floor = self._times[0]
            emptied = []
            for series, pts in data.items():
                if pts[0][0] >= floor:
                    continue
                i = 1
                while i < len(pts) and pts[i][0] < floor:
                    i += 1
                del pts[:i]
                if not pts:
                    emptied.append(series)
            for series in emptied:
                del data[series]
                self._by_name[series[0]].remove(series)
                self._buckets.pop(series[0], None)
                if not self._by_name[series[0]]:
                    del self._by_name[series[0]]

    # -- lookups ------------------------------------------------------------
    def times(self) -> Tuple[float, ...]:
        """Timestamps of the retained scrapes, oldest first."""
        return tuple(self._times)

    def names(self) -> List[str]:
        return sorted(self._by_name)

    def series(self, name: Optional[str] = None) -> List[Series]:
        if name is not None:
            return sorted(self._by_name.get(name, ()))
        return sorted(self._data)

    def label_values(self, name: str, label: str) -> List[str]:
        """Distinct values of one label across all series of ``name``."""
        out = {v for _, lbl in self._by_name.get(name, ())
               for k, v in lbl if k == label}
        return sorted(out, key=lambda s: (len(s), s))

    def latest(self, series: Series) -> Optional[float]:
        pts = self._data.get(series)
        return pts[-1][1] if pts else None

    def window(self, series: Series, window_s: Optional[float] = None,
               now: Optional[float] = None) -> List[Tuple[float, float]]:
        """Samples of ``series`` with ``now - window_s <= ts <= now``
        (both ends inclusive); the whole retained history when
        ``window_s`` is None. ``now`` defaults to the newest scrape."""
        pts = self._data.get(series, [])
        if not pts:
            return []
        hi = (self._times[-1] if self._times else pts[-1][0]) \
            if now is None else float(now)
        lo = -math.inf if window_s is None else hi - float(window_s)
        # points are time-sorted: slice by bisection, don't scan
        i = bisect.bisect_left(pts, (lo,)) if lo > -math.inf else 0
        j = bisect.bisect_right(pts, (hi, math.inf))
        return pts[i:j]

    # -- counter-reset-aware rates ------------------------------------------
    def increase(self, series: Series, window_s: Optional[float] = None,
                 now: Optional[float] = None) -> float:
        """Windowed counter increase: the sum of positive adjacent deltas.

        A decreased sample is a counter reset (migration folded the ledger
        out, a hot-swap replaced the scheduler): the drop contributes 0
        and the new value rebaselines — same discipline as
        ``SchedulerTelemetry.update``. Never negative. 0.0 with fewer
        than two samples in the window."""
        pts = self.window(series, window_s, now)
        total = 0.0
        for (_, a), (_, b) in zip(pts, pts[1:]):
            if b > a:
                total += b - a
        return total

    def rate(self, series: Series, window_s: Optional[float] = None,
             now: Optional[float] = None) -> float:
        """Per-second rate over the window: reset-aware increase divided
        by the elapsed time between the first and last sample actually in
        the window (no extrapolation). 0.0 with fewer than two samples."""
        pts = self.window(series, window_s, now)
        if len(pts) < 2:
            return 0.0
        elapsed = pts[-1][0] - pts[0][0]
        if elapsed <= 0:
            return 0.0
        return self.increase(series, window_s, now) / elapsed

    # -- windowed histogram quantiles ---------------------------------------
    def _bucket_index(self, name: str
                      ) -> Dict[Labels, List[Tuple[float, Series]]]:
        """``name``'s series grouped by their labels other than ``le``,
        each with its bucket edge; series without ``le`` are left out."""
        index = self._buckets.get(name)
        if index is None:
            index = {}
            for series in self._by_name.get(name, ()):
                d = dict(series[1])
                le = d.pop("le", None)
                if le is None:
                    continue
                edge = math.inf if le == "+Inf" else float(le)
                index.setdefault(tuple(sorted(d.items())), []).append(
                    (edge, series))
            self._buckets[name] = index
        return index

    def quantile_over_time(self, family: str, q: float,
                           window_s: Optional[float] = None,
                           now: Optional[float] = None,
                           **labels) -> Optional[float]:
        """Quantile of the samples a histogram family observed *inside the
        window*, from its exported cumulative ``_bucket`` series.

        Per-bucket reset-aware increases give the windowed cumulative
        counts; the answer is the upper edge of the bucket the quantile
        falls in — exactly ``Histogram.quantile``'s rule, so the result is
        bracketed by ``Histogram.quantile_bounds`` on the same samples.
        ``labels`` must match the series' non-``le`` labels exactly.
        None when no bucket series match or the window saw no samples."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("q must be in [0, 1]")
        want = tuple(sorted((k, str(v)) for k, v in labels.items()))
        index = self._bucket_index(family + "_bucket").get(want, ())
        if not index:
            return None
        # each bucket's increase(), inlined: one window for every bucket.
        # A series' points sit at retained scrape times, so one with a
        # point at every retained scrape has the scrapes' window indices
        times = self._times
        hi = times[-1] if now is None else float(now)
        lo = -math.inf if window_s is None else hi - float(window_s)
        i_all = bisect.bisect_left(times, lo) if lo > -math.inf else 0
        j_all = bisect.bisect_right(times, hi)
        buckets = []
        for edge, series in index:
            pts = self._data[series]
            if len(pts) == len(times):
                i, j = i_all, j_all
            else:
                i = bisect.bisect_left(pts, (lo,)) if lo > -math.inf else 0
                j = bisect.bisect_right(pts, (hi, math.inf))
            total = 0.0
            seg = pts[i:j]
            for (_, a), (_, b) in zip(seg, seg[1:]):
                if b > a:
                    total += b - a
            buckets.append((edge, total))
        buckets.sort()
        # per-series reset clamping can leave tiny non-monotonicities in
        # the cumulative counts; restore monotonicity with a running max
        cum, mono = 0.0, []
        for edge, c in buckets:
            cum = max(cum, c)
            mono.append((edge, cum))
        total = mono[-1][1]
        if total <= 0:
            return None
        rank = max(1, math.ceil(q * total - 1e-9))
        for edge, c in mono:
            if c >= rank:
                return edge
        return mono[-1][0]
