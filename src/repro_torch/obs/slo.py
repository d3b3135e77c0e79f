"""The fabric watchdog: SLO burn-rate alerts + a continuous invariant auditor.

The counterpart of ``repro/obs/slo.py``. The metrics registry, the spans
and the latency histograms make the fabric visible, but nothing watches
those signals: an operator staring at ``nk_top`` is the bottleneck. This
module closes that loop on top of ``obs/timeseries.py``'s ``SeriesStore``:

  * ``AlertRule`` subclasses evaluate the store and return the label-sets
    currently in violation. Three shapes:

      - ``BurnRateRule`` — Google-SRE multi-window burn-rate alerting: an
        ``SloSpec`` budget plus a FAST and a SLOW window that must *both*
        burn faster than ``burn_threshold`` before the rule fires (fast
        window = reacts quickly + resolves quickly; slow window = immune
        to one-scrape blips). The stock instance is **fairness burn**: no
        tenant may own more than ``objective`` of the fleet's contention
        budget, measured as its share of all deferred scheduler polls —
        the signal that separates a 10x hog from merely-busy tenants
        (per-tenant deferral *fractions* do not: on an oversubscribed
        fabric every well-behaved tenant defers constantly).
      - ``ThresholdRule`` — a computed value crosses a bound.
      - ``AbsenceRule`` — a heartbeat counter stalls while the fabric
        keeps scraping ("engine dark", "telemetry stalled"), gated so a
        deliberately-parked engine is not a dead one.

  * The **invariant auditor** rules re-check the fabric's own CI-gated
    claims continuously, from the scrape alone: aggregate served rate
    must respect the controller's capacity (``ConservationDriftRule``),
    windowed Jain fairness must hold on a healthy fabric
    (``JainFloorRule``), per-tenant admit-wait p99 must stay under SLO
    (``AdmitWaitSloRule``), and a parked engine must not sit on a deep
    backlog (``ParkedLeakRule``).

  * ``AlertEngine`` owns alert lifecycle: a violation fires once, stays
    active while it persists, and resolves when it clears — each
    transition emitted as a tracer instant (``alert.fire`` /
    ``alert.resolve`` with rule+severity+labels args) and counted as
    ``nk_alerts_total{rule,severity}`` / ``nk_alerts_active``.

  * ``FabricWatchdog`` is the cadence: scrape the registry, ingest,
    evaluate — one ``tick(now)``. With ``record=True`` it keeps every
    scrape's exposition text so the whole run can be replayed offline by
    ``tools/nk_watch.py`` (no handle on the live cluster, same contract
    as ``nk_top``).

All default thresholds were set empirically against the replay scenarios:
steady fires **zero** alerts, ``adversarial`` fires fairness burn on the
hog (and only the hog), ``failover`` fires and resolves engine-dark —
pinned as bench claim (k). Stdlib only.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import repro_torch.obs.tracing as tracing
from repro_torch.obs.metrics import Labels
from repro_torch.obs.timeseries import SeriesStore, series_key

SEVERITIES = ("info", "ticket", "page")


@dataclass(frozen=True)
class SloSpec:
    """A service-level objective: ``objective`` is the budget — the
    maximum acceptable bad-fraction (or bad-share) of the signal."""
    name: str
    objective: float
    description: str = ""

    def __post_init__(self):
        if not 0.0 < self.objective <= 1.0:
            raise ValueError("objective must be in (0, 1]")


@dataclass
class Alert:
    """One alert instance: a rule firing for one label-set."""
    rule: str
    severity: str
    labels: Labels
    fired_at: float
    value: float                       # the violating value at fire time
    resolved_at: Optional[float] = None

    @property
    def active(self) -> bool:
        return self.resolved_at is None

    def key(self) -> Tuple[str, Labels]:
        return self.rule, self.labels


class AlertRule:
    """One named check over the store. ``evaluate`` returns every
    label-set currently in violation, mapped to the violating value;
    the ``AlertEngine`` diffs consecutive evaluations into fire/resolve
    transitions."""

    def __init__(self, name: str, severity: str = "ticket"):
        if severity not in SEVERITIES:
            raise ValueError(f"severity must be one of {SEVERITIES}")
        self.name = name
        self.severity = severity

    def evaluate(self, store: SeriesStore,
                 now: float) -> Dict[Labels, float]:
        raise NotImplementedError


class BurnRateRule(AlertRule):
    """Multi-window burn-rate over a share-of-fleet SLO.

    For every value of ``key`` (e.g. each tenant) compute its share of
    the fleet-wide reset-aware increase of ``family`` over the fast and
    the slow window; burn = share / objective. Fire when **both** burns
    exceed ``burn_threshold`` — the SRE discipline that makes the fast
    window safe to page on. ``min_events`` is an absolute floor on the
    fleet's fast-window increase: a handful of deferred polls is noise,
    not a hog. Needs at least two distinct key values (a share of a
    one-tenant fleet is vacuously 1)."""

    def __init__(self, name: str, spec: SloSpec, family: str, *,
                 fast_window_s: float, slow_window_s: float,
                 key: str = "tenant", burn_threshold: float = 1.2,
                 min_events: float = 30.0, severity: str = "page"):
        super().__init__(name, severity)
        if slow_window_s < fast_window_s:
            raise ValueError("slow window must be >= fast window")
        self.spec = spec
        self.family = family
        self.key = key
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.burn_threshold = float(burn_threshold)
        self.min_events = float(min_events)

    def _shares(self, store: SeriesStore, now: float,
                window_s: float) -> Tuple[Dict[str, float], float]:
        per: Dict[str, float] = {}
        for s in store.series(self.family):
            lbl = dict(s[1])
            if self.key not in lbl:
                continue
            per[lbl[self.key]] = per.get(lbl[self.key], 0.0) \
                + store.increase(s, window_s, now)
        return per, sum(per.values())

    def burn_rates(self, store: SeriesStore,
                   now: float) -> Dict[str, Tuple[float, float]]:
        """Per-key (fast_burn, slow_burn) — what ``nk_watch`` renders."""
        fast, ftot = self._shares(store, now, self.fast_window_s)
        slow, stot = self._shares(store, now, self.slow_window_s)
        out: Dict[str, Tuple[float, float]] = {}
        for v in sorted(set(fast) | set(slow), key=lambda s: (len(s), s)):
            bf = (fast.get(v, 0.0) / ftot if ftot > 0 else 0.0) \
                / self.spec.objective
            bs = (slow.get(v, 0.0) / stot if stot > 0 else 0.0) \
                / self.spec.objective
            out[v] = (bf, bs)
        return out

    def evaluate(self, store: SeriesStore,
                 now: float) -> Dict[Labels, float]:
        fast, ftot = self._shares(store, now, self.fast_window_s)
        if len(fast) < 2 or ftot < self.min_events:
            return {}
        out: Dict[Labels, float] = {}
        for v, (bf, bs) in self.burn_rates(store, now).items():
            burn = min(bf, bs)
            if burn > self.burn_threshold:
                out[((self.key, v),)] = burn
        return out


class ThresholdRule(AlertRule):
    """The latest sample of one series crosses a bound. The generic
    building block for gauge checks ("engines failed > 0", "active
    alerts > N on a meta-registry")."""

    _OPS = {">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
            "<": lambda a, b: a < b, "<=": lambda a, b: a <= b}

    def __init__(self, name: str, series: Tuple[str, Labels], *,
                 bound: float, op: str = ">", severity: str = "ticket"):
        super().__init__(name, severity)
        if op not in self._OPS:
            raise ValueError(f"op must be one of {sorted(self._OPS)}")
        self.series = series
        self.bound = float(bound)
        self.op = op

    def evaluate(self, store: SeriesStore,
                 now: float) -> Dict[Labels, float]:
        v = store.latest(self.series)
        if v is None or not self._OPS[self.op](v, self.bound):
            return {}
        return {(): v}


class AbsenceRule(AlertRule):
    """A heartbeat counter stalled for a whole window while the fabric
    kept scraping. Fires per labeled series of ``family`` whose
    reset-aware increase over ``window_s`` is zero, provided the window
    holds at least ``min_scrapes`` scrapes (the reference clock did
    advance) and the series has ever been seen. ``gate_family`` (same
    ``key`` label) suppresses a series whose gate currently reads > 0 —
    a *parked* engine legitimately stops stepping; a dark one does not."""

    def __init__(self, name: str, family: str, *, window_s: float,
                 key: Optional[str] = None,
                 gate_family: Optional[str] = None,
                 min_scrapes: int = 3, severity: str = "page"):
        super().__init__(name, severity)
        self.family = family
        self.key = key
        self.window_s = float(window_s)
        self.gate_family = gate_family
        self.min_scrapes = int(min_scrapes)

    def evaluate(self, store: SeriesStore,
                 now: float) -> Dict[Labels, float]:
        in_window = [t for t in store.times()
                     if now - self.window_s <= t <= now]
        if len(in_window) < self.min_scrapes:
            return {}
        out: Dict[Labels, float] = {}
        for s in store.series(self.family):
            lbl = dict(s[1])
            if self.key is not None and self.key not in lbl:
                continue
            pts = store.window(s, self.window_s, now)
            if len(pts) < 2 or store.increase(s, self.window_s, now) > 0:
                continue
            if self.gate_family is not None and self.key is not None:
                gate = store.latest(
                    series_key(self.gate_family,
                               **{self.key: lbl[self.key]}))
                if gate is not None and gate > 0:
                    continue
            labels = ((self.key, lbl[self.key]),) if self.key else ()
            out[labels] = 0.0
        return out


# ---------------------------------------------------------------------------
# The invariant auditor: the fabric's CI-gated claims, re-checked live
# ---------------------------------------------------------------------------


def window_mature(store: SeriesStore, now: float, window_s: float,
                  frac: float = 0.75) -> bool:
    """True once the scrapes inside the window actually span (most of)
    it. Windowed invariants must not judge a half-populated window: the
    first scrape pair after startup sees the token buckets' initial
    burst allowance and reads as a conservation breach, and a two-sample
    Jain is noise — the SRE version of "don't page during deploy"."""
    ts = [t for t in store.times() if now - window_s <= t <= now]
    return len(ts) >= 2 and (ts[-1] - ts[0]) >= frac * window_s


class ConservationDriftRule(AlertRule):
    """Aggregate served rate must respect the controller's capacity.

    The replay's physical engine can run at ``headroom``x capacity — it
    is the token buckets that enforce the budget — so sustained
    aggregate throughput above ``capacity * (1 + tol)`` means rate
    enforcement itself broke. Windowed transients reach ~1.3x on the
    stock scenarios; the default ``tol=0.5`` fires only past the
    physical headroom."""

    def __init__(self, *, window_s: float, tol: float = 0.5,
                 family: str = "nk_served_tokens_total",
                 capacity_series: str = "controller_capacity",
                 severity: str = "page",
                 name: str = "conservation_drift"):
        super().__init__(name, severity)
        self.window_s = float(window_s)
        self.tol = float(tol)
        self.family = family
        self.capacity_series = capacity_series

    def evaluate(self, store: SeriesStore,
                 now: float) -> Dict[Labels, float]:
        if not window_mature(store, now, self.window_s):
            return {}
        cap = store.latest(series_key(self.capacity_series))
        if cap is None or cap <= 0:
            return {}
        total = sum(store.rate(s, self.window_s, now)
                    for s in store.series(self.family))
        if total <= cap * (1.0 + self.tol):
            return {}
        return {(): total / cap}


class JainFloorRule(AlertRule):
    """Windowed Jain fairness over per-tenant served rates must stay
    above ``floor`` — on a *healthy* fabric: any window that saw a
    failed engine is skipped (kill-and-restore legitimately starves the
    dark slot's tenants; that is engine-dark's alert, not this one)."""

    def __init__(self, *, window_s: float, floor: float = 0.5,
                 family: str = "nk_served_tokens_total",
                 gate_series: str = "nk_engines_failed",
                 severity: str = "ticket", name: str = "jain_floor"):
        super().__init__(name, severity)
        self.window_s = float(window_s)
        self.floor = float(floor)
        self.family = family
        self.gate_series = gate_series

    def evaluate(self, store: SeriesStore,
                 now: float) -> Dict[Labels, float]:
        if not window_mature(store, now, self.window_s):
            return {}
        gate = store.window(series_key(self.gate_series),
                            self.window_s, now)
        if any(v > 0 for _, v in gate):
            return {}
        rates = [store.rate(s, self.window_s, now)
                 for s in store.series(self.family)]
        rates = [r for r in rates if r > 0]
        n = len(rates)
        if n < 2:
            return {}
        jain = sum(rates) ** 2 / (n * sum(r * r for r in rates))
        return {} if jain >= self.floor else {(): jain}


class AdmitWaitSloRule(AlertRule):
    """Per-tenant windowed admit-wait p99 (via ``quantile_over_time``
    over the exported ``_bucket`` series) must stay under ``slo_s``."""

    def __init__(self, *, window_s: float, slo_s: float = 8.0,
                 family: str = "nk_admit_wait_seconds",
                 key: str = "tenant", severity: str = "ticket",
                 name: str = "admit_wait_p99"):
        super().__init__(name, severity)
        self.window_s = float(window_s)
        self.slo_s = float(slo_s)
        self.family = family
        self.key = key

    def evaluate(self, store: SeriesStore,
                 now: float) -> Dict[Labels, float]:
        out: Dict[Labels, float] = {}
        for v in store.label_values(self.family + "_bucket", self.key):
            p99 = store.quantile_over_time(
                self.family, 0.99, self.window_s, now, **{self.key: v})
            if p99 is not None and math.isfinite(p99) and p99 > self.slo_s:
                out[((self.key, v),)] = p99
        return out


class ParkedLeakRule(AlertRule):
    """An engine stayed parked for the whole window while the fleet's
    queued backlog never dropped below ``queue_floor`` — the autopilot
    is sitting on capacity the tenants need."""

    def __init__(self, *, window_s: float, queue_floor: float = 16.0,
                 parked_series: str = "nk_cluster_parked",
                 queue_family: str = "nk_queue_depth",
                 severity: str = "ticket",
                 name: str = "parked_engine_leak"):
        super().__init__(name, severity)
        self.window_s = float(window_s)
        self.queue_floor = float(queue_floor)
        self.parked_series = parked_series
        self.queue_family = queue_family

    def evaluate(self, store: SeriesStore,
                 now: float) -> Dict[Labels, float]:
        if not window_mature(store, now, self.window_s):
            return {}
        parked = store.window(series_key(self.parked_series),
                              self.window_s, now)
        if len(parked) < 2 or min(v for _, v in parked) < 1:
            return {}
        depth_at: Dict[float, float] = {}
        for s in store.series(self.queue_family):
            for t, v in store.window(s, self.window_s, now):
                depth_at[t] = depth_at.get(t, 0.0) + v
        if not depth_at:
            return {}
        backlog = min(depth_at.values())
        if backlog < self.queue_floor:
            return {}
        return {(): backlog}


# ---------------------------------------------------------------------------
# Lifecycle: fire / stay active / resolve
# ---------------------------------------------------------------------------


class AlertEngine:
    """Diffs rule evaluations into alert lifecycle transitions.

    A (rule, labels) violation fires once, stays active while every
    subsequent evaluation still reports it, and resolves the first time
    it clears. Transitions are traced (``alert.fire``/``alert.resolve``
    instants on the ``watchdog`` track, guarded by the tracer
    null-object) and exported via ``counters()``."""

    def __init__(self, rules: List[AlertRule], *,
                 track: str = "watchdog"):
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names in {names}")
        self.rules = list(rules)
        self.track = track
        self.active: Dict[Tuple[str, Labels], Alert] = {}
        self.history: List[Alert] = []
        self.fired: Dict[Tuple[str, str], int] = {}   # (rule, sev) -> n

    def evaluate(self, store: SeriesStore,
                 now: float) -> List[Tuple[str, Alert]]:
        """Run every rule; returns this tick's transitions as
        ``("fire"|"resolve", alert)`` pairs."""
        events: List[Tuple[str, Alert]] = []
        for rule in self.rules:
            viol = rule.evaluate(store, now)
            for labels, value in sorted(viol.items()):
                k = (rule.name, labels)
                if k in self.active:
                    self.active[k].value = value
                    continue
                a = Alert(rule.name, rule.severity, labels, now, value)
                self.active[k] = a
                self.history.append(a)
                self.fired[(rule.name, rule.severity)] = \
                    self.fired.get((rule.name, rule.severity), 0) + 1
                events.append(("fire", a))
                if tracing.TRACER.enabled:
                    tracing.TRACER.instant(
                        self.track, "alert.fire", now, rule=a.rule,
                        severity=a.severity, value=round(value, 4),
                        **dict(labels))
            stale = [k for k in self.active
                     if k[0] == rule.name and k[1] not in viol]
            for k in stale:
                a = self.active.pop(k)
                a.resolved_at = now
                events.append(("resolve", a))
                if tracing.TRACER.enabled:
                    tracing.TRACER.instant(
                        self.track, "alert.resolve", now, rule=a.rule,
                        severity=a.severity, **dict(a.labels))
        return events

    def counters(self) -> Dict[str, float]:
        out = {"nk_alerts_active": float(len(self.active))}
        for (rule, sev), n in sorted(self.fired.items()):
            out[f'nk_alerts_total{{rule="{rule}",severity="{sev}"}}'] = \
                float(n)
        return out


def default_rules(interval_s: float = 1.0, *,
                  objective: float = 0.5,
                  burn_threshold: float = 1.2,
                  min_events: float = 30.0,
                  admit_wait_slo_s: float = 8.0,
                  jain_floor: float = 0.5,
                  conservation_tol: float = 0.5,
                  queue_floor: float = 16.0) -> List[AlertRule]:
    """The stock rule catalog, windows sized in scrape intervals: fast =
    3 intervals, slow = 8. ``objective=0.5`` + ``burn_threshold=1.2``
    means fairness pages once a tenant owns > 60% of the fleet's
    deferred polls on both windows — empirically the steady scenario
    peaks at 0.38 per-tenant share while a 10x hog pins 1.0."""
    fast = 3.0 * interval_s
    slow = 8.0 * interval_s
    return [
        BurnRateRule(
            "fairness_burn",
            SloSpec("tenant_contention_share", objective,
                    "max share of fleet deferred polls one tenant may own"),
            "nk_deferred_polls_total",
            fast_window_s=fast, slow_window_s=slow,
            burn_threshold=burn_threshold, min_events=min_events,
            severity="page"),
        AbsenceRule("engine_dark", "nk_engine_heartbeat_total",
                    key="engine", gate_family="nk_engine_parked",
                    window_s=2.0 * interval_s, min_scrapes=3,
                    severity="page"),
        AbsenceRule("telemetry_stalled", "telemetry_updates_total",
                    key="plane", window_s=3.0 * interval_s,
                    min_scrapes=4, severity="page"),
        ConservationDriftRule(window_s=fast, tol=conservation_tol),
        JainFloorRule(window_s=slow, floor=jain_floor),
        AdmitWaitSloRule(window_s=slow, slo_s=admit_wait_slo_s),
        ParkedLeakRule(window_s=slow, queue_floor=queue_floor),
    ]


# ---------------------------------------------------------------------------
# The watchdog: scrape -> ingest -> evaluate, one cadence
# ---------------------------------------------------------------------------

SCRAPE_HEADER = "# SCRAPE ts="
SCRAPE_EOF = "# EOF"


class FabricWatchdog:
    """Owns the scrape cadence over one ``MetricsRegistry``.

    ``tick(now)`` scrapes the registry, ingests into the store, and runs
    the alert engine; with ``record=True`` every scrape's exposition
    text is kept (prefixed ``# SCRAPE ts=<now>``, terminated ``# EOF``)
    so ``write_scrapes`` can dump the run for offline replay by
    ``tools/nk_watch.py``. The watchdog is itself a metrics provider
    (``nk_watchdog_scrapes_total``, ``nk_watchdog_rules``, the alert
    counters) — register it on a *different* registry than the one it
    scrapes, or read ``counters()`` directly. ``interval_s``, where the
    caller knows it, is the scrape period the rule windows were sized to
    (what an offline replay of the recording sizes its windows to)."""

    def __init__(self, registry, rules: Optional[List[AlertRule]] = None,
                 *, store: Optional[SeriesStore] = None,
                 record: bool = False, track: str = "watchdog",
                 interval_s: Optional[float] = None):
        self.registry = registry
        self.interval_s = interval_s
        self.store = store if store is not None else SeriesStore()
        self.alerts = AlertEngine(
            default_rules() if rules is None else rules, track=track)
        self.recorded: Optional[List[Tuple[float, str]]] = \
            [] if record else None
        self.ticks = 0

    def tick(self, now: float) -> List[Tuple[str, Alert]]:
        """One watchdog cycle; returns the alert transitions it caused."""
        if self.recorded is not None:
            text = self.registry.export_prometheus()
            self.recorded.append((float(now), text))
            self.store.ingest(text, now)
        else:
            # skip the text round-trip on the hot path
            self.store.ingest(self.registry.collect(), now)
        self.ticks += 1
        return self.alerts.evaluate(self.store, now)

    def counters(self) -> Dict[str, float]:
        out = {"nk_watchdog_scrapes_total": float(self.ticks),
               "nk_watchdog_rules": float(len(self.alerts.rules))}
        out.update(self.alerts.counters())
        return out

    # -- offline artifact ---------------------------------------------------
    def scrape_sequence(self) -> str:
        """The recorded run as one text artifact: each scrape prefixed
        by its timestamp header and terminated by ``# EOF``."""
        if self.recorded is None:
            raise ValueError("watchdog was not constructed with record=True")
        chunks = []
        for ts, text in self.recorded:
            body = text if text.endswith("\n") else text + "\n"
            chunks.append(f"{SCRAPE_HEADER}{ts}\n{body}{SCRAPE_EOF}\n")
        return "".join(chunks)

    def write_scrapes(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.scrape_sequence())


def read_scrape_sequence(text: str) -> List[Tuple[float, str]]:
    """Parse a recorded scrape-sequence artifact back into
    ``[(ts, exposition_text), ...]`` — the inverse of
    ``FabricWatchdog.scrape_sequence``. Scrapes missing a timestamp
    header are stamped by position."""
    out: List[Tuple[float, str]] = []
    ts: Optional[float] = None
    lines: List[str] = []
    for line in text.splitlines():
        stripped = line.strip()
        if stripped.startswith(SCRAPE_HEADER):
            ts = float(stripped[len(SCRAPE_HEADER):])
            continue
        if stripped == SCRAPE_EOF:
            if lines:
                out.append((float(len(out)) if ts is None else ts,
                            "\n".join(lines) + "\n"))
            ts, lines = None, []
            continue
        lines.append(line)
    if any(l.strip() for l in lines):      # unterminated final scrape
        out.append((float(len(out)) if ts is None else ts,
                    "\n".join(lines) + "\n"))
    return out
