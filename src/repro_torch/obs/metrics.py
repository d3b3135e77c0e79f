"""MetricsRegistry: one scrape surface for every ``counters()`` provider.

The counterpart of ``repro/obs/metrics.py``. Every exporter
(``EngineTelemetry``, ``SchedulerTelemetry``, ``RateController``,
``PlacementController``, ``EngineCluster``) goes through one export path:

  * ``MetricsRegistry`` — labeled counters / gauges / histograms plus thin
    adapters over the existing ``counters()`` dicts (keys are already
    ``name{label="v"}`` series strings; the registry parses them back into
    (name, labels) pairs). ``collect()`` REFUSES duplicate series: two
    providers emitting the same name+labels is the bug the
    ``telemetry_updates_total`` plane label fixed, not something to merge
    silently.
  * ``render_prometheus`` — the one spec-compliant text formatter: grouped
    families with ``# HELP``/``# TYPE``, label values escaped per the
    exposition-format rules (``\\``, ``"``, newline), ``+Inf``/``-Inf``/
    ``NaN`` rendered as the spec spells them.
  * ``parse_prometheus_text`` — the inverse, used by ``tools/nk_top.py``
    (render a fabric snapshot from a scrape alone) and
    ``tools/check_metrics.py`` (the CI grammar gate).
  * ``METRIC_HELP`` — the metric-name catalog (also the source of the table
    in ``docs/observability.md``).

Stdlib only.
"""
from __future__ import annotations

import functools
import math
import re
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple

Labels = Tuple[Tuple[str, str], ...]
Series = Tuple[str, Labels]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


# ---------------------------------------------------------------------------
# The metric-name catalog (HELP text + type overrides)
# ---------------------------------------------------------------------------

# family name -> one-line HELP. docs/observability.md renders this table;
# render_prometheus emits these lines. Families not listed get a generic
# HELP so the export stays spec-parseable either way.
METRIC_HELP: Dict[str, str] = {
    "telemetry_updates_total":
        "Telemetry sampling intervals completed, labeled by plane",
    "controller_ticks_total": "RateController control intervals completed",
    "controller_capacity": "Enforced bottleneck capacity (units/s)",
    "controller_push_calls_total": "set_rate/update_tenant_rate calls issued",
    "controller_push_skipped_total": "Delta-mode pushes skipped (unchanged)",
    "nk_control_ticks_total": "Controller tick() calls (incl. baselining)",
    "nk_control_tick_seconds_total":
        "Wall seconds spent inside controller ticks",
    "nk_control_tenants": "Tenant population covered by the last tick",
    "nk_allocated_rate": "Per-tenant allocated rate (units/s)",
    "nk_offered_bytes_total": "Collective bytes offered per tenant and axes",
    "nk_deferred_bytes_total": "Over-rate collective bytes deferred",
    "nk_served_bytes_per_s": "EWMA served collective bytes/s per tenant",
    "nk_served_tokens_total": "Tokens billed to a tenant (prompt + decode)",
    "nk_served_tokens_per_s": "EWMA served tokens/s per tenant",
    "nk_queue_depth": "Unadmitted queued requests per tenant",
    "nk_admitted_requests_total": "Requests admitted per tenant",
    "nk_deferred_polls_total": "Bucket-blocked admission polls per tenant",
    "nk_mean_admit_wait_s": "Mean arrival->admission wait per tenant (s)",
    "nk_cluster_engines": "Engines in the cluster",
    "nk_cluster_steps_total": "Cluster steps taken",
    "nk_migrations_started_total": "Live tenant migrations started",
    "nk_migrations_completed_total": "Live tenant migrations finalized",
    "nk_migrations_draining": "Migrations currently draining on a source",
    "nk_migration_info": "Recent migration records (value = started step)",
    "nk_swaps_total": "Live stack-module hot-swaps, labeled by plane",
    "nk_swap_info": "Recent hot-swap records (value = cluster step)",
    "nk_checkpoints_total": "Fabric checkpoints taken",
    "nk_recoveries_total": "Engine kill-and-restore recoveries completed",
    "nk_engines_failed": "Engines currently failed (dark, awaiting recover)",
    "nk_cluster_parked": "Engines currently parked",
    "nk_parked_engine_steps_total": "Engine-steps skipped while parked",
    "nk_cores_saved": "Average engines parked per cluster step",
    "nk_parked_bytes": "Bytes currently freed by suspended engines",
    "nk_bytes_freed_total": "Cumulative bytes freed by suspend()",
    "nk_mem_saved_bytes": "Average bytes freed per cluster step",
    "nk_resident_cache_bytes": "Droppable buffer bytes currently resident",
    "nk_peak_resident_cache_bytes": "Peak resident droppable buffer bytes",
    "nk_placement": "Tenant -> engine index placement map",
    "nk_engine_load": "Per-engine queued + in-flight requests",
    "nk_engine_parked": "1 if the engine is parked",
    "nk_engine_decode_steps_total": "Decode steps taken per engine",
    "nk_placement_ticks_total": "Placement autopilot ticks",
    "nk_placement_plans_applied_total": "Non-empty placement plans applied",
    "nk_placement_moves_total": "Autopilot migrations applied",
    "nk_placement_moves_skipped_cooldown_total":
        "Moves skipped by the per-tenant cooldown gate",
    "nk_placement_moves_skipped_drain_total":
        "Moves skipped by the drain-cost gate",
    "nk_placement_parks_total": "Engines parked by the autopilot",
    "nk_placement_unparks_total": "Engines unparked by the autopilot",
    "nk_admit_wait_seconds": "Arrival->admission wait per tenant (s)",
    "nk_ttft_seconds": "Arrival->first-token latency per tenant (s)",
    "nk_e2e_seconds": "Arrival->completion latency per tenant (s)",
    "nk_trace_events_total": "Trace events recorded by the active tracer",
    "nk_engine_up": "1 while the engine slot is serving, 0 while failed",
    "nk_engine_heartbeat_total": "Cluster steps the engine actually ran",
    "nk_watchdog_scrapes_total": "Scrapes the watchdog ingested",
    "nk_watchdog_rules": "Alert rules the watchdog evaluates",
    "nk_alerts_total": "Alerts fired, labeled by rule and severity",
    "nk_alerts_active": "Alert instances currently firing",
}

# families whose type can't be inferred from the name alone
_TYPE_OVERRIDES: Dict[str, str] = {}


def metric_family(name: str) -> str:
    """The family a sample name belongs to (histogram samples share one)."""
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix):
            return name[: -len(suffix)]
    return name


def metric_type(name: str, families: Optional[Iterable[str]] = None) -> str:
    """Infer the exposition type for one sample name: ``*_total`` is a
    counter, ``*_bucket``/``*_sum``/``*_count`` belong to a histogram
    family (when the family is known to ``families``), everything else a
    gauge."""
    fam = metric_family(name)
    if name in _TYPE_OVERRIDES:
        return _TYPE_OVERRIDES[name]
    if fam != name and (families is None or fam in families):
        return "histogram"
    if name.endswith("_total"):
        return "counter"
    return "gauge"


# ---------------------------------------------------------------------------
# Escaping / formatting / parsing (the exposition text format)
# ---------------------------------------------------------------------------


def escape_label_value(value: str) -> str:
    """Escape a label value per the text format: backslash, double-quote
    and newline."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def unescape_label_value(value: str) -> str:
    out, i = [], 0
    while i < len(value):
        c = value[i]
        if c == "\\" and i + 1 < len(value):
            nxt = value[i + 1]
            out.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt, nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def format_value(value: float) -> str:
    """Render a sample value: ``+Inf``/``-Inf``/``NaN`` per the text-format
    rules, plain ``%.10g`` otherwise (round-trips every counter we emit)."""
    v = float(value)
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return format(v, ".10g")


def parse_value(text: str) -> float:
    t = text.strip()
    if t == "+Inf":
        return math.inf
    if t == "-Inf":
        return -math.inf
    if t == "NaN":
        return math.nan
    return float(t)


@functools.lru_cache(maxsize=8192)
def parse_series_key(key: str) -> Series:
    """Parse one ``counters()``-dict key — ``name`` or
    ``name{k="v",k2="v2"}`` — into ``(name, ((k, v), ...))``. Raises
    ``ValueError`` on anything that wouldn't re-render legally.

    Memoized: the watchdog re-parses the same few hundred series
    strings every scrape, and the result is an immutable tuple."""
    key = key.strip()
    if "{" not in key:
        name, body = key, None
    else:
        if not key.endswith("}"):
            raise ValueError(f"malformed series {key!r}")
        name, body = key.split("{", 1)
        body = body[:-1]
    if not _NAME_RE.match(name):
        raise ValueError(f"illegal metric name {name!r}")
    labels: List[Tuple[str, str]] = []
    if body:
        for lname, lval in _iter_labels(body, context=key):
            labels.append((lname, lval))
    return name, tuple(labels)


def _iter_labels(body: str, *, context: str):
    """Yield (name, unescaped value) pairs from a label body, honoring
    escapes inside quoted values."""
    i, n = 0, len(body)
    while i < n:
        eq = body.find("=", i)
        if eq < 0:
            raise ValueError(f"malformed labels in {context!r}")
        lname = body[i:eq].strip().lstrip(",").strip()
        if not _LABEL_NAME_RE.match(lname):
            raise ValueError(f"illegal label name {lname!r} in {context!r}")
        if eq + 1 >= n or body[eq + 1] != '"':
            raise ValueError(f"unquoted label value in {context!r}")
        j, raw = eq + 2, []
        while j < n:
            c = body[j]
            if c == "\\" and j + 1 < n:
                raw.append(body[j:j + 2])
                j += 2
                continue
            if c == '"':
                break
            raw.append(c)
            j += 1
        else:
            raise ValueError(f"unterminated label value in {context!r}")
        yield lname, unescape_label_value("".join(raw))
        i = j + 1
        if i < n and body[i] == ",":
            i += 1


def render_series(name: str, labels: Labels) -> str:
    if not labels:
        return name
    body = ",".join(f'{k}="{escape_label_value(v)}"' for k, v in labels)
    return f"{name}{{{body}}}"


def render_prometheus(counters: Mapping[str, float],
                      help_text: Optional[Mapping[str, str]] = None) -> str:
    """Spec-compliant text rendering of a flat ``counters()`` dict.

    Samples are grouped into families (histogram ``_bucket``/``_sum``/
    ``_count`` triples fold into one), each family prefixed by ``# HELP``
    and ``# TYPE``, label values escaped, ``+Inf``/``NaN`` rendered per
    the exposition format. Input order within a family is preserved.
    """
    parsed: List[Tuple[Series, float]] = [
        (parse_series_key(k), v) for k, v in counters.items()]
    # histogram families exist where a *_bucket sample carries an `le`
    hist_fams = {
        metric_family(name) for (name, labels), _ in parsed
        if name.endswith("_bucket") and any(k == "le" for k, _ in labels)}
    helps = dict(METRIC_HELP)
    helps.update(help_text or {})
    families: List[str] = []
    grouped: Dict[str, List[Tuple[Series, float]]] = {}
    for (name, labels), v in parsed:
        fam = metric_family(name)
        fam = fam if fam in hist_fams else name
        if fam not in grouped:
            grouped[fam] = []
            families.append(fam)
        grouped[fam].append(((name, labels), v))
    out: List[str] = []
    for fam in families:
        ftype = ("histogram" if fam in hist_fams
                 else metric_type(fam))
        out.append(f"# HELP {fam} "
                   f"{helps.get(fam, 'netkernel-repro metric')}")
        out.append(f"# TYPE {fam} {ftype}")
        for (name, labels), v in grouped[fam]:
            out.append(f"{render_series(name, labels)} {format_value(v)}")
    return "\n".join(out) + "\n" if out else ""


def parse_prometheus_text(text: str) -> Dict[Series, float]:
    """Parse exposition text back into ``{(name, labels): value}`` —
    the scrape-side inverse ``tools/nk_top.py`` renders from and
    ``tools/check_metrics.py`` validates with. Raises ``ValueError`` on
    any line the grammar rejects, including duplicate series.

    Tolerated (OpenMetrics-style output, re-wrapped scrapes): blank
    lines, trailing whitespace (including CRLF line endings), and
    ``# EOF`` / other non-HELP/TYPE comment lines — so a recorded
    watchdog scrape round-trips through render->parse->render."""
    out: Dict[Series, float] = {}
    typed: Dict[str, str] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.rstrip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] == "TYPE":
                if len(parts) < 4 or parts[3] not in (
                        "counter", "gauge", "histogram", "summary",
                        "untyped"):
                    raise ValueError(f"line {lineno}: malformed TYPE")
                if parts[2] in typed:
                    raise ValueError(
                        f"line {lineno}: duplicate TYPE for {parts[2]}")
                typed[parts[2]] = parts[3]
            elif len(parts) >= 3 and parts[1] == "HELP":
                pass
            continue
        # sample line: series value [timestamp]
        m = re.match(r"^(\S+?)(\{.*\})?\s+(\S+)(\s+-?\d+)?\s*$", line)
        if not m:
            raise ValueError(f"line {lineno}: malformed sample {line!r}")
        name, body, valtext = m.group(1), m.group(2) or "", m.group(3)
        try:
            series = parse_series_key(name + body)
            value = parse_value(valtext)
        except ValueError as e:
            raise ValueError(f"line {lineno}: {e}") from None
        fam = metric_family(series[0])
        if fam in typed and typed[fam] == "histogram":
            pass      # bucket/sum/count share the family's TYPE
        elif series[0] in typed or fam in typed:
            pass
        if series in out:
            raise ValueError(
                f"line {lineno}: duplicate series "
                f"{render_series(*series)}")
        out[series] = value
    return out


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------


class _Instrument:
    """One directly-owned metric family with labeled children."""

    def __init__(self, registry: "MetricsRegistry", name: str, kind: str,
                 help_text: str):
        self.registry = registry
        self.name = name
        self.kind = kind
        self.help = help_text
        self.values: Dict[Labels, float] = {}

    def _labels(self, labels: Mapping[str, object]) -> Labels:
        return tuple(sorted((k, str(v)) for k, v in labels.items()))

    def collect(self) -> Dict[Series, float]:
        return {(self.name, lb): v for lb, v in self.values.items()}


class Counter(_Instrument):
    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        lb = self._labels(labels)
        self.values[lb] = self.values.get(lb, 0.0) + amount


class Gauge(_Instrument):
    def set(self, value: float, **labels) -> None:
        self.values[self._labels(labels)] = float(value)


class HistogramVec(_Instrument):
    """Labeled histogram family backed by ``obs/hist.py``'s
    ``Histogram``."""

    def __init__(self, registry, name, help_text, buckets=None):
        super().__init__(registry, name, "histogram", help_text)
        from repro_torch.obs.hist import DEFAULT_BUCKETS, Histogram
        self._hist_cls = Histogram
        self.buckets = tuple(buckets if buckets is not None
                             else DEFAULT_BUCKETS)
        self.children: Dict[Labels, object] = {}

    def observe(self, value: float, **labels) -> None:
        lb = self._labels(labels)
        h = self.children.get(lb)
        if h is None:
            h = self.children[lb] = self._hist_cls(self.buckets)
        h.observe(value)

    def collect(self) -> Dict[Series, float]:
        out: Dict[Series, float] = {}
        for lb, h in self.children.items():
            for k, v in h.counters(self.name).items():
                name, extra = parse_series_key(k)
                out[(name, tuple(sorted(lb + extra)))] = v
        return out


def _raise_duplicate(before: List[Series], series: List[Series],
                     starts: List[Tuple[int, str]], pname: str) -> None:
    """Name the first of a provider's ``series`` that an earlier source
    (``before``, in scrape order) or the provider itself emitted."""
    seen = {s: k for k, s in enumerate(before)}
    for s in series:
        if s in seen:
            at = seen[s]
            first = [tag for i, tag in starts if i <= at][-1]
            raise ValueError(
                f"duplicate series {render_series(*s)}: emitted by "
                f"{first} and provider {pname} — label one of the "
                f"sources")
        seen[s] = len(before)
    raise AssertionError("no duplicate series found")


class MetricsRegistry:
    """Labeled instruments + ``counters()``-provider adapters, one scrape.

    ``register_provider`` adapts any object with a ``counters() ->
    Dict[str, float]`` method (or a bare callable returning such a dict):
    its series are parsed and merged at collect time, so live state is
    always scraped fresh. Duplicate series across providers/instruments
    raise — the regression the ``telemetry_updates_total`` plane label
    exists to prevent.
    """

    def __init__(self):
        self._instruments: Dict[str, _Instrument] = {}
        self._providers: List[Tuple[str, Callable[[], Mapping[str, float]]]]\
            = []
        # provider index -> (its last key tuple, those keys parsed)
        self._parsed: Dict[int, Tuple[Tuple[str, ...], List[Series]]] = {}
        self._help: Dict[str, str] = {}

    # -- direct instruments -------------------------------------------------
    def _add(self, inst: _Instrument) -> _Instrument:
        if inst.name in self._instruments:
            raise ValueError(f"metric {inst.name!r} already registered")
        if not _NAME_RE.match(inst.name):
            raise ValueError(f"illegal metric name {inst.name!r}")
        self._instruments[inst.name] = inst
        if inst.help:
            self._help[inst.name] = inst.help
        return inst

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._add(Counter(self, name, "counter", help_text))

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._add(Gauge(self, name, "gauge", help_text))

    def histogram(self, name: str, help_text: str = "",
                  buckets=None) -> HistogramVec:
        return self._add(HistogramVec(self, name, help_text, buckets))

    # -- provider adapters --------------------------------------------------
    def register_provider(self, provider, name: Optional[str] = None):
        """Adapt an existing exporter: anything with ``counters()`` or a
        zero-arg callable returning a flat series dict. Returns self for
        chaining."""
        fn = provider.counters if hasattr(provider, "counters") else provider
        if not callable(fn):
            raise TypeError(f"provider {provider!r} has no counters() and "
                            f"is not callable")
        self._providers.append(
            (name or type(provider).__name__, fn))
        return self

    # -- scrape -------------------------------------------------------------
    def collect(self) -> Dict[Series, float]:
        """Merged series from every instrument and provider. Raises on a
        duplicate series (same name AND labels from two sources)."""
        out: Dict[Series, float] = {}
        # (first index in ``out``, source): names a duplicate's first
        # source without a per-series record on the hot path
        starts: List[Tuple[int, str]] = []
        for inst in self._instruments.values():
            starts.append((len(out), f"instrument {inst.name}"))
            out.update(inst.collect())
        for i, (pname, fn) in enumerate(self._providers):
            starts.append((len(out), f"provider {pname}"))
            got = fn()
            keys = tuple(got)
            parsed = self._parsed.get(i)
            if parsed is None or parsed[0] != keys:
                # a provider emits the same keys scrape after scrape:
                # parse them when they change, not every scrape
                parsed = self._parsed[i] = (
                    keys, [parse_series_key(k) for k in keys])
            n = len(out)
            out.update(zip(parsed[1], map(float, got.values())))
            if len(out) != n + len(keys):
                _raise_duplicate(list(out)[:n], parsed[1], starts, pname)
        return out

    def export_prometheus(self) -> str:
        flat = {render_series(name, labels): v
                for (name, labels), v in self.collect().items()}
        return render_prometheus(flat, self._help)
