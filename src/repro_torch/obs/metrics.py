"""Prometheus exposition for every ``counters()`` provider.

  * ``render_prometheus`` — the one spec-compliant text formatter: grouped
    families with ``# HELP``/``# TYPE``, label values escaped per the
    exposition-format rules (``\\``, ``"``, newline), ``+Inf``/``-Inf``/
    ``NaN`` rendered as the spec spells them.
  * ``METRIC_HELP`` — the metric-name catalog.

Stdlib only. The port carries the formatter and what it needs; the
metrics registry and the scrape-side parser come with a later slice.
"""
from __future__ import annotations

import functools
import math
import re
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

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
