"""The port's fabric watchdog against the reference's, on the CPU.

* ``SeriesStore``: generated scrape sequences (monotone counters with
  resets, series that vanish and come back, gauges, a histogram family,
  each scrape given as exposition text, a flat ``counters()`` dict or a
  ``collect()`` dict) go into both packages' stores; every query
  (``latest``, ``window``, ``increase``, ``rate``, ``quantile_over_time``,
  the lookups) gives the same value, exactly: the same operations on the
  same floats.
* The alert rules: the same sequences through ``AlertEngine(default_rules(
  1.0))`` fire and resolve the same alerts, and each stock rule's
  ``evaluate`` (and ``BurnRateRule.burn_rates``) gives the same output at
  every scrape.
* The registry: render -> parse -> render gives the reference's text;
  ``collect`` refuses a duplicate series with the reference's message.
* Claim (k) (``benchmarks/bench_fairness.py::run_e2e_watchdog``) at the
  smoke config: the four watched scenarios fire the reference's alerts at
  the same virtual times, its gated values equal the reference's (the
  overhead is a timing: asserted < 0.02 on the port), the recorded
  failover scrapes equal the reference's but for one wall-clock meter
  (ROADMAP P13), and each package's recording replays through the other's
  alert engine to the same alerts.
"""
import importlib.util
import math
import pathlib
from types import SimpleNamespace

import pytest
import torch
from _hyp import given, settings, st

import repro.obs as j_obs
import repro_torch.obs as t_obs
from repro.serve.replay import make_watchdog as j_make_watchdog
from repro_torch.serve.replay import make_replay_engine, make_watchdog

# unlike the port's other test modules this one keeps torch's default
# intra-op threads (no ``_torch_threads.one_thread``): the watchdog
# phase's claim (k) holds the watchdog's ticks against the watch-free
# serving wall, and at one thread the smoke model's steps are so short
# that the rehearsal's share reaches the 2% limit (0.0201 against 0.0136
# at 8 threads, measured alone on the CPU)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
WALL_CLOCK = "nk_control_tick_seconds_total"


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _load("chip_smoke", "chip_smoke.py")

# ---------------------------------------------------------------------------
# generated scrape sequences over the families the stock rules read
# ---------------------------------------------------------------------------

EDGES = ("0.5", "2", "8", "+Inf")
HIST = "nk_admit_wait_seconds"


@st.composite
def scrape_runs(draw):
    """(retention, [(ts, scrape)]): counters that grow, stall, reset or
    vanish for a scrape; gauges; a cumulative per-tenant histogram that
    may reset or vanish for a scrape; each scrape as text, a flat dict or
    a ``Series`` dict."""
    n = draw(st.integers(min_value=2, max_value=14))
    tenants = draw(st.integers(min_value=1, max_value=3))
    engines = draw(st.integers(min_value=1, max_value=3))
    dark = draw(st.integers(min_value=0, max_value=n))   # heartbeat stalls
    counters = [f'nk_deferred_polls_total{{tenant="{t}"}}'
                for t in range(tenants)]
    counters += [f'nk_served_tokens_total{{tenant="{t}"}}'
                 for t in range(tenants)]
    counters += [f'nk_engine_heartbeat_total{{engine="{e}"}}'
                 for e in range(engines)]
    counters += ['telemetry_updates_total{plane="serve"}']
    value = {k: 0.0 for k in counters}
    hist = {t: [0] * len(EDGES) for t in range(tenants)}
    ts, out = 0.0, []
    for i in range(n):
        ts += draw(st.sampled_from([0.25, 0.5, 1.0, 1.25]))
        flat = {}
        for k in counters:
            op = draw(st.sampled_from(
                ["grow", "grow", "grow", "stall", "reset", "vanish"]))
            if "heartbeat" in k and 'engine="0"' in k and i >= dark:
                op = "stall"
            if op == "grow":
                value[k] += draw(st.integers(min_value=0, max_value=60))
            elif op == "reset":
                value[k] = float(draw(st.integers(min_value=0,
                                                  max_value=5)))
            if op != "vanish":
                flat[k] = value[k]
        for e in range(engines):
            flat[f'nk_engine_parked{{engine="{e}"}}'] = float(
                draw(st.integers(min_value=0, max_value=1)))
            flat[f'nk_queue_depth{{tenant="{e}"}}'] = float(
                draw(st.integers(min_value=0, max_value=30)))
        flat["controller_capacity"] = draw(st.sampled_from([0.0, 40.0,
                                                            100.0]))
        flat["nk_engines_failed"] = float(draw(st.integers(min_value=0,
                                                            max_value=1)))
        flat["nk_cluster_parked"] = float(draw(st.integers(min_value=0,
                                                            max_value=2)))
        for t, counts in hist.items():
            if draw(st.integers(min_value=0, max_value=9)) == 0:
                counts[:] = [0] * len(EDGES)
            for j in range(len(EDGES)):
                counts[j] += draw(st.integers(min_value=0, max_value=4))
            if draw(st.integers(min_value=0, max_value=7)) == 0:
                continue                  # the tenant's family vanishes
            cum = 0
            for edge, c in zip(EDGES, counts):
                cum += c
                flat[f'{HIST}_bucket{{tenant="{t}",le="{edge}"}}'] = \
                    float(cum)
            flat[f'{HIST}_count{{tenant="{t}"}}'] = float(cum)
        form = draw(st.sampled_from(["text", "flat", "series"]))
        if form == "text":
            scrape = j_obs.render_prometheus(flat)
        elif form == "series":
            scrape = {j_obs.parse_series_key(k): v for k, v in flat.items()}
        else:
            scrape = flat
        out.append((ts, scrape))
    return draw(st.sampled_from([2, 3, 5, 512])), out


WINDOWS = (None, 0.5, 1.0, 3.0, 8.0)


def _stores(retention, run):
    ref, port = j_obs.SeriesStore(retention), t_obs.SeriesStore(retention)
    for ts, scrape in run:
        ref.ingest(scrape, ts)
        port.ingest(scrape, ts)
        yield ts, ref, port


def _same(a, b):
    return a == b or (isinstance(a, float) and isinstance(b, float)
                      and math.isnan(a) and math.isnan(b))


@settings(max_examples=60, deadline=None)
@given(case=scrape_runs())
def test_series_store_equals_the_reference(case):
    retention, run = case
    for now, ref, port in _stores(retention, run):
        assert port.times() == ref.times()
        assert port.names() == ref.names()
        assert port.series() == ref.series()
        assert port.scrapes == ref.scrapes
        for name in ref.names():
            assert port.series(name) == ref.series(name)
            for label in ("tenant", "engine", "le"):
                assert port.label_values(name, label) == \
                    ref.label_values(name, label)
        for s in ref.series():
            assert port.latest(s) == ref.latest(s)
            for w in WINDOWS:
                for at in (None, now, now - 0.5):
                    assert port.window(s, w, at) == ref.window(s, w, at)
                    assert port.increase(s, w, at) == ref.increase(s, w, at)
                    assert port.rate(s, w, at) == ref.rate(s, w, at)
        for t in ref.label_values(HIST + "_bucket", "tenant") + ["9"]:
            for q in (0.0, 0.5, 0.99, 1.0):
                for w in WINDOWS:
                    assert port.quantile_over_time(HIST, q, w, now,
                                                   tenant=t) == \
                        ref.quantile_over_time(HIST, q, w, now, tenant=t)


def _rows(alerts):
    return [(a.rule, a.labels, a.severity, a.fired_at, a.value,
             a.resolved_at) for a in alerts]


@settings(max_examples=60, deadline=None)
@given(case=scrape_runs())
def test_alert_engine_fires_and_resolves_as_the_reference(case):
    retention, run = case
    ref = j_obs.AlertEngine(j_obs.default_rules(1.0))
    port = t_obs.AlertEngine(t_obs.default_rules(1.0))
    for now, jstore, tstore in _stores(retention, run):
        want = [(kind, a.rule, a.labels, a.severity, a.fired_at, a.value,
                 a.resolved_at) for kind, a in ref.evaluate(jstore, now)]
        got = [(kind, a.rule, a.labels, a.severity, a.fired_at, a.value,
                a.resolved_at) for kind, a in port.evaluate(tstore, now)]
        assert got == want
    assert _rows(port.history) == _rows(ref.history)
    assert sorted(port.active) == sorted(ref.active)
    assert port.counters() == ref.counters()


@settings(max_examples=60, deadline=None)
@given(case=scrape_runs())
def test_every_stock_rule_evaluates_as_the_reference(case):
    retention, run = case
    extra = {}
    for P in (j_obs, t_obs):
        extra[P] = [
            P.ThresholdRule("capacity_low", ("controller_capacity", ()),
                            bound=50.0, op="<"),
            P.ThresholdRule("failed", ("nk_engines_failed", ()), bound=0.0),
            P.AbsenceRule("dark_any", "nk_engine_heartbeat_total",
                          window_s=1.0, min_scrapes=2)]
    ref_rules = j_obs.default_rules(1.0) + extra[j_obs]
    port_rules = t_obs.default_rules(1.0) + extra[t_obs]
    for now, jstore, tstore in _stores(retention, run):
        for jr, tr in zip(ref_rules, port_rules):
            assert tr.evaluate(tstore, now) == jr.evaluate(jstore, now), \
                jr.name
            if isinstance(jr, j_obs.BurnRateRule):
                assert tr.burn_rates(tstore, now) == \
                    jr.burn_rates(jstore, now)
        for w in (1.0, 3.0):
            assert t_obs.window_mature(tstore, now, w) == \
                j_obs.window_mature(jstore, now, w)


def test_rule_catalog_refusals_alike():
    for P in (j_obs, t_obs):
        with pytest.raises(ValueError, match="objective"):
            P.SloSpec("x", 0.0)
        with pytest.raises(ValueError, match="severity"):
            P.ThresholdRule("x", ("a", ()), bound=1.0, severity="loud")
        with pytest.raises(ValueError, match="duplicate rule names"):
            P.AlertEngine([P.ThresholdRule("x", ("a", ()), bound=1.0)] * 2)
        with pytest.raises(ValueError, match="retention"):
            P.SeriesStore(1)


# ---------------------------------------------------------------------------
# the registry and the exposition round trip
# ---------------------------------------------------------------------------

FLAT = {
    "nk_served_tokens_total": 12.0,
    'nk_served_tokens_total{tenant="0"}': 7.0,
    'nk_queue_depth{tenant="a\\"b\\\\c\\nd"}': 3.0,
    "controller_capacity": math.inf,
    "nk_control_tenants": -math.inf,
    "nk_cluster_parked": math.nan,
    'nk_admit_wait_seconds_bucket{tenant="1",le="0.5"}': 2.0,
    'nk_admit_wait_seconds_bucket{tenant="1",le="+Inf"}': 3.0,
    'nk_admit_wait_seconds_sum{tenant="1"}': 1.25,
    'nk_admit_wait_seconds_count{tenant="1"}': 3.0,
}


def test_exposition_round_trip_gives_the_references_text():
    text = t_obs.render_prometheus(FLAT)
    assert text == j_obs.render_prometheus(FLAT)
    wrapped = text.replace("\n", "\r\n") + "\n# EOF\n\n"
    parsed = t_obs.parse_prometheus_text(wrapped)
    ref = j_obs.parse_prometheus_text(wrapped)
    assert parsed.keys() == ref.keys()
    assert all(_same(parsed[k], ref[k]) for k in ref)
    again = {t_obs.render_series(*k): v for k, v in parsed.items()}
    assert t_obs.render_prometheus(again) == text
    for bad in ("nk_x{tenant=1} 2", "nk_x 1\nnk_x 2",
                "# TYPE nk_x bogus\nnk_x 1"):
        for P in (j_obs, t_obs):
            with pytest.raises(ValueError):
                P.parse_prometheus_text(bad)


def _registry(P):
    reg = P.MetricsRegistry()
    reg.counter("nk_jobs_total", "Jobs").inc(2, tenant=1)
    reg.gauge("nk_depth", "Depth").set(4, engine="0")
    h = reg.histogram("nk_wait_seconds", "Wait", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v, tenant="0")
    reg.register_provider(lambda: {'nk_beats_total{engine="0"}': 3},
                          name="beats")
    return reg


@pytest.mark.parametrize("dup", [
    {'nk_beats_total{engine="0"}': 1},                  # another provider's
    {'nk_jobs_total{tenant="1"}': 1},                   # an instrument's
    {"nk_once_total": 1, " nk_once_total": 2},          # its own
])
def test_registry_exports_and_refuses_as_the_reference(dup):
    ref, port = _registry(j_obs), _registry(t_obs)
    for _ in range(2):                          # parsed keys come back
        assert port.collect() == ref.collect()
    assert port.export_prometheus() == ref.export_prometheus()
    msgs = {}
    for name, reg in (("ref", ref), ("port", port)):
        reg.register_provider(lambda: dict(dup), name="again")
        with pytest.raises(ValueError, match="duplicate series") as info:
            reg.collect()
        msgs[name] = str(info.value)
    assert msgs["port"] == msgs["ref"]
    for P in (j_obs, t_obs):
        reg = P.MetricsRegistry()
        c = reg.counter("nk_a_total")
        with pytest.raises(ValueError, match="only go up"):
            c.inc(-1)
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("nk_a_total")
        with pytest.raises(ValueError, match="illegal metric name"):
            reg.gauge("1bad")
        with pytest.raises(TypeError):
            reg.register_provider(object())


# ---------------------------------------------------------------------------
# claim (k) at the smoke config: both packages' watched scenarios
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def claim():
    """The reference's claim (k) run (``run_e2e_watchdog``: 3 engines, 12
    intervals, its reports kept) and the port's same runs through
    ``chip_smoke.py``'s helpers, with a watch-free steady base."""
    bench = _load("bench_fairness", "benchmarks/bench_fairness.py")
    ref = bench.run_e2e_watchdog(engines=3, intervals=cs.WATCH_INTERVALS)
    port = {name: cs.watch_run(torch, CPU, name, watch)[0]
            for name, watch in cs.WATCH_RUNS}
    # the watch-free wall, then at once the tick: one host speed for both
    base, wall, *_ = cs.watch_run(torch, CPU, "steady", None)
    claims = cs.watchdog_claims(port, wall,
                                cs.watchdog_tick_s(port["steady"].watchdog))
    return SimpleNamespace(
        ref_rows={k.split(",", 1)[1]: v for k, v in ref["rows"]},
        ref=dict(bench._WATCHDOG_REPORTS), port=port,
        base=base, claims=claims)


@pytest.mark.parametrize("name", [n for n, _ in cs.WATCH_RUNS])
def test_watched_scenario_fires_the_references_alerts(claim, name):
    ref, port = claim.ref[name], claim.port[name]
    assert cs.alert_rows(port.alerts) == cs.alert_rows(ref.alerts)
    assert (port.alerts_fired, port.alerts_resolved, port.alerts_active) \
        == (ref.alerts_fired, ref.alerts_resolved, ref.alerts_active)
    assert port.alerts_by_rule() == ref.alerts_by_rule()
    assert cs.ledgers(port) == cs.ledgers(ref)


WALL_CLOCK_ROWS = ("watchdog_tick_us", "step_overhead_frac")


def test_claim_k_values_equal_the_reference(claim, request):
    """The claim's values from the virtual clock equal the reference's and
    pass their limits in both packages. The two wall-clock rows are each
    package's own host time: the port's overhead is held under 0.02; the
    reference's is not asserted here (its watch-free wall shrinks once an
    earlier test in the process has compiled its engine)."""
    for key, value in claim.ref_rows.items():
        if key not in WALL_CLOCK_ROWS:
            assert claim.claims[key] == value, key
    limits = cs.watchdog_limits()
    assert set(limits) == set(claim.ref_rows) - {"adversarial_alerts",
                                                 "watchdog_tick_us"}
    for key, lim in limits.items():
        lo, hi = lim.get("min", -math.inf), lim.get("max", math.inf)
        assert lo <= claim.claims[key] <= hi, key
        if key not in WALL_CLOCK_ROWS:
            assert lo <= claim.ref_rows[key] <= hi, key
    # the host's readings, kept in a --junitxml report's properties
    request.node.user_properties.extend(
        (key, claim.claims[key]) for key in WALL_CLOCK_ROWS)
    assert claim.claims["step_overhead_frac"] < 0.02


def test_watched_run_changes_no_ledger(claim):
    assert cs.ledgers(claim.port["steady"]) == cs.ledgers(claim.base)
    assert claim.base.alerts is None and claim.base.watchdog is None


def _wall_clock_free(text):
    return "\n".join(ln for ln in text.splitlines() if WALL_CLOCK not in ln)


def test_recorded_scrapes_equal_the_references_but_a_wall_clock_meter(
        claim):
    """ROADMAP P13: the failover recordings are the reference's byte for
    byte once the controller's wall-clock meter
    ``nk_control_tick_seconds_total`` (seconds the host spent in control
    ticks) is taken out; that one series differs in every scrape, and no
    rule reads it."""
    ref = claim.ref["failover"].watchdog.scrape_sequence()
    port = claim.port["failover"].watchdog.scrape_sequence()
    assert _wall_clock_free(port) == _wall_clock_free(ref)
    ref_seq = j_obs.read_scrape_sequence(ref)
    port_seq = t_obs.read_scrape_sequence(port)
    assert [ts for ts, _ in port_seq] == [ts for ts, _ in ref_seq]
    assert len(port_seq) == cs.WATCH_INTERVALS + 1
    differs = set()
    for (_, a), (_, b) in zip(port_seq, ref_seq):
        pa, pb = t_obs.parse_prometheus_text(a), \
            j_obs.parse_prometheus_text(b)
        assert pa.keys() == pb.keys()
        differs |= {k[0] for k in pb if not _same(pa[k], pb[k])}
    assert differs <= {WALL_CLOCK}
    read = {rule.family for rule in t_obs.default_rules(1.0)
            if hasattr(rule, "family")}
    assert WALL_CLOCK not in read


def test_recordings_replay_through_either_packages_alert_engine(claim):
    nk_watch = _load("nk_watch", "tools/nk_watch.py")
    # both runs scrape at the same virtual times (the P13 test above), so
    # the port's scrape period sizes both replays' windows
    interval = claim.port["failover"].watchdog.interval_s
    assert interval > 1.0
    for mine, other in (("port", "ref"), ("ref", "port")):
        rep = getattr(claim, mine)["failover"]
        text = rep.watchdog.scrape_sequence()
        # the other package reads and replays this package's recording
        if other == "ref":
            _, engine, _ = nk_watch.replay_alerts(
                j_obs.read_scrape_sequence(text), interval_s=interval)
            offline = engine.history
        else:
            offline = cs.offline_alerts(text, interval)
        assert cs.alert_rows(offline) == cs.alert_rows(rep.alerts), mine
    assert any(a.rule == "engine_dark" and a.resolved_at is not None
               for a in claim.port["failover"].alerts)


def test_make_watchdog_refuses_an_engine_without_a_controller():
    eng = make_replay_engine(capacity=10.0, device="cpu")
    eng.controller = None
    msgs = {}
    for name, fn, target in (("port", make_watchdog, eng),
                             ("ref", j_make_watchdog,
                              SimpleNamespace(controller=None))):
        with pytest.raises(ValueError, match="no controller") as info:
            fn(target)
        msgs[name] = str(info.value)
    assert msgs["port"] == msgs["ref"]


def test_watchdog_phase_rehearses_on_the_cpu(monkeypatch, tmp_path, capsys,
                                            request):
    """``chip_smoke.py``'s watchdog phase at the smoke config on the CPU,
    with the plain attention versions counted as the kernels are on the
    card: every threshold, launch count, CPU re-run, the offline replay and
    the failover trace hold."""
    import json

    import repro_torch.kernels.decode_attention as dec
    import repro_torch.kernels.flash_attention as fl
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.params import init_params

    for mod, wrapper, plain in ((fl, fl.flash_attention,
                                 "flash_attention_plain"),
                                (dec, dec.decode_attention,
                                 "decode_attention_plain")):
        def counted(*a, _f=getattr(mod, plain), _w=wrapper, **kw):
            _w.launches += 1
            return _f(*a, **kw)
        monkeypatch.setattr(mod, plain, counted)
    cfg = get_smoke_config("llama3.2-3b")
    params = init_params(cfg, device="cpu", generator=torch.Generator(
        ).manual_seed(4))
    total = cs.phase_watchdog(torch, CPU, cfg, params, trace_dir=tmp_path)
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["run"] for r in rows] == \
        [n for n, _ in cs.WATCH_RUNS] + ["steady_unwatched", "claim_k"]
    summary = rows[-1]
    request.node.user_properties.extend(
        (key, summary[key]) for key in WALL_CLOCK_ROWS)
    assert summary["ok"] and not summary["cpu_mismatch"]
    assert total == summary["launches"]
    assert total["flash_attention"] > 0 and total["decode_attention"] > 0
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["failover.json", "failover_scrapes.txt"]
