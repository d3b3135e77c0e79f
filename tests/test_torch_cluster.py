"""The port's engine cluster against the reference's, on the CPU.

* One protocol script (``tests/_torch_fabric.py``: submits, steps, a
  migration mid-burst, park/unpark, a serve and a bytes swap, checkpoint,
  fail, recover and restore) on both packages' clusters of model-free
  doubles with ``CoreEngine``s on the bytes plane: equal placement,
  records, merged ledgers, counters, Prometheus text and
  ``FabricSnapshot.to_bytes()``, byte for byte. The one difference is a
  wall-clock meter, ``nk_control_tick_seconds_total``.
* Each refusal raises in both packages alike, and so does ROADMAP R6,
  the reference's conservation fault in ``fail_engine`` that the port
  shares.
* The five cluster scenarios at smoke size through ``replay_scenario``
  (the real ``ServeEngine``s, sharing one model): equal ledgers, records
  and park meters on the object backend, rates within 1e-12 relative;
  one vectorized run within the reference's 2%; traces that pass
  ``tools/check_trace.py``.
"""
import importlib.util
import json
import pathlib

import jax
import pytest
import torch
from _torch_fabric import PKGS, fake_cluster, req, scripted_run

import repro.control.vectorized as j_vec
from repro.serve.replay import replay_scenario as j_replay
from repro_torch.fabric import FABRIC_SNAPSHOT_VERSION, FabricSnapshot
from repro_torch.serve.replay import (
    make_replay_cluster, replay_scenario, scenario_spec,
)
from _torch_threads import one_thread  # noqa: F401

_CHECK = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
    "check_trace.py"
_spec = importlib.util.spec_from_file_location("check_trace", _CHECK)
check_trace = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(check_trace)

WALL_CLOCK = "nk_control_tick_seconds_total"
# intervals per scenario at smoke size: migration needs 10 for its
# maintenance window
INTERVALS = {"migration": 10, "failover": 8, "stack_swap": 6,
             "consolidation": 12, "hotspot": 12}


def _strip_wall_clock(obs):
    out = dict(obs)
    out["counters"] = {k: v for k, v in obs["counters"].items()
                       if k != WALL_CLOCK}
    out["prometheus"] = "\n".join(
        ln for ln in obs["prometheus"].splitlines() if WALL_CLOCK not in ln)
    return out


@pytest.mark.parametrize("seed", range(3))
def test_scripted_protocol_equals_the_reference(seed):
    _rc, ref_snaps, ref_obs = scripted_run(PKGS["ref"], seed)
    cl, snaps, obs = scripted_run(PKGS["port"], seed)
    assert snaps == ref_snaps                   # byte for byte
    assert list(obs) == list(ref_obs)
    for phase in ref_obs:
        assert _strip_wall_clock(obs[phase]) == \
            _strip_wall_clock(ref_obs[phase]), phase
    # the script did what it says: every lifecycle move happened
    final = obs["restored"]
    assert len(final["migrations"]) >= 2
    assert [s["plane"] for s in final["swaps"]] == ["serve", "bytes"]
    assert final["swaps"][0]["new_stack"].endswith("[rr]")
    assert final["swaps"][1]["new_stack"].endswith("[compressed]")
    assert obs["parked"]["parked"] == [2]
    assert obs["failed"]["failed"] and not final["failed"]
    assert final["counters"]["nk_recoveries_total"] == 1.0
    for t in cl.placement:
        cl.assert_ledger_conservation(t)
        assert cl.tenant_served_tokens(t) == cl.tenant_billed_ground_truth(t)


def _scalars_only(x):
    if isinstance(x, dict):
        return all(isinstance(k, str) and _scalars_only(v)
                   for k, v in x.items())
    if isinstance(x, list):
        return all(_scalars_only(v) for v in x)
    return x is None or type(x) in (int, float, str, bool)


def test_snapshot_round_trip_is_byte_stable_and_plain_json():
    cl, snaps, _obs = scripted_run(PKGS["port"], 0)
    for data in snaps:
        snap = FabricSnapshot.from_bytes(data)
        assert snap.to_bytes() == data
        assert FabricSnapshot.from_bytes(snap.to_bytes()) == snap
        assert _scalars_only(json.loads(data.decode("utf-8")))
    # a snapshot of the live fabric encodes nothing but Python scalars
    snap = cl.checkpoint(now=100.0)
    assert _scalars_only(json.loads(snap.to_bytes().decode("utf-8")))
    assert snap.version == FABRIC_SNAPSHOT_VERSION


# ---------------------------------------------------------------------------
# refusals: each raises, in both packages alike
# ---------------------------------------------------------------------------


def _drain(P):
    cl = fake_cluster(P, 2)
    cl.add_tenant(0, engine=0)
    cl.submit(req(P, 0, tokens=6))
    cl.step(now=0.0)
    cl.migrate(0, 1, now=0.1)
    assert cl.draining == {0: 0}
    return cl


def _mid_drain_checkpoint(P):
    _drain(P).checkpoint(now=0.2)


def _swap_draining_source(P):
    cl = _drain(P)
    cl.swap_module(0, "serve", P.Fake, now=0.2)


def _fail_last_live_engine(P):
    cl = fake_cluster(P, 2)
    cl.add_tenant(0, engine=0)
    cl.fail_engine(1, now=0.0)
    cl.fail_engine(0, now=0.0)


def _unknown_version_bytes(P):
    cl = fake_cluster(P, 2)
    cl.add_tenant(0, engine=0)
    doc = json.loads(cl.checkpoint(now=0.0).to_bytes().decode("utf-8"))
    doc["version"] = FABRIC_SNAPSHOT_VERSION + 1
    P.FabricSnapshot.from_bytes(json.dumps(doc).encode("utf-8"))


def _unknown_version_recover(P):
    cl = fake_cluster(P, 2)
    cl.add_tenant(0, engine=0)
    snap = cl.checkpoint(now=0.0)
    snap.version = FABRIC_SNAPSHOT_VERSION + 1
    cl.fail_engine(0, now=1.0)
    cl.recover_engine(0, snap, now=1.0)


def _unknown_version_restore(P):
    cl = fake_cluster(P, 2)
    snap = cl.checkpoint(now=0.0)
    snap.version = FABRIC_SNAPSHOT_VERSION + 1
    cl.restore(snap)


def _recovered(P):
    cl = fake_cluster(P, 2)
    cl.add_tenant(0, engine=0)
    cl.submit(req(P, 0, tokens=3))
    for i in range(8):
        cl.step(now=float(i))
    snap = cl.checkpoint(now=8.0)
    cl.fail_engine(0, now=8.0)
    cl.recover_engine(0, snap, now=8.0)
    return cl, snap


def _double_restore_tenant(P):
    cl, snap = _recovered(P)
    state = next(p for p in snap.planes if p.name == "serve") \
        .modules[0].tenants[0]
    cl.engines[0].restore_tenant(0, state, now=9.0)


def _double_recover(P):
    cl, snap = _recovered(P)
    cl.recover_engine(0, snap, now=9.0)


REFUSALS = {
    "mid_drain_checkpoint": (_mid_drain_checkpoint, RuntimeError),
    "swap_draining_source": (_swap_draining_source, RuntimeError),
    "fail_last_live_engine": (_fail_last_live_engine, ValueError),
    "unknown_version_bytes": (_unknown_version_bytes, ValueError),
    "unknown_version_recover": (_unknown_version_recover, ValueError),
    "unknown_version_restore": (_unknown_version_restore, ValueError),
    "double_restore_tenant": (_double_restore_tenant, ValueError),
    "double_recover": (_double_recover, ValueError),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_raise_as_the_reference_does(case):
    fn, exc = REFUSALS[case]
    msgs = {}
    for p, P in PKGS.items():
        with pytest.raises(exc) as info:
            fn(P)
        msgs[p] = str(info.value)
    assert msgs["port"] == msgs["ref"]


# ---------------------------------------------------------------------------
# ROADMAP R6: fail_engine breaks conservation, in both packages alike
# ---------------------------------------------------------------------------


def _crash_after_swap_in_place(P):
    cl = fake_cluster(P, 2)
    cl.add_tenant(0, engine=0)
    cl.add_tenant(1, engine=1)
    cl.submit(req(P, 0, 1, tokens=3))
    cl.submit(req(P, 1, 2, tokens=3))
    for i in range(5):
        cl.step(now=float(i))
    cl.swap_module(0, "serve", P.Fake, now=5.0)
    cl.submit(req(P, 0, 3, tokens=3))
    for i in range(5):
        cl.step(now=6.0 + i)
    cl.fail_engine(0, now=12.0)


def _crash_after_migrating_back(P):
    cl = fake_cluster(P, 2)
    cl.add_tenant(0, engine=0)
    cl.add_tenant(1, engine=1)
    cl.submit(req(P, 0, 1, tokens=3))
    for i in range(5):
        cl.step(now=float(i))
    cl.migrate(0, 1, now=5.0)
    for i in range(3):
        cl.step(now=6.0 + i)
    cl.migrate(0, 0, now=9.0)
    for i in range(3):
        cl.step(now=10.0 + i)
    assert cl.placement[0] == 0 and not cl.draining
    cl.fail_engine(0, now=14.0)


R6_VICTIMS = {"swapped_in_place": _crash_after_swap_in_place,
              "migrated_back": _crash_after_migrating_back}


@pytest.mark.parametrize("case", sorted(R6_VICTIMS))
def test_r6_crash_of_a_tenant_with_history_raises_alike(case):
    """ROADMAP R6, a known fault of the reference that the port shares:
    crashing the engine of a tenant whose carried ledger holds history
    billed on that same engine (swapped in place there, or migrated away
    and back) loses that history's ground truth, and ``fail_engine``'s
    own conservation assert raises. The scripted protocol run avoids such
    a victim (``_torch_fabric.crash_safe``); this test keeps the fault in
    view. When R6 is repaired this test fails: turn it into a check that
    both packages conserve the victim's ledger."""
    fn = R6_VICTIMS[case]
    msgs = {}
    for p, P in PKGS.items():
        with pytest.raises(AssertionError, match="broke conservation") \
                as info:
            fn(P)
        msgs[p] = str(info.value)
    assert msgs["port"] == msgs["ref"]


def test_attach_watchdog_ticks_alike_and_health_reports_liveness():
    """Each package's stock watchdog attached to its cluster of doubles
    (``attach_watchdog``, every second cluster step) through a crash and a
    recovery under traffic: the same ticks at the same virtual times, and
    engine-dark fired and resolved alike; ``health`` reports liveness."""
    seen = {}
    for p, P in PKGS.items():
        ctrl = P.RateController(160.0, alpha=0.6)
        cl = fake_cluster(P, 2, controller=ctrl, control_every=2)
        wd = P.make_watchdog(cl, interval_s=0.5)
        assert cl.attach_watchdog(wd, scrape_every=2) is wd
        for t in range(2):
            cl.add_tenant(t, engine=t)
        ids, vt = iter(range(1, 1000)), 0.0

        def run(steps):
            nonlocal vt
            for _ in range(steps):
                for t in range(2):
                    cl.submit(req(P, t, next(ids), now=vt))
                cl.step(now=vt)
                vt += 0.25
        run(4)
        snap = cl.checkpoint(now=vt)
        cl.fail_engine(1, now=vt)
        run(12)
        h = cl.health()
        assert h['nk_engine_up{engine="1"}'] == 0.0
        assert h['nk_engine_heartbeat_total{engine="0"}'] == 16.0
        assert h['nk_engine_heartbeat_total{engine="1"}'] == 4.0
        cl.recover_engine(1, snap, now=vt)
        run(8)
        seen[p] = (wd.ticks, wd.store.times(),
                   [(a.rule, a.labels, a.severity, a.fired_at,
                     a.resolved_at) for a in wd.alerts.history])
    assert seen["port"] == seen["ref"]
    ticks, times, alerts = seen["port"]
    assert ticks == 12 and times[0] == 0.25
    assert ("engine_dark", (("engine", "1"),)) in \
        [(a[0], a[1]) for a in alerts if a[4] is not None]


# ---------------------------------------------------------------------------
# the five scenarios at smoke size, on the real engines
# ---------------------------------------------------------------------------

TENANT_FIELDS = ("served_tokens", "admitted_requests", "completed_requests",
                 "deferred_polls")
REPORT_FIELDS = ("decode_steps", "engines", "migrations", "swaps",
                 "checkpoints", "recoveries", "max_parked", "cores_saved",
                 "max_parked_bytes", "mem_saved_bytes",
                 "peak_resident_cache_bytes", "autopilot_moves",
                 "placement", "set_rate_calls", "push_skipped",
                 "duration_s")


@pytest.mark.parametrize("name", sorted(INTERVALS))
def test_cluster_scenarios_equal_the_reference(name):
    iv = INTERVALS[name]
    ref = j_replay(name, n_tenants=4, intervals=iv)
    port = replay_scenario(name, n_tenants=4, intervals=iv, device="cpu")
    for f in REPORT_FIELDS:
        assert getattr(port, f) == getattr(ref, f), f
    assert set(port.per_tenant) == set(ref.per_tenant) == set(range(4))
    for t, want in ref.per_tenant.items():
        got = port.per_tenant[t]
        for f in TENANT_FIELDS:
            assert getattr(got, f) == getattr(want, f), (t, f)
        assert got.achieved_rate == pytest.approx(want.achieved_rate,
                                                  rel=1e-12)
    assert port.jain() == pytest.approx(ref.jain(), rel=1e-12)
    assert port.engines == 3 and port.jain() >= 0.95


def test_vectorized_cluster_scenario_within_two_percent(monkeypatch):
    """The failover drill with the array control plane in both packages
    (the reference's under the R1 workaround): per-tenant rates within
    2% of each other, every scenario claim intact."""
    monkeypatch.setattr(j_vec, "_x64", lambda: jax.enable_x64(True))
    ref = j_replay("failover", n_tenants=4, intervals=8,
                   backend="vectorized")
    port = replay_scenario("failover", n_tenants=4, intervals=8,
                           backend="vectorized", device="cpu")
    assert port.checkpoints >= 1 and port.recoveries == 1
    assert port.jain() >= 0.95
    for t in range(4):
        a = ref.per_tenant[t].achieved_rate
        b = port.per_tenant[t].achieved_rate
        assert b == pytest.approx(a, rel=0.02), f"tenant {t}: {a} vs {b}"


@pytest.mark.parametrize("name", ["migration", "stack_swap", "failover"])
def test_cluster_scenario_traces_pass_check_trace(name, tmp_path):
    path = tmp_path / f"{name}.json"
    rep = replay_scenario(name, n_tenants=4, intervals=INTERVALS[name],
                          device="cpu", trace_path=path)
    doc = json.loads(path.read_text())
    assert check_trace.check_trace(doc, scenario=name) == []
    assert rep.engines == 3


def test_cluster_engines_share_one_model_and_park_frees_the_cache():
    trace, cap = scenario_spec("steady", n_tenants=2, intervals=2)
    cl = make_replay_cluster(capacity=cap, engines=3, device="cpu")
    m = cl.engines[0].params
    assert all(e.params is m for e in cl.engines)
    cache = cl.engines[2]._cache_bytes()
    assert cache > 0 and cl.resident_bytes() == 3 * cache
    cl.park(2)
    assert cl.engines[2].caches is None
    assert cl.parked_bytes() == cache
    assert cl.resident_bytes() == 2 * cache
    cl.unpark(2)
    assert cl.engines[2].caches is None          # lazy: no admission yet
    cl.add_tenant(0, engine=2)
    cl.submit(req(PKGS["port"], 0, tokens=3))
    cl.step(now=0.0)
    assert isinstance(cl.engines[2].caches[0]["k"], torch.Tensor)
    assert cl.engines[2]._cache_bytes() == cache
    for i in range(1, 4):
        cl.step(now=float(i))
    (done,) = cl.completed
    # request tokens are Python ints: a snapshot's canonical JSON takes them
    assert all(type(t) is int for t in done.generated)
    assert len(done.generated) == 3


def test_cluster_phase_rehearses_on_the_cpu(monkeypatch, tmp_path, capsys):
    """``chip_smoke.py``'s cluster phase at the smoke config on the CPU,
    with the plain attention and water-fill versions counted as the
    kernels are on the card: every scenario's claims, launches, traces and
    the CPU re-run's ledgers hold (the card's memory checks are not run
    here)."""
    import repro_torch.kernels.decode_attention as dec
    import repro_torch.kernels.flash_attention as fl
    import repro_torch.kernels.waterfill as wf
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.params import init_params

    for mod, wrapper, plain in ((fl, fl.flash_attention,
                                 "flash_attention_plain"),
                                (dec, dec.decode_attention,
                                 "decode_attention_plain"),
                                (wf, wf.water_fill, "water_fill_plain")):
        def counted(*a, _f=getattr(mod, plain), _w=wrapper, **kw):
            _w.launches += 1
            return _f(*a, **kw)
        monkeypatch.setattr(mod, plain, counted)
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg = get_smoke_config("llama3.2-3b")
    params = init_params(cfg, device="cpu", generator=torch.Generator(
        ).manual_seed(4))
    total = cs.phase_cluster(torch, torch.device("cpu"), cfg, params,
                             trace_dir=tmp_path)
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["run"] for r in rows] == [n for n, _ in cs.CLUSTER_RUNS]
    assert all(r["ok"] and not r["cpu_mismatch"] for r in rows)
    assert total["flash_attention"] > 0 and total["decode_attention"] > 0
    assert 0 < total["water_fill"] == sum(
        r["launches"]["water_fill"] for r in rows)
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        sorted(f"{n}.json" for n in cs.CLUSTER_TRACED)

