"""The port's replay harness against the reference's, on the CPU.

The replayer runs on a virtual clock and reads only ledgers, so on the
object backend the same scenario must give the same counters on both
packages: per-tenant served tokens, admitted and completed requests,
deferred polls and decode steps equal, rates within 1e-12 relative (the
same sums over the same virtual durations). The port's vectorized backend
runs the water-fill as a bisection and must land within the reference's
2% of the object backend's per-tenant rates
(``tests/test_replay.py::test_replay_vectorized_backend_matches_object_end_to_end``).
"""
import numpy as np
import pytest

from repro.serve import multiplex as j_mx
from repro.serve.replay import adversarial_baseline as j_baseline
from repro.serve.replay import replay_scenario as j_replay
from repro.serve.replay import scenario_spec as j_spec
from repro_torch.serve import multiplex as t_mx
from repro_torch.serve.replay import (
    CLUSTER_SCENARIOS, SCENARIOS, adversarial_baseline, make_replay_cluster,
    make_replay_engine, make_watchdog, replay_scenario, scenario_spec,
)

from _torch_threads import one_thread  # noqa: F401

LEDGER = ("served_tokens", "admitted_requests", "completed_requests",
          "deferred_polls")


def test_replay_steady_ledgers_equal_the_reference():
    ref = j_replay("steady", n_tenants=2, intervals=6, backend="object")
    port = replay_scenario("steady", n_tenants=2, intervals=6,
                           backend="object", device="cpu")
    assert port.decode_steps == ref.decode_steps > 0
    assert port.duration_s == ref.duration_s
    assert port.set_rate_calls == ref.set_rate_calls
    assert set(port.per_tenant) == set(ref.per_tenant) == {0, 1}
    for t, want in ref.per_tenant.items():
        got = port.per_tenant[t]
        for field in LEDGER:
            assert getattr(got, field) == getattr(want, field), (t, field)
        assert got.achieved_rate == pytest.approx(want.achieved_rate,
                                                  rel=1e-12)
        assert got.mean_admit_wait_s == pytest.approx(
            want.mean_admit_wait_s, rel=1e-12)
    assert port.jain() == pytest.approx(ref.jain(), rel=1e-12)
    assert port.max_min_deviation() == pytest.approx(
        ref.max_min_deviation(), rel=1e-12, abs=1e-15)


def test_replay_vectorized_backend_matches_object():
    obj = replay_scenario("steady", n_tenants=4, intervals=10,
                          backend="object", device="cpu")
    vec = replay_scenario("steady", n_tenants=4, intervals=10,
                          backend="vectorized", device="cpu")
    assert vec.jain() >= 0.95
    assert vec.max_min_deviation() < 0.10
    for t in range(4):
        a = obj.per_tenant[t].achieved_rate
        b = vec.per_tenant[t].achieved_rate
        assert b == pytest.approx(a, rel=0.02), f"tenant {t}: {a} vs {b}"


@pytest.mark.parametrize("name", ["steady", "adversarial", "correlated",
                                  "ramp", "bursty", "migration",
                                  "consolidation", "hotspot", "stack_swap",
                                  "failover"])
def test_scenario_specs_and_traces_equal_the_reference(name):
    t_trace, t_cap = scenario_spec(name, n_tenants=4, intervals=12, seed=1)
    j_trace, j_cap = j_spec(name, n_tenants=4, intervals=12, seed=1)
    assert t_cap == j_cap
    np.testing.assert_array_equal(t_trace.loads, j_trace.loads)
    if name == "adversarial":
        np.testing.assert_array_equal(adversarial_baseline(t_trace).loads,
                                      j_baseline(j_trace).loads)


def test_multiplex_accounting_and_fair_replay_equal_the_reference():
    assert t_mx.paper_table2_analog() == j_mx.paper_table2_analog()
    trace = t_mx.bursty_trace(6, intervals=30, seed=2)
    np.testing.assert_array_equal(
        trace.loads, j_mx.bursty_trace(6, intervals=30, seed=2).loads)
    weights = {0: 2.0, 3: 0.5}
    port = t_mx.fair_replay(trace, 60.0, weights, rate_caps={1: 5.0})
    ref = j_mx.fair_replay(j_mx.Trace(loads=trace.loads.copy()), 60.0,
                           weights, rate_caps={1: 5.0})
    assert port.keys() == ref.keys()
    for k in port:
        np.testing.assert_array_equal(port[k], ref[k])
    for xs in ([2.0, 2.0, 2.0], [], [0.0, 0.0], [float("nan"), 3.0],
               [1.0, 4.0, 9.0]):
        assert t_mx.jain_index(xs) == j_mx.jain_index(xs)


def test_watchdog_entry_points_work_and_every_cluster_scenario_runs():
    """``watch=``, ``make_watchdog`` and ``EngineCluster.attach_watchdog``
    each give a working fabric watchdog (it scrapes, ingests and
    evaluates); every cluster scenario and option runs (a short window of
    each)."""
    from repro_torch.obs import FabricWatchdog
    assert set(SCENARIOS) - set(CLUSTER_SCENARIOS) == {
        "steady", "adversarial", "correlated", "ramp", "bursty"}
    rep = replay_scenario("steady", n_tenants=2, intervals=3, device="cpu",
                          watch=True)
    assert isinstance(rep.watchdog, FabricWatchdog)
    assert rep.watchdog.ticks == 4 and rep.alerts_fired == 0
    eng = make_replay_engine(capacity=10.0, device="cpu")
    wd = make_watchdog(eng)
    assert wd.tick(0.0) == [] and wd.ticks == 1
    assert "controller_capacity" in wd.store.names()
    cluster = make_replay_cluster(capacity=10.0, engines=2, device="cpu")
    wd = make_watchdog(cluster, record=True)
    assert cluster.attach_watchdog(wd, scrape_every=2) is wd
    for k in range(4):
        cluster.step(now=0.5 * k)
    assert wd.ticks == 2 and wd.store.times() == (0.5, 1.5)
    assert "nk_engine_heartbeat_total" in wd.store.names()
    assert len(wd.recorded) == 2
    for name in CLUSTER_SCENARIOS:
        rep = replay_scenario(name, n_tenants=4, intervals=4, device="cpu")
        assert rep.engines == 3 and rep.decode_steps > 0, name
        with pytest.raises(ValueError, match="needs a cluster"):
            replay_scenario(name, intervals=4, engines=1, device="cpu")
    rep = replay_scenario("steady", n_tenants=2, intervals=2, engines=2,
                          core_plane=True, autopilot="consolidate",
                          device="cpu")
    assert rep.engines == 2 and rep.decode_steps > 0


def test_replay_writes_a_trace(tmp_path):
    path = tmp_path / "steady.json"
    rep = replay_scenario("steady", n_tenants=2, intervals=2,
                          device="cpu", trace_path=path)
    assert rep.decode_steps > 0
    text = path.read_text()
    assert '"traceEvents"' in text and "request.admit" in text
