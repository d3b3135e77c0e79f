"""The port's fairness harness (``control/sim.py``) and bytes-plane
telemetry against the reference's, on the CPU.

``benchmarks/bench_fairness.py``'s three virtual-time scenarios run on both
packages with the reference's parameters. On the object backend the port
must reproduce the reference exactly (the same float operations in the same
order); on ``backend="vectorized"`` (the water-fill kernel's plain version,
``device="cpu"``) it must agree with the object backend within 1e-6 x
capacity (ROADMAP P4). Claims (a) convergence within 10% of weighted
max-min, (b) isolation under 5% degradation and (c) work conservation must
hold on the port.
"""
import importlib.util
import pathlib

import numpy as np
import pytest

import repro.control as jctl
import repro.control.vectorized as jvec
import repro.core.engine as jeng
import repro_torch.control as tctl
import repro_torch.core.engine as teng

from _torch_threads import one_thread  # noqa: F401


def _chip_smoke():
    """``chip_smoke.py``'s fairness phase code: the scenarios run here on
    both packages are the ones the card runs."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
SCENARIOS = CS.FAIRNESS
CAPACITY = CS.FAIR_CAPACITY


def _series(res):
    return (res.times, res.served_cum, res.offered_cum,
            [dict(a) for a in res.allocations])


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_sim_equals_reference_on_the_object_backend(name):
    """Every run of the scenario: identical times, cumulative served and
    offered bytes and controller allocations, and identical claim
    metrics."""
    jruns, jm = SCENARIOS[name](jctl)
    truns, tm = SCENARIOS[name](tctl)
    assert [_series(r) for r in truns] == [_series(r) for r in jruns]
    assert tm == jm
    assert CS.fairness_claim(name, tm), (name, tm)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_vectorized_sim_agrees_with_object_and_holds_the_claims(
        name, monkeypatch):
    """``backend="vectorized"`` (telemetry banks, the water-fill's plain
    bisection on the CPU) against the port's object backend and against
    the reference's own vectorized plane (R1 routed around, as in
    ``tests/test_torch_control.py``): allocations within 1e-6 x capacity
    at every tick; the claims hold."""
    import jax
    monkeypatch.setattr(jvec, "_x64", lambda: jax.enable_x64(True))
    oruns, _ = SCENARIOS[name](tctl)
    vruns, vm = SCENARIOS[name](tctl, backend="vectorized", device="cpu")
    assert CS.allocation_gap(oruns, vruns) <= 1e-6
    assert CS.fairness_claim(name, vm), (name, vm)
    jruns = _reference_vectorized(name)
    assert CS.allocation_gap(jruns, vruns) <= 1e-6


def _reference_vectorized(name):
    """The reference's sim has no ``backend``; its vectorized water-fill
    is swapped in as the ``algo`` (the same object the port builds)."""
    class _Ctl:
        SimTenant = jctl.SimTenant

        @staticmethod
        def SharedBottleneckSim(tenants, capacity, **kw):
            algo = jctl.WaterFill({t.tenant_id: t.weight for t in tenants},
                                  min_rate=capacity * 1e-3,
                                  backend="vectorized")
            return jctl.SharedBottleneckSim(tenants, capacity, algo=algo,
                                            **kw)
    return SCENARIOS[name](_Ctl)[0]


def test_sim_vectorized_without_a_device_refuses_when_no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tctl.SharedBottleneckSim([tctl.SimTenant(1, 1.0)], 10.0,
                                 backend="vectorized")


@pytest.mark.parametrize("backend", ["object", "vectorized"])
@pytest.mark.parametrize("axes_filter", [None, ("pod",)])
def test_engine_telemetry_equals_reference(backend, axes_filter):
    """Both packages' ``EngineTelemetry`` over one engine each, fed the
    same ops (on ``pod`` and ``data``, with deferral, a migration-style reset
    and an evicted tenant): equal observations at every sample and equal
    Prometheus counters."""
    rng = np.random.default_rng(3)
    plan = [(int(rng.integers(0, 5)), ("pod",) if rng.random() < 0.6
             else ("data",), int(rng.integers(1, 5000)))
            for _ in range(400)]
    out = []
    for eng_mod, ctl, payload in ((jeng, jctl, _JP), (teng, tctl, _TP)):
        eng = eng_mod.CoreEngine(enforcement="account")
        for t in range(5):
            eng.set_tenant_rate(t, 2e4 * (t + 1))
        tel = ctl.EngineTelemetry(eng, alpha=0.5, axes_filter=axes_filter,
                                  backend=backend)
        obs = []
        for i, (t, axes, n) in enumerate(plan):
            now = 0.01 * (i + 1)
            eng.dispatch("shm_move", payload(n), axes, tenant_id=t, now=now)
            if i % 25 == 24:
                obs.append({k: (o.rate, o.offered, o.deferred, o.queue)
                            for k, o in sorted(tel.update(now).items())})
            if i == 200:
                eng.export_tenant(2, now)
            if i == 300:
                tel.evict_tenant(4)
        out.append((obs, tel.counters(), sorted(tel.tracked_tenants())))
    assert out[1] == out[0]


def _JP(n):
    from repro.control.sim import _Payload
    return _Payload(n)


def _TP(n):
    from repro_torch.control.sim import _Payload
    return _Payload(n)
