"""The port's vectorized control plane and water-fill against the reference.

Every reference call runs in float64 under ``jax.enable_x64(True)``. The
reference's ``control/vectorized.py::_x64`` imports
``jax.experimental.enable_x64``, which the installed jax no longer has
(ROADMAP R1); the tests that drive the reference's own plane or facade
replace it for the test's duration with ``monkeypatch`` — nothing in the
reference package changes.

Tolerances, each with its reason:

* the water-fill's plain version and the Pallas kernel (interpret mode)
  run the same 48-step bisection in float64 and differ only in the order
  of each step's sum: 1e-9 x capacity;
* the bisection against the exact sort-based fill and the scalar
  ``max_min_fair``: 1e-6 x capacity (the reference's own bound);
* the fused tick against the reference's: all ten outputs within 1e-9
  relative, NaN positions equal (elementwise float64 is identical, the
  water-fill differs as above);
* token buckets, tenant indexes and telemetry banks carry the reference's
  host arithmetic over unchanged: equal means equal.
"""
import math

import jax
import numpy as np
import pytest
import torch

import repro.control.vectorized as j_vec
from repro.control.congestion import max_min_fair as j_max_min_fair
from repro.kernels import ops as j_ops
from repro_torch.control import congestion as t_cong
from repro_torch.control.controller import RateController
from repro_torch.control.telemetry import SchedulerTelemetry, TenantObs
from repro_torch.control.vectorized import (
    BucketStore, TelemetryBank, TenantIndex, VectorizedControlPlane,
    check_backend, fused_tick, waterfill_allocate,
)
from repro_torch.core.engine import TokenBucket
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels.waterfill import water_fill, water_fill_plain
from repro_torch.serve.scheduler import TenantScheduler

from _torch_threads import one_thread  # noqa: F401

CAP = 1000.0


def _x64():
    return jax.enable_x64(True)


def test_check_backend_accepts_both():
    assert check_backend("object") == "object"
    assert check_backend("vectorized") == "vectorized"
    with pytest.raises(ValueError):
        check_backend("simd")


# ---------------------------------------------------------------------------
# the water-fill
# ---------------------------------------------------------------------------


def _water_case(n, seed, kind="mixed"):
    """Seeded demands and weights (numpy f64) and a capacity: a mix of
    satisfiable, large and inf demands, zero demands, and zero or
    negative weights; or one of the edge cases."""
    rng = np.random.default_rng(seed)
    cap = CAP
    d = rng.uniform(0.1, 2.0, n) * cap / n
    d[rng.random(n) < 0.2] *= 50.0
    d[rng.random(n) < 0.1] = np.inf
    d[rng.random(n) < 0.05] = 0.0
    w = rng.choice([0.5, 1.0, 2.0, 4.0], n)
    w[rng.random(n) < 0.05] = 0.0
    w[rng.random(n) < 0.03] = -1.0
    if kind == "parked":
        w[:] = 0.0
    elif kind == "zero_cap":
        cap = 0.0
    elif kind == "all_inf":
        d[:] = np.inf
        w = np.abs(w) + 0.5
    return d, w, cap


WATER_CASES = [(1, "mixed"), (5, "mixed"), (1000, "mixed"), (3000, "mixed"),
               (1000, "parked"), (5, "zero_cap"), (1000, "all_inf")]


def _t(x):
    return torch.tensor(x, dtype=torch.float64)


# the bisection's step counts: none, one, and counts that are not a
# multiple of the kernel's pass depths (its remainder pass), beside the
# default 48; the default keeps each case's plain id
WATER_ITERS = (0, 1, 5, 47, 48)
WATER_ITER_CASES = [
    pytest.param(n, kind, iters,
                 id=f"{n}-{kind}" + ("" if iters == 48 else f"-iters{iters}"))
    for n, kind in WATER_CASES for iters in WATER_ITERS]


@pytest.mark.parametrize("n,kind,iters", WATER_ITER_CASES)
def test_water_fill_plain_matches_pallas_kernel(n, kind, iters):
    d, w, cap = _water_case(n, seed=n, kind=kind)
    with _x64():
        want = np.asarray(j_ops.water_fill(d, w, cap, impl="pallas",
                                           iters=iters))
    assert want.dtype == np.float64
    plain, level = water_fill_plain(_t(d), _t(w), cap, iters=iters)
    # CPU: the plain path
    wrapped, level2 = water_fill(_t(d), _t(w), cap, iters=iters)
    via_ops = t_ops.water_fill(_t(d), _t(w), cap, iters=iters)
    tol = 1e-9 * max(cap, 1.0)
    for got in (plain, wrapped, via_ops):
        assert np.abs(got.numpy() - want).max() <= tol
    assert float(level) == float(level2)


@pytest.mark.parametrize("n,kind", WATER_CASES)
def test_water_fill_matches_exact_fill_and_max_min_fair(n, kind):
    d, w, cap = _water_case(n, seed=n, kind=kind)
    with _x64():
        exact = np.asarray(j_ops.water_fill(d, w, cap, impl="ref"))
    mmf = j_max_min_fair(cap, dict(enumerate(d)), dict(enumerate(w)))
    mmf = np.array([mmf[i] for i in range(n)])
    port_exact = t_ref.water_fill_ref(_t(d), _t(w), cap).numpy()
    assert np.abs(port_exact - exact).max() <= 1e-9 * max(cap, 1.0)
    plain = water_fill_plain(_t(d), _t(w), cap)[0].numpy()
    for want in (exact, mmf):
        assert np.abs(plain - want).max() <= 1e-6 * max(cap, 1.0)
        assert np.abs(port_exact - want).max() <= 1e-6 * max(cap, 1.0)
    assert plain.sum() <= cap * (1 + 1e-9) + 1e-6


def _entries(seed, n):
    """Demand/weight dicts in the style of the reference's equivalence
    suite: zero, small, big and inf demands over weights incl. 0."""
    rng = np.random.default_rng(seed)
    kinds = rng.choice(["zero", "small", "big", "inf"], n)
    frac = rng.uniform(0.01, 1.0, n)
    demands = {t: {"zero": 0.0, "small": frac[t] * CAP / n,
                   "big": frac[t] * 2.0 * CAP, "inf": math.inf}[kinds[t]]
               for t in range(n)}
    weights = {t: float(rng.choice([0.0, 0.5, 1.0, 2.0, 4.0]))
               for t in range(n)}
    return demands, weights


@pytest.mark.parametrize("seed", range(4))
def test_waterfill_allocate_bounded_by_reference_exact_fill(seed,
                                                            monkeypatch):
    """P4: the port's facade runs the bisection by default where the
    reference's runs the exact sort; they agree within 1e-6 x capacity,
    and a satisfied tenant gets its demand exactly on both."""
    monkeypatch.setattr(j_vec, "_x64", _x64)
    demands, weights = _entries(seed, 12)
    port = waterfill_allocate(demands, CAP, weights, device="cpu")
    port_ref = waterfill_allocate(demands, CAP, weights, impl="ref",
                                  device="cpu")
    ref = j_vec.waterfill_allocate(demands, CAP, weights)
    mmf = j_max_min_fair(CAP, demands, weights)
    assert set(port) == set(ref) == set(mmf)
    for t in ref:
        assert port[t] == pytest.approx(ref[t], abs=1e-6 * CAP)
        assert port_ref[t] == pytest.approx(ref[t], abs=1e-9 * CAP)
        if math.isfinite(demands[t]) and mmf[t] == demands[t]:
            assert port[t] == demands[t]       # snapped, exactly


def test_waterfill_facade_matches_object_backend():
    obs = {0: TenantObs(rate=100.0, offered=100.0),
           1: TenantObs(rate=50.0, offered=50.0, deferred=30.0),
           2: TenantObs(rate=0.0, offered=0.0, queue=4.0)}
    weights = {0: 1.0, 1: 2.0, 2: 1.0}
    a_obj = t_cong.WaterFill(weights).allocate(obs, CAP)
    a_vec = t_cong.WaterFill(weights, backend="vectorized",
                             device="cpu").allocate(obs, CAP)
    assert set(a_obj) == set(a_vec)
    for t in a_obj:
        assert a_vec[t] == pytest.approx(a_obj[t], abs=1e-6 * CAP)


# ---------------------------------------------------------------------------
# the fused tick
# ---------------------------------------------------------------------------


def _tick_trace(n=48, ticks=6, seed=5, min_weight=1.0):
    """A seeded 6-tick counter trace: integer counter steps, a deferred
    counter on a backlogged subset, queue depth on another, one inactive
    slot and one counter reset (slot 5 at tick 3)."""
    rng = np.random.default_rng(seed)
    state = {
        "level": rng.uniform(0.0, 50.0, n), "brate": rng.uniform(0, 20, n),
        "bcap": rng.uniform(10.0, 60.0, n), "updated": np.zeros(n),
        "ewma_off": np.full(n, np.nan), "ewma_def": np.full(n, np.nan),
        "prev_off": np.zeros(n), "prev_def": np.zeros(n),
        "weight": rng.choice([1.0, 2.0, 4.0], n),
        "active": np.ones(n, dtype=bool),
    }
    state["weight"][7] = min_weight
    state["active"][3] = False
    steps = np.round(rng.uniform(0.2, 2.0, n) * CAP / n)
    backlog = rng.random(n) < 0.25
    off = np.zeros(n)
    dfr = np.zeros(n)
    samples = []
    for k in range(ticks):
        off = off + steps
        dfr = dfr + np.where(backlog, np.round(steps / 3), 0.0)
        cur = off.copy()
        if k == 3:
            cur[5] = 1.0                          # counter reset
        queue = np.where(rng.random(n) < 0.15, 2.0, 0.0)
        samples.append(np.stack([cur, dfr.copy(), queue]))
    return state, samples


def _assert_close(got, want, rtol=1e-9):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want,
                                                              dtype=np.float64)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    keep = ~np.isnan(want)
    np.testing.assert_allclose(got[keep], want[keep], rtol=rtol, atol=0.0)


NAMES = ("level", "brate", "bcap", "updated", "ewma_off", "ewma_def",
         "prev_off", "prev_def", "alloc", "water_level")


@pytest.mark.parametrize("scheduler_buckets,min_weight", [
    (True, 1.0), (False, 1.0),
    (True, 1e-20),       # far below any real weight, above the 1e-30 clamp
])
def test_fused_tick_matches_reference(scheduler_buckets, min_weight):
    state, samples = _tick_trace(min_weight=min_weight)
    order = ("level", "brate", "bcap", "updated", "ewma_off", "ewma_def",
             "prev_off", "prev_def")
    j_state = dict(state)
    t_state = {k: torch.tensor(v) for k, v in state.items()}
    j_tick = jax.jit(j_vec._fused_tick_impl,
                     static_argnames=("iters", "scheduler_buckets"))
    prev_t = 0.0
    for k, smp in enumerate(samples):
        now = 1.0 + k
        params = np.array([now, prev_t, 0.5, CAP, 1.25, 0.5, 0.25])
        with _x64():
            out_j = j_tick(*[j_state[nm] for nm in order], j_state["weight"],
                           j_state["active"], smp, params, iters=48,
                           scheduler_buckets=scheduler_buckets)
            out_j = [np.asarray(x) for x in out_j]
        out_t = fused_tick(*[t_state[nm] for nm in order],
                           t_state["weight"], t_state["active"],
                           torch.tensor(smp), torch.tensor(params),
                           iters=48, scheduler_buckets=scheduler_buckets)
        assert out_j[0].dtype == np.float64
        for name, got, want in zip(NAMES, out_t, out_j):
            assert got.dtype == torch.float64, name
            _assert_close(got.numpy(), want)
        for i, nm in enumerate(order):
            j_state[nm] = out_j[i]
            t_state[nm] = out_t[i]
        prev_t = now


# ---------------------------------------------------------------------------
# the whole plane
# ---------------------------------------------------------------------------


def _drive(n=40, ticks=5, seed=3):
    """One counter trace through the reference's plane, the port's plane
    (on the CPU) and the port's object RateController + scheduler."""
    rng = np.random.default_rng(seed)
    weights = rng.choice([1.0, 2.0, 4.0], size=n)
    steps = np.maximum(np.round(rng.uniform(0.2, 2.0, size=n)
                                * (CAP / n)), 1.0)
    backlogged = rng.random(n) < 0.25
    sched = TenantScheduler(policy="wfq", charge_prompt=True)
    ctrl = RateController(CAP, weights={t: float(weights[t])
                                        for t in range(n)}, alpha=0.5)
    ctrl.attach_scheduler(sched)
    j_plane = j_vec.VectorizedControlPlane(CAP, alpha=0.5, headroom=1.25)
    t_plane = VectorizedControlPlane(CAP, alpha=0.5, headroom=1.25,
                                     device="cpu")
    for t in range(n):
        sched.add_tenant(t, weight=float(weights[t]))
        j_plane.add_tenant(t, weight=float(weights[t]))
        t_plane.add_tenant(t, weight=float(weights[t]))
        if backlogged[t]:
            sched.queues[t].append(None)        # pending() counts length
    queue = np.where(backlogged, 1.0, 0.0)
    served = np.zeros(n)
    now = 0.0
    for _ in range(ticks):
        served += steps
        for t in range(n):
            sched.served_tokens[t] = int(served[t])
        ctrl.tick(now)
        j_out = j_plane.tick(served, queue=queue, now=now)
        t_out = t_plane.tick(served, queue=queue, now=now)
        assert (j_out is None) == (t_out is None)
        if t_out is not None:
            _assert_close(t_out, j_out)
        now += 1.0
    return ctrl, j_plane, t_plane


def test_plane_matches_reference_plane_and_object_controller(monkeypatch):
    monkeypatch.setattr(j_vec, "_x64", _x64)
    ctrl, j_plane, t_plane = _drive()
    port = t_plane.allocations()
    ref = j_plane.allocations()
    assert set(port) == set(ref) == set(ctrl.allocations)
    for t, r in ctrl.allocations.items():
        assert port[t] == pytest.approx(r, abs=1e-6 * CAP)
        assert port[t] == pytest.approx(ref[t], rel=1e-9)
    assert t_plane.last_level == pytest.approx(j_plane.last_level, rel=1e-9)
    for t in (0, 7, 39):
        a, b = t_plane.snapshot_tenant(t), j_plane.snapshot_tenant(t)
        assert a["bucket"] == pytest.approx(b["bucket"], rel=1e-9)
        assert a["weight"] == b["weight"]
    c = t_plane.counters()
    assert c["nk_control_ticks_total"] == 5
    assert c["nk_control_tenants"] == 40
    assert t_plane.state_bytes() == j_plane.state_bytes()
    obs_t, obs_j = t_plane.obs(), j_plane.obs()
    assert set(obs_t) == set(obs_j)
    for t in obs_t:
        assert obs_t[t].offered == pytest.approx(obs_j[t].offered, rel=1e-9)


def test_plane_snapshot_restore_round_trip_across_packages(monkeypatch):
    """JAX ``snapshot_tenant`` dicts restore into the port's plane and
    back, in the shared wire format, value for value."""
    monkeypatch.setattr(j_vec, "_x64", _x64)
    _ctrl, j_plane, t_plane = _drive(n=12, ticks=3)
    snap = j_plane.snapshot_tenant(5, now=2.5)
    port = VectorizedControlPlane(CAP, device="cpu")
    port.add_tenant(99)
    port.restore_tenant(5, snap)
    assert port.snapshot_tenant(5) == snap
    back = j_vec.VectorizedControlPlane(CAP)
    back.restore_tenant(5, port.export_tenant(5))
    assert back.snapshot_tenant(5) == snap
    assert 5 not in port.index
    with pytest.raises(ValueError):
        t_plane.restore_tenant(0, snap)          # a live slot refuses
    # the port's own export/restore at the export instant is lossless
    before = t_plane.snapshot_tenant(4)
    t_plane.restore_tenant(4, t_plane.export_tenant(4))
    assert t_plane.snapshot_tenant(4) == before


# ---------------------------------------------------------------------------
# host state: buckets, index, telemetry bank
# ---------------------------------------------------------------------------


def _ops(seed, k=40):
    rng = np.random.default_rng(seed)
    names = ["consume", "drain", "wait", "set_rate", "set_rate_burst",
             "snapshot_roundtrip"]
    return [(names[rng.integers(len(names))], float(rng.uniform(0, 2)),
             float(rng.uniform(0.01, 1.0))) for _ in range(k)]


def _apply(bucket, ops, rate, cap):
    """Drive one bucket through an op sequence; return observed outputs."""
    out, now = [], 0.0
    for op, x, dt in ops:
        now += dt
        if op == "consume":
            out.append(bucket.consume(x * cap, now=now))
        elif op == "drain":
            out.append(bucket.drain(x * cap, now=now))
        elif op == "wait":
            out.append(bucket.wait_time(x * cap, now=now))
        elif op == "set_rate":
            bucket.set_rate(rate * (0.5 + x), burst=None, now=now)
        elif op == "set_rate_burst":
            bucket.set_rate(rate * (0.5 + x), burst=cap * (0.5 + x), now=now)
        else:
            out.append(tuple(sorted(bucket.snapshot(now=now).items())))
        out.append((bucket.rate, bucket.capacity, bucket.tokens,
                    bucket.updated))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_store_bucket_bit_identical_to_token_bucket(seed):
    rng = np.random.default_rng(100 + seed)
    rate, cap = float(rng.uniform(0.5, 500)), float(rng.uniform(1, 1000))
    ops = _ops(seed)
    want = _apply(TokenBucket(rate, cap), ops, rate, cap)
    assert _apply(BucketStore().add(7, rate, cap), ops, rate, cap) == want
    assert _apply(j_vec.BucketStore().add(7, rate, cap), ops, rate,
                  cap) == want
    # snapshots cross backends exactly, both ways
    store = BucketStore()
    vec = store.add(1, rate, cap)
    _apply(vec, ops, rate, cap)
    snap = vec.snapshot(now=200.0)
    back = TokenBucket.restore(snap, now=200.0)
    again = BucketStore().restore(2, back.snapshot(), now=200.0)
    assert again.snapshot() == snap
    assert again.wait_time(cap, now=203.7) == back.wait_time(cap, now=203.7)


@pytest.mark.parametrize("seed", range(3))
def test_tenant_index_churn_and_compact_match_reference(seed):
    rng = np.random.default_rng(seed)
    port, ref = TenantIndex(), j_vec.TenantIndex()
    shadow = {}
    for _ in range(80):
        op = rng.choice(["add", "add", "drop", "compact"])
        t = int(rng.integers(0, 30))
        if op == "add":
            shadow[t] = port.add(t)
            assert ref.add(t) == shadow[t]
        elif op == "drop" and t in shadow:
            assert port.drop(t) == ref.drop(t)
            del shadow[t]
        elif op == "compact":
            remap = port.compact()
            assert remap == ref.compact()
            shadow = {k: remap.get(s, s) for k, s in shadow.items()}
        assert len(port) == len(shadow) and port.size >= len(port)
        for tenant, slot in shadow.items():
            assert port.slot(tenant) == slot
            assert port.tenant_at(slot) == tenant
    port.compact()
    assert port.size == len(port)
    assert sorted(s for _, s in port.items()) == list(range(len(port)))


def test_telemetry_bank_matches_reference():
    rng = np.random.default_rng(9)
    port, ref = TelemetryBank(0.5), j_vec.TelemetryBank(0.5)
    offered = {t: 0.0 for t in range(6)}
    for bank in (port, ref):
        bank.baseline(offered)
    for k in range(5):
        offered = {t: v + float(rng.integers(0, 9))
                   for t, v in offered.items()}
        if k == 2:
            offered[1] = 0.0                     # a counter reset
            offered.pop(4)                       # a tenant vanished
        outs = [bank.update(dict(offered), 1.0, extra=[9]) for bank in
                (port, ref)]
        assert outs[0][0] == outs[1][0]
        for a, b in zip(outs[0][1:], outs[1][1:]):
            np.testing.assert_array_equal(a, b)
    assert port.tenants() == ref.tenants()


# ---------------------------------------------------------------------------
# facades: telemetry and controller eviction, both backends
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["object", "vectorized"])
def test_scheduler_telemetry_eviction(backend):
    sched = TenantScheduler(bucket_backend=backend)
    tel = SchedulerTelemetry(sched, alpha=0.5, backend=backend)
    for t in (1, 2):
        sched.add_tenant(t)
        sched.served_tokens[t] = 10
    tel.update(now=0.0)
    sched.served_tokens[1] = 30
    sched.served_tokens[2] = 40
    obs = tel.update(now=1.0)
    assert obs[1].rate == 20.0 and obs[2].rate == 30.0
    assert tel.tracked_tenants() >= {1, 2}
    sched.drop_tenant(1)
    tel.evict_tenant(1)
    assert 1 not in tel.tracked_tenants()
    assert 2 in tel.tracked_tenants()
    obs = tel.update(now=2.0)
    assert 1 not in obs and 2 in obs


@pytest.mark.parametrize("backend", ["object", "vectorized"])
def test_controller_evict_tenant(backend):
    sched = TenantScheduler(bucket_backend=backend)
    ctrl = RateController(CAP, alpha=0.5, backend=backend, device="cpu")
    ctrl.attach_scheduler(sched)
    for t in (1, 2):
        sched.add_tenant(t)
        sched.served_tokens[t] = 5
    ctrl.tick(0.0)
    sched.served_tokens[1] = 25
    sched.served_tokens[2] = 25
    ctrl.tick(1.0)
    assert ctrl.allocations == {1: 25.0, 2: 25.0}   # headroom 1.25 x 20
    sched.drop_tenant(1)
    ctrl.evict_tenant(1)
    tel = ctrl._schedulers[0][1]
    assert 1 not in tel.tracked_tenants()
    assert 1 not in ctrl.allocations
    # a tenant the scheduler still holds keeps its live telemetry
    ctrl.evict_tenant(2)
    assert 2 in tel.tracked_tenants()


def test_scheduler_bucket_backend_migration_roundtrip():
    """TenantState crosses object<->vectorized schedulers unchanged."""
    now = 1.0
    src = TenantScheduler(bucket_backend="vectorized")
    dst = TenantScheduler(bucket_backend="object")
    src.add_tenant(1, weight=2.0, rate_tokens_per_s=100.0, burst=50.0)
    src.buckets[1].consume(20.0, now=now)
    state = src.export_tenant(1, now=now)
    dst.import_tenant(1, state, now=now)
    assert dst.buckets[1].snapshot(now=now) == \
        {"rate": 100.0, "capacity": 50.0, "tokens": 30.0, "updated": now}
    back = TenantScheduler(bucket_backend="vectorized")
    back.restore_tenant(1, dst.snapshot_tenant(1, now=now), now=now)
    assert back.buckets[1].snapshot(now=now) == \
        dst.buckets[1].snapshot(now=now)
    back.wipe()
    assert not back.buckets and len(back._bucket_store) == 0
