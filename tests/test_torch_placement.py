"""The port's placement loop against the reference's, on the CPU.

``control/placement.py`` is pure selection logic over a ``ClusterView``
plus two gates (the per-tenant cooldown and the drain-cost model), and it
applies its plans through ``EngineCluster.apply_plan``. So the same views
must give the same plans in both packages, and the same closed loop over
the same clusters of model-free doubles (``tests/_torch_fabric.py``) must
move the same tenants at the same virtual times, park and unpark the same
engines and report the same counters.
"""
import itertools
import warnings

import numpy as np
import pytest
from _torch_fabric import PKGS, fake_cluster, req

import repro.control.placement as j_pl
import repro_torch.control.placement as t_pl
from _torch_threads import one_thread  # noqa: F401

PACKAGES = {"ref": j_pl, "port": t_pl}


def _view(M, **kw):
    base = dict(n_engines=3, parked=frozenset(), placement={},
                draining=frozenset(), engine_load=(0.0, 0.0, 0.0),
                demand={}, pending={}, queued_cost={},
                inflight_remaining={})
    base.update(kw)
    return M.ClusterView(**base)


def _plan(plan):
    return ([(m.tenant, m.src, m.dst, m.reason, m.expected_gain,
              m.drain_cost) for m in plan.moves],
            list(plan.park), list(plan.unpark))


# the reference's own policy fixtures (tests/test_placement.py), each
# with the policy that plans it
VIEWS = {
    "consolidate_idle": ("consolidate", dict(
        placement={0: 0, 1: 1, 2: 2}, demand={0: 1.0, 1: 1.0, 2: 1.0},
        queued_cost={0: 0.0, 1: 0.0, 2: 0.0})),
    "consolidate_sticky": ("consolidate", dict(
        placement={0: 0, 1: 0, 2: 1}, demand={0: 4.0, 1: 4.0, 2: 4.0},
        parked=frozenset({2}))),
    "consolidate_unpark": ("consolidate", dict(
        placement={0: 0, 1: 0, 2: 0}, parked=frozenset({1, 2}),
        demand={0: 8.0, 1: 8.0, 2: 8.0})),
    "consolidate_overload": ("consolidate", dict(
        placement={0: 0, 1: 1, 2: 2, 3: 0},
        demand={0: 9.0, 1: 9.0, 2: 9.0, 3: 9.0})),
    "consolidate_draining": ("consolidate", dict(
        placement={0: 0, 1: 1}, draining=frozenset({1}),
        demand={0: 1.0, 1: 1.0})),
    "consolidate_queue_pressure": ("consolidate", dict(
        placement={0: 0, 1: 0, 2: 1, 3: 2},
        demand={0: 2.0, 1: 2.0, 2: 0.5, 3: 0.1},
        queued_cost={0: 30.0, 1: 4.0, 2: 0.0, 3: 0.0},
        inflight_remaining={0: 3.0, 1: 1.0})),
    "spread_backlogged": ("spread_hot", dict(
        placement={0: 0, 1: 0, 2: 1}, engine_load=(20.0, 1.0, 0.0),
        pending={0: 15, 1: 3, 2: 1},
        queued_cost={0: 120.0, 1: 24.0, 2: 8.0})),
    "spread_below_floor": ("spread_hot", dict(
        placement={0: 0, 1: 1}, engine_load=(5.0, 1.0, 0.0),
        pending={0: 5, 1: 1})),
    "spread_inside_band": ("spread_hot", dict(
        placement={0: 0, 1: 1}, engine_load=(12.0, 8.0, 9.0),
        pending={0: 12, 1: 8})),
    "spread_lone_hog": ("spread_hot", dict(
        placement={0: 0, 1: 1, 2: 2}, engine_load=(50.0, 2.0, 1.0),
        pending={0: 48, 1: 2, 2: 1})),
    "spread_parked_cool": ("spread_hot", dict(
        placement={0: 0, 1: 0, 2: 2}, parked=frozenset({1}),
        engine_load=(30.0, 0.0, 2.0), pending={0: 20, 1: 0, 2: 2},
        queued_cost={0: 160.0, 2: 16.0}, inflight_remaining={0: 12.0})),
}


def _policy(M, name):
    return M.make_policy(name, ceiling=10.0) if name == "consolidate" \
        else M.make_policy(name)


@pytest.mark.parametrize("case", sorted(VIEWS))
def test_policy_plans_equal_the_reference(case):
    name, kw = VIEWS[case]
    plans = {p: _plan(_policy(M, name).plan(_view(M, **kw), 0.0))
             for p, M in PACKAGES.items()}
    assert plans["port"] == plans["ref"]


@pytest.mark.parametrize("seed", range(6))
def test_random_views_plan_alike(seed):
    """Random fleets: both policies, and spread_hot forced and pinned."""
    rng = np.random.default_rng(seed)
    n_eng, n_t = int(rng.integers(2, 5)), int(rng.integers(1, 8))
    parked = frozenset(k for k in range(n_eng) if rng.random() < 0.25)
    awake = [k for k in range(n_eng) if k not in parked] or [0]
    placement = {t: int(rng.choice(awake)) for t in range(n_t)}
    pending = {t: int(rng.integers(0, 30)) for t in placement}
    kw = dict(
        n_engines=n_eng, parked=parked if len(awake) < n_eng else
        frozenset(), placement=placement,
        draining=frozenset(t for t in placement if rng.random() < 0.2),
        engine_load=tuple(float(sum(pending[t] for t in placement
                                    if placement[t] == k))
                          for k in range(n_eng)),
        demand={t: float(rng.uniform(0, 12)) for t in placement},
        pending=pending,
        queued_cost={t: 8.0 * pending[t] for t in placement},
        inflight_remaining={t: float(rng.integers(0, 20))
                            for t in placement})
    pin = int(rng.integers(0, n_t))
    ceiling = float(rng.uniform(5.0, 30.0))
    out = {}
    for p, M in PACKAGES.items():
        v = _view(M, **kw)
        out[p] = (_plan(M.Consolidate(ceiling=ceiling).plan(v, 0.0)),
                  _plan(M.SpreadHot(min_hot_load=6.0).plan(v, 0.0)),
                  _plan(M.SpreadHot().plan(v, 0.0, force=True)),
                  _plan(M.SpreadHot().plan(v, 0.0, pin_tenant=pin,
                                           force=True)))
    assert out["port"] == out["ref"]


def test_spread_hot_arming_sequence_equals_the_reference():
    """The hysteresis band: a moved hog is disarmed until its engine
    cools below the exit band, in both packages, view for view."""
    seq = [
        dict(placement={0: 0, 1: 0, 2: 1, 3: 2},
             engine_load=(50.0, 1.0, 1.0), pending={0: 48, 1: 1, 2: 1,
                                                     3: 1}),
        dict(placement={0: 2, 1: 0, 2: 1, 3: 1},
             engine_load=(1.0, 2.0, 50.0), pending={0: 48, 1: 1, 2: 1,
                                                     3: 1}),
        dict(placement={0: 2, 1: 0, 2: 0, 3: 1},
             engine_load=(30.0, 1.0, 2.0), pending={0: 1, 1: 28, 2: 1,
                                                    3: 1}),
    ]
    logs = {}
    for p, M in PACKAGES.items():
        pol = M.SpreadHot(min_hot_load=8.0)
        log = []
        for i, kw in enumerate(seq):
            plan = pol.plan(_view(M, **kw), float(i))
            log.append((_plan(plan), sorted(pol._disarmed)))
            for mv in plan.moves:
                pol.notify_moved(mv.tenant)
        logs[p] = log
    assert logs["port"] == logs["ref"]
    assert logs["port"][0][0][0][0][0] == 0       # the hog moved first
    assert logs["port"][1][0] == ([], [], [])     # disarmed: no bounce


def test_make_policy_registry():
    assert sorted(t_pl.PLACEMENT_POLICIES) == sorted(j_pl.PLACEMENT_POLICIES)
    assert isinstance(t_pl.make_policy("spread_hot"), t_pl.SpreadHot)
    assert isinstance(t_pl.make_policy("consolidate", ceiling=5.0),
                      t_pl.Consolidate)
    with pytest.raises(KeyError):
        t_pl.make_policy("nope")
    p = t_pl.SpreadHot()
    assert t_pl.make_policy(p) is p
    with pytest.raises(ValueError):
        t_pl.make_policy(p, ceiling=5.0)
    with pytest.raises(TypeError):
        t_pl.make_policy(object())
    with pytest.raises(ValueError):
        t_pl.Consolidate(ceiling=0.0)
    with pytest.raises(ValueError):
        t_pl.SpreadHot(enter_ratio=0.5)


# ---------------------------------------------------------------------------
# the controller's gates and the closed loop, on both packages' doubles
# ---------------------------------------------------------------------------


class _ScriptedPolicy:
    """Hands the controller one scripted plan per tick."""

    name = "test"

    def __init__(self, M, plans):
        self.M, self.plans = M, list(plans)

    def plan(self, view, now):
        moves, park, unpark = self.plans.pop(0) if self.plans \
            else ([], [], [])
        return self.M.PlacementPlan(
            moves=[self.M.PlannedMove(*m) for m in moves], park=list(park),
            unpark=list(unpark))


def _gates(p, M):
    P = PKGS[p]
    cl = fake_cluster(P, 3)
    cl.add_tenant(0, engine=0)
    cl.add_tenant(1, engine=1)
    cl.park(2)
    plans = [
        ([(0, 0, 1, "test")], [], []),                  # lands
        ([(0, 1, 2, "test")], [], [2]),                 # cooldown-gated
        ([(1, 1, 2, "test", 10.0, 25.0)], [1], [2]),    # drain-gated
        ([(0, 1, 2, "test", 10.0, 5.0)], [], [2]),      # lands, unparks 2
        ([(7, 0, 1, "test"), (1, 0, 2, "test")], [0], []),  # both stale
    ]
    pc = P.PlacementController(cl, policy=_ScriptedPolicy(M, plans),
                               cooldown_s=3.0, drain_cost_factor=1.0)
    out = []
    for now in (0.0, 1.0, 2.0, 3.5, 4.0):
        out.append(_plan(pc.tick(now=now)))
    pc.assert_no_ping_pong()
    return (out, dict(cl.placement), sorted(cl.parked), pc.counters(),
            [(w, mv.tenant, mv.src, mv.dst) for w, mv in pc.move_log])


def test_cooldown_and_drain_gates_equal_the_reference():
    got = {p: _gates(p, M) for p, M in PACKAGES.items()}
    assert got["port"] == got["ref"]
    out, placement, parked, counters, moves = got["port"]
    assert counters["nk_placement_moves_skipped_cooldown_total"] == 1
    assert counters["nk_placement_moves_skipped_drain_total"] == 1
    assert moves == [(0.0, 0, 0, 1), (3.5, 0, 1, 2)]
    assert placement == {0: 2, 1: 1} and parked == [0]


def test_ping_pong_checker_bites():
    cl = fake_cluster(PKGS["port"], 3)
    pc = t_pl.PlacementController(cl, cooldown_s=3.0)
    pc.move_log += [(1.0, t_pl.PlannedMove(0, 0, 1, "x")),
                    (2.0, t_pl.PlannedMove(0, 1, 0, "x"))]
    with pytest.raises(AssertionError, match="ping-ponged"):
        pc.assert_no_ping_pong()


def _pump(P, cl, loads, vt, seconds, ids, dt=0.25):
    frac = {t: 0.0 for t in loads}
    end = vt + seconds
    while vt < end - 1e-9:
        for t, rps in loads.items():
            frac[t] += rps * dt
            while frac[t] >= 1.0:
                frac[t] -= 1.0
                cl.submit(req(P, t, k=next(ids), now=vt))
        cl.step(now=vt)
        vt += dt
    return vt


def _closed_loop(p, policy):
    """The reference's closed-loop fixtures (tests/test_placement.py):
    busy -> idle -> busy under consolidate; a mid-run hog under
    spread_hot."""
    P = PKGS[p]
    ids = itertools.count(1000)
    cl = fake_cluster(P, 3, place_every=4)
    snaps = []
    if policy == "consolidate":
        pc = P.PlacementController(cl, policy="consolidate", ceiling=30.0,
                                   cooldown_s=2.0, alpha=1.0)
        cl.attach_autopilot(pc)
        for t in range(3):
            cl.add_tenant(t, engine=t)
        busy = {t: 3.0 for t in range(3)}
        idle = {t: 0.25 for t in range(3)}
        vt = 0.0
        for loads, secs in ((busy, 4.0), (idle, 6.0), (busy, 6.0)):
            vt = _pump(P, cl, loads, vt, secs, ids)
            snaps.append((sorted(cl.parked), dict(cl.placement),
                          cl.parked_engine_steps))
    else:
        pc = P.PlacementController(cl, policy="spread_hot",
                                   min_hot_load=6.0, cooldown_s=2.0,
                                   alpha=1.0)
        cl.attach_autopilot(pc)
        for t, k in ((0, 0), (1, 1), (2, 2), (3, 0)):
            cl.add_tenant(t, engine=k)
        calm = {0: 1.0, 1: 1.0, 2: 1.0, 3: 1.0}
        hot = {0: 1.0, 1: 1.0, 2: 1.0, 3: 30.0}
        vt = 0.0
        for loads, secs in ((calm, 3.0), (hot, 8.0), (hot, 6.0)):
            vt = _pump(P, cl, loads, vt, secs, ids)
            snaps.append((sorted(cl.parked), dict(cl.placement),
                          len(pc.move_log)))
    pc.assert_no_ping_pong()
    for t in cl.placement:
        cl.assert_ledger_conservation(t)
    return {"snaps": snaps,
            "moves": [(w, mv.tenant, mv.src, mv.dst, mv.reason)
                      for w, mv in pc.move_log],
            "counters": {k: v for k, v in cl.counters().items()
                         if "tick_seconds" not in k},
            "served": cl.merged_ledger("served_tokens"),
            "cores_saved": cl.cores_saved(), "mem_saved": cl.mem_saved(),
            "decode_steps": [e.decode_steps for e in cl.engines]}


def test_closed_loop_consolidation_equals_the_reference():
    got = {p: _closed_loop(p, "consolidate") for p in PACKAGES}
    assert got["port"] == got["ref"]
    snaps = got["port"]["snaps"]
    assert snaps[0][0] == []                       # busy: all awake
    assert len(snaps[1][0]) >= 1                   # idle: parked
    assert len(set(snaps[1][1].values())) == 1     # packed on one engine
    assert snaps[2][0] == []                       # load returned
    assert got["port"]["cores_saved"] > 0 and got["port"]["mem_saved"] > 0


def test_closed_loop_hotspot_equals_the_reference():
    got = {p: _closed_loop(p, "spread_hot") for p in PACKAGES}
    assert got["port"] == got["ref"]
    moved = [m[1] for m in got["port"]["moves"]]
    assert moved.count(3) == 1 and len(moved) == len(set(moved))
    assert got["port"]["snaps"][1][1][3] != 0      # the hog left engine 0
    assert got["port"]["snaps"][2][2] == got["port"]["snaps"][1][2]


def _one_shots(p):
    P = PKGS[p]
    if p == "port":
        from repro_torch.serve.replay import operator_rebalance
    else:
        from repro.serve.replay import operator_rebalance
    out = []
    cl = fake_cluster(P, 3)
    for t, k in ((0, 0), (1, 0), (2, 1)):
        cl.add_tenant(t, engine=k)
    for k in range(6):
        cl.submit(req(P, 0, k=k))
    for k in range(2):
        cl.submit(req(P, 1, k=10 + k))
    cl.submit(req(P, 2, k=20))
    with pytest.warns(DeprecationWarning, match="plan_once"):
        out.append(vars(cl.rebalance(now=0.0)))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        rec = operator_rebalance(cl, now=0.0, pin_tenant=1)
        out.append(vars(rec) if rec is not None else None)
        pc = P.PlacementController(cl, policy="spread_hot")
        out.append(_plan(pc.plan_once(now=1.0, force=True)))
        out.append(_plan(pc.plan_once(now=2.0)))
    with pytest.warns(DeprecationWarning), pytest.raises(KeyError):
        cl.rebalance(tenant=99)
    balanced = fake_cluster(P, 2)
    balanced.add_tenant(0, engine=0)
    balanced.add_tenant(1, engine=1)
    with pytest.warns(DeprecationWarning):
        out.append(balanced.rebalance())
    out.append(dict(cl.placement))
    return out


def test_one_shot_rebalance_and_plan_once_equal_the_reference():
    got = {p: _one_shots(p) for p in PACKAGES}
    assert got["port"] == got["ref"]
    first = got["port"][0]
    assert (first["tenant"], first["src"], first["dst"]) == (0, 0, 2)
    assert got["port"][-2] is None                  # balanced: no move


# ---------------------------------------------------------------------------
# park/unpark through apply_plan on the port
# ---------------------------------------------------------------------------


def test_park_requires_quiesced_engine_and_never_last():
    P = PKGS["port"]
    cl = fake_cluster(P, 2)
    cl.add_tenant(0, engine=0)
    with pytest.raises(ValueError):
        cl.park(0)                 # hosts a tenant
    cl.park(1)
    assert cl.parked == {1}
    with pytest.raises(ValueError):
        cl.park(1)                 # already parked
    with pytest.raises(ValueError):
        cl.park(0)                 # would be the last awake engine
    assert cl.add_tenant(5) == 0
    with pytest.raises(ValueError):
        cl.add_tenant(6, engine=1)
    with pytest.raises(ValueError):
        cl.migrate(0, 1)
    cl.unpark(1)
    with pytest.raises(ValueError):
        cl.unpark(1)
    assert cl.migrate(0, 1) is not None


def test_apply_plan_skips_stale_moves_and_parks_only_quiesced():
    P = PKGS["port"]
    cl = fake_cluster(P, 3)
    cl.add_tenant(0, engine=0)
    cl.add_tenant(1, engine=1)
    plan = t_pl.PlacementPlan(moves=[
        t_pl.PlannedMove(0, 0, 1, "test"),
        t_pl.PlannedMove(7, 0, 1, "test"),
        t_pl.PlannedMove(1, 0, 2, "test"),
    ], park=[0, 1])
    recs = cl.apply_plan(plan, now=0.0)
    assert [r.tenant for r in recs] == [0]
    assert cl.placement == {0: 1, 1: 1}
    assert cl.parked == {0}
    assert cl.counters()["nk_cluster_parked"] == 1.0
    assert cl.parked_bytes() == P.Fake.FAKE_CACHE_BYTES
