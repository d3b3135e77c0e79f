"""Shared helpers of the port's cluster and placement tests.

* ``FakeEngine`` — the port's model-free serve-plane double on
  ``repro_torch.fabric.SchedulerServeModule``, slot for slot the
  reference's ``tests/test_placement.py::FakeEngine`` (admit bills prompt
  + first token, each decode step bills one token, a fixed fake cache
  dropped on suspend).
* ``PKGS`` — the names one protocol script needs, per package, so the
  same script runs on the reference's cluster and on the port's.
* ``scripted_run`` — that script: submits, steps, a migration mid-burst,
  park/unpark, a serve and a bytes swap, then checkpoint, fail, recover
  and restore, on 3 doubles with a ``CoreEngine`` each and one shared
  ``RateController``; returns everything a run can be compared by.
"""
import itertools
from types import SimpleNamespace

import numpy as np

from repro_torch.fabric import SchedulerServeModule
from repro_torch.serve.scheduler import TenantScheduler


class _Slot:
    def __init__(self, req=None, remaining=0):
        self.active = req is not None
        self.req = req
        self.remaining = remaining


class FakeEngine(SchedulerServeModule):
    """ServeEngine's admission and billing contract, no model."""

    FAKE_CACHE_BYTES = 4096

    def __init__(self, batch_slots=4):
        self.B = batch_slots
        self.scheduler = TenantScheduler(policy="wfq", charge_prompt=True)
        self.controller = None
        self.slots = self._make_slots()
        self.completed = []
        self.decode_steps = 0

    def _make_slots(self):
        return [_Slot() for _ in range(self.B)]

    def _cache_bytes(self):
        return self.FAKE_CACHE_BYTES

    def submit(self, req):
        self.scheduler.submit(req)

    def step(self, now=None):
        for i, s in enumerate(self.slots):
            if s.active:
                continue
            req = self.scheduler.next_request(now)
            if req is None:
                break
            req.generated.append(1)          # prefill's first token
            self.scheduler.account(req.tenant_id, len(req.prompt) + 1)
            if req.max_new_tokens <= 1:
                self.completed.append(req)
                continue
            self.slots[i] = _Slot(req, req.max_new_tokens - 1)
        active = [s for s in self.slots if s.active]
        for i, s in enumerate(self.slots):
            if not s.active:
                continue
            s.req.generated.append(1)
            s.remaining -= 1
            self.scheduler.account(s.req.tenant_id, 1)
            if s.remaining <= 0:
                self.completed.append(s.req)
                self.slots[i] = _Slot()
        if active:
            self.decode_steps += 1
        return len(active)


def _pkg(name):
    if name == "port":
        from repro_torch.control.controller import RateController
        from repro_torch.control.placement import PlacementController
        from repro_torch.core.engine import CoreEngine
        from repro_torch.core.nqe import CommOp
        from repro_torch.fabric import FabricSnapshot
        from repro_torch.serve.cluster import EngineCluster
        from repro_torch.serve.replay import make_watchdog, swap_live_stack
        from repro_torch.serve.scheduler import Request
        fake = FakeEngine
    else:
        from test_placement import FakeEngine as fake

        from repro.control.controller import RateController
        from repro.control.placement import PlacementController
        from repro.core.engine import CoreEngine
        from repro.core.nqe import CommOp
        from repro.fabric import FabricSnapshot
        from repro.serve.cluster import EngineCluster
        from repro.serve.replay import make_watchdog, swap_live_stack
        from repro.serve.scheduler import Request
    return SimpleNamespace(
        name=name, Fake=fake, RateController=RateController,
        PlacementController=PlacementController, CoreEngine=CoreEngine,
        CommOp=CommOp, FabricSnapshot=FabricSnapshot,
        EngineCluster=EngineCluster, swap_live_stack=swap_live_stack,
        make_watchdog=make_watchdog, Request=Request)


PKGS = {name: _pkg(name) for name in ("ref", "port")}


def fake_cluster(P, n=3, *, core_plane=False, controller=None, **kw):
    cores = [P.CoreEngine(enforcement="account") for _ in range(n)] \
        if core_plane else None
    return P.EngineCluster([P.Fake() for _ in range(n)], controller,
                           core_engines=cores, **kw)


def req(P, tenant, k=0, tokens=6, now=0.0):
    return P.Request(tenant_id=tenant, prompt=[1, 2], max_new_tokens=tokens,
                     req_id=k, arrival=now)


def records(log):
    return [dict(vars(r)) for r in log]


def observe(cl):
    """Everything two clusters driven by one script must agree on."""
    planes = {}
    for plane in cl.planes:
        planes[plane.name] = {
            f: plane.ledger.merged(f) for f in plane.ledger.fields}
    return {
        "placement": dict(cl.placement), "parked": sorted(cl.parked),
        "failed": sorted(cl.failed), "draining": dict(cl.draining),
        "steps": cl.steps,
        "decode_steps": [e.decode_steps for e in cl.engines],
        "completed": len(cl.completed),
        "migrations": records(cl.migration_log),
        "swaps": records(cl.swap_log),
        "failures": records(cl.failure_log),
        "planes": planes,
        "counters": cl.counters(), "prometheus": cl.export_prometheus(),
        "health": cl.health(),
        "allocations": (dict(cl.controller.allocations)
                        if cl.controller is not None else None),
    }


def crash_safe(cl, k):
    """True iff crashing engine ``k`` keeps every plane conserved in both
    packages: each tenant placed on ``k`` has no billed history there
    beyond its live counters. A tenant swapped in place on ``k``, or one
    that left ``k`` and came back, carries history whose ground truth
    ``crash`` wipes with the rest, and ``fail_engine``'s conservation
    assert then raises (ROADMAP R6)."""
    for plane in cl.planes:
        mod = plane.modules[k]
        for t, e in cl.placement.items():
            if e == k and mod.billed_ground_truth(t) != \
                    mod.live_counter(t, plane.ledger.conserved):
                return False
    return True


def scripted_run(P, seed=0):
    """The protocol script on package ``P``; returns (cluster, snapshots'
    bytes, observations taken after each phase)."""
    rng = np.random.default_rng(seed)
    ids = itertools.count(1)
    ctrl = P.RateController(160.0, alpha=0.6)
    cl = fake_cluster(P, 3, core_plane=True, controller=ctrl,
                      control_every=2)
    clock = {"vt": 0.0}
    snaps, obs = [], {}

    def step(n, hog=3):
        for _ in range(n):
            vt = clock["vt"]
            for t in range(4):
                k = int(rng.poisson(3.0 if t == hog else 0.6))
                tokens = rng.integers(1, 7, size=k)
                size = int(rng.integers(1, 4096))
                for tok in tokens:
                    cl.submit(P.Request(
                        tenant_id=t, prompt=[1, 2],
                        max_new_tokens=int(tok), req_id=next(ids),
                        arrival=vt))
                e = cl.placement.get(t)
                if e is not None and e not in cl.failed:
                    op = P.CommOp(verb="psum", axes=("pod",), tenant_id=t,
                                  size_bytes=size)
                    cl.core_engines[e].admit(op, vt)
                    cl.core_engines[e].route(op)
            cl.step(now=vt)
            clock["vt"] = vt + 0.25

    def settle(cap=60):
        for _ in range(cap):
            if not cl.draining:
                return
            step(1)
        raise AssertionError(f"drains never finalized: {cl.draining}")

    for t in range(4):
        cl.add_tenant(t)
    step(6)
    obs["burst"] = observe(cl)
    # a migration mid-burst: the hog leaves with slots in flight
    src = cl.placement[3]
    dst = min((k for k in cl.active_engines() if k != src),
              key=lambda k: (cl.engine_load(k), k))
    cl.migrate(3, dst, now=clock["vt"])
    settle()
    obs["migrate"] = observe(cl)
    # maintenance: empty engine 2, park it, run without it, wake it
    for t, k in sorted(cl.placement.items()):
        if k == 2:
            cl.migrate(t, 1 if dst != 1 else 0, now=clock["vt"])
    settle()
    for _ in range(40):
        if cl.parkable(2):
            break
        step(1, hog=-1)
    cl.park(2, now=clock["vt"])
    step(4)
    obs["parked"] = observe(cl)
    cl.unpark(2, now=clock["vt"])
    step(2)
    # live swaps on both planes, under traffic
    P.swap_live_stack(cl, "serve", now=clock["vt"])
    step(3)
    P.swap_live_stack(cl, "bytes", now=clock["vt"])
    step(3)
    obs["swapped"] = observe(cl)
    # checkpoint, a crash of the hottest engine, its recovery
    settle()
    snap = cl.checkpoint(now=clock["vt"])
    snaps.append(snap.to_bytes())
    step(3)
    victim = max((k for k in cl.active_engines() if crash_safe(cl, k)),
                 key=lambda k: (cl.engine_load(k), -k))
    cl.fail_engine(victim, now=clock["vt"])
    step(2)
    obs["failed"] = observe(cl)
    cl.recover_engine(victim, snap, now=clock["vt"])
    step(3)
    obs["recovered"] = observe(cl)
    # a full-fabric restore to a later snapshot
    settle()
    snap2 = cl.checkpoint(now=clock["vt"])
    snaps.append(snap2.to_bytes())
    step(3)
    cl.restore(P.FabricSnapshot.from_bytes(snaps[-1]), now=clock["vt"])
    step(2)
    settle()
    snaps.append(cl.checkpoint(now=clock["vt"]).to_bytes())
    obs["restored"] = observe(cl)
    return cl, snaps, obs
