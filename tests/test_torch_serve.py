"""The port's serve and control planes against the reference's.

The same request and counter streams, on a frozen or virtual clock, go
through the reference's objects and the port's: admission order,
served/billed counters, pushed rates and allocations must be equal (the
host code was carried over, so equal means equal, not close). Then both
``ServeEngine``s serve the same requests with the same (bridged) weights at
the f32 smoke variant: generated tokens, completion order and ledgers
must be identical. The reference engine's prefill compiles once per prompt
length, so the prompts use two lengths.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JRunConfig
from repro.configs import get_smoke_config as j_smoke
from repro.control import congestion as j_cong
from repro.control.controller import RateController as JController
from repro.core.engine import TokenBucket as JBucket
from repro.models.model import build_params
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.scheduler import Request as JRequest
from repro.serve.scheduler import TenantScheduler as JScheduler
from repro_torch.configs import RunConfig, get_smoke_config
from repro_torch.control import congestion as t_cong
from repro_torch.control.controller import RateController as TController
from repro_torch.core.engine import CoreEngine
from repro_torch.core.engine import TokenBucket as TBucket
from repro_torch.models.params import params_from_jax
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TEngine
from repro_torch.serve import TenantScheduler as TScheduler

from _torch_threads import one_thread  # noqa: F401

SIDES = {
    "ref": dict(Bucket=JBucket, Scheduler=JScheduler, Request=JRequest,
                Controller=JController, cong=j_cong),
    "port": dict(Bucket=TBucket, Scheduler=TScheduler, Request=TRequest,
                 Controller=TController, cong=t_cong),
}


def _both(fn):
    """Run ``fn(side)`` for both packages; return (ref, port)."""
    return fn(SIDES["ref"]), fn(SIDES["port"])


# ---------------------------------------------------------------------------
# token bucket, scheduler
# ---------------------------------------------------------------------------


def test_token_bucket_matches_reference():
    def run(side):
        b = side["Bucket"](10.0, 25.0)
        out = [b.consume(20, now=0.0), b.consume(20, now=0.5),
               b.wait_time(30, now=0.6), b.drain(40, now=1.0)]
        b.set_rate(2.0, burst=8.0, now=2.0)
        out += [b.tokens, b.wait_time(5, now=2.5), b.snapshot(now=3.0)]
        r = side["Bucket"].restore(b.snapshot(), now=10.0)
        out += [r.consume(8, now=10.0), r.snapshot()]
        z = side["Bucket"](0.0, 0.0)
        out += [z.wait_time(1, now=5.0)]
        return out
    ref, port = _both(run)
    assert port == ref
    assert port[-1] == math.inf


def _serve_loop(side, *, policy, setup, requests, steps, slots,
                clock=lambda k: 0.0, charge_prompt=False):
    """A model-free serve loop: admit into free slots each step, bill
    prompt + first token at admission and one token per decode step."""
    sched = side["Scheduler"](policy=policy, charge_prompt=charge_prompt)
    setup(sched)
    for rid, (tenant, plen, new) in enumerate(requests):
        sched.submit(side["Request"](tenant_id=tenant, prompt=[1] * plen,
                                     max_new_tokens=new, req_id=rid,
                                     arrival=0.0))
    active, order = [], []
    for k in range(steps):
        now = clock(k)
        while len(active) < slots:
            req = sched.next_request(now)
            if req is None:
                break
            order.append(req.req_id)
            sched.account(req.tenant_id, len(req.prompt) + 1)
            active.append([req, req.max_new_tokens - 1])
        for a in active:
            sched.account(a[0].tenant_id, 1)
            a[1] -= 1
        active = [a for a in active if a[1] > 0]
    return (order, dict(sched.served_tokens), sched.ledger(),
            sched.shares(), {t: b.snapshot() for t, b in sched.buckets.items()})


@pytest.mark.parametrize("case", ["wfq_contention", "bucket_isolation",
                                  "round_robin", "charged_refill"])
def test_scheduler_matches_reference(case):
    """Mirrors tests/test_system.py's WFQ-contention and token-bucket
    isolation cases, plus RR and prompt-charged buckets refilling on a
    virtual clock."""
    if case == "wfq_contention":
        kw = dict(policy="wfq",
                  setup=lambda s: (s.add_tenant(0), s.add_tenant(1)),
                  requests=[(0, 2, 12)] * 4 + [(1, 2, 12)] * 16,
                  steps=25, slots=2)
    elif case == "bucket_isolation":
        kw = dict(policy="wfq",
                  setup=lambda s: (s.add_tenant(0, rate_tokens_per_s=1.0,
                                                burst=14.0),
                                   s.add_tenant(1)),
                  requests=[(t, 1, 12) for _ in range(8) for t in (0, 1)],
                  steps=120, slots=2)
    elif case == "round_robin":
        kw = dict(policy="rr", setup=lambda s: None,
                  requests=[(t % 3, 1 + t % 2, 3 + t % 4) for t in range(15)],
                  steps=40, slots=3)
    else:
        kw = dict(policy="wfq", charge_prompt=True,
                  setup=lambda s: (s.add_tenant(0, weight=2.0,
                                                rate_tokens_per_s=40.0,
                                                burst=30.0),
                                   s.add_tenant(1, rate_tokens_per_s=20.0)),
                  requests=[(t % 2, 4, 6) for t in range(20)],
                  steps=200, slots=3, clock=lambda k: 0.05 * k)
    ref, port = _both(lambda side: _serve_loop(side, **kw))
    assert port == ref
    if case == "bucket_isolation":   # the reference test's claim holds too
        assert port[0].count(0) == 1 and len(port[0]) == 9


def test_tenant_export_import_matches_reference():
    def run(side):
        a, b = side["Scheduler"](), side["Scheduler"]()
        a.add_tenant(3, weight=2.0, rate_tokens_per_s=5.0, burst=9.0)
        for i in range(3):
            a.submit(side["Request"](tenant_id=3, prompt=[1, 2],
                                     max_new_tokens=4, req_id=i,
                                     arrival=0.0))
        a.next_request(now=0.5)
        a.account(3, 7)
        st = a.export_tenant(3, now=1.0)
        b.add_tenant(9)
        b.account(9, 11)
        b.import_tenant(3, st, now=2.0)
        return (st.plane, st.bucket, st.carried, st.payload["weight"],
                [r.req_id for r in st.queue], b.vtime, b.pending(3),
                b.buckets[3].snapshot(), 3 in a.queues)
    ref, port = _both(run)
    assert port == ref


# ---------------------------------------------------------------------------
# congestion control and the controller
# ---------------------------------------------------------------------------


def test_max_min_fair_and_algorithms_match_reference():
    rng = np.random.default_rng(0)
    for trial in range(20):
        n = int(rng.integers(1, 8))
        demands = {t: float(rng.choice([rng.uniform(0, 50), math.inf, 0.0]))
                   for t in range(n)}
        weights = {t: float(rng.uniform(0.5, 3.0)) for t in range(n)}
        cap = float(rng.uniform(1, 120))
        ref = j_cong.max_min_fair(cap, demands, weights)
        port = t_cong.max_min_fair(cap, demands, weights)
        assert port == ref, trial

    def run(side):
        from repro.control.telemetry import TenantObs as JObs
        from repro_torch.control.telemetry import TenantObs as TObs
        obs_cls = JObs if side is SIDES["ref"] else TObs
        algos = [side["cong"].WaterFill({1: 2.0}),
                 side["cong"].Aimd(increase=5.0),
                 side["cong"].Dctcp(increase=5.0)]
        out = []
        for k in range(12):
            obs = {1: obs_cls(rate=30.0 + k, offered=40.0 + k,
                              deferred=5.0 if k % 3 else 0.0),
                   2: obs_cls(rate=10.0, offered=10.0, queue=k % 2),
                   3: obs_cls(rate=2.0 * k, offered=2.0 * k)}
            out.append([a.allocate(obs, 100.0) for a in algos])
        return out
    ref, port = _both(run)
    assert port == ref


@pytest.mark.parametrize("push_mode", ["full", "delta"])
def test_rate_controller_matches_reference(push_mode):
    """One counter stream through both controllers over their schedulers:
    allocations, pushed bucket rates, push counts and exported counters
    (minus wall-clock tick timing) are equal."""
    def run(side):
        s1, s2 = side["Scheduler"](), side["Scheduler"]()
        ctrl = side["Controller"](100.0, alpha=0.6, push_mode=push_mode,
                                  delta_tol=0.05, refresh_every=7,
                                  weights={2: 2.0})
        ctrl.attach_scheduler(s1).attach_scheduler(s2)
        out, now = [], 0.0
        for k in range(30):
            now += 0.1
            for i, s in enumerate((s1, s2)):
                for t in range(1 + (k + i) % 3):
                    s.submit(side["Request"](tenant_id=t, prompt=[1],
                                             max_new_tokens=4))
                req = s.next_request(now)
                if req is not None:
                    s.account(req.tenant_id, 3 + i + k % 5)
            out.append(dict(ctrl.tick(now)))
            out.append({t: b.snapshot() for t, b in s1.buckets.items()})
            out.append({t: b.snapshot() for t, b in s2.buckets.items()})
        ctrl.evict_tenant(2)
        counters = {k: v for k, v in ctrl.counters().items()
                    if "tick_seconds" not in k}
        return out, ctrl.push_calls, ctrl.push_skipped, counters, \
            ctrl.export_prometheus().count("\n")
    ref, port = _both(run)
    assert port == ref


def test_unported_backends_and_points_raise():
    # the vectorized backend is ported: it builds (its water-fill on the
    # device asked for); CoreEngine points are ported too: a controller
    # tick pushes a rate into an attached engine's bucket. An unknown
    # bucket backend still raises.
    assert TScheduler(bucket_backend="vectorized").bucket_backend == \
        "vectorized"
    assert TController(10.0, backend="vectorized",
                       device="cpu").backend == "vectorized"
    assert t_cong.WaterFill(backend="vectorized",
                            device="cpu").device.type == "cpu"
    eng = CoreEngine(enforcement="account")
    ctrl = TController(10.0).attach_engine(eng, ("pod",))
    for k, now in enumerate((0.1, 0.2)):
        eng.dispatch("shm_move", torch.zeros(16 * (k + 1), dtype=torch.uint8),
                     ("pod",), tenant_id=3, now=now)
        ctrl.tick(now)
    assert ctrl.allocations and eng.buckets[3].rate == \
        pytest.approx(ctrl.allocations[3])
    assert eng.total_bytes(3) == 48
    with pytest.raises(ValueError):
        TScheduler(bucket_backend="arrays")


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

F32 = dict(dtype="float32", param_dtype="float32")


@pytest.fixture(scope="module")
def bridged(mesh1):
    jcfg = dataclasses.replace(j_smoke("llama3.2-3b"), **F32)
    tcfg = dataclasses.replace(get_smoke_config("llama3.2-3b"), **F32)
    params = build_params(jcfg, mesh1, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                            device="cpu")
    return jcfg, tcfg, params, model


def _requests(request_cls):
    rng = np.random.default_rng(5)
    out = []
    for i in range(6):
        plen = (3, 5)[i % 2]
        out.append(request_cls(
            tenant_id=i % 3, prompt=[int(x) for x in rng.integers(1, 256,
                                                                   plen)],
            max_new_tokens=(6, 9, 12)[i % 3], req_id=i, arrival=0.0))
    return out


def _engine_run(engine, scheduler, requests):
    for r in requests:
        engine.submit(r)
    k = 0
    while scheduler.pending() or any(s.active for s in engine.slots):
        k += 1
        engine.step(now=0.1 * k)
        assert k < 200
    return ([(r.req_id, r.generated) for r in engine.completed],
            dict(scheduler.served_tokens), scheduler.ledger(),
            {t: engine.billed_ground_truth(t) for t in range(3)},
            engine.decode_steps)


def test_serve_engine_matches_reference(bridged, mesh1):
    """Both engines, wired like the replay engine (WFQ, prompt-charged
    buckets, a RateController ticked every 4 steps), serve the same six
    requests with the same weights: identical tokens, completion order,
    ledgers and decode steps."""
    jcfg, tcfg, params, model = bridged

    def make(side, engine_cls, cfg, rcfg, weights, mesh_args):
        sched = side["Scheduler"](policy="wfq", charge_prompt=True)
        ctrl = side["Controller"](200.0, alpha=0.6)
        ctrl.attach_scheduler(sched)
        eng = engine_cls(cfg, rcfg, *mesh_args, params=weights,
                         batch_slots=4, max_seq=64, scheduler=sched,
                         controller=ctrl, control_every=4)
        return eng, sched

    jeng, jsched = make(SIDES["ref"], JEngine, jcfg,
                        JRunConfig(attn_q_block=16, attn_kv_block=16),
                        params, (mesh1,))
    teng, tsched = make(SIDES["port"], TEngine, tcfg, RunConfig(), model, ())
    ref = _engine_run(jeng, jsched, _requests(JRequest))
    port = _engine_run(teng, tsched, _requests(TRequest))
    assert port == ref
    for t in range(3):      # and the port's own ledger balances
        assert tsched.served_tokens[t] == teng.billed_ground_truth(t)


def test_suspend_resume_serves_bit_identical(bridged):
    """suspend() drops the KV-cache and slot table; resume() brings the
    cache back lazily on the next admission; serving after the cycle is
    bit-identical to the never-parked behavior."""
    _, tcfg, _, model = bridged
    sched = TScheduler(policy="wfq", charge_prompt=True)
    eng = TEngine(tcfg, RunConfig(), model, batch_slots=2, max_seq=32,
                  scheduler=sched)

    def serve(req_id):
        eng.submit(TRequest(tenant_id=0, prompt=[1, 2], max_new_tokens=4,
                            req_id=req_id, arrival=0.0))
        for k in range(12):
            eng.step(now=0.1 * (k + 1))
        return eng.completed[-1]

    before = serve(0)
    resident = eng.resident_bytes()
    assert resident > 0
    assert eng.suspend() == resident
    assert eng.resident_bytes() == 0 and eng.caches is None
    assert eng.slots == []
    with pytest.raises(RuntimeError):
        eng.step(now=9.9)
    eng.resume()
    assert eng.caches is None
    after = serve(1)
    assert eng.resident_bytes() == resident
    assert after.generated == before.generated
    assert sched.served_tokens[0] == sum(
        len(r.prompt) + len(r.generated) for r in eng.completed)


def test_slot_install_clears_stale_rows(bridged):
    """Inactive slots decode token 0 at position 0 and write row 0 of
    their cache; an admission must overwrite the whole slot so nothing of
    that (or of an earlier request) survives into the new request."""
    _, tcfg, _, model = bridged
    eng = TEngine(tcfg, RunConfig(), model, batch_slots=2, max_seq=32)
    eng.submit(TRequest(tenant_id=0, prompt=[5, 6, 7, 8, 9, 10],
                        max_new_tokens=8))
    eng.run_until_drained()
    eng.submit(TRequest(tenant_id=1, prompt=[3, 4], max_new_tokens=2))
    eng._admit()
    fresh = TEngine(tcfg, RunConfig(), model, batch_slots=2, max_seq=32)
    fresh.submit(TRequest(tenant_id=1, prompt=[3, 4], max_new_tokens=2))
    fresh._admit()
    for seg, seg_fresh in zip(eng.caches, fresh.caches):
        for k in seg:
            assert (seg[k][:, 0] == seg_fresh[k][:, 0]).all(), k
