"""End-to-end fairness replay: Trace -> real Requests -> live ServeEngine.

The counterpart of ``repro/serve/replay.py``.
``fair_replay`` (``serve/multiplex.py``) validates the paper's Fig. 21/22
claims as a fluid-flow model; this module closes the gap to the actual
datapath. A ``TraceReplayer`` takes the same ``Trace`` vocabulary (bursty,
adversarial 10x-misbehaver, correlated-burst, ramp, steady), converts each
interval's per-tenant load into real ``Request`` objects, and feeds them to
a live ``ServeEngine`` — prefill and decode through the attention kernels,
slot-based continuous batching, WFQ admission — with a ``RateController``
attached to the scheduler's token buckets (the tokens/s bottleneck).
Everything runs on a virtual clock: one engine step advances time by a
fixed ``step_dt`` chosen so the engine's raw throughput is ``headroom`` x
the enforced capacity, so the *management plane*, not the slots, is the
binding constraint. The virtual clock does not depend on the device's
speed: the same scenario gives the same ledgers on the CPU and on a card.

All metrics are read from real ledgers, never from the model:

  * achieved tokens/s   TenantScheduler.served_tokens (prompt + decode)
  * admission latency   arrival -> admission wait, scheduler ledger
  * defer pressure      bucket-blocked poll counts
  * Jain index          over achieved per-weight rates of contending tenants
  * control chatter     RateController push_calls / push_skipped

The scheduler runs with ``charge_prompt=True`` so bucket pricing, telemetry
observation and the served-token ledger share one unit and the controller's
``capacity`` is directly comparable to measured rates.

The same replayer drives a multi-engine ``EngineCluster`` (N ServeEngines
sharing one copy of the weights, one shared controller, operator-controlled
placement) unchanged — see ``make_replay_cluster`` and the cluster
scenarios (``CLUSTER_SCENARIOS``), whose operator events (a live migration,
a stack swap, a checkpoint/kill/recover drill) land mid-replay via
``run(events=...)``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.control.congestion import max_min_fair
from repro_torch.serve import multiplex as mx
from repro_torch.serve.multiplex import Trace, jain_index
from repro_torch.serve.scheduler import Request, TenantScheduler


@dataclass
class TenantReport:
    """One tenant's end-to-end outcome, straight from the ledgers.

    The percentile columns are histogram estimates (upper edge of the
    bucket the quantile falls in — within one log-bucket width of the
    true sample quantile, see ``repro_torch.obs.hist``), windowed to this run
    like every other counter. NaN when the window observed no samples
    (a zero-request tenant in a short scenario): "no data" must not
    read as "p99 = 0". Renderers show it as ``-``."""

    demand_rate: float            # offered load, tokens/s
    achieved_rate: float          # served tokens/s over the replay window
    served_tokens: float
    admitted_requests: int
    completed_requests: int
    deferred_polls: int
    mean_admit_wait_s: float
    weight: float = 1.0
    p50_admit_wait_s: float = 0.0
    p99_admit_wait_s: float = 0.0
    p99_ttft_s: float = 0.0
    p99_e2e_s: float = 0.0


@dataclass
class ReplayReport:
    """Everything a fairness claim needs, measured on the real datapath.

    ``engines``/``migrations``/``placement`` surface the cluster view when
    the replay drove an ``EngineCluster``: how many engines shared the
    bottleneck, how many live migrations finalized inside this window, and
    where each tenant ended up (tenant -> engine index).

    ``cores_saved``/``max_parked``/``autopilot_moves`` surface the
    placement loop when an autopilot drove the cluster: average engines
    parked per step inside this window (the closed-loop core savings),
    the peak engines asleep at once, and how many moves the autopilot
    applied.

    ``mem_saved_bytes``/``max_parked_bytes``/``peak_resident_cache_bytes``
    surface the park suspend/resume lifecycle, all windowed to this run:
    average bytes freed per cluster step (the memory analog of
    ``cores_saved``), the peak bytes simultaneously freed by suspended
    engines, and the peak resident droppable-buffer footprint
    (KV-caches + slot state across awake engines) observed inside the
    window."""

    duration_s: float
    capacity: float               # enforced bottleneck, tokens/s
    per_tenant: Dict[int, TenantReport]
    decode_steps: int
    set_rate_calls: int = 0
    push_skipped: int = 0
    engines: int = 1
    migrations: int = 0
    swaps: int = 0                # live stack hot-swaps inside this window
    placement: Optional[Dict[int, int]] = None
    cores_saved: float = 0.0      # avg engines parked per cluster step
    max_parked: int = 0           # peak engines asleep at once
    autopilot_moves: int = 0      # placement-loop migrations this window
    mem_saved_bytes: float = 0.0  # avg bytes freed per cluster step
    max_parked_bytes: int = 0     # peak bytes freed by suspended engines
    peak_resident_cache_bytes: int = 0   # lifetime peak resident buffers
    checkpoints: int = 0          # fabric checkpoints inside this window
    recoveries: int = 0           # kill-and-restore recoveries this window
    # the watchdog view when the replay ran with one attached: alert
    # instances that fired inside this window (``obs/slo.py``'s ``Alert``,
    # in fire order), how many of those resolved before the window
    # closed, how many were still firing at the end — and the watchdog
    # itself, so callers can dump its recorded scrape sequence
    alerts: Optional[Sequence] = None
    alerts_fired: int = 0
    alerts_resolved: int = 0
    alerts_active: int = 0
    watchdog: Optional[object] = None

    def alerts_by_rule(self) -> Dict[str, int]:
        """Fired-alert counts per rule name inside this window."""
        out: Dict[str, int] = {}
        for a in self.alerts or ():
            out[a.rule] = out.get(a.rule, 0) + 1
        return out

    def rates(self) -> Dict[int, float]:
        return {t: r.achieved_rate for t, r in self.per_tenant.items()}

    def total_rate(self) -> float:
        return sum(r.achieved_rate for r in self.per_tenant.values())

    def contending(self) -> Sequence[int]:
        """Tenants whose demand exceeded their fair share — the ones a
        fairness index is actually about."""
        ref = self.fair_reference()
        return [t for t, r in self.per_tenant.items()
                if r.demand_rate > ref[t] * 1.01]

    def jain(self, tenants: Optional[Sequence[int]] = None) -> float:
        ts = list(tenants) if tenants is not None else list(self.contending())
        if not ts:
            ts = list(self.per_tenant)
        return jain_index([self.per_tenant[t].achieved_rate
                           / self.per_tenant[t].weight for t in ts])

    def fair_reference(self) -> Dict[int, float]:
        """Weighted max-min fair allocation of the tenants' offered loads
        over the enforced capacity — the paper's Fig. 21 target."""
        demands = {t: r.demand_rate for t, r in self.per_tenant.items()}
        weights = {t: r.weight for t, r in self.per_tenant.items()}
        return max_min_fair(self.capacity, demands, weights)

    def max_min_deviation(self) -> float:
        """Worst relative gap between achieved rate and the max-min fair
        reference, over tenants with non-trivial fair share."""
        ref = self.fair_reference()
        worst = 0.0
        for t, want in ref.items():
            if want <= 1e-9:
                continue
            worst = max(worst,
                        abs(self.per_tenant[t].achieved_rate - want) / want)
        return worst


# canonical request shape for the e2e scenarios — the one place the
# request's token price (prompt + decode) is defined; bench_fairness --e2e
# and tests derive from these instead of re-hardcoding them
PROMPT_LEN = 2
MAX_NEW_TOKENS = 6
TOKENS_PER_REQUEST = PROMPT_LEN + MAX_NEW_TOKENS


class TraceReplayer:
    """Drives a ServeEngine — or a whole EngineCluster — through a Trace
    on a virtual clock.

    Args:
        engine: a live ``ServeEngine`` or ``EngineCluster`` (anything with
            the engine driving surface: ``B``, ``submit``, ``step``,
            ``completed``, ``decode_steps``, ``scheduler``,
            ``controller``). A cluster's ledger facade makes per-tenant
            counters continuous across live migrations.
        capacity: the enforced bottleneck in tokens/s (the controller's
            capacity — cluster-wide when driving a cluster).
        interval_s: seconds of virtual time per trace interval.
        prompt_len / max_new_tokens: request shape in tokens.
        headroom: raw engine throughput as a multiple of ``capacity``; > 1
            keeps the management plane, not the slots, the binding
            constraint.
        weights: per-tenant WFQ weights (dimensionless), default 1.0.
        watchdog: a ``FabricWatchdog`` (``obs/slo.py``) to tick on the
            virtual clock — once before the first interval (the rate
            baseline) and once at each interval boundary — so every
            replay doubles as an alert-precision fixture. Its alert
            activity lands in the report's ``alerts*`` fields.
    """

    def __init__(self, engine, *, capacity: float,
                 interval_s: float = 1.0, prompt_len: int = PROMPT_LEN,
                 max_new_tokens: int = MAX_NEW_TOKENS, headroom: float = 1.5,
                 weights: Optional[Dict[int, float]] = None,
                 watchdog=None):
        self.engine = engine
        self.watchdog = watchdog
        self.capacity = float(capacity)
        self.interval_s = float(interval_s)
        self.prompt_len = int(prompt_len)
        self.max_new_tokens = int(max_new_tokens)
        self.weights = dict(weights or {})
        self.tokens_per_request = self.prompt_len + self.max_new_tokens
        # raw engine throughput at full slots is B*(p+n)/n tokens per step;
        # pick step_dt so that equals headroom * capacity: enforcement binds
        raw_per_step = engine.B * self.tokens_per_request / self.max_new_tokens
        self.step_dt = raw_per_step / (headroom * self.capacity)
        self._req_id = 0
        self._vt = 0.0

    # ------------------------------------------------------------------
    def _submit(self, tenant: int, now: float):
        self._req_id += 1
        self.engine.submit(Request(
            tenant_id=tenant, prompt=list(range(1, self.prompt_len + 1)),
            max_new_tokens=self.max_new_tokens, req_id=self._req_id,
            arrival=now))

    def run(self, trace: Trace, *, unit: str = "requests",
            events: Optional[Sequence] = None) -> ReplayReport:
        """Replay ``trace`` (per-tenant loads per interval). ``unit`` is
        what a load value means: "requests" (requests/s, the multiplexing
        vocabulary) or "tokens" (tokens/s, divided by request cost).

        ``events``: optional sequence of ``(interval_index, fn)`` operator
        actions; ``fn(engine, now)`` runs at the start of that (0-based)
        interval — how a live migration lands mid-replay."""
        loads = np.asarray(trace.loads, float)
        if unit == "tokens":
            loads = loads / self.tokens_per_request
        elif unit != "requests":
            raise ValueError(f"unknown unit {unit!r}")
        n, T = loads.shape
        sched: TenantScheduler = self.engine.scheduler
        for i in range(n):
            if i not in sched.queues:
                sched.add_tenant(i, weight=self.weights.get(i, 1.0))
            else:
                sched.set_weight(i, self.weights.get(i, 1.0))
        start_vt = self._vt
        served0 = {i: sched.served_tokens.get(i, 0) for i in range(n)}
        admitted0 = {i: sched.admitted_requests.get(i, 0) for i in range(n)}
        deferred0 = {i: sched.deferred_polls.get(i, 0) for i in range(n)}
        wait0 = {i: sched.admit_wait_sum.get(i, 0.0) for i in range(n)}
        completed0 = len(self.engine.completed)
        ctrl = self.engine.controller
        calls0 = getattr(ctrl, "push_calls", 0)
        skip0 = getattr(ctrl, "push_skipped", 0)
        steps0 = self.engine.decode_steps
        migrations0 = getattr(self.engine, "migrations_completed", 0)
        swaps0 = len(getattr(self.engine, "swap_log", ()))
        ckpt0 = getattr(self.engine, "checkpoints_total", 0)
        recov0 = getattr(self.engine, "recoveries_total", 0)
        cl_steps0 = getattr(self.engine, "steps", 0)
        parked0 = getattr(self.engine, "parked_engine_steps", 0)
        mem0 = getattr(self.engine, "mem_saved_byte_steps", 0)
        pilot = getattr(self.engine, "autopilot", None)
        pilot_moves0 = getattr(pilot, "moves_applied", 0)
        # window the latency histograms like every other counter: snapshot
        # per-tenant counts now, diff at the end (engine and cluster both
        # expose latency() -> {metric: TenantHistograms})
        lat_fn = getattr(self.engine, "latency", None)
        lat0: Dict[str, Dict[int, object]] = {}
        if lat_fn is not None:
            for mname, th in lat_fn().items():
                lat0[mname] = {t: h.copy()
                               for t, h in th.per_tenant.items()}

        ev: Dict[int, list] = {}
        for idx, fn in (events or ()):
            if not 0 <= int(idx) < T:
                # a silently dropped event breaks the scenario's contract
                # (e.g. "includes a live migration") in confusing ways
                raise ValueError(f"event interval {idx} out of range for a "
                                 f"{T}-interval trace")
            ev.setdefault(int(idx), []).append(fn)
        wd = self.watchdog
        alerts0 = len(wd.alerts.history) if wd is not None else 0
        if wd is not None and (not wd.store.times()
                               or start_vt > wd.store.times()[-1]):
            # the pre-traffic baseline scrape: window rates at interval 0
            # diff against quiet counters instead of an empty store
            wd.tick(start_vt)
        frac = np.zeros(n)
        # per-window peaks of engines asleep / bytes freed (the cluster's
        # own high-water marks are lifetime; this report is windowed)
        max_parked = 0
        max_parked_bytes = 0
        peak_resident = 0
        parked_bytes = getattr(self.engine, "parked_bytes", None)
        resident_bytes = getattr(self.engine, "resident_bytes", None)
        for t in range(T):
            for fn in ev.get(t, ()):
                fn(self.engine, self._vt)
            interval_end = self._vt + self.interval_s
            for i in range(n):
                want = loads[i, t] * self.interval_s + frac[i]
                k = int(want)
                frac[i] = want - k
                for _ in range(k):
                    self._submit(i, self._vt)
            while self._vt < interval_end - 1e-9:
                self.engine.step(now=self._vt)
                self._vt += self.step_dt
                max_parked = max(max_parked,
                                 len(getattr(self.engine, "parked", ())))
                if parked_bytes is not None:
                    max_parked_bytes = max(max_parked_bytes,
                                           parked_bytes())
                if resident_bytes is not None:
                    peak_resident = max(peak_resident, resident_bytes())
            if wd is not None:
                wd.tick(self._vt)

        duration = self._vt - start_vt
        completed: Dict[int, int] = {}
        for req in self.engine.completed[completed0:]:
            completed[req.tenant_id] = completed.get(req.tenant_id, 0) + 1
        lat_now = lat_fn() if lat_fn is not None else {}

        def _q(mname: str, tenant: int, q: float) -> float:
            # NaN, not 0.0, when the window has no samples: a tenant that
            # never admitted a request has UNKNOWN latency, not a perfect
            # p99 (renderers show it as '-')
            th = lat_now.get(mname)
            h = th.per_tenant.get(tenant) if th is not None else None
            if h is None:
                return float("nan")
            snap = lat0.get(mname, {}).get(tenant)
            win = h.since(snap) if snap is not None else h
            return win.quantile(q) if win.total else float("nan")

        per_tenant: Dict[int, TenantReport] = {}
        for i in range(n):
            # every counter is windowed to THIS run: repeated run() calls on
            # one replayer (phased scenarios) must not leak prior pressure
            served = sched.served_tokens.get(i, 0) - served0[i]
            adm = sched.admitted_requests.get(i, 0) - admitted0[i]
            wait = sched.admit_wait_sum.get(i, 0.0) - wait0[i]
            per_tenant[i] = TenantReport(
                demand_rate=float(loads[i].mean()) * self.tokens_per_request,
                achieved_rate=served / duration,
                served_tokens=float(served),
                admitted_requests=adm,
                completed_requests=completed.get(i, 0),
                deferred_polls=sched.deferred_polls.get(i, 0) - deferred0[i],
                mean_admit_wait_s=wait / adm if adm else 0.0,
                weight=self.weights.get(i, 1.0),
                p50_admit_wait_s=_q("nk_admit_wait_seconds", i, 0.50),
                p99_admit_wait_s=_q("nk_admit_wait_seconds", i, 0.99),
                p99_ttft_s=_q("nk_ttft_seconds", i, 0.99),
                p99_e2e_s=_q("nk_e2e_seconds", i, 0.99),
            )
        placement = getattr(self.engine, "placement", None)
        cl_steps = getattr(self.engine, "steps", 0) - cl_steps0
        parked_steps = getattr(self.engine, "parked_engine_steps", 0) \
            - parked0
        mem_steps = getattr(self.engine, "mem_saved_byte_steps", 0) - mem0
        return ReplayReport(
            duration_s=duration, capacity=self.capacity,
            per_tenant=per_tenant,
            decode_steps=self.engine.decode_steps - steps0,
            set_rate_calls=getattr(ctrl, "push_calls", 0) - calls0,
            push_skipped=getattr(ctrl, "push_skipped", 0) - skip0,
            engines=len(getattr(self.engine, "engines", ())) or 1,
            migrations=getattr(self.engine, "migrations_completed", 0)
            - migrations0,
            swaps=len(getattr(self.engine, "swap_log", ())) - swaps0,
            placement=dict(placement) if placement is not None else None,
            cores_saved=parked_steps / cl_steps if cl_steps else 0.0,
            max_parked=max_parked,
            autopilot_moves=getattr(pilot, "moves_applied", 0)
            - pilot_moves0,
            mem_saved_bytes=mem_steps / cl_steps if cl_steps else 0.0,
            max_parked_bytes=max_parked_bytes,
            peak_resident_cache_bytes=peak_resident,
            checkpoints=getattr(self.engine, "checkpoints_total", 0) - ckpt0,
            recoveries=getattr(self.engine, "recoveries_total", 0) - recov0,
            alerts=(list(wd.alerts.history[alerts0:])
                    if wd is not None else None),
            alerts_fired=(len(wd.alerts.history) - alerts0
                          if wd is not None else 0),
            alerts_resolved=(sum(1 for a in wd.alerts.history[alerts0:]
                                 if a.resolved_at is not None)
                             if wd is not None else 0),
            alerts_active=len(wd.alerts.active) if wd is not None else 0,
            watchdog=wd,
        )


# ---------------------------------------------------------------------------
# Canonical scenarios (the shared vocabulary with bench_fairness/multiplex)
# ---------------------------------------------------------------------------


def make_replay_engine(*, capacity: float, batch_slots: int = 4,
                       max_seq: int = 32, control_every: int = 4,
                       push_mode: str = "full", delta_tol: float = 0.05,
                       model: str = "llama3.2-3b", weights=None,
                       backend: str = "object", device=None, params=None):
    """A ServeEngine + WFQ scheduler + attached RateController, wired the
    way the e2e scenarios expect (charge_prompt pricing, tokens/s
    bottleneck = ``capacity``). The model is ``model``'s smoke config with
    fresh seeded weights, or the model ``params`` (a ``Model`` of any
    width, whose config then wins). ``backend="vectorized"`` selects the
    array-backed control plane end to end (scheduler buckets, telemetry
    EWMA banks, the water-fill kernel) — same behavior, flat per-tenant
    cost. ``device``: ``cuda`` unless ``"cpu"`` is passed."""
    from repro_torch.configs import RunConfig, get_smoke_config
    from repro_torch.control.controller import RateController
    from repro_torch.serve.engine import ServeEngine

    if params is not None and device is None:
        device = params.device
    sched = TenantScheduler(policy="wfq", charge_prompt=True,
                            bucket_backend=backend)
    ctrl = RateController(capacity, weights=weights, alpha=0.6,
                          push_mode=push_mode, delta_tol=delta_tol,
                          backend=backend, device=device)
    ctrl.attach_scheduler(sched)
    cfg = params.cfg if params is not None else get_smoke_config(model)
    return ServeEngine(cfg, RunConfig(attn_q_block=16, attn_kv_block=16),
                       params, batch_slots=batch_slots, max_seq=max_seq,
                       scheduler=sched, controller=ctrl,
                       control_every=control_every, device=device)


def make_replay_cluster(*, capacity: float, engines: int = 3,
                        batch_slots: int = 4, max_seq: int = 32,
                        control_every: int = 4, push_mode: str = "full",
                        delta_tol: float = 0.05, model: str = "llama3.2-3b",
                        weights=None, autopilot=None,
                        place_every: int = 8, autopilot_kw=None,
                        core_plane: bool = False, backend: str = "object",
                        device=None, params=None):
    """N ServeEngines behind ONE shared RateController — the multi-engine
    fabric the e2e scenarios drive.

    ``capacity`` is the single tokens/s bottleneck spanning the whole
    cluster (the controller splits each tenant's allocation across engines
    by observed demand). Every engine serves the same ``Model``: ``params``
    (a ``Model`` of any width, whose config then wins) or ``model``'s smoke
    config with fresh weights made once, by the first engine. Nothing
    copies the weights: on a card the cluster holds one copy of them plus
    one KV-cache per engine. ``device``: ``cuda`` unless ``"cpu"`` is
    passed (``params``' device when given).

    ``autopilot`` closes the placement loop: a policy name
    ('consolidate'/'spread_hot') builds a ``PlacementController`` over the
    cluster (extra policy/controller kwargs ride in ``autopilot_kw``;
    'consolidate' defaults its ceiling to ``0.375 * capacity`` tokens/s —
    between one and two equal shares of a 4-tenant fleet, so a busy fleet
    spreads and an idle one packs), or pass a ready controller instance.
    ``core_plane`` pairs each ServeEngine with a bytes-plane ``CoreEngine``
    (no mesh: it admits, routes and accounts) so migrations move
    collective-traffic state in the same plan.
    """
    from repro_torch.configs import RunConfig, get_smoke_config
    from repro_torch.control.controller import RateController
    from repro_torch.serve.cluster import EngineCluster
    from repro_torch.serve.engine import ServeEngine

    if params is not None and device is None:
        device = params.device
    ctrl = RateController(capacity, weights=weights, alpha=0.6,
                          push_mode=push_mode, delta_tol=delta_tol,
                          backend=backend, device=device)
    cfg = params.cfg if params is not None else get_smoke_config(model)
    rcfg = RunConfig(attn_q_block=16, attn_kv_block=16)
    engs = []
    for _ in range(int(engines)):
        sched = TenantScheduler(policy="wfq", charge_prompt=True,
                                bucket_backend=backend)
        # replicas serve the first engine's Model: one copy of the weights
        eng = ServeEngine(cfg, rcfg, engs[0].params if engs else params,
                          batch_slots=batch_slots, max_seq=max_seq,
                          scheduler=sched, controller=None, device=device)
        engs.append(eng)
    cores = None
    if core_plane:
        from repro_torch.core.engine import CoreEngine
        cores = [CoreEngine(enforcement="account") for _ in engs]
    cluster = EngineCluster(engs, ctrl, control_every=control_every,
                            core_engines=cores, place_every=place_every)
    if autopilot is not None:
        from repro_torch.control.placement import PlacementController
        if isinstance(autopilot, str):
            kw = dict(autopilot_kw or {})
            if autopilot == "consolidate":
                kw.setdefault("ceiling", 0.375 * float(capacity))
            autopilot = PlacementController(cluster, policy=autopilot, **kw)
        cluster.attach_autopilot(autopilot, place_every=place_every)
    return cluster


def make_watchdog(engine, *, interval_s: float = 1.0, rules=None,
                  record: bool = False):
    """A ``FabricWatchdog`` wired over ``engine``'s live metrics.

    Builds a fresh ``MetricsRegistry``, registers the engine's own
    exporter (a cluster's ``counters`` folds controller + autopilot +
    latency; a single engine contributes its controller's merged view)
    plus the cluster ``health`` liveness provider when one exists, and
    returns the watchdog running the stock rule catalog with windows
    sized to ``interval_s`` (the replay's scrape cadence). ``record=True``
    keeps every scrape's text for the offline ``nk_watch`` artifact.

    The store's retention is bounded at 64 scrapes — far past the widest
    stock rule window (8 intervals), and it bounds the per-tick
    evaluation cost instead of letting window scans grow with uptime
    (the recorded artifact is kept separately, so ``record=True`` still
    retains the whole run)."""
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.slo import FabricWatchdog, default_rules
    from repro_torch.obs.timeseries import SeriesStore

    reg = MetricsRegistry()
    if hasattr(engine, "migrate"):              # a cluster fabric
        reg.register_provider(engine, name="cluster")
        reg.register_provider(engine.health, name="health")
    else:
        ctrl = getattr(engine, "controller", None)
        if ctrl is None:
            raise ValueError("engine has no controller to scrape; pass a "
                             "cluster or a controller-attached engine")
        reg.register_provider(ctrl, name="controller")
        lat_fn = getattr(engine, "latency", None)
        if lat_fn is not None:
            def latency_counters():
                out = {}
                for th in lat_fn().values():
                    out.update(th.counters())
                return out
            reg.register_provider(latency_counters, name="latency")
    return FabricWatchdog(
        reg, default_rules(interval_s) if rules is None else rules,
        store=SeriesStore(retention=64), record=record,
        interval_s=interval_s)


# every name scenario_spec accepts (trace vocabulary + the cluster-only
# scenarios layered on top of it)
SCENARIOS = ("steady", "adversarial", "migration", "correlated", "ramp",
             "bursty", "consolidation", "hotspot", "stack_swap", "failover")

# scenarios that need an EngineCluster (engines >= 2) to mean anything,
# with the autopilot policy each one runs by default (None = operator-
# driven: the migration scenario fires a one-shot operator_rebalance
# event — plan_once(force=True) —, the stack_swap scenario fires two
# live swap_module events, one per plane, and the failover scenario runs
# a checkpoint/kill/recover drill — instead)
CLUSTER_SCENARIOS = {"migration": None, "consolidation": "consolidate",
                     "hotspot": "spread_hot", "stack_swap": None,
                     "failover": None}


def scenario_spec(name: str, *, n_tenants: int = 4, intervals: int = 20,
                  capacity: Optional[float] = None, seed: int = 0):
    """(trace, enforced capacity) for one named scenario — the single
    source of truth shared by ``replay_scenario``, ``bench_fairness --e2e``
    and the scenario tests.

    Loads are generated in requests/s by the shared trace vocabulary
    (``repro_torch.serve.multiplex.TRACES``) and capacities chosen so aggregate
    demand oversubscribes the bottleneck where the scenario calls for it.
    """
    per_req = TOKENS_PER_REQUEST
    if name == "steady":
        trace = mx.steady_trace(n_tenants, intervals, rps=3.0)
        demand = 3.0 * per_req * n_tenants
        cap = capacity or demand * 0.7            # mild, stable contention
    elif name in ("adversarial", "migration", "stack_swap", "failover"):
        # one spec, four drivers: "migration" is the same adversarial
        # fleet but on a multi-engine cluster, with a mid-window rebalance
        # (a live migration the Jain/isolation bounds must survive),
        # "stack_swap" hot-swaps a serve and a bytes stack module
        # mid-burst, and "failover" kills and restores an engine mid-burst
        # on a checkpoint cadence — sharing the branch keeps the hog-free
        # baseline comparable by design
        trace = mx.adversarial_trace(n_tenants, intervals, base=1.0,
                                     hog_factor=10.0)
        cap = capacity or 1.0 * per_req * (n_tenants + 3)
    elif name == "correlated":
        trace = mx.correlated_burst_trace(n_tenants, intervals, seed=seed,
                                          base=1.0, burst=6.0, period=8,
                                          width=2)
        cap = capacity or float(trace.loads.sum(axis=0).mean()) * per_req * 0.8
    elif name == "ramp":
        trace = mx.ramp_trace(n_tenants, intervals, base=2.0, peak=8.0)
        cap = capacity or float(trace.loads.sum(axis=0).mean()) * per_req * 0.7
    elif name == "bursty":
        trace = mx.bursty_trace(n_tenants, intervals, seed=seed, base=2.0,
                                burst=8.0)
        cap = capacity or float(trace.loads.sum(axis=0).mean()) * per_req * 0.7
    elif name == "consolidation":
        # busy -> shared idle window -> busy: the closed placement loop
        # should pack the idle fleet onto one engine and park the rest
        trace = mx.idle_window_trace(n_tenants, intervals, base=3.0,
                                     idle_level=0.2)
        demand = 3.0 * per_req * n_tenants
        cap = capacity or demand * 0.7            # mild, stable contention
    elif name == "hotspot":
        # everyone equal, then one tenant turns 10x mid-run: the autopilot
        # must detect the heating engine and migrate the hog on its own
        trace = mx.hotspot_trace(n_tenants, intervals, base=1.0,
                                 hog_factor=10.0)
        cap = capacity or 1.0 * per_req * (n_tenants + 3)
    else:
        raise KeyError(f"unknown scenario {name!r}; have {SCENARIOS}")
    return trace, cap


def operator_rebalance(cluster, now=None, *, pin_tenant=None):
    """One operator-triggered hot->cool rebalance, as a replay event.

    The modern spelling of the deprecated ``EngineCluster.rebalance()``
    (which delegates here, so the legacy semantics exist once): a
    one-shot ``PlacementController.plan_once(force=True)`` over the
    ``spread_hot`` policy (no bands, no cooldown, no drain gate).
    ``pin_tenant`` overrides victim selection. Returns the
    ``MigrationRecord`` of the move that landed, or None if the cluster
    was already balanced."""
    from repro_torch.control.placement import PlacementController
    pc = PlacementController(cluster, policy="spread_hot",
                             cooldown_s=0.0, drain_cost_factor=None)
    before = len(cluster.migration_log)
    pc.plan_once(now=now, pin_tenant=pin_tenant, force=True)
    if len(cluster.migration_log) == before:
        return None
    return cluster.migration_log[before]


class MaintenanceWindow:
    """Scripted engine maintenance as replay events: drain the coolest
    engine (migrate its tenants off), park it once quiesced, unpark it a
    couple of intervals later.

    The migration scenario runs one of these so a single replay exercises
    the *whole* stack-module lifecycle — migrate, drain, finalize, park
    (suspend), unpark (resume) — and its Chrome trace shows every phase
    on one timeline. ``park`` is safe to schedule on consecutive
    intervals: it no-ops until the drained engine's in-flight slots ran
    dry, and again once the engine is asleep."""

    def __init__(self):
        self.engine: Optional[int] = None
        self.parked = False

    def drain(self, cluster, now=None):
        """Pick the coolest engine and migrate every tenant off it."""
        self.engine = k = cluster.coolest_engine()
        for t, e in sorted(cluster.placement.items()):
            if e == k and t not in cluster.draining:
                dst = min((j for j in cluster.active_engines() if j != k),
                          key=lambda j: (cluster.engine_load(j), j))
                cluster.migrate(t, dst, now=now)
        return k

    def park(self, cluster, now=None):
        if self.engine is None or self.parked:
            return
        if cluster.parkable(self.engine):
            cluster.park(self.engine, now=now)
            self.parked = True

    def unpark(self, cluster, now=None):
        if self.parked:
            cluster.unpark(self.engine, now=now)
            self.parked = False


def migration_events(intervals: int):
    """The migration scenario's operator script: the mid-window
    hot->cool rebalance, then (window permitting) a maintenance
    park/unpark of the coolest engine near the end."""
    half = max(intervals // 2, 1)
    events = [(half, operator_rebalance)]
    if intervals >= half + 5:
        mw = MaintenanceWindow()
        events += [(intervals - 4, mw.drain),
                   (intervals - 3, mw.park),
                   (intervals - 2, mw.park),      # retry if still draining
                   (intervals - 1, mw.unpark)]
    return events


def swap_live_stack(cluster, plane: str, *, engine=None, now=None):
    """One live stack hot-swap, as a replay operator event — the paper's
    kernel-TCP -> mTCP move under traffic.

    On the **serve** plane the hottest engine's module is replaced by a
    variant running the OTHER scheduler policy (wfq <-> rr), serving the
    retired module's ``Model`` on its device (a swap copies no weights;
    the replacement allocates its own KV-cache, and the retired one's is
    freed with it). On the **bytes** plane the same engine slot's
    ``CoreEngine`` flips its default transport between the native ``xla``
    stack and the int8 ``compressed`` one. ``engine`` pins the slot.
    Returns the ``SwapRecord``.
    """
    from repro_torch.core.engine import CoreEngine

    if plane == "serve":
        k = cluster.hottest_engine() if engine is None else int(engine)
        old = cluster.engines[k]
        policy = "rr" if old.scheduler.policy == "wfq" else "wfq"
        if hasattr(old, "cfg"):                # a real ServeEngine
            from repro_torch.serve.engine import ServeEngine

            def factory():
                sched = TenantScheduler(
                    policy=policy,
                    charge_prompt=old.scheduler.charge_prompt)
                return ServeEngine(old.cfg, old.rcfg, old.params,
                                   batch_slots=old.B, max_seq=old.max_seq,
                                   scheduler=sched, controller=None,
                                   device=old.device)
        else:                                  # a model-free test double
            def factory():
                eng = type(old)(batch_slots=old.B)
                eng.scheduler = TenantScheduler(
                    policy=policy,
                    charge_prompt=old.scheduler.charge_prompt)
                return eng
    elif plane == "bytes":
        cores = getattr(cluster, "core_engines", None)
        if not cores:
            raise KeyError("the cluster has no bytes plane attached; "
                           "build it with core_plane=True")
        # swap beneath the hottest serve engine's paired core: placement
        # routes that slot the most collective traffic too
        k = cluster.hottest_engine() if engine is None else int(engine)
        old = cores[k]
        nsm = "compressed" if old.default_nsm != "compressed" else "xla"

        def factory():
            # the old engine's MeshAxes (or None): its process groups are
            # shared, never created again
            return CoreEngine(mesh=old.axes, default_nsm=nsm,
                              enforcement=old.enforcement)
    else:
        raise KeyError(f"unknown plane {plane!r}; have 'serve'/'bytes'")
    return cluster.swap_module(k, plane, factory, now=now)


def _byte_pump_event(cluster, now=None, *, size_bytes: int = 4096):
    """Per-interval bytes-plane traffic for the stack_swap scenario: one
    collective op per placed tenant, routed through its engine's paired
    core — so the bytes-plane swap happens under real traffic and its
    conservation assert is non-trivial."""
    from repro_torch.core.nqe import CommOp

    cores = getattr(cluster, "core_engines", None)
    if not cores:
        return
    t_now = 0.0 if now is None else float(now)
    failed = getattr(cluster, "failed", ())
    for t, k in sorted(cluster.placement.items()):
        if k in failed:
            continue       # a dark slot takes no collective traffic
        op = CommOp(verb="psum", axes=("pod",), tenant_id=t,
                    size_bytes=size_bytes)
        cores[k].admit(op, t_now)
        cores[k].route(op)


def stack_swap_events(intervals: int):
    """The stack_swap scenario's operator script: collective traffic every
    interval, a live serve-plane swap a third of the way in (mid-burst,
    on the hottest engine), and a bytes-plane swap (native xla ->
    compressed int8 transport) two thirds in."""
    serve_at = max(intervals // 3, 1)
    bytes_at = max(2 * intervals // 3, serve_at + 1)
    events = [(i, _byte_pump_event) for i in range(intervals)]
    events += [
        (serve_at, lambda cl, now=None: swap_live_stack(cl, "serve",
                                                        now=now)),
        (bytes_at, lambda cl, now=None: swap_live_stack(cl, "bytes",
                                                        now=now)),
    ]
    return events


class FailoverDrill:
    """Scripted kill-and-restore failover as replay events: checkpoint
    the whole fabric on a fixed cadence, crash the hottest engine
    mid-burst, recover it from the last ``FabricSnapshot`` two intervals
    later — the admission gap buffered in between replays on recovery.

    Cadence ticks that land while the slot is dark (or mid-drain) are
    skipped: ``EngineCluster.checkpoint`` refuses both, by contract."""

    def __init__(self):
        self.snapshot = None
        self.engine: Optional[int] = None

    def checkpoint(self, cluster, now=None):
        if getattr(cluster, "failed", None) or cluster.draining:
            return
        self.snapshot = cluster.checkpoint(now=now)

    def fail(self, cluster, now=None):
        if self.snapshot is None:
            raise RuntimeError(
                "failover drill fired fail before any checkpoint")
        self.engine = cluster.hottest_engine()
        cluster.fail_engine(self.engine, now=now)

    def recover(self, cluster, now=None):
        cluster.recover_engine(self.engine, self.snapshot, now=now)


# checkpoint cadence of the failover drill, in trace intervals — "one
# checkpoint interval", the unit the token-loss bound is stated in
FAILOVER_CHECKPOINT_EVERY = 3


def failover_events(intervals: int, *, pump=None):
    """The failover scenario's operator script: collective traffic every
    interval, a fabric checkpoint every ``FAILOVER_CHECKPOINT_EVERY``
    intervals, a crash of the hottest engine ~2/5 of the way in — nudged
    OFF the checkpoint cadence, so real work lands between the last
    snapshot and the kill and the measured token loss is non-trivial —
    and recovery from that snapshot two intervals later. ``pump``
    overrides the per-interval bytes-plane traffic event (the bench
    passes an instrumented pump that counts what it routed)."""
    drill = FailoverDrill()
    every = FAILOVER_CHECKPOINT_EVERY
    events = [(i, pump or _byte_pump_event) for i in range(intervals)]
    events += [(i, drill.checkpoint) for i in range(1, intervals, every)]
    fail_at = max(2 * intervals // 5, 2)
    if (fail_at - 1) % every == 0:      # keep the kill off the cadence
        fail_at += 1
    recover_at = min(fail_at + 2, intervals - 1)
    events += [(fail_at, drill.fail), (recover_at, drill.recover)]
    return events


# row index of the misbehaver in the adversarial trace (multiplex's default)
ADVERSARIAL_HOG = -1


def adversarial_baseline(trace: Trace) -> Trace:
    """The adversarial fleet with the misbehaver removed — the hog-free
    baseline isolation claims compare against. One definition, so the hog
    row index can never silently diverge between bench and tests."""
    return Trace(loads=np.delete(trace.loads, ADVERSARIAL_HOG, axis=0))


def replay_scenario(name: str, *, n_tenants: int = 4, intervals: int = 20,
                    capacity: Optional[float] = None, engine=None,
                    push_mode: str = "full", weights=None,
                    seed: int = 0, engines: Optional[int] = None,
                    autopilot=None, core_plane: bool = False,
                    trace_path=None, watch=None,
                    backend: str = "object", device=None) -> ReplayReport:
    """Run one named scenario end-to-end and return the measured report.

    ``engine``: a ready engine or ``EngineCluster`` to drive (built when
    None, on ``device``: ``cuda`` unless ``"cpu"`` is passed).

    ``engines`` > 1 drives an ``EngineCluster`` (N ServeEngines behind one
    shared controller) instead of a single engine; None picks the
    scenario's natural scale (3 engines for the cluster scenarios, 1
    otherwise). The ``migration`` scenario requires a cluster: mid-window
    the operator rebalances the hottest engine, and near the end a
    maintenance window drains, parks and unparks the coolest one — one
    replay exercises the whole stack-module lifecycle. The ``stack_swap``
    scenario hot-swaps live stack modules mid-burst (a serve-plane
    scheduler variant a third of the way in, a bytes-plane native ->
    compressed transport two thirds in) with collective traffic pumped
    every interval; it forces ``core_plane=True``. The ``failover``
    scenario checkpoints the fabric every third interval, kills the
    hottest engine mid-burst and recovers it from the last snapshot two
    intervals later (gap replayed, conservation asserted on every
    plane); it also forces ``core_plane=True`` so the crash spans both
    planes.

    ``autopilot`` closes the placement loop on the cluster (policy name or
    a ``PlacementController``); the ``consolidation`` and ``hotspot``
    scenarios run their natural policy by default — no operator events,
    the loop finds the moves itself. ``core_plane`` attaches a bytes-plane
    CoreEngine per ServeEngine so every move carries both planes.

    ``trace_path``: write the run's flight-recorder timeline (Chrome
    trace-event JSON, loadable in Perfetto) to this path. A recording
    tracer is installed for the duration of the run and restored after.

    ``watch``: attach the fabric watchdog so the scenario doubles as an
    alert-precision fixture. ``True`` builds the stock one over the
    engine (``make_watchdog``); or pass a ready ``FabricWatchdog``
    (e.g. one constructed with ``record=True`` to keep the scrape
    sequence). The registry is scraped at every interval boundary and
    the report's ``alerts*`` fields carry the outcome — steady fires
    zero, adversarial fires fairness burn on the hog, failover fires
    and resolves engine-dark (bench claim (k) pins all three).

    ``backend="vectorized"`` runs the whole control plane on the array
    backend (scheduler bucket store, telemetry EWMA banks, the water-fill
    kernel); every scenario claim must hold unchanged.
    """
    from repro_torch.obs.tracing import trace_to

    # fail fast, before any engine construction
    needs_cluster = name in CLUSTER_SCENARIOS
    if engines is None:
        engines = 3 if (needs_cluster and engine is None) else 1
    if needs_cluster and (engines < 2 if engine is None
                          else not hasattr(engine, "migrate")):
        raise ValueError(f"the {name} scenario needs a cluster: "
                         f"pass engines >= 2 (or an EngineCluster)")
    if autopilot is None:
        autopilot = CLUSTER_SCENARIOS.get(name)
    if name in ("stack_swap", "failover"):
        # stack_swap swaps one module per plane and failover crashes both
        # planes at once, so the bytes plane must exist (and carry
        # traffic — see the scenarios' shared byte pump)
        core_plane = True
    trace, cap = scenario_spec(name, n_tenants=n_tenants,
                               intervals=intervals, capacity=capacity,
                               seed=seed)
    eng = engine
    if eng is None:
        if engines > 1:
            eng = make_replay_cluster(capacity=cap, engines=engines,
                                      push_mode=push_mode, weights=weights,
                                      autopilot=autopilot,
                                      core_plane=core_plane,
                                      backend=backend, device=device)
        else:
            eng = make_replay_engine(capacity=cap, push_mode=push_mode,
                                     weights=weights, backend=backend,
                                     device=device)
    elif autopilot is not None and getattr(eng, "autopilot", None) is None \
            and hasattr(eng, "attach_autopilot"):
        from repro_torch.control.placement import PlacementController
        if isinstance(autopilot, str):
            kw = {"ceiling": 0.375 * cap} if autopilot == "consolidate" \
                else {}
            autopilot = PlacementController(eng, policy=autopilot, **kw)
        eng.attach_autopilot(autopilot)
    events = None
    if name == "migration":
        events = migration_events(intervals)
    elif name == "stack_swap":
        events = stack_swap_events(intervals)
    elif name == "failover":
        events = failover_events(intervals)
    rep = TraceReplayer(eng, capacity=cap, weights=weights)
    wd = watch
    if wd is True or wd == "record":
        # the replayer's clock overshoots each interval by up to one
        # step_dt, so the *effective* scrape period is what the rule
        # windows must be sized to — else a "3-interval" window holds
        # fewer scrapes than designed and the absence rules go blind
        wd = make_watchdog(eng,
                           interval_s=rep.interval_s + rep.step_dt,
                           record=(wd == "record"))
    rep.watchdog = wd or None
    if trace_path is None:
        return rep.run(trace, events=events)
    with trace_to() as tr:
        report = rep.run(trace, events=events)
    tr.write(trace_path)
    return report
