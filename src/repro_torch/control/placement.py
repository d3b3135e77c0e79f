"""PlacementController: the closed loop from observed load to *where*
tenants run. The counterpart of ``repro/control/placement.py``.

``RateController`` closes the rate loop — it decides *how fast* each tenant
goes on a shared bottleneck. This module closes the placement loop — the
paper's other operator win: because the stack is infrastructure, the
operator can multiplex tenants onto fewer network-stack modules to save
cores, and rebalance the mapping when load shifts, without the guests
noticing. A ``PlacementController`` runs on a cadence next to the rate
controller, consumes the same telemetry (per-engine load, per-tenant
tokens/s, queue depth), and emits ``PlacementPlan``s under a pluggable
``PlacementPolicy``:

  * ``consolidate`` — pack tenants onto the fewest engines that fit a
    per-engine load ceiling; engines left empty *park* (the cluster "saves
    cores", the paper's Table-2 multiplexing claim, now closed-loop).
    Parked engines unpark automatically when load returns.
  * ``spread_hot`` — hot-engine detection with hysteresis bands (a move
    needs the hot/cool gap to exceed an entry band AND to actually shrink
    the cluster's max load), so tenants don't ping-pong between engines.

Two gates apply to every planned move, independent of policy:

  * a per-tenant **cooldown** (the hysteresis window): a tenant that just
    moved cannot move again for ``cooldown_s`` virtual seconds — the
    no-ping-pong guarantee is enforced here, centrally;
  * a **drain-cost model**: migration leaves in-flight slots draining on
    the source, so a move whose drain window (in-flight tokens still to be
    generated) exceeds the expected gain (queued tokens that would start
    serving at the destination) is skipped — it would cost more than it
    relieves.

The controller is duck-typed over ``EngineCluster`` (anything with
``engines``, ``placement``, ``draining``, ``parked``, ``engine_load``,
``apply_plan``), and reads per-tenant pressure through the serve module's
``StackModule.tenant_load`` (the fabric package) — the drain-cost gate prices
moves from the same protocol surface migration uses, never from a
concrete engine's slots — so policies can be unit-tested on a hand-built
``ClusterView`` with no model anywhere near the test.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Tuple

from repro_torch.control.telemetry import SchedulerTelemetry, merge_obs
from repro_torch.obs import tracing

# an idle tenant still occupies a placement slot: give it a tiny demand so
# bin-packing keeps it *somewhere* instead of dividing by zero around it
_DEMAND_FLOOR = 1e-6


# ---------------------------------------------------------------------------
# The policy input: one consistent snapshot of the cluster
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ClusterView:
    """Everything a placement policy may look at, snapshotted at plan time.

    Units: ``demand`` is tokens/s (EWMA of served rate — the same signal
    ``SchedulerTelemetry`` feeds the rate loop); ``engine_load`` and
    ``pending`` are requests (queued + in-flight — the instantaneous
    pressure ``EngineCluster.engine_load`` reports); ``queued_cost`` and
    ``inflight_remaining`` are tokens (the drain-cost model's unit).
    """

    n_engines: int
    parked: FrozenSet[int]
    placement: Dict[int, int]              # tenant -> engine index
    draining: FrozenSet[int]               # tenants mid-drain (unmovable)
    engine_load: Tuple[float, ...]         # per-engine queued + in-flight
    demand: Dict[int, float]               # tenant -> tokens/s (EWMA)
    pending: Dict[int, int]                # tenant -> queued requests
    queued_cost: Dict[int, float]          # tenant -> queued tokens
    inflight_remaining: Dict[int, float]   # tenant -> tokens still in-flight

    def active_engines(self) -> List[int]:
        return [k for k in range(self.n_engines) if k not in self.parked]

    def tenants_on(self, k: int) -> List[int]:
        return sorted(t for t, e in self.placement.items() if e == k)

    def movable(self, tenant: int) -> bool:
        return tenant not in self.draining


# ---------------------------------------------------------------------------
# The policy output
# ---------------------------------------------------------------------------


@dataclass
class PlannedMove:
    """One tenant relocation a policy wants."""

    tenant: int
    src: int
    dst: int
    reason: str                      # policy name that asked for it
    expected_gain: float = 0.0       # tokens the move starts serving sooner
    drain_cost: float = 0.0          # tokens still draining on the source


@dataclass
class PlacementPlan:
    """A policy's desired delta: moves + park/unpark lifecycle changes.

    ``unpark`` engines wake BEFORE moves apply (a move may target one);
    ``park`` engines sleep AFTER (they must be empty by then). An empty
    plan (no moves, no lifecycle changes) is a no-op the controller does
    not even hand to the cluster.
    """

    moves: List[PlannedMove] = field(default_factory=list)
    park: List[int] = field(default_factory=list)
    unpark: List[int] = field(default_factory=list)

    @property
    def empty(self) -> bool:
        return not (self.moves or self.park or self.unpark)


# ---------------------------------------------------------------------------
# Policies
# ---------------------------------------------------------------------------


class PlacementPolicy:
    """Maps one ``ClusterView`` to the ``PlacementPlan`` it wants.

    Policies are pure selection logic: the controller owns the hysteresis
    cooldown and the drain-cost gate, so every policy gets the same
    no-ping-pong guarantee for free.
    """

    name = "noop"

    def plan(self, view: ClusterView, now: float) -> PlacementPlan:
        raise NotImplementedError


class Consolidate(PlacementPolicy):
    """Pack tenants onto the fewest engines that fit ``ceiling`` tokens/s.

    First-fit-decreasing with a stickiness preference: a tenant stays on
    its current engine whenever that engine is open and still fits it, and
    a new bin to open is the tenant's own engine when possible — both keep
    steady state move-free. Engines hosting nothing after the pack are
    parked (cores saved); parked engines are unparked on demand when the
    open set no longer fits the fleet.

    Demand is each tenant's EWMA served rate *plus its backlog pressure*
    (queued tokens / ``queue_horizon_s``). The queue term is what makes
    the loop see through saturation: a fleet packed onto one engine serves
    at that engine's capacity no matter how much load returns, so the
    served rate alone would keep claiming the pack still fits — the
    growing queues are the only signal that it does not.

    Args:
        ceiling: per-engine demand ceiling in tokens/s. A fleet that
            cannot fit under the ceiling even with every engine awake
            overflows onto the least-loaded open engine (placement must
            never refuse a tenant).
        queue_horizon_s: backlog-to-rate conversion window, seconds: a
            queue is priced as the rate needed to clear it this fast.
    """

    name = "consolidate"

    def __init__(self, ceiling: float, queue_horizon_s: float = 4.0):
        if ceiling <= 0:
            raise ValueError("consolidate needs a positive tokens/s ceiling")
        self.ceiling = float(ceiling)
        self.queue_horizon_s = float(queue_horizon_s)

    def plan(self, view: ClusterView, now: float) -> PlacementPlan:
        demand = {t: max(view.demand.get(t, 0.0)
                         + view.queued_cost.get(t, 0.0)
                         / self.queue_horizon_s, _DEMAND_FLOOR)
                  for t in view.placement}
        # draining tenants cannot move: their engine stays open with their
        # demand pre-committed, whatever the pack decides
        fill: Dict[int, float] = {}
        open_bins: List[int] = []
        for t in sorted(view.placement):
            if not view.movable(t):
                k = view.placement[t]
                fill[k] = fill.get(k, 0.0) + demand[t]
                if k not in open_bins:
                    open_bins.append(k)
        target: Dict[int, int] = {}
        order = sorted((t for t in view.placement if view.movable(t)),
                       key=lambda t: (-demand[t], t))

        def fits(k: int, d: float) -> bool:
            return fill.get(k, 0.0) + d <= self.ceiling

        def openable() -> List[int]:
            return [k for k in range(view.n_engines) if k not in open_bins]

        for t in order:
            cur, d = view.placement[t], demand[t]
            if cur in open_bins and fits(cur, d):
                k = cur                              # stickiness: stay put
            else:
                k = next((b for b in open_bins if fits(b, d)), None)
                if k is None:
                    cands = openable()
                    if cands:
                        # opening the tenant's own engine is a free "move"
                        k = cur if cur in cands else cands[0]
                        open_bins.append(k)
                    else:
                        # overload: every engine is open and none fits —
                        # spill onto the least-loaded (placement never
                        # refuses; the rate loop handles the oversubscribe).
                        # Ties prefer the tenant's current engine so an
                        # equal-fill spill does not oscillate tick to tick.
                        k = min(open_bins,
                                key=lambda b: (fill.get(b, 0.0),
                                               b != cur, b))
            fill[k] = fill.get(k, 0.0) + d
            target[t] = k

        plan = PlacementPlan()
        for t, k in sorted(target.items()):
            src = view.placement[t]
            if k != src:
                plan.moves.append(PlannedMove(
                    tenant=t, src=src, dst=k, reason=self.name,
                    expected_gain=view.queued_cost.get(t, 0.0),
                    drain_cost=view.inflight_remaining.get(t, 0.0)))
        used = set(open_bins)
        plan.unpark = sorted(k for k in used if k in view.parked)
        plan.park = sorted(k for k in view.active_engines()
                           if k not in used)
        return plan


class SpreadHot(PlacementPolicy):
    """Move the most-backlogged tenant off a hot engine — with hysteresis.

    An engine is *hot* only when its load clears an absolute floor
    (``min_hot_load`` requests — small-queue jitter never triggers a move)
    AND exceeds the coolest engine by the entry band (``enter_ratio``).

    Ping-pong is prevented by two guards working together:

      * **arming (the hysteresis band)** — every tenant starts *armed*;
        moving it disarms it, and it only re-arms once it is observed on
        an engine whose load fell below the exit band (``exit_load``).
        A hog whose backlog makes every engine it touches hot therefore
        migrates exactly once: its new engine never cools, so it never
        re-arms, and the classic "the maximum moves with the tenant"
        oscillation cannot start.
      * **usefulness** — the move must either relieve a co-located tenant
        (the hot engine hosts someone besides the victim: de-colocation,
        the hog-vs-neighbour case) or improve the balance by a real margin
        (``cool_load + moved_queue <= (1 - improvement) * hot_load``) —
        a lone hog fails both (its queue IS the maximum, wherever it
        sits), so it is never bounced around.

    Args:
        enter_ratio: hot/cool load ratio that opens the band (>= 1).
        min_hot_load: absolute queued+in-flight floor before anything is
            considered hot, in requests.
        exit_load: engine load below which a disarmed tenant placed there
            re-arms (defaults to ``min_hot_load`` — enter high/exit low).
        improvement: required relative drop of the max load for a
            balance-motivated (no co-tenant) move.
    """

    name = "spread_hot"

    def __init__(self, enter_ratio: float = 2.0, min_hot_load: float = 8.0,
                 exit_load: Optional[float] = None,
                 improvement: float = 0.1):
        if enter_ratio < 1.0:
            raise ValueError("enter_ratio must be >= 1")
        self.enter_ratio = float(enter_ratio)
        self.min_hot_load = float(min_hot_load)
        self.exit_load = float(exit_load if exit_load is not None
                               else min_hot_load)
        self.improvement = float(improvement)
        self._disarmed: set = set()

    def _rearm(self, view: ClusterView) -> None:
        for t in list(self._disarmed):
            k = view.placement.get(t)
            if k is None or view.engine_load[k] < self.exit_load:
                self._disarmed.discard(t)

    def _victim(self, view: ClusterView, hot: int) -> Optional[int]:
        cands = [t for t in view.tenants_on(hot)
                 if view.movable(t) and t not in self._disarmed]
        if not cands:
            return None
        # most backlogged wins; ties break to the smaller tenant id
        return max(cands, key=lambda t: (view.pending.get(t, 0), -t))

    def notify_moved(self, tenant: int) -> None:
        """Controller callback: an applied move disarms its tenant until
        the engine it lives on cools below the exit band."""
        self._disarmed.add(tenant)

    def plan(self, view: ClusterView, now: float, *,
             pin_tenant: Optional[int] = None,
             force: bool = False) -> PlacementPlan:
        """``force`` bypasses bands, arming and the usefulness guard —
        the legacy one-shot ``rebalance()`` semantics (hot -> cool,
        unconditionally). ``pin_tenant`` overrides victim selection."""
        self._rearm(view)
        active = view.active_engines()
        if len(active) < 2:
            return PlacementPlan()
        hot = max(active, key=lambda k: (view.engine_load[k], -k))
        cool = min(active, key=lambda k: (view.engine_load[k], k))
        if hot == cool:
            return PlacementPlan()
        hot_load, cool_load = view.engine_load[hot], view.engine_load[cool]
        if not force:
            if hot_load < self.min_hot_load:
                return PlacementPlan()
            if hot_load < self.enter_ratio * max(cool_load, 1.0):
                return PlacementPlan()
        if pin_tenant is not None:
            victim = pin_tenant if view.movable(pin_tenant) else None
        else:
            victim = self._victim(view, hot)
        if victim is None or victim not in view.placement:
            return PlacementPlan()
        if view.placement[victim] != hot and not force:
            return PlacementPlan()
        src = view.placement[victim]
        if src == cool:
            return PlacementPlan()
        if not force:
            # what actually moves is the unserved queue — in-flight slots
            # drain on the source — so the transferable load is pending
            moved = float(view.pending.get(victim, 0))
            relieves_cotenant = len(view.tenants_on(src)) >= 2
            improves_balance = cool_load + moved <= \
                (1.0 - self.improvement) * hot_load
            if not (relieves_cotenant or improves_balance):
                return PlacementPlan()
        mv = PlannedMove(
            tenant=victim, src=src, dst=cool, reason=self.name,
            expected_gain=view.queued_cost.get(victim, 0.0),
            drain_cost=view.inflight_remaining.get(victim, 0.0))
        return PlacementPlan(moves=[mv])


PLACEMENT_POLICIES = {
    Consolidate.name: Consolidate,
    SpreadHot.name: SpreadHot,
}


def make_policy(policy, **kw) -> PlacementPolicy:
    """``policy``: a registry name ('consolidate' needs ``ceiling=``) or
    any object with a ``plan(view, now)`` method (returned as-is; kwargs
    must be empty — they only configure registry construction)."""
    if not isinstance(policy, str):
        if not hasattr(policy, "plan"):
            raise TypeError(f"{policy!r} is not a placement policy "
                            f"(no plan() method)")
        if kw:
            raise ValueError("policy kwargs only apply to registry names")
        return policy
    try:
        cls = PLACEMENT_POLICIES[policy]
    except KeyError:
        raise KeyError(f"unknown placement policy {policy!r}; "
                       f"have {sorted(PLACEMENT_POLICIES)}") from None
    return cls(**kw)


# ---------------------------------------------------------------------------
# The controller: telemetry -> policy -> gated application
# ---------------------------------------------------------------------------


class PlacementController:
    """Closed-loop placement next to the rate loop.

    Ticked by the cluster on a cadence (``EngineCluster(place_every=...)``,
    exactly how the shared ``RateController`` is ticked), or driven
    manually via ``plan_once``. Each tick: sample per-engine scheduler
    telemetry (the same ``SchedulerTelemetry`` the rate loop reads), build
    a ``ClusterView``, ask the policy for a plan, gate its moves through
    the hysteresis cooldown and the drain-cost model, and apply what
    survives via ``cluster.apply_plan`` (every applied move runs through
    ``migrate()``'s ledger-conserving drain-and-transfer).

    Args:
        cluster: an ``EngineCluster`` (or anything duck-typing it).
        policy: a ``PlacementPolicy`` instance or registry name; policy
            constructor kwargs ride in ``**policy_kw`` when a name is
            given (``consolidate`` requires ``ceiling=`` tokens/s).
        cooldown_s: the hysteresis window, virtual seconds — a tenant
            never moves twice within one window (0 disables).
        drain_cost_factor: skip a move when its drain cost exceeds
            ``factor`` x its expected gain (tokens vs tokens; None
            disables the gate). Factor 1.0 = "the move must relieve at
            least as many tokens as it strands draining".
        alpha: EWMA gain for the per-tenant tokens/s demand signal.
    """

    def __init__(self, cluster, policy="spread_hot", *,
                 cooldown_s: float = 3.0,
                 drain_cost_factor: Optional[float] = 1.0,
                 alpha: float = 0.5, **policy_kw):
        self.cluster = cluster
        self.policy = make_policy(policy, **policy_kw)
        self.cooldown_s = float(cooldown_s)
        self.drain_cost_factor = drain_cost_factor
        self._tel = [SchedulerTelemetry(e.scheduler, alpha)
                     for e in cluster.engines]
        self.last_move: Dict[int, float] = {}      # tenant -> virtual time
        self.move_log: List[Tuple[float, PlannedMove]] = []
        self.ticks = 0
        self.plans_applied = 0
        self.moves_applied = 0
        self.moves_skipped_cooldown = 0
        self.moves_skipped_drain = 0
        self.parks = 0
        self.unparks = 0

    # -- observation --------------------------------------------------------
    def view(self, now: Optional[float] = None) -> ClusterView:
        """Sample telemetry and snapshot the cluster for the policy.

        Per-tenant pressure comes from the serve module's
        ``StackModule.tenant_load`` — the same protocol surface migration
        uses — so the controller never reaches into a concrete engine's
        slot machinery."""
        obs = merge_obs([tel.update(now) for tel in self._tel])
        cl = self.cluster
        demand = {t: obs[t].rate if t in obs else 0.0
                  for t in cl.placement}
        pending: Dict[int, int] = {}
        queued: Dict[int, float] = {}
        inflight: Dict[int, float] = {}
        for t, k in cl.placement.items():
            tl = cl.engines[k].tenant_load(t)
            pending[t] = tl.pending
            queued[t] = float(tl.queued_tokens)
            inflight[t] = float(tl.inflight_tokens)
        return ClusterView(
            n_engines=len(cl.engines),
            parked=frozenset(getattr(cl, "parked", ())),
            placement=dict(cl.placement),
            draining=frozenset(cl.draining),
            engine_load=tuple(cl.engine_load(k)
                              for k in range(len(cl.engines))),
            demand=demand, pending=pending, queued_cost=queued,
            inflight_remaining=inflight)

    # -- gates --------------------------------------------------------------
    def _gate(self, plan: PlacementPlan, now: float) -> PlacementPlan:
        """Apply the cooldown + drain-cost gates; lifecycle changes for
        engines that only existed to receive a gated move are dropped."""
        kept: List[PlannedMove] = []
        for mv in plan.moves:
            since = now - self.last_move.get(mv.tenant, -float("inf"))
            if self.cooldown_s > 0 and since < self.cooldown_s:
                self.moves_skipped_cooldown += 1
                continue
            if self.drain_cost_factor is not None and mv.drain_cost > \
                    self.drain_cost_factor * max(mv.expected_gain, 0.0):
                self.moves_skipped_drain += 1
                continue
            kept.append(mv)
        if len(kept) != len(plan.moves):
            # a gated move leaves its tenant where it is: engines the plan
            # wanted to park may no longer be empty, and unparks that only
            # served a gated move may be pointless — recompute both
            staying = {mv.tenant for mv in plan.moves} - \
                {mv.tenant for mv in kept}
            occupied = {self.cluster.placement[t] for t in staying}
            plan = PlacementPlan(
                moves=kept,
                park=[k for k in plan.park if k not in occupied],
                unpark=[k for k in plan.unpark
                        if any(mv.dst == k for mv in kept)])
        return plan

    # -- the loop body ------------------------------------------------------
    def tick(self, now: Optional[float] = None) -> PlacementPlan:
        """One placement interval: observe -> plan -> gate -> apply.

        ``now``: seconds (virtual or wall clock; defaults to the wall
        clock, like ``RateController.tick`` — never a fabricated 0.0,
        which would re-anchor migrated buckets at t=0 and mint a full
        fresh burst for wall-clock callers). Returns the plan that was
        applied (possibly empty)."""
        self.ticks += 1
        now = time.monotonic() if now is None else float(now)
        view = self.view(now)
        plan = self._gate(self.policy.plan(view, now), now)
        if tracing.TRACER.enabled:
            tracing.TRACER.instant(
                "placement", "placement.plan", now,
                policy=self.policy.name, moves=len(plan.moves),
                park=len(plan.park), unpark=len(plan.unpark))
        self._apply(plan, now)
        return plan

    def plan_once(self, now: Optional[float] = None, *,
                  pin_tenant: Optional[int] = None,
                  force: bool = False) -> PlacementPlan:
        """One-shot planning (the deprecated ``rebalance()`` path).

        ``force`` bypasses bands/improvement/cooldown/drain gates —
        byte-for-byte the old operator one-shot semantics. Only
        ``spread_hot`` supports pinning/forcing."""
        now = time.monotonic() if now is None else float(now)
        view = self.view(now)
        if isinstance(self.policy, SpreadHot):
            plan = self.policy.plan(view, now, pin_tenant=pin_tenant,
                                    force=force)
        else:
            plan = self.policy.plan(view, now)
        if not force:
            plan = self._gate(plan, now)
        if tracing.TRACER.enabled:
            tracing.TRACER.instant(
                "placement", "placement.plan", now,
                policy=self.policy.name, moves=len(plan.moves),
                park=len(plan.park), unpark=len(plan.unpark),
                one_shot=True)
        self._apply(plan, now)
        return plan

    def _apply(self, plan: PlacementPlan, now: float) -> None:
        if plan.empty:
            return
        records = self.cluster.apply_plan(plan, now=now)
        applied = {r.tenant for r in records}
        notify = getattr(self.policy, "notify_moved", None)
        for mv in plan.moves:
            if mv.tenant in applied:
                self.last_move[mv.tenant] = now
                self.move_log.append((now, mv))
                self.moves_applied += 1
                if notify is not None:
                    notify(mv.tenant)
        self.parks += len(plan.park)
        self.unparks += len(plan.unpark)
        self.plans_applied += 1

    # -- invariants ---------------------------------------------------------
    def assert_no_ping_pong(self) -> None:
        """No tenant ever moved twice within one hysteresis window — the
        guarantee the cooldown gate enforces, checkable after a run."""
        seen: Dict[int, float] = {}
        for when, mv in self.move_log:
            prev = seen.get(mv.tenant)
            if prev is not None and when - prev < self.cooldown_s:
                raise AssertionError(
                    f"tenant {mv.tenant} ping-ponged: moved at {prev:.3f} "
                    f"and again at {when:.3f} inside the "
                    f"{self.cooldown_s}s hysteresis window")
            seen[mv.tenant] = when

    # -- reporting ----------------------------------------------------------
    def counters(self) -> Dict[str, float]:
        return {
            "nk_placement_ticks_total": float(self.ticks),
            "nk_placement_plans_applied_total": float(self.plans_applied),
            "nk_placement_moves_total": float(self.moves_applied),
            "nk_placement_moves_skipped_cooldown_total":
                float(self.moves_skipped_cooldown),
            "nk_placement_moves_skipped_drain_total":
                float(self.moves_skipped_drain),
            "nk_placement_parks_total": float(self.parks),
            "nk_placement_unparks_total": float(self.unparks),
        }
