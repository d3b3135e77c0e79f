"""EngineCluster: one controller, N stack modules per plane, live migration.

The counterpart of ``repro/serve/cluster.py``. On a card the engines share
one copy of the weights (one ``Model``) and step one after another on the
default stream; each holds its own KV-cache, which parking frees.

The paper's operator owns the stack as *infrastructure*: many guests
multiplex onto shared stack modules, and the operator can rebalance that
mapping at will — including moving a tenant between modules without the
guest noticing. This module is that placement power, written against the
``StackModule`` protocol (the fabric package) rather than any concrete
engine:

  * N live ``ServeEngine``s (think: NSMs on different hosts) behind ONE
    shared ``RateController``. The controller's water-fill runs over the
    merged telemetry of every engine's scheduler — one tokens/s bottleneck
    spanning the cluster — and splits each tenant's global allocation
    across engines in proportion to where its traffic shows up.
  * a tenant -> engine ``placement`` map the operator controls. New
    tenants auto-place on the least-loaded engine; ``migrate`` moves a
    live tenant mid-replay.
  * optional extra planes: ``core_engines`` pairs each ServeEngine with a
    bytes-plane ``CoreEngine``; one migration then moves the tenant's
    serve *and* collective state through the same protocol calls.

Migration is drain-and-transfer, and conserves every plane's ledger:

  1. each plane's module exports the tenant (``StackModule.export_tenant``:
     unserved queue, WFQ weight, token-bucket *level* on the serve plane;
     bucket level + flattened counters on the bytes plane) and the
     destination module imports it (a move can never reopen a fresh burst);
  2. the source's cumulative counters fold into the plane's
     ``ConservationLedger`` carried view, so the global view never jumps
     (telemetry on the source sees a counter reset, not a negative rate);
  3. in-flight slots are NOT moved: they finish — and bill — where they
     were admitted; the tenant is ``draining`` until they run dry, then
     the residual billing folds and the migration finalizes.

Each plane's ``ConservationLedger`` pins carried + live counters against
the modules' summed billed ground truth — ONE assert implementation for
both planes, invoked on every move (no lost tokens or bytes, no
double-billing).

Two closed-loop extensions sit on top of the migration primitive:

  * **park/unpark lifecycle** — a quiesced engine can be parked: it stops
    stepping (the cluster "saves cores", the paper's multiplexing claim)
    AND its modules ``suspend()`` — the KV-cache, slot table and scratch
    are dropped, so parking saves *memory* too. ``unpark`` resumes the
    modules (cache re-init is lazy: it re-materializes on the first
    admission). ``parked_engine_steps`` and ``mem_saved_byte_steps``
    accumulate the savings; at least one engine always stays awake.
  * **autopilot** — an attached ``PlacementController``
    (``control/placement.py``) is ticked every ``place_every`` steps,
    exactly how the shared RateController is ticked, and applies its
    plans through ``apply_plan`` -> ``migrate``: the placement loop runs
    closed, next to the rate loop.
  * **checkpoint / kill-and-restore failover** — ``checkpoint()``
    captures the whole fabric as one versioned ``FabricSnapshot``
    (``fabric/checkpoint.py``); ``fail_engine`` simulates a crash (module
    state wiped in place, in-flight slots lost, admissions gap-buffered)
    and ``recover_engine`` re-materializes the slot from its last
    snapshot, replays the gap and re-asserts conservation on every
    plane — the work lost is bounded by one checkpoint interval.
    ``restore()`` is the full-fabric reset to a snapshot.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.control.telemetry import format_prometheus
from repro_torch.fabric import (
    FABRIC_SNAPSHOT_VERSION, FabricSnapshot, ModuleSnapshot, PlaneSnapshot,
    StackPlane, TenantState,
)
from repro_torch.obs import tracing
from repro_torch.obs.hist import TenantHistograms
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import Request


@dataclass
class MigrationRecord:
    """One migrate() call, for the operator's audit log."""

    tenant: int
    src: int                      # engine index the tenant left
    dst: int                      # engine index it moved to
    started_step: int             # cluster step count at the move
    queued_moved: int             # unserved requests transferred
    inflight_at_move: int         # slots left draining on the source
    bucket_tokens_moved: float    # token-bucket level transferred (tokens)
    finalized_step: int = -1      # -1 while the source is still draining

    @property
    def finalized(self) -> bool:
        return self.finalized_step >= 0


@dataclass
class SwapRecord:
    """One swap_module() call — a live stack hot-swap — for the audit log.

    The paper's flagship move (kernel TCP -> mTCP under an unmodified
    guest): the module serving one engine slot is replaced in place,
    under traffic, with every tenant transferred across the boundary and
    the plane's conservation ledger unchanged.
    """

    engine: int                   # engine slot swapped in place
    plane: str                    # plane name ("serve", "bytes", ...)
    step: int                     # cluster step count at the swap
    tenants: Tuple[int, ...]      # tenants transferred across the boundary
    inflight_at_swap: int         # slots quiesced before the transfer
    quiesce_steps: int            # extra engine steps the quiesce ran
    old_stack: str                # descriptor of the retired module
    new_stack: str                # descriptor of the replacement


@dataclass
class FailureRecord:
    """One fail_engine() crash (and its recovery), for the audit log.

    ``tokens_lost`` is the serve-plane ground truth billed between the
    restored checkpoint and the crash — the work a kill-and-restore
    failover genuinely loses, bounded by one checkpoint interval. It is
    -1.0 until ``recover_engine`` computes it against the snapshot it
    restored from.
    """

    engine: int                   # engine slot that crashed
    step: int                     # cluster step count at the crash
    inflight_lost: int            # decode slots lost with the crash
    queued_lost: int              # queued requests lost with the crash
    gt_at_crash: Dict[int, float]  # serve billed ground truth at crash
    tokens_lost: float = -1.0     # gt billed after the restored snapshot
    recovered_step: int = -1      # -1 while the slot is still dark

    @property
    def recovered(self) -> bool:
        return self.recovered_step >= 0


class ClusterLedger:
    """Duck-types the ``TenantScheduler`` ledger surface over a cluster.

    ``TraceReplayer`` (and anything else written against one scheduler's
    ledgers) reads per-tenant counters through this facade and sees the
    cluster-global view: carried (migrated-away) history plus the live
    counters of every engine, so a tenant's numbers are continuous across
    migrations.
    """

    def __init__(self, cluster: "EngineCluster"):
        self._cluster = cluster

    @property
    def queues(self) -> Dict[int, int]:
        """Known tenants (tenant -> engine index) — membership view."""
        return dict(self._cluster.placement)

    def add_tenant(self, tenant_id: int, weight: float = 1.0, **kw):
        self._cluster.add_tenant(tenant_id, weight=weight)

    def set_weight(self, tenant_id: int, weight: float):
        self._cluster.set_weight(tenant_id, weight)

    def pending(self, tenant_id: Optional[int] = None) -> int:
        return sum(e.scheduler.pending(tenant_id)
                   for e in self._cluster.engines)

    @property
    def served_tokens(self) -> Dict[int, int]:
        return self._cluster.merged_ledger("served_tokens")

    @property
    def admitted_requests(self) -> Dict[int, int]:
        return self._cluster.merged_ledger("admitted_requests")

    @property
    def deferred_polls(self) -> Dict[int, int]:
        return self._cluster.merged_ledger("deferred_polls")

    @property
    def admit_wait_sum(self) -> Dict[int, float]:
        return self._cluster.merged_ledger("admit_wait_sum")

    def ledger(self) -> Dict[int, Dict[str, float]]:
        """Cluster-global version of ``TenantScheduler.ledger``."""
        served = self.served_tokens
        admitted = self.admitted_requests
        deferred = self.deferred_polls
        waits = self.admit_wait_sum
        out: Dict[int, Dict[str, float]] = {}
        for t in set(served) | set(admitted) | set(deferred):
            adm = admitted.get(t, 0)
            out[t] = {
                "served_tokens": float(served.get(t, 0)),
                "admitted_requests": float(adm),
                "deferred_polls": float(deferred.get(t, 0)),
                "queued": float(self.pending(t)),
                "mean_admit_wait_s": (waits.get(t, 0.0) / adm
                                      if adm else 0.0),
            }
        return out


class EngineCluster:
    """N serve-plane StackModules + one shared RateController + placement.

    Exposes the same driving surface as a single ``ServeEngine`` (``B``,
    ``submit``, ``step``, ``completed``, ``decode_steps``, ``scheduler``,
    ``controller``) so ``TraceReplayer`` runs a cluster unchanged. All
    tenant movement, ledger folding, conservation checks and the park
    suspend/resume lifecycle go through the ``StackModule`` protocol —
    the cluster never names a concrete engine class.

    Args:
        engines: live serve-plane modules (``ServeEngine`` or any
            ``SchedulerServeModule``). Their own ``controller`` hooks must
            be unset — the cluster drives the shared controller itself
            (one tick for the whole cluster per control interval, not one
            per engine).
        controller: the shared ``RateController`` (capacity in tokens/s =
            the ONE bottleneck spanning all engines). Any engine scheduler
            not yet attached to it is attached here.
        control_every: controller tick period, in cluster steps.
        core_engines: optional bytes-plane ``CoreEngine`` per ServeEngine
            (same order/length): a migration then moves the tenant's
            collective-traffic state (bucket level + carried ledger) in
            the same plan, byte conservation asserted.
        place_every: autopilot tick period, in cluster steps (takes
            effect once ``attach_autopilot`` is called).
    """

    def __init__(self, engines: Sequence[ServeEngine], controller=None,
                 *, control_every: int = 4, core_engines=None,
                 place_every: int = 8):
        self.engines: List[ServeEngine] = list(engines)
        if not self.engines:
            raise ValueError("EngineCluster needs at least one engine")
        for k, e in enumerate(self.engines):
            # one trace track per engine: request lifecycle events from
            # the engine and its scheduler land on the same timeline
            e.trace_name = f"engine{k}"
            e.scheduler.trace_track = f"engine{k}"
        for e in self.engines:
            if e.controller is not None:
                raise ValueError(
                    "cluster engines must not own a controller; the "
                    "cluster ticks the shared one")
        self.controller = controller
        if controller is not None:
            attached = {id(s) for s, _ in controller._schedulers}
            for e in self.engines:
                if id(e.scheduler) not in attached:
                    controller.attach_scheduler(e.scheduler)
        self.control_every = max(int(control_every), 1)
        self.core_engines = list(core_engines) if core_engines else None
        if self.core_engines is not None and \
                len(self.core_engines) != len(self.engines):
            raise ValueError(
                f"core_engines must pair 1:1 with engines "
                f"({len(self.core_engines)} vs {len(self.engines)})")
        # every plane is modules + ONE shared ConservationLedger — the
        # serve plane always, the bytes plane when attached
        self.planes: List[StackPlane] = [
            StackPlane.build("serve", self.engines)]
        if self.core_engines is not None:
            self.planes.append(StackPlane.build("bytes", self.core_engines))
        self.autopilot = None
        self.place_every = max(int(place_every), 1)
        self.placement: Dict[int, int] = {}
        self.draining: Dict[int, int] = {}          # tenant -> src engine
        self.parked: Set[int] = set()               # engine indices asleep
        self.parked_engine_steps = 0                # the cores-saved ledger
        self.max_parked = 0                         # peak engines asleep
        # the memory-saved ledger: bytes currently freed per parked engine,
        # cumulative bytes ever freed, the per-step integral of freed
        # bytes, and the peak resident droppable-buffer footprint
        self._suspended_bytes: Dict[int, int] = {}
        self.bytes_freed_total = 0
        self.mem_saved_byte_steps = 0
        self.peak_resident_bytes = 0
        self.migration_log: List[MigrationRecord] = []
        self.migrations_started = 0
        self.migrations_completed = 0
        self.swap_log: List[SwapRecord] = []
        self.swaps_total: Dict[str, int] = {}   # plane name -> swaps done
        # kill-and-restore failover: engine slots currently dark, the
        # bounded admission gap buffered per dark slot, and the meters
        # the checkpoint/recover lifecycle exports
        self.failed: Set[int] = set()
        self._gap: Dict[int, List[Request]] = {}
        self.failure_log: List[FailureRecord] = []
        self.checkpoints_total = 0
        self.recoveries_total = 0
        self.completed: List[Request] = []
        self._seen_completed = [len(e.completed) for e in self.engines]
        # liveness ledger the watchdog's engine-dark rule reads: one
        # heartbeat per engine per cluster step it actually ran (parked
        # and failed engines do not beat — that absence IS the signal)
        self.heartbeats: Dict[int, int] = {
            k: 0 for k in range(len(self.engines))}
        self.watchdog = None
        self.watch_every = 1
        self.steps = 0
        self.scheduler = ClusterLedger(self)
        self._note_resident()

    @property
    def serve_plane(self) -> StackPlane:
        return self.planes[0]

    def attach_autopilot(self, autopilot,
                         place_every: Optional[int] = None):
        """Close the placement loop: tick ``autopilot`` (typically a
        ``PlacementController`` of ``control/placement.py`` built over
        this cluster) every ``place_every`` cluster steps, next to the rate
        controller's own cadence. Returns the autopilot for chaining."""
        self.autopilot = autopilot
        if place_every is not None:
            self.place_every = max(int(place_every), 1)
        return autopilot

    def attach_watchdog(self, watchdog, scrape_every: int = 1):
        """Give the fabric its own pulse: tick ``watchdog`` (a
        ``FabricWatchdog`` of ``obs/slo.py``) every ``scrape_every`` cluster
        steps, alongside the controller/autopilot cadences. The caller
        owns the watchdog's registry wiring; this cluster's ``counters``
        and ``health`` providers are what it should scrape. Returns the
        watchdog for chaining."""
        self.watchdog = watchdog
        self.watch_every = max(int(scrape_every), 1)
        return watchdog

    # -- engine-like surface ------------------------------------------------
    @property
    def B(self) -> int:
        """Total decode slots across the cluster."""
        return sum(e.B for e in self.engines)

    @property
    def decode_steps(self) -> int:
        return sum(e.decode_steps for e in self.engines)

    def submit(self, req: Request) -> int:
        """Route one request to its tenant's placed engine (auto-placing
        an unknown tenant on the least-loaded one). A request for a
        tenant placed on a FAILED engine is not dropped: it buffers in
        that slot's admission gap and ``recover_engine`` replays it in
        arrival order — the gap is bounded by the fail->recover window.
        Returns the engine index it landed on (or is buffered for)."""
        idx = self.placement.get(req.tenant_id)
        if idx is None:
            idx = self.add_tenant(req.tenant_id)
        if idx in self.failed:
            self._gap[idx].append(req)
            return idx
        self.engines[idx].submit(req)
        return idx

    def step(self, now: Optional[float] = None) -> int:
        """One cluster step: tick the shared controller (every
        ``control_every`` steps), step every awake engine once, collect
        completions, finalize any drained migrations, tick the autopilot
        (every ``place_every`` steps). Parked engines do not step — that
        skipped work *is* the cores-saved claim (``parked_engine_steps``)
        and their suspended buffers *are* the memory-saved claim
        (``mem_saved_byte_steps``). Returns the number of active slots
        cluster-wide."""
        self.steps += 1
        if self.controller is not None and \
                self.steps % self.control_every == 0:
            self.controller.tick(time.monotonic() if now is None else now)
        active = 0
        for k, e in enumerate(self.engines):
            if k in self.parked or k in self.failed:
                continue
            active += e.step(now=now)
            self.heartbeats[k] = self.heartbeats.get(k, 0) + 1
        # account the parked set that actually held during the engine loop
        # — an engine the autopilot parks below still ran this step and
        # must not be billed as a saved core until the next one
        self.parked_engine_steps += len(self.parked)
        self.mem_saved_byte_steps += sum(self._suspended_bytes.values())
        self.max_parked = max(self.max_parked, len(self.parked))
        self._note_resident()
        self._collect_completed()
        self._poll_drains(now)
        if self.autopilot is not None and \
                self.steps % self.place_every == 0:
            self.autopilot.tick(time.monotonic() if now is None else now)
        if self.watchdog is not None and \
                self.steps % self.watch_every == 0:
            self.watchdog.tick(time.monotonic() if now is None else now)
        return active

    # -- placement ----------------------------------------------------------
    def add_tenant(self, tenant_id: int, weight: float = 1.0,
                   engine: Optional[int] = None) -> int:
        """Register (or re-weight) a tenant. ``engine`` pins the placement
        of a NEW tenant; None auto-places on the least-loaded engine.
        Returns the engine index the tenant lives on. Re-placing an
        existing tenant is ``migrate``'s job — passing a different
        ``engine`` for one raises instead of silently ignoring the pin."""
        if tenant_id in self.placement:
            idx = self.placement[tenant_id]
            if engine is not None and engine != idx:
                raise ValueError(
                    f"tenant {tenant_id} is already placed on engine "
                    f"{idx}; use migrate({tenant_id}, {engine}) to move "
                    f"a live tenant")
            self.engines[idx].scheduler.set_weight(tenant_id, weight)
            return idx
        idx = engine if engine is not None else self._auto_place()
        if not 0 <= idx < len(self.engines):
            raise IndexError(f"engine {idx} not in cluster")
        if idx in self.parked:
            raise ValueError(f"engine {idx} is parked; unpark it before "
                             f"placing tenant {tenant_id} there")
        if idx in self.failed:
            raise ValueError(f"engine {idx} has failed; recover it before "
                             f"placing tenant {tenant_id} there")
        self.placement[tenant_id] = idx
        self.engines[idx].scheduler.add_tenant(tenant_id, weight=weight)
        return idx

    def set_weight(self, tenant_id: int, weight: float) -> None:
        self.add_tenant(tenant_id, weight=weight)

    def active_engines(self) -> List[int]:
        """Engine indices currently awake (neither parked nor failed)."""
        return [k for k in range(len(self.engines))
                if k not in self.parked and k not in self.failed]

    def _auto_place(self) -> int:
        def load(k: int):
            placed = sum(1 for v in self.placement.values() if v == k)
            return (self.engine_load(k), placed, k)
        return min(self.active_engines(), key=load)

    def engine_load(self, k: int) -> float:
        """Demand pressure on engine ``k``: queued + in-flight requests
        (the serve module's ``StackModule.load``)."""
        return self.engines[k].load()

    def hottest_engine(self) -> int:
        return max(self.active_engines(),
                   key=lambda k: (self.engine_load(k), -k))

    def coolest_engine(self) -> int:
        return min(self.active_engines(),
                   key=lambda k: (self.engine_load(k), k))

    # -- park/unpark lifecycle (cores- AND memory-saved claims) -------------
    def parkable(self, k: int) -> bool:
        """True iff engine ``k`` could be parked right now: awake, fully
        quiesced (no placed tenants, no draining source, no queued or
        in-flight work) and not the last awake engine."""
        if not 0 <= k < len(self.engines) or k in self.parked or \
                k in self.failed:
            return False
        if len(self.active_engines()) <= 1:
            return False
        if any(v == k for v in self.placement.values()):
            return False
        if any(src == k for src in self.draining.values()):
            return False
        return self.engines[k].load() == 0

    def _trace_ts(self, now: Optional[float]) -> float:
        """Timestamp for a control-plane trace event: the caller's clock
        when given, else the step count (wall-clock callers that never
        pass ``now`` still get a monotonic timeline)."""
        return float(self.steps) if now is None else float(now)

    def park(self, k: int, *, now: Optional[float] = None) -> None:
        """Put a quiesced engine to sleep: it stops stepping (saved cores)
        AND every plane's module at ``k`` suspends — KV-cache, slot table
        and scratch are dropped (saved memory) — until ``unpark``. Raises
        if the engine still has any work: parking must never strand a
        tenant."""
        if not 0 <= k < len(self.engines):
            raise IndexError(f"engine {k} not in cluster")
        if k in self.parked:
            raise ValueError(f"engine {k} is already parked")
        if not self.parkable(k):
            raise ValueError(
                f"engine {k} is not quiesced (tenants placed, work "
                f"in-flight, a drain in progress, or it is the last "
                f"awake engine); refuse to park")
        self.parked.add(k)
        freed = sum(plane.modules[k].suspend() for plane in self.planes)
        self._suspended_bytes[k] = freed
        self.bytes_freed_total += freed
        if tracing.TRACER.enabled:
            tracing.TRACER.instant("cluster", "park", self._trace_ts(now),
                                   engine=k, freed_bytes=freed)

    def unpark(self, k: int, *, now: Optional[float] = None) -> None:
        """Wake a parked engine: every plane's module ``resume``s (the
        KV-cache re-materializes lazily on the first admission) and it
        can step and host tenants again immediately."""
        if not 0 <= k < len(self.engines):
            raise IndexError(f"engine {k} not in cluster")
        if k not in self.parked:
            raise ValueError(f"engine {k} is not parked")
        self.parked.discard(k)
        for plane in self.planes:
            plane.modules[k].resume()
        self._suspended_bytes.pop(k, None)
        if tracing.TRACER.enabled:
            tracing.TRACER.instant("cluster", "unpark", self._trace_ts(now),
                                   engine=k)

    def cores_saved(self) -> float:
        """Average engines parked per cluster step so far — the closed-loop
        analog of the paper's Table-2 core savings (engine units; 1.0 =
        one whole engine slept through the run)."""
        return self.parked_engine_steps / max(self.steps, 1)

    def parked_bytes(self) -> int:
        """Bytes currently freed by suspended (parked) engines."""
        return sum(self._suspended_bytes.values())

    def mem_saved(self) -> float:
        """Average bytes freed per cluster step so far — the memory analog
        of ``cores_saved`` (bytes; the integral of parked buffer bytes
        over steps, normalized)."""
        return self.mem_saved_byte_steps / max(self.steps, 1)

    def resident_bytes(self) -> int:
        """Droppable buffer bytes currently resident across every plane's
        modules (suspended modules report 0)."""
        return sum(m.resident_bytes()
                   for plane in self.planes for m in plane.modules)

    def _note_resident(self) -> None:
        self.peak_resident_bytes = max(self.peak_resident_bytes,
                                       self.resident_bytes())

    # -- migration ----------------------------------------------------------
    def migrate(self, tenant: int, dst_engine: int,
                *, now: Optional[float] = None) -> Optional[MigrationRecord]:
        """Move a live tenant to ``dst_engine`` mid-run, conserving its
        ledger on every plane.

        For each plane: the source module exports the tenant (queue, WFQ
        weight, token-bucket level), the carried counters fold into the
        plane's ``ConservationLedger``, and the destination imports —
        identical protocol calls whether the plane is serve or bytes.
        In-flight slots stay draining on the source (they finish and bill
        there). Delta-push history for the tenant is invalidated so the
        controller re-pushes fresh rates to every enforcement point next
        tick. Returns the ``MigrationRecord`` (None if the tenant is
        already on ``dst_engine``).
        """
        if tenant not in self.placement:
            raise KeyError(f"tenant {tenant} is not placed on this cluster")
        if tenant in self.draining:
            raise RuntimeError(
                f"tenant {tenant} is still draining from a previous "
                f"migration; wait for it to finalize")
        src = self.placement[tenant]
        dst = int(dst_engine)
        if not 0 <= dst < len(self.engines):
            raise IndexError(f"engine {dst} not in cluster")
        if dst == src:
            return None
        if dst in self.parked:
            raise ValueError(f"engine {dst} is parked; unpark it before "
                             f"migrating tenant {tenant} onto it")
        if dst in self.failed:
            raise ValueError(f"engine {dst} has failed; recover it before "
                             f"migrating tenant {tenant} onto it")
        if src in self.failed:
            raise RuntimeError(
                f"tenant {tenant} is placed on failed engine {src}; its "
                f"live state died with the crash — recover_engine first, "
                f"then migrate")
        # validate EVERY plane's destination BEFORE the first destructive
        # export: failing after an export would lose the unserved queue
        # (or strand carried counters half-folded)
        for plane in self.planes:
            if plane.modules[dst].has_tenant(tenant):
                raise ValueError(
                    f"tenant {tenant} has live {plane.name}-plane state "
                    f"on engine {dst} (out-of-band submission or rate "
                    f"push?); migration requires a quiesced destination "
                    f"on every plane")
        totals_before = {p.name: p.ledger.total(tenant) for p in self.planes}
        inflight = self.engines[src].tenant_load(tenant).inflight
        ts = self._trace_ts(now)
        serve_state: Optional[TenantState] = None
        for plane in self.planes:
            state = plane.modules[src].export_tenant(tenant, now)
            plane.ledger.fold(tenant, plane.modules[src], state)
            plane.modules[dst].import_tenant(tenant, state, now)
            if plane is self.serve_plane:
                serve_state = state
        if tracing.TRACER.enabled:
            tracing.TRACER.span(
                "cluster", "migrate.transfer", ts, ts, tenant=tenant,
                src=src, dst=dst, queued=len(serve_state.queue),
                inflight=inflight)
            # the drain window [move, finalize] as an async pair keyed by
            # tenant — drains of different tenants overlap on this track
            tracing.TRACER.async_begin("cluster", "migrate.drain",
                                       tenant, ts, tenant=tenant, src=src,
                                       inflight=inflight)
        self.placement[tenant] = dst
        if self.controller is not None:
            self.controller.invalidate_tenant(tenant)
        rec = MigrationRecord(
            tenant=tenant, src=src, dst=dst, started_step=self.steps,
            queued_moved=len(serve_state.queue), inflight_at_move=inflight,
            bucket_tokens_moved=serve_state.bucket_tokens)
        self.migrations_started += 1
        self.migration_log.append(rec)
        # the move itself bills nothing: no plane's global ledger may jump
        for plane in self.planes:
            after = plane.ledger.total(tenant)
            if int(round(after)) != int(round(totals_before[plane.name])):
                raise AssertionError(
                    f"{plane.name}-plane migration broke tenant {tenant}'s "
                    f"ledger continuity: {totals_before[plane.name]} -> "
                    f"{after} {plane.ledger.conserved}")
        self.assert_ledger_conservation(tenant)
        if inflight:
            self.draining[tenant] = src
        else:
            self._finalize(rec, now)
        return rec

    # -- live stack hot-swap (the paper's kernel-TCP -> mTCP move) ----------
    # quiesce safety valve: a slot that never drains (a stuck decode loop)
    # must fail loudly instead of spinning the swap forever
    QUIESCE_STEP_CAP = 10_000

    @staticmethod
    def _stack_desc(module) -> str:
        """Audit-log descriptor for one stack module: the class name plus
        the knob a swap actually flips (the bytes plane swaps CoreEngine
        for CoreEngine — only ``default_nsm`` tells them apart; serve
        variants differ by scheduler policy)."""
        name = type(module).__name__
        nsm = getattr(module, "default_nsm", None)
        if nsm is not None:
            return f"{name}[{nsm}]"
        policy = getattr(getattr(module, "scheduler", None), "policy", None)
        return f"{name}[{policy}]" if policy else name

    def swap_module(self, engine_id: int, plane: str,
                    new_module_factory: Callable[[], object],
                    *, now: Optional[float] = None) -> SwapRecord:
        """Hot-swap the ``StackModule`` serving one engine slot, live.

        The NetKernel headline demo as a cluster primitive: the operator
        replaces the stack beneath unmodified tenants (native <->
        ``CompressedNsm`` on the bytes plane; an alternate scheduler
        variant on the serve plane) while traffic is running, with zero
        dropped or double-billed tokens. Three phases, one trace span
        each:

          1. **quiesce** (``swap.quiesce`` async pair): admission pauses
             (``scheduler.paused`` — queued work stays put, no
             deferred-poll noise) and the old module steps until its
             in-flight slots run dry — they finish *and bill* on the
             stack that admitted them, exactly like a migration drain.
          2. **transfer** (``swap.transfer`` span): every placed tenant
             exports via ``TenantState``, its counters fold into the
             plane's ``ConservationLedger``, the replacement is built and
             adopts the retired module's billed ground truth
             (``inherit_ground_truth`` — completed records / billed
             bytes stay attributed to this engine slot), the module list
             entry is replaced IN PLACE (the plane, the cluster and the
             ledger share the list by reference), the controller's
             enforcement point is re-wired, and every tenant re-imports.
          3. **resume** (``swap.resume`` instant): admission reopens on
             the new module; ``invalidate_tenant`` forces the delta-push
             controller to re-push fresh rates to every enforcement
             point next tick, so no stale rate survives the swap.

        Ledger continuity AND ground-truth continuity are asserted per
        tenant across the boundary, then the full conservation invariant.
        Refused while the engine is parked or is the draining source of a
        live migration (the residual billing would be stranded on the
        retired module — same contract as mid-drain re-migration).
        Returns the ``SwapRecord``.
        """
        k = int(engine_id)
        if not 0 <= k < len(self.engines):
            raise IndexError(f"engine {k} not in cluster")
        pl = next((p for p in self.planes if p.name == plane), None)
        if pl is None:
            raise KeyError(
                f"plane {plane!r} is not attached to this cluster "
                f"(have: {[p.name for p in self.planes]})")
        if k in self.parked:
            raise ValueError(
                f"engine {k} is parked; unpark it before swapping its "
                f"{plane} module")
        if k in self.failed:
            raise ValueError(
                f"engine {k} has failed; recover it before swapping its "
                f"{plane} module")
        if any(src == k for src in self.draining.values()):
            raise RuntimeError(
                f"engine {k} is the draining source of a live migration; "
                f"a swap would strand the residual billing on the retired "
                f"module — wait for the drain to finalize")
        old = pl.modules[k]
        tenants = tuple(sorted(
            t for t, e in self.placement.items()
            if e == k and old.has_tenant(t)))
        ts0 = self._trace_ts(now)
        quiesce_id = f"{pl.name}:{k}:{self.steps}"
        if tracing.TRACER.enabled:
            tracing.TRACER.async_begin("cluster", "swap.quiesce",
                                       quiesce_id, ts0, engine=k,
                                       plane=pl.name)
        # 1. quiesce: pause admission, drain in-flight slots on the old
        # module (planes without slot machinery skip straight through)
        sched = getattr(old, "scheduler", None)
        inflight_fn = getattr(old, "inflight", None)
        inflight0 = int(inflight_fn()) if callable(inflight_fn) else 0
        quiesce_steps = 0
        if sched is not None:
            sched.paused = True
        try:
            while callable(inflight_fn) and inflight_fn():
                if quiesce_steps >= self.QUIESCE_STEP_CAP:
                    raise RuntimeError(
                        f"engine {k} failed to quiesce within "
                        f"{self.QUIESCE_STEP_CAP} steps "
                        f"({inflight_fn()} slot(s) still in flight)")
                old.step(now=now)
                quiesce_steps += 1
        finally:
            if sched is not None:
                sched.paused = False
        ts1 = self._trace_ts(now)
        if tracing.TRACER.enabled:
            tracing.TRACER.async_end("cluster", "swap.quiesce",
                                     quiesce_id, ts1, engine=k,
                                     plane=pl.name)
        # 2. transfer: totals are taken AFTER the quiesce (drain billing
        # moved them) and must be unchanged by everything below
        totals_before = {t: pl.ledger.total(t) for t in tenants}
        truth_before = {t: pl.ledger.ground_truth(t) for t in tenants}
        states: Dict[int, TenantState] = {}
        for t in tenants:
            state = old.export_tenant(t, now)
            pl.ledger.fold(t, old, state)
            states[t] = state
        new = new_module_factory()
        if getattr(new, "plane", pl.name) != pl.name:
            raise ValueError(
                f"replacement module is {getattr(new, 'plane')!r}-plane; "
                f"cannot swap it into the {pl.name} plane")
        if getattr(new, "controller", None) is not None:
            raise ValueError(
                "replacement module must not own a controller; the "
                "cluster ticks the shared one")
        # the replacement takes over the slot's identity: trace track and
        # the retired module's never-migrates ground truth
        if hasattr(new, "trace_name"):
            new.trace_name = f"engine{k}"
        new_sched = getattr(new, "scheduler", None)
        if new_sched is not None:
            new_sched.trace_track = f"engine{k}"
        new.inherit_ground_truth(old)
        pl.modules[k] = new    # in place: engines/planes/ledger all see it
        if pl is self.serve_plane and self.controller is not None:
            if sched is not None:
                self.controller.detach_scheduler(sched)
            if new_sched is not None:
                self.controller.attach_scheduler(new_sched)
        for t in tenants:
            new.import_tenant(t, states[t], now)
        # 3. resume: fresh rates to every enforcement point next tick
        if self.controller is not None:
            for t in tenants:
                self.controller.invalidate_tenant(t)
        for t in tenants:
            after = pl.ledger.total(t)
            if int(round(after)) != int(round(totals_before[t])):
                raise AssertionError(
                    f"{pl.name}-plane swap broke tenant {t}'s ledger "
                    f"continuity: {totals_before[t]} -> {after} "
                    f"{pl.ledger.conserved}")
            truth_after = pl.ledger.ground_truth(t)
            if int(round(truth_after)) != int(round(truth_before[t])):
                raise AssertionError(
                    f"{pl.name}-plane swap lost tenant {t}'s billed "
                    f"ground truth across the boundary: "
                    f"{truth_before[t]} -> {truth_after}")
            self.assert_ledger_conservation(t)
        ts2 = self._trace_ts(now)
        rec = SwapRecord(
            engine=k, plane=pl.name, step=self.steps, tenants=tenants,
            inflight_at_swap=inflight0, quiesce_steps=quiesce_steps,
            old_stack=self._stack_desc(old),
            new_stack=self._stack_desc(new))
        self.swap_log.append(rec)
        self.swaps_total[pl.name] = self.swaps_total.get(pl.name, 0) + 1
        if tracing.TRACER.enabled:
            tracing.TRACER.span(
                "cluster", "swap.transfer", ts1, ts2, engine=k,
                plane=pl.name, tenants=len(tenants),
                old=rec.old_stack, new=rec.new_stack)
            tracing.TRACER.instant("cluster", "swap.resume", ts2,
                                   engine=k, plane=pl.name)
        return rec

    # -- checkpoint / kill-and-restore failover -----------------------------
    def checkpoint(self, *, now: Optional[float] = None) -> FabricSnapshot:
        """Capture the whole fabric as one ``FabricSnapshot``.

        Every plane's per-tenant state is exported non-destructively
        (``StackModule.snapshot_tenant`` — live counters included), plus
        each module's FULL billed-ground-truth map (departed tenants'
        never-migrates history included), the serve plane's engine-side
        latency tails, the per-plane carried ledgers, the placement map,
        park set, swap log and the controller's soft state.

        The capture is passive: no admission pause, no drain. In-flight
        slots are deliberately NOT captured — a crash loses them by
        definition — but their billing-so-far IS (in both the counters
        and the ground-truth map), so conservation holds exactly on any
        restore. Refused mid-drain (a draining tenant's residual billing
        lives in in-flight slots a snapshot cannot carry) and while an
        engine is failed (the admission-gap buffer is not part of the
        wire format — recover first). Emits one ``checkpoint`` span per
        engine so the trace checker can pin recover-after-checkpoint
        ordering per slot.
        """
        if self.draining:
            raise RuntimeError(
                f"cannot checkpoint mid-drain (tenants "
                f"{sorted(self.draining)} still draining): residual "
                f"billing lives in in-flight slots a snapshot cannot "
                f"carry; wait for the migration to finalize")
        if self.failed:
            raise RuntimeError(
                f"cannot checkpoint with failed engines "
                f"{sorted(self.failed)}: their buffered admission gap "
                f"is not part of the snapshot; recover them first")
        ts = self._trace_ts(now)
        planes: List[PlaneSnapshot] = []
        for plane in self.planes:
            mods: List[ModuleSnapshot] = []
            for k, m in enumerate(plane.modules):
                tenants = {
                    t: m.snapshot_tenant(t, now)
                    for t, e in self.placement.items()
                    if e == k and m.has_tenant(t)}
                latency: Dict[str, Dict[int, dict]] = {}
                if plane is self.serve_plane:
                    latency = {
                        fam: {t: h.to_payload()
                              for t, h in th.per_tenant.items()}
                        for fam, th in m.latency_hists().items()}
                mods.append(ModuleSnapshot(
                    tenants=tenants, ground_truth=m.ground_truth_map(),
                    latency=latency))
            planes.append(PlaneSnapshot(
                name=plane.name,
                carried={f: dict(d)
                         for f, d in plane.ledger.carried.items()},
                modules=mods))
        ctrl: Dict[str, object] = {}
        if self.controller is not None:
            ctrl = {"capacity": float(self.controller.capacity),
                    "ticks": int(self.controller.ticks),
                    "allocations": dict(self.controller.allocations)}
        snap = FabricSnapshot(
            step=self.steps, placement=dict(self.placement),
            draining={}, parked=sorted(self.parked), planes=planes,
            controller=ctrl,
            swap_log=[dict(vars(r), tenants=list(r.tenants))
                      for r in self.swap_log])
        self.checkpoints_total += 1
        if tracing.TRACER.enabled:
            for k in range(len(self.engines)):
                tracing.TRACER.span("cluster", "checkpoint", ts, ts,
                                    engine=k, step=self.steps)
        return snap

    def _check_snapshot(self, snapshot: FabricSnapshot) -> Dict[str, PlaneSnapshot]:
        """Shared restore-side validation: version strict-reject (a
        hand-built snapshot skips ``from_bytes``) and plane/module shape
        against this cluster. Returns the planes keyed by name."""
        if snapshot.version != FABRIC_SNAPSHOT_VERSION:
            raise ValueError(
                f"unknown FabricSnapshot version {snapshot.version!r} "
                f"(this cluster understands {FABRIC_SNAPSHOT_VERSION})")
        by_name = {p.name: p for p in snapshot.planes}
        for plane in self.planes:
            if plane.name not in by_name:
                raise ValueError(
                    f"snapshot has no {plane.name!r} plane "
                    f"(have: {sorted(by_name)})")
            n = len(by_name[plane.name].modules)
            if n != len(self.engines):
                raise ValueError(
                    f"snapshot {plane.name} plane has {n} modules; this "
                    f"cluster has {len(self.engines)} engines")
        return by_name

    def fail_engine(self, k: int, *,
                    now: Optional[float] = None) -> FailureRecord:
        """Simulated crash of one engine slot: every plane's module at
        ``k`` is wiped in place (``StackModule.crash``) — queued and
        in-flight work lost, counters and billed records gone, latency
        tails gone. The slot stops stepping and stops receiving
        dispatches; requests for its tenants buffer in a bounded
        admission gap that ``recover_engine`` replays. For tenants placed
        on the slot, live counters equal the module's billed ground truth
        at every instant, so wiping both sides together preserves
        conservation. Ground-truth history the slot holds for tenants
        placed ELSEWHERE (a drained migration leaves its completed
        records on the source forever) is finalized billing the carried
        ledger already references — it is re-seeded as a baseline, not
        lost: a crash destroys live state, not the billing record.
        Conservation is asserted for every placed tenant before
        returning.

        Refused for a parked engine (park and failure are distinct
        lifecycle states — unpark first), for the draining source of a
        live migration (the residual billing would be unrecoverable),
        and for the last live engine.
        """
        if not 0 <= k < len(self.engines):
            raise IndexError(f"engine {k} not in cluster")
        if k in self.failed:
            raise ValueError(f"engine {k} has already failed")
        if k in self.parked:
            raise ValueError(
                f"engine {k} is parked; unpark it before failing it")
        if any(src == k for src in self.draining.values()):
            raise RuntimeError(
                f"engine {k} is the draining source of a live migration; "
                f"crashing it now would lose the residual billing "
                f"forever — wait for the drain to finalize")
        if len(self.active_engines()) <= 1:
            raise ValueError(
                f"engine {k} is the last live engine; refusing to fail "
                f"the whole cluster")
        serve_mod = self.serve_plane.modules[k]
        rec = FailureRecord(
            engine=k, step=self.steps,
            inflight_lost=int(self.engines[k].inflight()),
            queued_lost=int(self.engines[k].scheduler.pending()),
            gt_at_crash=dict(serve_mod.ground_truth_map()))
        for plane in self.planes:
            mod = plane.modules[k]
            history = {t: v for t, v in mod.ground_truth_map().items()
                       if self.placement.get(t) != k}
            mod.crash()
            for t, v in history.items():
                mod.restore_ground_truth(t, v)
        self._seen_completed[k] = 0
        self.failed.add(k)
        self._gap[k] = []
        self.failure_log.append(rec)
        for t in self.placement:
            self.assert_ledger_conservation(t)
        if tracing.TRACER.enabled:
            tracing.TRACER.instant(
                "cluster", "fail", self._trace_ts(now), engine=k,
                inflight_lost=rec.inflight_lost,
                queued_lost=rec.queued_lost)
        return rec

    def recover_engine(self, k: int, snapshot: FabricSnapshot, *,
                       now: Optional[float] = None) -> FailureRecord:
        """Re-materialize a crashed engine slot from its last
        ``FabricSnapshot`` and replay the bounded admission gap.

        Per plane (matched by name): the slot's tenants restore through
        ``StackModule.restore_tenant`` (refused onto live state — the
        double-restore guard), the module's FULL billed-ground-truth map
        re-installs (SET, never added), and the serve plane's engine-side
        latency tails replace wholesale. Carried ledgers are NOT touched:
        nothing folded while the slot was dark. Tenants placed on the
        slot after the checkpoint re-register empty (their pre-crash work
        is lost with the crash, like everything billed after the
        checkpoint — ``tokens_lost`` on the returned record, bounded by
        one checkpoint interval). Buffered requests replay through
        ``submit`` in arrival order, delta-push history is invalidated so
        fresh rates reach the slot next tick, and conservation is
        asserted for every placed tenant on every plane.
        """
        if not 0 <= k < len(self.engines):
            raise IndexError(f"engine {k} not in cluster")
        if k not in self.failed:
            raise ValueError(
                f"engine {k} has not failed; recover_engine "
                f"re-materializes a crashed slot — use restore() for a "
                f"full-fabric reset")
        by_name = self._check_snapshot(snapshot)
        serve_snap = by_name[self.serve_plane.name].modules[k]
        for t in serve_snap.tenants:
            if self.placement.get(t) != k:
                raise ValueError(
                    f"tenant {t} was on engine {k} at checkpoint time "
                    f"but is placed on {self.placement.get(t)} now; "
                    f"recovery needs a checkpoint taken since the last "
                    f"move")
        restored: Set[int] = set()
        for plane in self.planes:
            snap_mod = by_name[plane.name].modules[k]
            mod = plane.modules[k]
            for t, value in snap_mod.ground_truth.items():
                mod.restore_ground_truth(t, value)
            for t, state in snap_mod.tenants.items():
                mod.restore_tenant(t, state, now)
                restored.add(t)
            if plane is self.serve_plane:
                mod.restore_latency(snap_mod.latency)
        # tenants placed here after the checkpoint: re-register empty so
        # admission works the moment the slot is live again
        for t, e in self.placement.items():
            if e == k and t not in serve_snap.tenants:
                self.engines[k].scheduler.add_tenant(t)
        self.failed.discard(k)
        gap = self._gap.pop(k, [])
        for req in gap:
            self.submit(req)
        if self.controller is not None:
            for t in restored:
                self.controller.invalidate_tenant(t)
        rec = next((r for r in reversed(self.failure_log)
                    if r.engine == k and not r.recovered), None)
        if rec is None:        # failed outside fail_engine? keep the log sane
            rec = FailureRecord(engine=k, step=self.steps,
                                inflight_lost=0, queued_lost=0,
                                gt_at_crash={})
            self.failure_log.append(rec)
        rec.recovered_step = self.steps
        rec.tokens_lost = sum(
            max(gt - float(serve_snap.ground_truth.get(t, 0.0)), 0.0)
            for t, gt in rec.gt_at_crash.items())
        self.recoveries_total += 1
        for t in self.placement:
            self.assert_ledger_conservation(t)
        if tracing.TRACER.enabled:
            ts = self._trace_ts(now)
            tracing.TRACER.span(
                "cluster", "recover", ts, ts, engine=k,
                tenants=len(restored), gap_replayed=len(gap),
                tokens_lost=rec.tokens_lost)
        return rec

    def restore(self, snapshot: FabricSnapshot, *,
                now: Optional[float] = None) -> None:
        """Full-fabric reset to a ``FabricSnapshot``: every engine slot
        on every plane crashes in place, then the snapshot's placement,
        park set, per-tenant states, ground-truth maps, latency tails,
        carried ledgers, swap log and controller soft state install.
        In-flight work at snapshot time was never captured (crash
        semantics) and anything submitted since the snapshot is gone —
        including failed slots' buffered gaps. Conservation is asserted
        for every placed tenant before returning."""
        by_name = self._check_snapshot(snapshot)
        for plane in self.planes:
            for m in plane.modules:
                m.crash()
        self.failed.clear()
        self._gap.clear()
        self.placement = dict(snapshot.placement)
        self.draining = dict(snapshot.draining)
        # crash() left every module resumed; re-park per the snapshot
        # (a freshly wiped module has no cache, so freed bytes are ~0)
        self.parked = set()
        self._suspended_bytes.clear()
        for k in snapshot.parked:
            self.parked.add(k)
            freed = sum(p.modules[k].suspend() for p in self.planes)
            self._suspended_bytes[k] = freed
        for plane in self.planes:
            sp = by_name[plane.name]
            for f in plane.ledger.fields:
                plane.ledger.carried[f] = dict(sp.carried.get(f, {}))
            for k, snap_mod in enumerate(sp.modules):
                mod = plane.modules[k]
                for t, value in snap_mod.ground_truth.items():
                    mod.restore_ground_truth(t, value)
                for t, state in snap_mod.tenants.items():
                    mod.restore_tenant(t, state, now)
                if plane is self.serve_plane:
                    mod.restore_latency(snap_mod.latency)
        self.steps = int(snapshot.step)
        self.swap_log = [
            SwapRecord(**dict(r, tenants=tuple(r.get("tenants", ()))))
            for r in snapshot.swap_log]
        self.swaps_total = {}
        for srec in self.swap_log:
            self.swaps_total[srec.plane] = \
                self.swaps_total.get(srec.plane, 0) + 1
        self._seen_completed = [len(e.completed) for e in self.engines]
        if self.controller is not None and snapshot.controller:
            self.controller.capacity = \
                float(snapshot.controller.get("capacity",
                                              self.controller.capacity))
            self.controller.ticks = int(snapshot.controller.get("ticks", 0))
            self.controller.allocations = dict(
                snapshot.controller.get("allocations", {}))
            # full re-push next tick: no stale delta-push judgment may
            # survive a fabric reset
            self.controller._last_push.clear()
        for t in self.placement:
            self.assert_ledger_conservation(t)
        if tracing.TRACER.enabled:
            tracing.TRACER.instant("cluster", "restore",
                                   self._trace_ts(now),
                                   step=int(snapshot.step))

    def rebalance(self, *, tenant: Optional[int] = None,
                  now: Optional[float] = None) -> Optional[MigrationRecord]:
        """Operator one-shot: move a tenant off the hottest engine onto the
        coolest. Default victim is the hottest engine's most-backlogged
        tenant (by queue depth — under an adversarial trace, the hog).
        No-op (returns None) if the cluster is already balanced.

        .. deprecated:: since the placement autopilot landed this is a
           thin wrapper over ``PlacementController.plan_once`` (the
           ``spread_hot`` policy, forced: no bands, no cooldown, no drain
           gate — the legacy semantics). Calling it emits a
           ``DeprecationWarning``; prefer attaching a
           ``PlacementController`` via ``attach_autopilot`` (closed loop)
           or calling ``PlacementController.plan_once(force=True)``
           directly (one-shot).
        """
        from repro_torch.serve.replay import operator_rebalance
        warnings.warn(
            "EngineCluster.rebalance() is deprecated; use "
            "operator_rebalance / PlacementController.plan_once("
            "force=True) for the one-shot or attach_autopilot() for the "
            "closed loop", DeprecationWarning, stacklevel=2)
        if tenant is not None:
            # keep the legacy error contract migrate() provided
            if tenant not in self.placement:
                raise KeyError(
                    f"tenant {tenant} is not placed on this cluster")
            if tenant in self.draining:
                raise RuntimeError(
                    f"tenant {tenant} is still draining from a previous "
                    f"migration; wait for it to finalize")
        return operator_rebalance(self, now=now, pin_tenant=tenant)

    def apply_plan(self, plan, *,
                   now: Optional[float] = None) -> List[MigrationRecord]:
        """Apply a ``PlacementPlan``: unpark first (a move may target a
        waking engine), then every move through ``migrate``'s
        ledger-conserving drain-and-transfer, then park engines the plan
        emptied. Stale entries — a tenant that already moved or is
        mid-drain, a park target that turns out non-quiesced — are skipped
        rather than raised: plans are computed from a snapshot and the
        cluster may have moved on. Returns the records of the migrations
        that actually happened (conservation was asserted on each)."""
        records: List[MigrationRecord] = []
        for k in plan.unpark:
            if k in self.parked:
                self.unpark(k, now=now)
        for mv in plan.moves:
            if mv.tenant not in self.placement or \
                    mv.tenant in self.draining:
                continue
            if self.placement[mv.tenant] != mv.src:
                continue                           # stale: already moved
            if mv.dst in self.parked:
                continue                           # unpark was skipped
            rec = self.migrate(mv.tenant, mv.dst, now=now)
            if rec is not None:
                records.append(rec)
        for k in plan.park:
            if k not in self.parked and self.parkable(k):
                self.park(k, now=now)
        return records

    def _finalize(self, rec: MigrationRecord,
                  now: Optional[float] = None) -> None:
        rec.finalized_step = self.steps
        self.migrations_completed += 1
        self.assert_ledger_conservation(rec.tenant)
        if self.controller is not None:
            # the source no longer holds the tenant: drop its telemetry
            # EWMA/baseline state there (the destination, which does hold
            # it, is left untouched) — without this, every migration
            # leaked the tenant's control state on the source forever
            self.controller.evict_tenant(rec.tenant)
        if tracing.TRACER.enabled:
            ts = self._trace_ts(now)
            tracing.TRACER.async_end("cluster", "migrate.drain",
                                     rec.tenant, ts)
            tracing.TRACER.span(
                "cluster", "migrate.finalize", ts, ts, tenant=rec.tenant,
                src=rec.src, dst=rec.dst,
                drained_steps=rec.finalized_step - rec.started_step)

    def _poll_drains(self, now: Optional[float] = None) -> None:
        serve = self.serve_plane
        for tenant, src in list(self.draining.items()):
            if serve.modules[src].tenant_load(tenant).inflight:
                continue
            # in-flight work finished on the source: fold its residual
            # billing (decode tokens accrued since the move) and finalize
            residual = serve.modules[src].export_tenant(tenant)
            if residual.queue:
                raise AssertionError(
                    f"tenant {tenant} grew a queue on drained source "
                    f"engine {src}: routing leaked past the placement map")
            serve.ledger.fold(tenant, serve.modules[src], residual)
            del self.draining[tenant]
            rec = next(r for r in reversed(self.migration_log)
                       if r.tenant == tenant)
            self._finalize(rec, now)

    def _collect_completed(self) -> None:
        for k, e in enumerate(self.engines):
            if len(e.completed) > self._seen_completed[k]:
                self.completed.extend(e.completed[self._seen_completed[k]:])
                self._seen_completed[k] = len(e.completed)

    # -- cluster-global ledger ----------------------------------------------
    def merged_ledger(self, fld: str) -> Dict[int, float]:
        """Carried (migrated-away) history + live per-engine counters for
        one serve-plane ledger field — the continuous cluster-global
        view."""
        return self.serve_plane.ledger.merged(fld)

    def tenant_served_tokens(self, tenant: int) -> float:
        """Tokens billed to a tenant cluster-wide, continuous across
        migrations (carried + live engine counters)."""
        return self.serve_plane.ledger.total(tenant, "served_tokens")

    def tenant_core_bytes(self, tenant: int) -> float:
        """Collective bytes routed for a tenant cluster-wide, continuous
        across migrations (bytes-plane carried + live CoreEngine ledgers).
        0.0 when the cluster has no bytes plane attached."""
        for plane in self.planes:
            if plane.name == "bytes":
                return plane.ledger.total(tenant, "bytes")
        return 0.0

    def tenant_billed_ground_truth(self, tenant: int) -> int:
        """Request-level ground truth: prompt+generated tokens over the
        tenant's completed and in-flight requests, summed over every
        serve module (completed records never migrate). The billing
        scheme (admit bills prompt + first prefill token, each decode
        step bills the token it produced) makes this equal the ledger at
        all times."""
        return int(round(self.serve_plane.ledger.ground_truth(tenant)))

    def assert_ledger_conservation(self, tenant: int) -> None:
        """No lost units, no double-billing, on ANY plane: each plane's
        carried+live ledger must equal its modules' summed billed ground
        truth exactly — one shared assert implementation
        (``ConservationLedger.assert_conservation``)."""
        for plane in self.planes:
            plane.ledger.assert_conservation(tenant, plane=plane.name)

    # -- reporting ----------------------------------------------------------
    def latency(self) -> Dict[str, TenantHistograms]:
        """Cluster-global per-tenant latency families (admit wait, TTFT,
        e2e): every serve module's histograms merged. Continuous across
        migrations — the admit-wait counts travel with the tenant, the
        engine-side TTFT/e2e counts stay where they were served."""
        out: Dict[str, TenantHistograms] = {}
        for m in self.serve_plane.modules:
            for name, th in m.latency().items():
                out[name] = out[name].merged(th) if name in out \
                    else th.merged(TenantHistograms(name, th.edges))
        return out

    def health(self) -> Dict[str, float]:
        """Liveness series for the watchdog's absence rules, kept out of
        ``counters()`` so existing scrapes are unchanged: ``nk_engine_up``
        (0 only while failed — a parked engine is asleep, not dead) and
        ``nk_engine_heartbeat_total`` (steps the engine actually ran; a
        stalled heartbeat on an unparked engine means the slot is dark).
        Register alongside ``counters``:
        ``registry.register_provider(cluster.health, name="health")``."""
        out: Dict[str, float] = {}
        for k in range(len(self.engines)):
            out[f'nk_engine_up{{engine="{k}"}}'] = \
                0.0 if k in self.failed else 1.0
            out[f'nk_engine_heartbeat_total{{engine="{k}"}}'] = \
                float(self.heartbeats.get(k, 0))
        return out

    def counters(self) -> Dict[str, float]:
        """Placement/migration counters (Prometheus naming), merged with
        the shared controller's."""
        out: Dict[str, float] = {
            "nk_cluster_engines": float(len(self.engines)),
            "nk_cluster_steps_total": float(self.steps),
            "nk_migrations_started_total": float(self.migrations_started),
            "nk_migrations_completed_total":
                float(self.migrations_completed),
            "nk_migrations_draining": float(len(self.draining)),
            "nk_cluster_parked": float(len(self.parked)),
            "nk_parked_engine_steps_total":
                float(self.parked_engine_steps),
            "nk_cores_saved": self.cores_saved(),
            "nk_parked_bytes": float(self.parked_bytes()),
            "nk_bytes_freed_total": float(self.bytes_freed_total),
            "nk_mem_saved_bytes": self.mem_saved(),
            "nk_resident_cache_bytes": float(self.resident_bytes()),
            "nk_peak_resident_cache_bytes":
                float(self.peak_resident_bytes),
        }
        for t, k in sorted(self.placement.items()):
            out[f'nk_placement{{tenant="{t}"}}'] = float(k)
        for k, e in enumerate(self.engines):
            out[f'nk_engine_load{{engine="{k}"}}'] = self.engine_load(k)
            out[f'nk_engine_parked{{engine="{k}"}}'] = \
                float(k in self.parked)
            out[f'nk_engine_decode_steps_total{{engine="{k}"}}'] = \
                float(e.decode_steps)
        # recent moves as info series (value = cluster step the move
        # started at) — what nk_top's "recent autopilot moves" pane reads
        for rec in self.migration_log[-5:]:
            out[f'nk_migration_info{{seq="{rec.started_step}",'
                f'tenant="{rec.tenant}",src="{rec.src}",'
                f'dst="{rec.dst}"}}'] = float(rec.started_step)
        out["nk_checkpoints_total"] = float(self.checkpoints_total)
        out["nk_recoveries_total"] = float(self.recoveries_total)
        out["nk_engines_failed"] = float(len(self.failed))
        for plane_name, n in sorted(self.swaps_total.items()):
            out[f'nk_swaps_total{{plane="{plane_name}"}}'] = float(n)
        # recent hot-swaps as info series (value = cluster step), like
        # nk_migration_info above
        for srec in self.swap_log[-5:]:
            out[f'nk_swap_info{{seq="{srec.step}",'
                f'engine="{srec.engine}",plane="{srec.plane}",'
                f'old="{srec.old_stack}",new="{srec.new_stack}"}}'] = \
                float(srec.step)
        for th in self.latency().values():
            out.update(th.counters())
        if self.autopilot is not None and \
                hasattr(self.autopilot, "counters"):
            out.update(self.autopilot.counters())
        if self.controller is not None:
            out.update(self.controller.counters())
        return out

    def export_prometheus(self) -> str:
        return format_prometheus(self.counters())
