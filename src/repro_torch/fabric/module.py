"""StackModule: the one tenant-lifecycle protocol both planes implement.

Before this layer the two planes each grew a private copy of the same
interface — ``TenantScheduler.export_tenant``/WFQ/buckets on the serve
plane, ``CoreEngine.export_tenant``/``import_tenant``/ledger on the bytes
plane — stitched together by ``EngineCluster.migrate`` with two parallel
fold paths and two conservation asserts. Here the interface is extracted
once:

  * ``TenantState`` — the uniform transferable unit: a token-bucket
    snapshot, the flattened cumulative counters the operator *carries*
    (never replayed into a destination, where the jump would read as a
    rate spike to telemetry), and a plane-specific payload (the serve
    plane's unserved queue + WFQ weight; the bytes plane's per-(verb,
    axes) ledger detail).
  * ``StackModule`` — the protocol: ``export_tenant`` / ``import_tenant``
    / ``fold`` / ``billed_ground_truth`` / ``tenant_load`` / ``suspend``
    / ``resume`` plus the read surface (``has_tenant``,
    ``live_counters``, ``load``, ``resident_bytes``) the cluster and the
    placement loop consume. A module that holds accelerator buffers
    (KV-cache, slot state) releases them in ``suspend`` and lazily
    re-materializes them after ``resume`` — parking an engine is a real
    memory saving, not just skipped steps.
  * ``ConservationLedger`` — ONE carried-ledger + conservation-assert
    implementation shared by every plane: carried (migrated-away) history
    plus each module's live counters must equal the sum of the modules'
    billed ground truth at every instant. The serve plane's ground truth
    is request-level (prompt+generated tokens over completed and
    in-flight requests); the bytes plane's is the monotonic billed-bytes
    counter that never migrates (the analog of completed-request records
    staying on the engine that served them).

Nothing here imports an engine class: modules are duck-typed, so the
whole lifecycle is unit-testable without a model anywhere near the test.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs import tracing
from repro_torch.obs.hist import TenantHistograms


@dataclass
class TenantState:
    """One tenant's transferable state, exported from a ``StackModule``.

    Attributes:
        plane: the exporting module's plane name ("serve", "bytes", ...).
        bucket: ``TokenBucket.snapshot`` output (rate/capacity/tokens/
            updated), or None when the tenant was uncapped. The *level*
            travels with the tenant so a migration can never reopen a
            fresh burst.
        carried: flattened cumulative counters, keyed by the module's
            ``ledger_fields`` — what ``ConservationLedger.fold`` adds to
            the operator's carried view. Deliberately NOT replayed into a
            destination module.
        payload: plane-specific transfer detail — the serve plane's
            unserved ``queue`` (FIFO list of Requests) and WFQ
            ``weight``; the bytes plane's per-(verb, axes) ``ledger`` /
            ``deferred`` / ``admitted`` breakdown.
    """

    plane: str
    bucket: Optional[Dict[str, float]]
    carried: Dict[str, float]
    payload: Dict[str, Any] = field(default_factory=dict)

    @property
    def bucket_tokens(self) -> float:
        """Token-bucket level travelling with the tenant (0.0 if uncapped)."""
        return (self.bucket or {}).get("tokens", 0.0)

    @property
    def queue(self) -> Sequence:
        """The unserved work moving with the tenant (empty for planes
        that hold no queues)."""
        return self.payload.get("queue", ())


@dataclass(frozen=True)
class TenantLoad:
    """One tenant's instantaneous pressure on one module — the placement
    loop's (and the drain-cost model's) per-tenant signal.

    Units: ``pending``/``inflight`` are requests (queued, resp. decode
    slots held); ``queued_tokens``/``inflight_tokens`` are tokens (the
    drain-cost model's unit: what a migration would start serving at the
    destination vs what it strands draining on the source).
    """

    pending: int = 0
    inflight: int = 0
    queued_tokens: float = 0.0
    inflight_tokens: float = 0.0


class StackModule:
    """The uniform stack-module interface (NetKernel's NSM, as a protocol).

    Concrete planes subclass this (``ServeEngine`` via
    ``SchedulerServeModule``, ``CoreEngine`` directly) and the cluster /
    placement layers operate on it exclusively — no isinstance checks, no
    per-plane fold paths, one conservation assert.

    Class attributes each plane pins:
        plane: short plane name, labels ``TenantState`` and asserts.
        ledger_fields: counter names ``export_tenant`` flattens into
            ``TenantState.carried`` and ``live_counters`` serves.
        conserved_field: the one field conservation is asserted on
            ("served_tokens" for serve, "bytes" for the bytes plane).
    """

    plane: str = "stack"
    ledger_fields: Tuple[str, ...] = ()
    conserved_field: str = ""

    # -- tenant lifecycle (migration) ---------------------------------------
    def export_tenant(self, tenant_id: int,
                      now: Optional[float] = None) -> TenantState:
        """Atomically remove a tenant and return its transferable state."""
        raise NotImplementedError

    def import_tenant(self, tenant_id: int, state: TenantState,
                      now: Optional[float] = None) -> None:
        """Install an exported tenant; raises if the destination is not
        quiesced for it (any live state — a silent merge would corrupt
        continuity)."""
        raise NotImplementedError

    def has_tenant(self, tenant_id: int) -> bool:
        """True iff this module holds ANY live state for the tenant — the
        quiesced-destination check ``migrate`` runs BEFORE the
        destructive export."""
        raise NotImplementedError

    # -- checkpoint lifecycle (failover) ------------------------------------
    def snapshot_tenant(self, tenant_id: int,
                        now: Optional[float] = None) -> TenantState:
        """Non-destructive ``export_tenant``: the same ``TenantState``
        wire shape, but the tenant keeps running here — the checkpoint
        half of failover. Unlike an export, the snapshot also captures
        the module's LIVE cumulative counters in ``carried`` (a restore
        re-installs them so the post-crash ledger picks up exactly where
        the checkpoint left it)."""
        raise NotImplementedError

    def restore_tenant(self, tenant_id: int, state: TenantState,
                       now: Optional[float] = None) -> None:
        """Install a snapshot onto a crashed-and-rebuilt module: full
        state INCLUDING counters, unlike ``import_tenant`` (which carries
        counters in the operator's ledger instead). Refuses a
        destination with any live state for the tenant — restoring twice
        after a failed attempt must raise, never silently re-add."""
        raise NotImplementedError

    def ground_truth_map(self) -> Dict[int, float]:
        """Every tenant's billed ground truth on this module — including
        tenants that migrated away but left their never-migrates history
        (completed records / billed bytes) here. A checkpoint captures
        this whole map; restoring only currently-placed tenants would
        drop the departed tenants' share and break conservation."""
        raise NotImplementedError

    def restore_ground_truth(self, tenant_id: int, value: float) -> None:
        """SET (never add) one tenant's billed-ground-truth share on a
        crashed-and-rebuilt module, from a checkpoint's
        ``ground_truth_map``."""
        raise NotImplementedError

    def crash(self) -> None:
        """Simulated module crash: wipe ALL live state in place —
        queues, slots, counters, ground truth. Routing/config survives
        (a restarted stack keeps its build config); telemetry reads the
        counter drop as a reset (Prometheus discipline)."""
        raise NotImplementedError

    def fold(self, state: TenantState) -> Dict[str, float]:
        """Ledger-field increments an export contributes to the carried
        view. Default: the state's own flattened counters."""
        return dict(state.carried)

    # -- conservation read surface ------------------------------------------
    def live_counters(self, fld: str) -> Dict[int, float]:
        """Live per-tenant counters for one ``ledger_fields`` entry."""
        raise NotImplementedError

    def live_counter(self, tenant_id: int, fld: str) -> float:
        """One tenant's live counter for one field — the migration hot
        path (``ConservationLedger.total`` runs per move); planes
        override with a direct read instead of materializing the full
        per-tenant dict."""
        return self.live_counters(fld).get(tenant_id, 0)

    def billed_ground_truth(self, tenant_id: int) -> float:
        """This module's share of the tenant's ground truth in
        ``conserved_field`` units — state that NEVER migrates (completed
        requests stay where they billed; routed bytes stay billed where
        they were routed), so summing it over all modules is the
        migration-invariant reference the carried+live ledger must equal.
        """
        raise NotImplementedError

    def inherit_ground_truth(self, old: "StackModule") -> None:
        """Adopt a retired module's billed ground truth (hot-swap only).

        A live stack swap replaces a module *in place*: the replacement
        keeps serving the same engine slot, so the retired module's
        never-migrates state (completed-request records, billed-bytes
        counters) must move to the replacement or the plane's summed
        ground truth would drop by everything the old stack ever billed
        and the conservation assert would fire. Default: nothing to
        inherit (a stateless plane)."""
        return None

    # -- placement read surface ---------------------------------------------
    def tenant_load(self, tenant_id: int) -> TenantLoad:
        """One tenant's instantaneous pressure here (zeros for planes
        with no queue/slot machinery)."""
        return TenantLoad()

    def load(self) -> float:
        """Total demand pressure on this module (queued + in-flight
        requests) — the cluster's hot/cool signal."""
        return 0.0

    # -- park lifecycle (the memory-saved claim) ----------------------------
    def suspend(self) -> int:
        """Release droppable buffers (KV-cache, slot state, scratch) for a
        quiesced module; returns the bytes freed. Default: nothing to
        free."""
        return 0

    def resume(self) -> int:
        """Undo ``suspend``: the module can serve again; buffers may
        re-materialize lazily on first use. Returns the bytes made
        resident eagerly (0 when lazy)."""
        return 0

    def resident_bytes(self) -> int:
        """Droppable buffer bytes currently resident (0 while suspended
        or before lazy re-init)."""
        return 0


class SchedulerServeModule(StackModule):
    """Serve-plane ``StackModule`` over the scheduler + slot surface.

    Anything with a ``TenantScheduler`` at ``self.scheduler``, decode
    ``self.slots`` (objects with ``active``/``req``/``remaining``) and a
    ``self.completed`` request list inherits the whole protocol from here
    — the real ``ServeEngine`` and a model-free test fake
    share one implementation, so the protocol cannot drift between them.

    Suspend/resume hooks for subclasses holding accelerator buffers:
    ``_cache_bytes()`` (resident droppable bytes), ``_release_buffers()``
    (drop them), ``_make_slots()`` (rebuild the slot table on resume).
    """

    plane = "serve"
    ledger_fields = ("served_tokens", "admitted_requests", "deferred_polls",
                     "admit_wait_sum")
    conserved_field = "served_tokens"
    suspended = False
    # logical trace track this module's request events land on; the
    # cluster renames per engine ("engine0", "engine1", ...)
    trace_name = "engine"

    # -- subclass hooks -----------------------------------------------------
    def _make_slots(self) -> List:
        return []

    def _cache_bytes(self) -> int:
        return 0

    def _release_buffers(self) -> None:
        pass

    # -- lifecycle ----------------------------------------------------------
    def export_tenant(self, tenant_id: int,
                      now: Optional[float] = None) -> TenantState:
        return self.scheduler.export_tenant(tenant_id, now)

    def import_tenant(self, tenant_id: int, state: TenantState,
                      now: Optional[float] = None) -> None:
        self.scheduler.import_tenant(tenant_id, state, now)

    def has_tenant(self, tenant_id: int) -> bool:
        return tenant_id in self.scheduler.queues

    # -- checkpoint lifecycle -----------------------------------------------
    def snapshot_tenant(self, tenant_id: int,
                        now: Optional[float] = None) -> TenantState:
        return self.scheduler.snapshot_tenant(tenant_id, now)

    def restore_tenant(self, tenant_id: int, state: TenantState,
                       now: Optional[float] = None) -> None:
        self.scheduler.restore_tenant(tenant_id, state, now)

    def ground_truth_map(self) -> Dict[int, float]:
        out: Dict[int, float] = dict(self.__dict__.get("_gt_baseline") or {})
        for r in self.completed:
            t = r.tenant_id
            out[t] = out.get(t, 0.0) + len(r.prompt) + len(r.generated)
        for s in self.slots:
            if s.active and s.req is not None:
                t = s.req.tenant_id
                out[t] = out.get(t, 0.0) \
                    + len(s.req.prompt) + len(s.req.generated)
        return out

    def restore_ground_truth(self, tenant_id: int, value: float) -> None:
        # completed Request records died with the crash; the restored
        # share lives in a baseline the billed_ground_truth sum includes
        base = self.__dict__.get("_gt_baseline")
        if base is None:
            base = self._gt_baseline = {}
        base[tenant_id] = float(value)

    def restore_latency(self, snap: Dict[str, Dict[int, dict]]) -> None:
        """Wholesale REPLACE of the engine-side latency families from a
        checkpoint's ``{family: {tenant: Histogram payload}}`` view —
        replace, never merge: re-importing the same snapshot after a
        failed restore attempt must rebaseline the counts, not re-add
        them."""
        from repro_torch.obs.hist import Histogram
        hists = self.latency_hists()
        for fam, th in hists.items():
            th.per_tenant = {
                int(t): Histogram.from_payload(p)
                for t, p in (snap.get(fam) or {}).items()}

    def crash(self) -> None:
        """Wipe the serve module in place: queued + in-flight work lost,
        counters and completed records gone, latency tails gone. The
        scheduler/slot config and compiled stack survive — a restarted
        engine slot serves again the moment state is restored.
        ``decode_steps`` (the perf meter) is kept: wiping it would make
        windowed step diffs negative in replay reports."""
        self.scheduler.wipe()
        self.slots = self._make_slots()
        self.completed.clear()
        self.__dict__.pop("_latency_hists", None)
        self.__dict__.pop("_gt_baseline", None)
        self.suspended = False

    def live_counters(self, fld: str) -> Dict[int, float]:
        if fld not in self.ledger_fields:
            raise KeyError(f"unknown serve ledger field {fld!r}")
        return dict(getattr(self.scheduler, fld))

    def live_counter(self, tenant_id: int, fld: str) -> float:
        if fld not in self.ledger_fields:
            raise KeyError(f"unknown serve ledger field {fld!r}")
        return getattr(self.scheduler, fld).get(tenant_id, 0)

    def billed_ground_truth(self, tenant_id: int) -> float:
        """Prompt+generated tokens over this engine's completed and
        in-flight requests. Completed records stay here forever — they
        are the migration-invariant half of conservation."""
        total = sum(len(r.prompt) + len(r.generated)
                    for r in self.completed if r.tenant_id == tenant_id)
        for s in self.slots:
            if s.active and s.req is not None \
                    and s.req.tenant_id == tenant_id:
                total += len(s.req.prompt) + len(s.req.generated)
        # plus any share restored from a checkpoint (the completed
        # records it summarizes died with the crash)
        base = self.__dict__.get("_gt_baseline")
        if base:
            total += base.get(tenant_id, 0.0)
        return float(total)

    def inherit_ground_truth(self, old: "SchedulerServeModule") -> None:
        """Adopt the retired module's completed-request records (its share
        of the serve-plane ground truth) in order, so the cluster's
        completed-collection cursor for this engine slot stays valid. The
        old module must be quiesced first — in-flight slots are the OTHER
        half of ground truth and cannot be inherited mid-generation."""
        if old.inflight():
            raise RuntimeError(
                f"cannot inherit ground truth: {old.inflight()} slot(s) "
                f"still in flight on the retiring module; quiesce first")
        self.completed.extend(old.completed)
        # a restored-from-checkpoint baseline is ground truth too
        old_base = old.__dict__.get("_gt_baseline")
        if old_base:
            base = self.__dict__.get("_gt_baseline")
            if base is None:
                base = self._gt_baseline = {}
            for t, v in old_base.items():
                base[t] = base.get(t, 0.0) + v
        # engine-local latency tails stay attributed to this engine slot
        # across the swap, like the completed records they describe
        hists = self.latency_hists()
        for fam, th in old.latency_hists().items():
            for t, h in th.per_tenant.items():
                hists[fam].absorb(t, h)

    # -- latency observability ----------------------------------------------
    def latency_hists(self) -> Dict[str, TenantHistograms]:
        """Per-tenant TTFT / e2e histogram families, lazily created per
        instance (this is a mixin without an ``__init__``). Engine-side:
        like completed-request records, they never migrate — a tenant's
        tail is attributed to the engine that served it."""
        h = self.__dict__.get("_latency_hists")
        if h is None:
            h = self._latency_hists = {
                "nk_ttft_seconds": TenantHistograms("nk_ttft_seconds"),
                "nk_e2e_seconds": TenantHistograms("nk_e2e_seconds")}
        return h

    def observe_admitted(self, req) -> None:
        """Record one request's dispatch into a decode slot: TTFT (the
        first token exists the moment prefill ran) + a trace instant."""
        if req.arrival >= 0.0 and req.admit_time >= 0.0:
            self.latency_hists()["nk_ttft_seconds"].observe(
                req.tenant_id, max(req.admit_time - req.arrival, 0.0))
        if tracing.TRACER.enabled and req.admit_time >= 0.0:
            tracing.TRACER.instant(
                self.trace_name, "request.dispatch", req.admit_time,
                tenant=req.tenant_id, req=req.req_id)

    def observe_finished(self, req) -> None:
        """Record one request's completion: e2e latency + a trace
        instant."""
        if req.arrival >= 0.0 and req.finish_time >= 0.0:
            self.latency_hists()["nk_e2e_seconds"].observe(
                req.tenant_id, max(req.finish_time - req.arrival, 0.0))
        if tracing.TRACER.enabled and req.finish_time >= 0.0:
            tracing.TRACER.instant(
                self.trace_name, "request.finish", req.finish_time,
                tenant=req.tenant_id, req=req.req_id,
                generated=len(req.generated))

    def latency(self) -> Dict[str, TenantHistograms]:
        """All three latency families for this module: the scheduler's
        admit-wait (which migrates with its tenants) plus the engine-side
        TTFT / e2e."""
        out = dict(self.latency_hists())
        out["nk_admit_wait_seconds"] = self.scheduler.admit_wait_hist
        return out

    # -- placement signals --------------------------------------------------
    def inflight(self, tenant_id: Optional[int] = None) -> int:
        """Active decode slots held by one tenant (or all, if None).

        The drain signal for live migration: a tenant has left this engine
        once its queue was exported *and* its in-flight slots ran dry —
        in-flight requests finish (and bill) where they were admitted, so
        no token is ever lost or moved mid-generation. Tolerates a slot
        whose ``req`` was cleared concurrently (``s.req is None``).
        """
        return sum(1 for s in self.slots if s.active and s.req is not None
                   and (tenant_id is None or s.req.tenant_id == tenant_id))

    def tenant_load(self, tenant_id: int) -> TenantLoad:
        return TenantLoad(
            pending=self.scheduler.pending(tenant_id),
            inflight=self.inflight(tenant_id),
            queued_tokens=float(self.scheduler.queued_cost(tenant_id)),
            inflight_tokens=float(sum(
                s.remaining for s in self.slots
                if s.active and s.req is not None
                and s.req.tenant_id == tenant_id)))

    def load(self) -> float:
        return float(self.scheduler.pending() + self.inflight())

    # -- park lifecycle -----------------------------------------------------
    def suspend(self) -> int:
        """Drop the KV-cache, slot table and step scratch of a quiesced
        engine. Idempotent; raises if any slot is still in flight (the
        cluster parks only quiesced engines — suspending live work would
        strand it)."""
        if self.suspended:
            return 0
        if self.inflight():
            raise RuntimeError(
                f"cannot suspend: {self.inflight()} slot(s) still in "
                f"flight; drain before parking")
        freed = self.resident_bytes()
        self.slots = []
        self._release_buffers()
        self.suspended = True
        return freed

    def resume(self) -> int:
        """Wake a suspended engine: the slot table comes back now, the
        KV-cache lazily on the first admission (see the subclass's
        ``_release_buffers``/cache re-init). Idempotent."""
        if not self.suspended:
            return 0
        self.suspended = False
        self.slots = self._make_slots()
        return self._cache_bytes()

    def resident_bytes(self) -> int:
        return 0 if self.suspended else self._cache_bytes()


class ConservationLedger:
    """Carried ledger + the ONE conservation assert, for any plane.

    Replaces the per-plane ``_fold``/``_fold_core``, ``merged_ledger``
    and duplicated assert logic the cluster used to carry: every plane is
    a list of ``StackModule``s plus this ledger, and the invariant is the
    same everywhere —

        carried (migrated-away history) + sum of live module counters
            == sum of module billed ground truth

    for the plane's ``conserved_field``, at every instant, including
    across migration windows (``fold`` moves an export's counters into
    ``carried`` at the same moment the live source forgets them).
    """

    def __init__(self, modules: Sequence[StackModule],
                 fields: Optional[Sequence[str]] = None,
                 conserved: Optional[str] = None):
        # a list is kept BY REFERENCE: the owner (e.g. EngineCluster) and
        # this ledger must see the same module set, so appending an engine
        # later cannot silently desync conservation from the live fleet
        self.modules: List[StackModule] = (
            modules if isinstance(modules, list) else list(modules))
        if not self.modules and (fields is None or conserved is None):
            raise ValueError(
                "ConservationLedger needs modules, or explicit fields "
                "AND conserved")
        self.fields: Tuple[str, ...] = tuple(
            fields if fields is not None else self.modules[0].ledger_fields)
        self.conserved: str = (conserved if conserved is not None
                               else self.modules[0].conserved_field)
        self.carried: Dict[str, Dict[int, float]] = \
            {f: {} for f in self.fields}

    def fold(self, tenant_id: int, module: StackModule,
             state: TenantState) -> None:
        """Fold one export into the carried view (the module's ``fold``
        maps its state to per-field increments)."""
        inc = module.fold(state)
        for f in self.fields:
            c = self.carried[f]
            c[tenant_id] = c.get(tenant_id, 0) + inc.get(f, 0)

    def merged(self, fld: str) -> Dict[int, float]:
        """Carried history + live per-module counters for one field —
        the continuous cluster-global view."""
        if fld not in self.fields:
            raise KeyError(f"unknown ledger field {fld!r}")
        out = dict(self.carried[fld])
        for m in self.modules:
            for t, v in m.live_counters(fld).items():
                out[t] = out.get(t, 0) + v
        return out

    def total(self, tenant_id: int, fld: Optional[str] = None) -> float:
        """One tenant's carried + live total for ``fld`` (default: the
        conserved field)."""
        fld = self.conserved if fld is None else fld
        return self.carried[fld].get(tenant_id, 0) + sum(
            m.live_counter(tenant_id, fld) for m in self.modules)

    def ground_truth(self, tenant_id: int) -> float:
        return sum(m.billed_ground_truth(tenant_id) for m in self.modules)

    def assert_conservation(self, tenant_id: int, *,
                            plane: str = "") -> None:
        """No lost units, no double-billing: carried+live must equal the
        modules' summed ground truth exactly."""
        ledger = self.total(tenant_id)
        truth = self.ground_truth(tenant_id)
        if int(round(ledger)) != int(round(truth)):
            raise AssertionError(
                f"tenant {tenant_id} {plane or 'stack'} ledger broke "
                f"conservation: ledger says {ledger} {self.conserved}, "
                f"ground truth accounts for {truth}")


@dataclass
class StackPlane:
    """One plane of a cluster: N ``StackModule``s (one per engine slot)
    plus their shared ``ConservationLedger``."""

    name: str
    modules: List[StackModule]
    ledger: ConservationLedger

    @classmethod
    def build(cls, name: str, modules: Sequence[StackModule]) -> "StackPlane":
        """A list is kept by reference (shared with the caller and the
        ledger), so one module set serves load, lifecycle and
        conservation — growing the fleet later can't desync them."""
        mods = modules if isinstance(modules, list) else list(modules)
        return cls(name=name, modules=mods,
                   ledger=ConservationLedger(mods))
