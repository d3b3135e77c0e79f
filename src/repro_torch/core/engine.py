"""CoreEngine: the NQE switch — routing, accounting, isolation.

The paper's CoreEngine is a software switch on the hypervisor: it maps each
NQE to the right NSM via a connection table, polls queues round-robin for
basic fairness, and can rate-limit a VM in bytes/s or NQEs/s. Here:

  * routing table   : ordered policy rules ``predicate(CommOp) -> nsm name``;
                      the operator swaps a tenant's whole comm stack by
                      editing rules, never model code (use case 3).
  * ledger          : per-(tenant, verb, axes) op/byte accounting of every
                      intent the models issue — the control-plane view.
  * token buckets   : per-tenant rate limiting, also used by the serving
                      scheduler (paper Fig. 21); round-robin polling lives
                      in repro_torch.serve.scheduler.
"""
from __future__ import annotations

import math
import threading
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.nqe import CommOp, describe, payload_bytes
from repro_torch.core.nsm import MeshAxes, Nsm, get_nsm
from repro_torch.fabric.module import StackModule, TenantState

Rule = Tuple[str, Callable[[CommOp], bool], str]   # (name, predicate, nsm)


@dataclass
class LedgerEntry:
    ops: int = 0
    bytes: int = 0


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s, burst up to ``capacity``.

    Tokens are bytes (or request units). ``consume`` returns True if admitted;
    ``wait_time`` reports how long until ``n`` tokens would be available —
    the scheduler uses it for work-conserving backfill.
    """

    def __init__(self, rate: float, capacity: float):
        self.rate = float(rate)
        self.capacity = float(capacity)
        self.tokens = float(capacity)
        self.updated = 0.0

    def _refill(self, now: float):
        if now > self.updated:
            self.tokens = min(self.capacity,
                              self.tokens + (now - self.updated) * self.rate)
            self.updated = now

    def consume(self, n: float, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        self._refill(now)
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def drain(self, n: float, now: Optional[float] = None) -> float:
        """Fluid admission: take up to ``n`` tokens, never going negative.

        Returns the amount actually admitted. CoreEngine enforcement uses
        this (a collective's bytes are a divisible stream, unlike a request,
        which is admitted whole or not at all via ``consume``).
        """
        now = time.monotonic() if now is None else now
        self._refill(now)
        take = min(float(n), max(self.tokens, 0.0))
        self.tokens -= take
        return take

    def wait_time(self, n: float, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        self._refill(now)
        if self.tokens >= n:
            return 0.0
        if self.rate <= 0.0:
            return math.inf          # hard-blocked tenant: never admissible
        return (n - self.tokens) / self.rate

    def set_rate(self, rate: float, burst: Optional[float] = None,
                 now: Optional[float] = None) -> None:
        """Retarget the bucket mid-run, preserving accumulated tokens.

        Settles the balance at the old rate first so a controller pushing
        updates does not retroactively re-price the elapsed interval.
        """
        now = time.monotonic() if now is None else now
        self._refill(now)
        self.rate = float(rate)
        if burst is not None:
            self.capacity = float(burst)
            self.tokens = min(self.tokens, self.capacity)

    # -- migration support -------------------------------------------------
    def snapshot(self, now: Optional[float] = None) -> Dict[str, float]:
        """Return the bucket's transferable state: ``{rate, capacity,
        tokens, updated}`` (units/s, units, units, seconds), settling the
        balance at ``now`` first when given (``None`` keeps the last
        settled level and its timestamp).

        The enforcement-point half of live tenant migration: the level a
        tenant has already burned down travels with it, so moving between
        enforcement points can never reopen a fresh burst.
        """
        if now is not None:
            self._refill(now)
        return {"rate": self.rate, "capacity": self.capacity,
                "tokens": self.tokens, "updated": self.updated}

    @classmethod
    def restore(cls, state: Dict[str, float],
                now: Optional[float] = None) -> "TokenBucket":
        """Rebuild a bucket from ``snapshot()`` output, anchored at ``now``
        so refill resumes from the transfer instant. ``None`` keeps the
        snapshot's own timestamp — the right choice when the caller's
        clock is unknown (virtual-clock replays must NOT be anchored to
        the wall clock, which would freeze refill forever)."""
        b = cls(state["rate"], state["capacity"])
        b.tokens = min(float(state["tokens"]), b.capacity)
        b.updated = float(state.get("updated", 0.0)) if now is None \
            else float(now)
        return b


ENFORCEMENT_MODES = ("off", "account", "defer")


class CoreEngine(StackModule):
    """Routes CommOps to NSMs; accounts and isolates tenants.

    Implements the bytes-plane half of the ``StackModule`` protocol
    (repro_torch.fabric): tenant export/import with bucket-level transfer,
    flattened carried counters, and a monotonic ``billed`` ground-truth
    counter that never migrates — the conservation reference
    ``ConservationLedger`` checks carried+live ledgers against.
    """

    plane = "bytes"
    ledger_fields = ("ops", "bytes", "deferred_ops", "deferred_bytes",
                     "admitted_ops", "admitted_bytes", "admit_wait_s")
    conserved_field = "bytes"

    def __init__(self, mesh=None, default_nsm: str = "xla",
                 enforcement: str = "off"):
        """``mesh``: a ``DeviceMesh`` with ``mesh_dim_names`` (every
        process group over its axes is created here, on every rank), or a
        ``MeshAxes`` already built from one, to share its groups between
        engines; None for an engine that only routes and accounts."""
        self.axes = mesh if mesh is None or isinstance(mesh, MeshAxes) \
            else MeshAxes(mesh)
        self.mesh = None if self.axes is None else self.axes.mesh
        self.default_nsm = default_nsm
        self.rules: List[Rule] = []
        self.ledger: Dict[Tuple[int, str, Tuple[str, ...]], LedgerEntry] = \
            defaultdict(LedgerEntry)
        # bytes/ops that arrived beyond the tenant's rate (shortfall only)
        self.deferred: Dict[Tuple[int, Tuple[str, ...]], LedgerEntry] = \
            defaultdict(LedgerEntry)
        # per-tenant admission view: ops/bytes admitted within rate, and the
        # cumulative shaping delay (seconds) enforcement charged the tenant —
        # the "admission latency" column the replay harness reads
        self.admitted: Dict[int, LedgerEntry] = defaultdict(LedgerEntry)
        self.admit_wait_s: Dict[int, float] = defaultdict(float)
        # per-tenant bytes ever routed HERE — the bytes plane's billed
        # ground truth. Never exported by a migration (the analog of the
        # serve plane's completed-request records staying on the engine
        # that served them), so carried + live ledgers must equal its sum
        # over all engines at every instant: the conservation invariant.
        self.billed: Dict[int, int] = defaultdict(int)
        self.route_log: List[Tuple[bytes, str]] = []
        self.throttle_log: List[Tuple[int, float, float]] = []
        self.buckets: Dict[int, TokenBucket] = {}
        self.set_enforcement(enforcement)
        self.max_defer_s = 0.05      # wall-clock cap per deferred dispatch
        self._lock = threading.Lock()

    # --- connection-table management ------------------------------------
    def add_rule(self, name: str, predicate: Callable[[CommOp], bool],
                 nsm: str) -> None:
        get_nsm(nsm)  # validate eagerly
        self.rules.append((name, predicate, nsm))

    def clear_rules(self) -> None:
        self.rules.clear()

    def set_tenant_rate(self, tenant_id: int, bytes_per_s: float,
                        burst: Optional[float] = None) -> None:
        self.buckets[tenant_id] = TokenBucket(
            bytes_per_s, burst if burst is not None else bytes_per_s)

    def update_tenant_rate(self, tenant_id: int, bytes_per_s: float,
                           burst: Optional[float] = None,
                           now: Optional[float] = None) -> None:
        """Controller push: retarget a live bucket without dropping its
        token balance (``set_tenant_rate`` would reopen the full burst)."""
        b = self.buckets.get(tenant_id)
        if b is None:
            self.set_tenant_rate(tenant_id, bytes_per_s, burst)
            if now is not None:
                self.buckets[tenant_id].updated = now
        else:
            b.set_rate(bytes_per_s, burst, now)

    def set_enforcement(self, mode: str) -> None:
        """off: buckets are advisory (seed behaviour). account: admit
        everything but meter the over-rate excess. defer: additionally
        sleep (bounded) so wall-clock dispatch rates are actually shaped."""
        if mode not in ENFORCEMENT_MODES:
            raise ValueError(f"enforcement must be one of {ENFORCEMENT_MODES}")
        self.enforcement = mode

    def admit(self, op: CommOp, now: Optional[float] = None) -> float:
        """Consume the tenant's bucket for this op; returns the shaping
        delay in seconds (0.0 = admitted entirely within rate).

        The op's bytes are drained from the bucket as a fluid; any shortfall
        is metered in ``deferred`` + ``throttle_log`` and, in ``defer`` mode
        with a real clock, slept off (capped at ``max_defer_s``).
        """
        b = self.buckets.get(op.tenant_id)
        if self.enforcement == "off":
            return 0.0            # seed fast path: no ledger, no lock
        if b is None:
            with self._lock:
                e = self.admitted[op.tenant_id]
                e.ops += 1
                e.bytes += op.size_bytes
            return 0.0
        admitted = b.drain(op.size_bytes, now)
        shortfall = float(op.size_bytes) - admitted
        if shortfall <= 0.0:
            with self._lock:
                e = self.admitted[op.tenant_id]
                e.ops += 1
                e.bytes += op.size_bytes
            return 0.0
        wait = math.inf if b.rate <= 0.0 else shortfall / b.rate
        with self._lock:
            a = self.admitted[op.tenant_id]
            a.bytes += int(admitted)
            e = self.deferred[(op.tenant_id, op.axes)]
            e.ops += 1
            e.bytes += int(shortfall)
            if math.isfinite(wait):
                self.admit_wait_s[op.tenant_id] += wait
            self.throttle_log.append((op.tenant_id, shortfall, wait))
        if self.enforcement == "defer" and now is None:
            time.sleep(min(wait, self.max_defer_s))
        return wait

    # --- routing ---------------------------------------------------------
    def route(self, op: CommOp) -> Nsm:
        choice = self.default_nsm
        for name, pred, nsm in self.rules:
            if pred(op):
                choice = nsm
                break
        with self._lock:
            e = self.ledger[(op.tenant_id, op.verb, op.axes)]
            e.ops += 1
            e.bytes += op.size_bytes
            self.billed[op.tenant_id] += op.size_bytes
            self.route_log.append((op.pack(), choice))
        return get_nsm(choice)

    def route_batch(self, ops: List[CommOp]) -> List[Nsm]:
        """Batched routing (paper Fig. 11: batching the NQE switch)."""
        return [self.route(op) for op in ops]

    # --- execution helper -------------------------------------------------
    def axis_sizes(self) -> MeshAxes:
        """The mesh's axes: each axis's size, and the process groups the
        NSMs run their collectives on (``core/nsm.py::MeshAxes``)."""
        if self.axes is None:
            raise ValueError("CoreEngine needs a mesh to execute collectives")
        return self.axes

    def dispatch(self, verb: str, x, axes: Tuple[str, ...], *, tenant_id=0,
                 tag=0, flags=0, op_data=0, now=None, **kw):
        op = CommOp(verb=verb, axes=tuple(axes), tenant_id=tenant_id, tag=tag,
                    flags=flags, op_data=op_data, size_bytes=payload_bytes(x),
                    shape_desc=describe(x))
        self.admit(op, now)
        nsm = self.route(op)
        fn = getattr(nsm, "psum" if verb == "psum" else verb, None)
        if verb == "shm_move":
            return x
        if fn is None:
            raise ValueError(f"NSM {nsm.name} cannot execute {verb}")
        return fn(x, tuple(axes), axis_sizes=self.axis_sizes(), op=op, **kw)

    # --- migration (bytes-plane half of live tenant migration) -----------
    def _live_state(self, tenant_id: int) -> List[str]:
        """Names of the live bytes-plane state a tenant holds here (empty
        = quiesced). Callers hold ``self._lock``."""
        live = []
        if tenant_id in self.buckets:
            live.append("bucket")
        if any(k[0] == tenant_id for k in self.ledger):
            live.append("ledger")
        if any(k[0] == tenant_id for k in self.deferred):
            live.append("deferred")
        if tenant_id in self.admitted:
            live.append("admitted")
        if tenant_id in self.admit_wait_s:
            live.append("admit_wait_s")
        return live

    def has_tenant(self, tenant_id: int) -> bool:
        """True iff the tenant holds ANY live bytes-plane state here —
        the quiesced-destination check a migration runs before its
        destructive export."""
        with self._lock:
            return bool(self._live_state(tenant_id))

    def export_tenant(self, tenant_id: int,
                      now: Optional[float] = None) -> TenantState:
        """Atomically remove a tenant's bytes-plane state and return it.

        Mirrors ``TenantScheduler.export_tenant`` for the collective
        fabric: the tenant's token-bucket *level* travels (a move can
        never reopen a fresh burst of bytes), and the cumulative ledger /
        deferred / admitted counters flatten into ``TenantState.carried``
        for the caller to fold — ``import_tenant`` deliberately does not
        replay them into the destination engine, where the jump would
        read as a rate spike to ``EngineTelemetry`` (the same
        counter-reset discipline the scheduler plane uses). The
        per-(verb, axes) breakdown rides in ``payload`` for audit.
        Conservation: carried + both engines' live counters must be
        unchanged across the move; ``ConservationLedger`` asserts exactly
        that on every plan.
        """
        with self._lock:
            ledger = {}
            for key in [k for k in self.ledger if k[0] == tenant_id]:
                e = self.ledger.pop(key)
                ledger[(key[1], key[2])] = (e.ops, e.bytes)
            deferred = {}
            for key in [k for k in self.deferred if k[0] == tenant_id]:
                e = self.deferred.pop(key)
                deferred[key[1]] = (e.ops, e.bytes)
            adm = self.admitted.pop(tenant_id, None)
            wait = self.admit_wait_s.pop(tenant_id, 0.0)
            state = TenantState(
                plane="bytes",
                bucket=(self.buckets[tenant_id].snapshot(now)
                        if tenant_id in self.buckets else None),
                carried={
                    "ops": sum(o for o, _ in ledger.values()),
                    "bytes": sum(b for _, b in ledger.values()),
                    "deferred_ops": sum(o for o, _ in deferred.values()),
                    "deferred_bytes": sum(b for _, b in deferred.values()),
                    "admitted_ops": adm.ops if adm else 0,
                    "admitted_bytes": adm.bytes if adm else 0,
                    "admit_wait_s": wait,
                },
                payload={
                    "ledger": ledger,               # (verb, axes) -> (ops, b)
                    "deferred": deferred,           # axes -> (ops, bytes)
                    "admitted": (adm.ops, adm.bytes) if adm else (0, 0),
                })
            self.buckets.pop(tenant_id, None)
        return state

    def import_tenant(self, tenant_id: int, state: TenantState,
                      now: Optional[float] = None) -> None:
        """Install a migrated tenant's bytes-plane state.

        Only the enforcement state (the bucket, at its transferred level,
        anchored at ``now``) lands here; the exported counters stay with
        the operator's carried ledger — see ``export_tenant``.

        Refuses a destination holding ANY live state for the tenant —
        not just a bucket: an unbucketed tenant with live ledger or
        deferred entries here would merge silently and corrupt byte
        continuity (the carried+live invariant would double-count its
        history on the next export).
        """
        if state.plane != self.plane:
            # bucket snapshots are shape-identical across planes: without
            # this guard a tokens-denominated level would silently install
            # as a bytes/s bucket
            raise ValueError(
                f"cannot import a {state.plane!r}-plane TenantState into "
                f"the {self.plane} plane")
        with self._lock:
            live = self._live_state(tenant_id)
            if live:
                raise ValueError(
                    f"tenant {tenant_id} has live bytes-plane state on "
                    f"this engine ({', '.join(live)}); migration "
                    f"requires a quiesced destination")
            if state.bucket is not None:
                self.buckets[tenant_id] = TokenBucket.restore(
                    state.bucket, now)

    # --- checkpoint / restore (failover) ----------------------------------
    def snapshot_tenant(self, tenant_id: int,
                        now: Optional[float] = None) -> TenantState:
        """Non-destructive ``export_tenant``: same wire shape, tenant
        keeps routing here. The per-(verb, axes) detail in the payload is
        the restore's source of truth (``restore_tenant`` re-installs it
        entry for entry, unlike a migration import)."""
        with self._lock:
            ledger = {(k[1], k[2]): (e.ops, e.bytes)
                      for k, e in self.ledger.items() if k[0] == tenant_id}
            deferred = {k[1]: (e.ops, e.bytes)
                        for k, e in self.deferred.items()
                        if k[0] == tenant_id}
            adm = self.admitted.get(tenant_id)
            wait = self.admit_wait_s.get(tenant_id, 0.0)
            return TenantState(
                plane="bytes",
                bucket=(self.buckets[tenant_id].snapshot(now)
                        if tenant_id in self.buckets else None),
                carried={
                    "ops": sum(o for o, _ in ledger.values()),
                    "bytes": sum(b for _, b in ledger.values()),
                    "deferred_ops": sum(o for o, _ in deferred.values()),
                    "deferred_bytes": sum(b for _, b in deferred.values()),
                    "admitted_ops": adm.ops if adm else 0,
                    "admitted_bytes": adm.bytes if adm else 0,
                    "admit_wait_s": wait,
                },
                payload={
                    "ledger": ledger,
                    "deferred": deferred,
                    "admitted": (adm.ops, adm.bytes) if adm else (0, 0),
                })

    def restore_tenant(self, tenant_id: int, state: TenantState,
                       now: Optional[float] = None) -> None:
        """Install a checkpoint snapshot onto a crashed engine: the full
        per-(verb, axes) ledger detail, deferred and admitted counters
        come back (unlike ``import_tenant``). Refused on any live state
        for the tenant — a double restore must raise, never re-add.
        Zero-valued entries are skipped: materializing them in the
        defaultdicts would make the tenant read as live forever."""
        if state.plane != self.plane:
            raise ValueError(
                f"cannot restore a {state.plane!r}-plane TenantState into "
                f"the {self.plane} plane")
        with self._lock:
            live = self._live_state(tenant_id)
            if live:
                raise ValueError(
                    f"tenant {tenant_id} has live bytes-plane state on "
                    f"this engine ({', '.join(live)}); restore requires a "
                    f"crashed/quiesced module")
            for (verb, axes), (ops, byts) in \
                    (state.payload.get("ledger") or {}).items():
                if ops or byts:
                    e = self.ledger[(tenant_id, verb, tuple(axes))]
                    e.ops, e.bytes = int(ops), int(byts)
            for axes, (ops, byts) in \
                    (state.payload.get("deferred") or {}).items():
                if ops or byts:
                    e = self.deferred[(tenant_id, tuple(axes))]
                    e.ops, e.bytes = int(ops), int(byts)
            adm_ops, adm_bytes = state.payload.get("admitted", (0, 0))
            if adm_ops or adm_bytes:
                e = self.admitted[tenant_id]
                e.ops, e.bytes = int(adm_ops), int(adm_bytes)
            wait = float(state.carried.get("admit_wait_s", 0.0))
            if wait:
                self.admit_wait_s[tenant_id] = wait
            if state.bucket is not None:
                self.buckets[tenant_id] = TokenBucket.restore(
                    state.bucket, now)

    def ground_truth_map(self) -> Dict[int, float]:
        """Every tenant's billed bytes on this engine — including tenants
        that migrated away but stay billed here."""
        with self._lock:
            return {t: float(b) for t, b in self.billed.items() if b}

    def restore_ground_truth(self, tenant_id: int, value: float) -> None:
        """SET one tenant's billed-bytes ground truth from a checkpoint."""
        with self._lock:
            self.billed[tenant_id] = int(value)

    def crash(self) -> None:
        """Simulated crash: every tenant's enforcement and accounting
        state wiped in place. Routing config (rules, default NSM, mesh,
        enforcement mode) survives — a restarted switch routes the same
        way the moment state is restored."""
        with self._lock:
            self.ledger.clear()
            self.deferred.clear()
            self.admitted.clear()
            self.admit_wait_s.clear()
            self.billed.clear()
            self.route_log.clear()
            self.throttle_log.clear()
            self.buckets.clear()

    def live_counters(self, fld: str) -> Dict[int, float]:
        """Live per-tenant totals for one ``ledger_fields`` entry,
        flattened from the per-(verb, axes) detail under the lock."""
        with self._lock:
            out: Dict[int, float] = defaultdict(float)
            if fld in ("ops", "bytes"):
                for (t, _, _), e in self.ledger.items():
                    out[t] += e.ops if fld == "ops" else e.bytes
            elif fld in ("deferred_ops", "deferred_bytes"):
                for (t, _), e in self.deferred.items():
                    out[t] += e.ops if fld == "deferred_ops" else e.bytes
            elif fld in ("admitted_ops", "admitted_bytes"):
                for t, e in self.admitted.items():
                    out[t] += e.ops if fld == "admitted_ops" else e.bytes
            elif fld == "admit_wait_s":
                for t, w in self.admit_wait_s.items():
                    out[t] += w
            else:
                raise KeyError(f"unknown bytes ledger field {fld!r}")
            return dict(out)

    def live_counter(self, tenant_id: int, fld: str) -> float:
        """One tenant's live total for one field — tallied directly under
        the lock (the migration hot path; no full-dict materialization)."""
        with self._lock:
            if fld in ("ops", "bytes"):
                return float(sum(
                    e.ops if fld == "ops" else e.bytes
                    for (t, _, _), e in self.ledger.items()
                    if t == tenant_id))
            if fld in ("deferred_ops", "deferred_bytes"):
                return float(sum(
                    e.ops if fld == "deferred_ops" else e.bytes
                    for (t, _), e in self.deferred.items()
                    if t == tenant_id))
            if fld in ("admitted_ops", "admitted_bytes"):
                e = self.admitted.get(tenant_id)
                if e is None:
                    return 0.0
                return float(e.ops if fld == "admitted_ops" else e.bytes)
            if fld == "admit_wait_s":
                return float(self.admit_wait_s.get(tenant_id, 0.0))
            raise KeyError(f"unknown bytes ledger field {fld!r}")

    def billed_ground_truth(self, tenant_id: int) -> float:
        """Bytes ever routed for the tenant on THIS engine — monotonic,
        never exported, the migration-invariant conservation reference."""
        with self._lock:
            return float(self.billed.get(tenant_id, 0))

    def inherit_ground_truth(self, old: "CoreEngine") -> None:
        """Adopt a retired engine's billed-bytes ground truth (hot-swap
        only): the replacement keeps serving the same engine slot, so the
        bytes the old stack routed must stay billed *here* or the plane's
        summed ground truth would drop and conservation would break."""
        with old._lock:
            inherited = dict(old.billed)
        with self._lock:
            for t, b in inherited.items():
                self.billed[t] += b

    def suspend(self) -> int:
        """Bytes-plane park: the switch holds no accelerator buffers, so
        suspending only trims the audit scratch (route/throttle logs).
        Enforcement state (buckets, billed ground truth) is untouched."""
        with self._lock:
            self.route_log.clear()
            self.throttle_log.clear()
        return 0

    # --- reporting ---------------------------------------------------------
    def ledger_table(self) -> List[Tuple[int, str, Tuple[str, ...], int, int]]:
        with self._lock:
            return sorted(
                (t, v, a, e.ops, e.bytes)
                for (t, v, a), e in self.ledger.items())

    def total_bytes(self, tenant_id: Optional[int] = None) -> int:
        with self._lock:
            return sum(e.bytes for (t, _, _), e in self.ledger.items()
                       if tenant_id is None or t == tenant_id)

    def snapshot(self) -> Tuple[Dict, Dict]:
        """Consistent copy of (ledger, deferred) counters under the lock —
        the telemetry read path (iterating the live dicts races dispatch)."""
        with self._lock:
            return ({k: (e.ops, e.bytes) for k, e in self.ledger.items()},
                    {k: (e.ops, e.bytes) for k, e in self.deferred.items()})

    def deferred_bytes(self, tenant_id: Optional[int] = None) -> int:
        with self._lock:
            return sum(e.bytes for (t, _), e in self.deferred.items()
                       if tenant_id is None or t == tenant_id)

    def admit_snapshot(self) -> Dict[int, Tuple[int, int, float]]:
        """Per-tenant (admitted_ops, admitted_bytes, cumulative shaping
        delay s) — the engine-side admission-latency ledger."""
        with self._lock:
            return {t: (e.ops, e.bytes, self.admit_wait_s.get(t, 0.0))
                    for t, e in self.admitted.items()}

    def reset_ledger(self) -> None:
        with self._lock:
            self.ledger.clear()
            self.deferred.clear()
            self.admitted.clear()
            self.admit_wait_s.clear()
            self.billed.clear()
            self.route_log.clear()
            self.throttle_log.clear()


# ---------------------------------------------------------------------------
# Stock operator policies (what `RunConfig.nsm_policy` selects)
# ---------------------------------------------------------------------------


def make_engine(mesh, policy: str = "xla") -> CoreEngine:
    """Build a CoreEngine with one of the stock routing policies.

    xla           everything on the native stack (paper-faithful baseline:
                  "the kernel stack NSM").
    ring          large payloads on the explicit ring stack, small ops native
                  (message-size-based stack selection).
    hierarchical  multi-axis reductions 2-level; rest native.
    compressed    gradient-flagged psums on slow axes int8; rest hierarchical.
    shm-first     sharding-compatible moves elided, rest native.
    """
    eng = CoreEngine(mesh=mesh, default_nsm="xla")
    if policy == "xla":
        pass
    elif policy == "ring":
        eng.add_rule("large-to-ring",
                     lambda op: op.size_bytes >= 1 << 20 and op.verb in
                     ("psum", "all_gather", "reduce_scatter"), "ring2")
    elif policy == "hierarchical":
        eng.add_rule("multiaxis-psum",
                     lambda op: op.verb == "psum" and len(op.axes) > 1,
                     "hierarchical")
    elif policy == "compressed":
        eng.add_rule("grad-pod-psum",
                     lambda op: op.verb == "psum" and bool(op.flags & 1)
                     and "pod" in op.axes, "compressed")
        eng.add_rule("multiaxis-psum",
                     lambda op: op.verb == "psum" and len(op.axes) > 1,
                     "hierarchical")
    elif policy == "shm-first":
        eng.add_rule("elide-compatible",
                     lambda op: bool(op.op_data & 1), "shm")
    else:
        raise ValueError(f"unknown nsm policy {policy!r}")
    return eng
