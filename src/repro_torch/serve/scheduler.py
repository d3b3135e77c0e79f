"""Multi-tenant request scheduling: the CoreEngine control plane, serving.

Implements the paper's isolation/fairness mechanisms at the request level:

  * round-robin polling across tenant queues (CoreEngine's baseline),
  * weighted fair queueing (virtual-time WFQ) so a tenant issuing 64
    concurrent requests gets the same decode share as one issuing 8
    (use case 2 — entity-level, not flow-level, fairness),
  * per-tenant token buckets in tokens/s (Fig. 21 rate caps), with
    work-conserving backfill: capped tenants release capacity to others.
"""
from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

from repro_torch.control.vectorized import BucketStore, check_backend
from repro_torch.core.engine import TokenBucket
from repro_torch.fabric import TenantState
from repro_torch.obs import tracing
from repro_torch.obs.hist import Histogram, TenantHistograms


@dataclass
class Request:
    tenant_id: int
    prompt: List[int]
    max_new_tokens: int
    req_id: int = 0
    arrival: float = -1.0      # < 0: unknown (excluded from wait ledger)
    # filled by the engine
    generated: List[int] = field(default_factory=list)
    admit_time: float = -1.0
    finish_time: float = -1.0


class TenantScheduler:
    """Fair multi-tenant admission: WFQ + optional token buckets + RR."""

    def __init__(self, policy: str = "wfq", charge_prompt: bool = False,
                 bucket_backend: str = "object"):
        if policy not in ("wfq", "rr"):
            raise ValueError(f"policy must be 'wfq' or 'rr', got {policy!r}")
        self.policy = policy
        # bucket_backend="vectorized" keeps every tenant's bucket state in
        # one BucketStore (flat float64 arrays); self.buckets then holds
        # StoreBucket views with the identical TokenBucket interface
        self.bucket_backend = check_backend(bucket_backend)
        self._bucket_store = BucketStore() \
            if bucket_backend == "vectorized" else None
        # charge_prompt: buckets price a request at prompt + decode tokens
        # instead of decode only, so admission rates, telemetry (which sees
        # served prompt+decode tokens) and controller capacity share one
        # unit. The e2e replay harness turns this on; default keeps the
        # decode-only pricing.
        self.charge_prompt = charge_prompt
        self.queues: Dict[int, Deque[Request]] = {}
        self.weights: Dict[int, float] = {}
        self.buckets: Dict[int, TokenBucket] = {}
        self.vtime: Dict[int, float] = {}
        self.served_tokens: Dict[int, int] = {}
        # admission ledger (what the replay harness reads): requests admitted,
        # polls where a queued tenant was blocked by its bucket, and the
        # summed arrival->admission wait (needs ``now`` passed through)
        self.admitted_requests: Dict[int, int] = {}
        self.deferred_polls: Dict[int, int] = {}
        self.admit_wait_sum: Dict[int, float] = {}
        # per-tenant arrival->admission wait distribution (log buckets);
        # migrates with the tenant (export/import carry the counts)
        self.admit_wait_hist = TenantHistograms("nk_admit_wait_seconds")
        # trace track this scheduler's admission events land on; the
        # owning engine/cluster renames it ("engine0", ...)
        self.trace_track = "scheduler"
        # quiesce gate for live stack swaps: while True, next_request
        # admits nothing (and doesn't scan — no deferred_polls noise in
        # the ledger), queued work stays put, in-flight slots keep
        # stepping until they drain on the old module
        self.paused = False
        self._rr = itertools.count()
        self._rr_order: List[int] = []

    # -- bucket backend ------------------------------------------------------
    def _new_bucket(self, tenant_id: int, rate: float, burst: float):
        if self._bucket_store is not None:
            return self._bucket_store.add(tenant_id, rate, burst)
        return TokenBucket(rate, burst)

    def _restore_bucket(self, tenant_id: int, snap, now):
        if self._bucket_store is not None:
            return self._bucket_store.restore(tenant_id, snap, now)
        return TokenBucket.restore(snap, now)

    def _drop_bucket(self, tenant_id: int) -> None:
        self.buckets.pop(tenant_id, None)
        if self._bucket_store is not None:
            self._bucket_store.drop(tenant_id)

    # -- tenant management -------------------------------------------------
    def add_tenant(self, tenant_id: int, weight: float = 1.0,
                   rate_tokens_per_s: Optional[float] = None,
                   burst: Optional[float] = None):
        """Register a tenant: WFQ ``weight`` (dimensionless share), optional
        admission cap ``rate_tokens_per_s`` with ``burst`` in tokens
        (defaults to 1 s worth of rate). Resets any existing state."""
        self.queues[tenant_id] = deque()
        self.weights[tenant_id] = weight
        self.vtime[tenant_id] = 0.0
        self.served_tokens[tenant_id] = 0
        self._rr_order.append(tenant_id)
        if rate_tokens_per_s is not None:
            self.buckets[tenant_id] = self._new_bucket(
                tenant_id, rate_tokens_per_s, burst or rate_tokens_per_s)

    def set_rate(self, tenant_id: int,
                 rate_tokens_per_s: Optional[float],
                 burst: Optional[float] = None,
                 now: Optional[float] = None):
        """Controller push: retarget a tenant's admission rate mid-run.

        Preserves the live bucket's token balance (a tick must not reopen a
        fresh burst for a tenant it is throttling). ``None`` lifts the cap.

        Rate-only: a tenant unknown to this scheduler gets a bucket but NO
        queue registration. Controllers probe every enforcement point for
        every tenant, so registering here would grow ghost tenants — empty
        queues that WFQ/RR scan forever and whose stale rate entry would
        greet the tenant whenever it first shows up (see ``drop_tenant``).
        """
        if rate_tokens_per_s is None:
            self._drop_bucket(tenant_id)
            return
        b = self.buckets.get(tenant_id)
        if b is None:
            self.buckets[tenant_id] = b = self._new_bucket(
                tenant_id, rate_tokens_per_s, burst or rate_tokens_per_s)
            if now is not None:
                b.updated = now
        else:
            b.set_rate(rate_tokens_per_s, burst, now)
            if burst is None:
                # requests admit whole: keep >= 1s of burst so a raised rate
                # can actually cover a request (a capacity stuck below one
                # request's cost would starve the queue no matter the rate)
                b.capacity = max(b.capacity, float(rate_tokens_per_s))

    def set_weight(self, tenant_id: int, weight: float):
        """Set a tenant's WFQ weight (dimensionless; 2.0 = twice the decode
        share of a weight-1.0 tenant), registering it if unknown."""
        if tenant_id not in self.queues:
            self.add_tenant(tenant_id, weight=weight)
        self.weights[tenant_id] = weight

    def drop_tenant(self, tenant_id: int):
        """Forget a departed tenant entirely: queue state AND rate entry.

        Regression guard: a tenant with zero queued requests used to keep a
        stale bucket (last pushed rate) forever after ``set_rate``; a tenant
        returning much later was admitted against that stale rate instead of
        starting uncapped.
        """
        self.queues.pop(tenant_id, None)
        self.weights.pop(tenant_id, None)
        self._drop_bucket(tenant_id)
        self.vtime.pop(tenant_id, None)
        self.served_tokens.pop(tenant_id, None)
        self.admitted_requests.pop(tenant_id, None)
        self.deferred_polls.pop(tenant_id, None)
        self.admit_wait_sum.pop(tenant_id, None)
        self.admit_wait_hist.pop(tenant_id)
        if tenant_id in self._rr_order:
            self._rr_order.remove(tenant_id)

    # -- migration ----------------------------------------------------------
    def _live_state(self, tenant_id: int) -> List[str]:
        """Names of the live serve-plane state a tenant holds here (empty
        = quiesced destination).

        Deliberately does NOT include ``buckets``: controllers push
        rate-only buckets to every enforcement point (``set_rate``), so a
        pushed rate must not make a destination look live. But any
        counter a ``ConservationLedger.fold`` already carried
        (``served_tokens`` & co.) MUST: a freshly constructed replacement
        module whose counters were pre-seeded from the retiring module
        (e.g. via ``account`` replay) would otherwise pass the old
        queue-only guard, and the next export would fold those counters a
        second time — the double-fold / counter-replay edge the hot-swap
        path exercises.
        """
        live = []
        if tenant_id in self.queues:
            live.append("queue")
        for fld in ("served_tokens", "admitted_requests", "deferred_polls",
                    "admit_wait_sum", "vtime"):
            if getattr(self, fld).get(tenant_id):
                live.append(fld)
        if tenant_id in self.admit_wait_hist.per_tenant:
            live.append("admit_wait_hist")
        return live

    def export_tenant(self, tenant_id: int,
                      now: Optional[float] = None) -> TenantState:
        """Atomically remove a tenant and return its transferable state.

        The source half of live migration — the serve plane's
        ``StackModule.export_tenant`` body. Returns a ``TenantState``
        whose payload carries the tenant's unserved ``queue`` (list of
        Requests, FIFO order) and WFQ ``weight``, whose ``bucket`` is a
        ``TokenBucket.snapshot`` settled at ``now`` (None if uncapped),
        and whose ``carried`` counters are the cumulative ledger entries
        (``served_tokens`` [tokens], ``admitted_requests``,
        ``deferred_polls``, ``admit_wait_sum`` [s]). The carried entries
        are for the *operator* to fold — ``import_tenant`` deliberately
        does not replay them into the destination, where a sudden counter
        jump would read as a rate spike to telemetry.
        """
        state = TenantState(
            plane="serve",
            bucket=(self.buckets[tenant_id].snapshot(now)
                    if tenant_id in self.buckets else None),
            carried={
                "served_tokens": self.served_tokens.get(tenant_id, 0),
                "admitted_requests":
                    self.admitted_requests.get(tenant_id, 0),
                "deferred_polls": self.deferred_polls.get(tenant_id, 0),
                "admit_wait_sum": self.admit_wait_sum.get(tenant_id, 0.0),
            },
            payload={
                "queue": list(self.queues.get(tenant_id, ())),
                "weight": self.weights.get(tenant_id, 1.0),
            })
        wait_hist = self.admit_wait_hist.per_tenant.get(tenant_id)
        if wait_hist is not None:
            # the wait distribution travels with the tenant (unlike the
            # carried counters it IS replayed into the destination — a
            # histogram merge cannot read as a rate spike to telemetry)
            state.payload["admit_wait_hist"] = wait_hist.to_payload()
        self.drop_tenant(tenant_id)
        return state

    def import_tenant(self, tenant_id: int, state: TenantState,
                      now: Optional[float] = None) -> None:
        """Install a migrated tenant from ``export_tenant`` state.

        The unserved queue arrives in order; the bucket resumes at its
        transferred token balance anchored at ``now`` (migration can never
        reopen a fresh burst); the WFQ virtual time re-joins at the
        destination's current minimum so the migrant competes fairly from
        now instead of replaying a zero-vtime catch-up burst.
        """
        if state.plane != "serve":
            # bucket snapshots are shape-identical across planes: without
            # this guard a bytes-denominated level would silently install
            # as a tokens/s bucket
            raise ValueError(
                f"cannot import a {state.plane!r}-plane TenantState into "
                f"the serve plane")
        live = self._live_state(tenant_id)
        if live:
            raise ValueError(
                f"tenant {tenant_id} has live serve-plane state on the "
                f"destination ({', '.join(live)}); migration requires a "
                f"quiesced destination")
        self.add_tenant(tenant_id,
                        weight=state.payload.get("weight", 1.0))
        self.queues[tenant_id].extend(state.payload.get("queue", ()))
        others = [v for t, v in self.vtime.items() if t != tenant_id]
        self.vtime[tenant_id] = min(others) if others else 0.0
        if state.bucket is not None:
            self.buckets[tenant_id] = self._restore_bucket(
                tenant_id, state.bucket, now)
        hist_payload = state.payload.get("admit_wait_hist")
        if hist_payload is not None:
            self.admit_wait_hist.absorb(
                tenant_id, Histogram.from_payload(hist_payload))

    # -- checkpoint / restore (failover) ------------------------------------
    @staticmethod
    def _copy_request(r: Request) -> Request:
        """A request copy that shares nothing mutable: the checkpoint must
        not alias live ``generated`` lists, or post-checkpoint decode
        would silently inflate the snapshot's ground truth."""
        return Request(tenant_id=r.tenant_id, prompt=list(r.prompt),
                       max_new_tokens=r.max_new_tokens, req_id=r.req_id,
                       arrival=r.arrival, generated=list(r.generated),
                       admit_time=r.admit_time, finish_time=r.finish_time)

    def snapshot_tenant(self, tenant_id: int,
                        now: Optional[float] = None) -> TenantState:
        """Non-destructive ``export_tenant``: same ``TenantState`` wire
        shape, tenant keeps running here. Two deliberate differences:
        queued Requests are deep-copied (no aliasing with the live
        queue), and the payload additionally records the WFQ ``vtime`` —
        a restore resumes competition exactly where the checkpoint left
        it instead of re-joining at the destination minimum."""
        state = TenantState(
            plane="serve",
            bucket=(self.buckets[tenant_id].snapshot(now)
                    if tenant_id in self.buckets else None),
            carried={
                "served_tokens": self.served_tokens.get(tenant_id, 0),
                "admitted_requests":
                    self.admitted_requests.get(tenant_id, 0),
                "deferred_polls": self.deferred_polls.get(tenant_id, 0),
                "admit_wait_sum": self.admit_wait_sum.get(tenant_id, 0.0),
            },
            payload={
                "queue": [self._copy_request(r)
                          for r in self.queues.get(tenant_id, ())],
                "weight": self.weights.get(tenant_id, 1.0),
                "vtime": self.vtime.get(tenant_id, 0.0),
            })
        wait_hist = self.admit_wait_hist.per_tenant.get(tenant_id)
        if wait_hist is not None:
            state.payload["admit_wait_hist"] = wait_hist.to_payload()
        return state

    def restore_tenant(self, tenant_id: int, state: TenantState,
                       now: Optional[float] = None) -> None:
        """Install a checkpoint snapshot onto a crashed-and-wiped
        scheduler: FULL state including cumulative counters (unlike
        ``import_tenant``, which leaves counters to the operator's
        carried ledger). Refused on any live state — restoring the same
        tenant twice after a failed attempt must raise, never re-add."""
        if state.plane != "serve":
            raise ValueError(
                f"cannot restore a {state.plane!r}-plane TenantState into "
                f"the serve plane")
        live = self._live_state(tenant_id)
        if live:
            raise ValueError(
                f"tenant {tenant_id} has live serve-plane state on the "
                f"restore target ({', '.join(live)}); restore requires a "
                f"crashed/quiesced module")
        self.add_tenant(tenant_id,
                        weight=state.payload.get("weight", 1.0))
        # queue copies in: the snapshot stays byte-identical and reusable
        # even if this restored timeline mutates the requests
        self.queues[tenant_id].extend(
            self._copy_request(r) for r in state.payload.get("queue", ()))
        self.vtime[tenant_id] = float(state.payload.get("vtime", 0.0))
        self.served_tokens[tenant_id] = \
            int(state.carried.get("served_tokens", 0))
        self.admitted_requests[tenant_id] = \
            int(state.carried.get("admitted_requests", 0))
        self.deferred_polls[tenant_id] = \
            int(state.carried.get("deferred_polls", 0))
        self.admit_wait_sum[tenant_id] = \
            float(state.carried.get("admit_wait_sum", 0.0))
        if state.bucket is not None:
            # now=None keeps the snapshot's own timestamp (virtual-clock
            # safe: no free refill between checkpoint and restore)
            self.buckets[tenant_id] = self._restore_bucket(
                tenant_id, state.bucket, now)
        hist_payload = state.payload.get("admit_wait_hist")
        if hist_payload is not None:
            # REPLACE, never absorb: a re-restore after a failed attempt
            # must rebaseline the counts, not double them
            self.admit_wait_hist.per_tenant[tenant_id] = \
                Histogram.from_payload(hist_payload)

    def wipe(self) -> None:
        """Simulated crash: every tenant's queue, counters and bucket are
        gone in place. Telemetry reads the counter drop as a reset
        (Prometheus discipline), so a live controller survives it."""
        self.queues.clear()
        self.weights.clear()
        self.buckets.clear()
        if self._bucket_store is not None:
            self._bucket_store = BucketStore()
        self.vtime.clear()
        self.served_tokens.clear()
        self.admitted_requests.clear()
        self.deferred_polls.clear()
        self.admit_wait_sum.clear()
        self.admit_wait_hist.per_tenant.clear()
        self._rr_order.clear()
        self.paused = False

    def submit(self, req: Request):
        """Enqueue one request; an unknown tenant is auto-registered at
        weight 1.0 (uncapped until a controller pushes a rate)."""
        if req.tenant_id not in self.queues:
            self.add_tenant(req.tenant_id)
        self.queues[req.tenant_id].append(req)
        if tracing.TRACER.enabled and req.arrival >= 0.0:
            tracing.TRACER.instant(self.trace_track, "request.arrival",
                                   req.arrival, tenant=req.tenant_id,
                                   req=req.req_id)

    def pending(self, tenant_id: Optional[int] = None) -> int:
        """Unadmitted queued requests for one tenant (or all, if None)."""
        if tenant_id is not None:
            return len(self.queues.get(tenant_id, ()))
        return sum(len(q) for q in self.queues.values())

    def queued_cost(self, tenant_id: int) -> int:
        """Token price of a tenant's unadmitted queue (the bucket unit:
        prompt + decode under ``charge_prompt``, decode only otherwise).
        The placement autopilot's expected-gain signal: tokens that would
        start serving at a migration destination."""
        return sum(self._cost(r) for r in self.queues.get(tenant_id, ()))

    # -- admission ----------------------------------------------------------
    def _admissible(self, t: int, now: Optional[float]) -> bool:
        if not self.queues[t]:
            return False
        b = self.buckets.get(t)
        if b is None:
            return True
        head = self.queues[t][0]
        # admissible iff the bucket can cover the whole request NOW
        ok = b.wait_time(self._cost(head), now) <= 0.0
        if not ok:
            self.deferred_polls[t] = self.deferred_polls.get(t, 0) + 1
            if tracing.TRACER.enabled and now is not None:
                tracing.TRACER.instant(self.trace_track, "request.defer",
                                       now, tenant=t, req=head.req_id)
        return ok

    def next_request(self, now: Optional[float] = None) -> Optional[Request]:
        """Pick the next request to admit (or None; always None while
        ``paused`` — the hot-swap quiesce window)."""
        if self.paused:
            return None
        cands = [t for t in self.queues if self._admissible(t, now)]
        if not cands:
            return None
        if self.policy == "rr":
            # rotate round-robin order
            for _ in range(len(self._rr_order)):
                t = self._rr_order.pop(0)
                self._rr_order.append(t)
                if t in cands:
                    return self._take(t, now)
            return None
        # WFQ: smallest virtual time wins; vtime advances by served work
        t = min(cands, key=lambda q: (self.vtime[q], q))
        return self._take(t, now)

    def _cost(self, req: Request) -> int:
        return req.max_new_tokens + \
            (len(req.prompt) if self.charge_prompt else 0)

    def _take(self, t: int, now) -> Request:
        req = self.queues[t].popleft()
        b = self.buckets.get(t)
        if b is not None:
            b.consume(self._cost(req), now)
        self.admitted_requests[t] = self.admitted_requests.get(t, 0) + 1
        if now is not None and req.arrival >= 0.0:
            wait = max(now - req.arrival, 0.0)
            self.admit_wait_sum[t] = \
                self.admit_wait_sum.get(t, 0.0) + wait
            self.admit_wait_hist.observe(t, wait)
            if tracing.TRACER.enabled:
                tracing.TRACER.instant(self.trace_track, "request.admit",
                                       now, tenant=t, req=req.req_id,
                                       wait_s=round(wait, 6))
        return req

    # -- accounting (engine reports completed work) -------------------------
    def account(self, tenant_id: int, tokens: int):
        """Bill ``tokens`` (prompt and/or generated tokens — the unit the
        buckets and telemetry share) to a tenant and advance its WFQ
        virtual time by tokens/weight."""
        self.served_tokens[tenant_id] = \
            self.served_tokens.get(tenant_id, 0) + tokens
        w = max(self.weights.get(tenant_id, 1.0), 1e-9)
        self.vtime[tenant_id] = self.vtime.get(tenant_id, 0.0) + tokens / w

    def shares(self) -> Dict[int, float]:
        """Each tenant's fraction of all tokens served so far (sums to 1)."""
        tot = max(sum(self.served_tokens.values()), 1)
        return {t: n / tot for t, n in self.served_tokens.items()}

    def ledger(self) -> Dict[int, Dict[str, float]]:
        """Per-tenant admission ledger: the replay harness's source of truth
        (served tokens, admitted/deferred counts, mean admission wait)."""
        out: Dict[int, Dict[str, float]] = {}
        for t in set(self.served_tokens) | set(self.admitted_requests) \
                | set(self.deferred_polls):
            admitted = self.admitted_requests.get(t, 0)
            out[t] = {
                "served_tokens": float(self.served_tokens.get(t, 0)),
                "admitted_requests": float(admitted),
                "deferred_polls": float(self.deferred_polls.get(t, 0)),
                "queued": float(self.pending(t)),
                "mean_admit_wait_s": (self.admit_wait_sum.get(t, 0.0)
                                      / admitted if admitted else 0.0),
            }
        return out
