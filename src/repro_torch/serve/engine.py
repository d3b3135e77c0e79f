"""Multi-tenant serving engine: continuous batching over shared decode steps.

The counterpart of ``repro/serve/engine.py``. One engine ("NSM") serves
requests from many tenants ("VMs"): decode slots are the shared resource,
the ``TenantScheduler`` decides admission with fairness/rate policies, and
all tenants share one copy of the weights. Each admission runs one prefill
(the flash-attention kernel, or the SSD-scan kernel on an SSM model) and
installs the request's cache into a free slot; each step runs one batched
decode (the decode-attention kernel, or the SSM state update) over all
slots plus a greedy argmax.

On a mesh (``shd``, a ``ShardingCtx``: the dense family) every rank runs
its own engine over the same requests: the same scheduler state and one
clock (``ShardingCtx.agreed_now``) give every rank the same admission
decisions. A prefill runs on each rank's shards; a slot's cache is
installed by the data rank that holds the slot's row; each data rank
decodes its rows, and the sampled tokens are all-gathered over the batch
axes, so every rank's ``Slot``s agree. The collectives go through the
``nk_*`` verbs and the installed ``CoreEngine``.

A request carries token ids only, so an encoder model (whisper), whose
prefill needs frames, is refused at construction (ROADMAP R9: the
reference's engine takes it and fails at its first prefill); it is served
through ``forward_prefill(..., frames=)`` and ``forward_decode``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.device import resolve_device
from repro_torch.fabric import SchedulerServeModule
from repro_torch.models.model import (
    Model, cache_nbytes, check_family, check_slot_prompt,
    forward_decode, forward_prefill, gather_rows, greedy, init_cache,
)
from repro_torch.models.params import init_params
from repro_torch.serve.scheduler import Request, TenantScheduler


@dataclass
class Slot:
    active: bool = False
    req: Optional[Request] = None
    pos: int = 0           # next write position (== tokens so far - 1)
    remaining: int = 0


class ServeEngine(SchedulerServeModule):
    """Slot-based continuous batching engine (greedy decoding).

    Implements the serve-plane ``StackModule`` protocol
    (``repro_torch.fabric``) via ``SchedulerServeModule``: tenant
    export/import delegate to the scheduler, ``billed_ground_truth`` reads
    completed requests + live slots, and ``suspend``/``resume`` make
    parking a real memory saving — suspend drops the KV-cache and slot
    table; the cache re-materializes lazily on the first admission after
    resume.
    """

    def __init__(self, cfg: ModelConfig, rcfg: RunConfig,
                 params: Optional[Model] = None, *, batch_slots: int = 8,
                 max_seq: int = 256,
                 scheduler: Optional[TenantScheduler] = None,
                 controller=None, control_every: int = 4, device=None,
                 generator: Optional[torch.Generator] = None, shd=None):
        """``batch_slots``: concurrent decode slots (the shared resource);
        ``max_seq``: KV-cache length in tokens; ``params``: a ``Model`` to
        share (another engine's weights) or None to initialize fresh ones
        on ``device`` from ``generator``; ``controller``: optional
        management-plane hook ticked every ``control_every`` steps.
        ``device``: ``cuda`` unless ``"cpu"`` is passed (raises without a
        card). ``shd``: a ``ShardingCtx`` on a mesh; ``params`` must then
        be made with it."""
        self.cfg, self.rcfg = check_family(cfg), rcfg
        self.shd = shd if shd is not None and shd.mesh is not None \
            else None
        if cfg.encoder_layers:
            raise ValueError(
                f"{cfg.name}: ServeEngine cannot serve an encoder model; its "
                f"prefill needs frames, which a Request does not carry "
                f"(ROADMAP R9)")
        self.device = resolve_device(
            params.device if params is not None and device is None
            else device)
        self.B, self.max_seq = batch_slots, max_seq
        self.scheduler = scheduler or TenantScheduler()
        # management plane: anything with tick(now) — typically a
        # RateController attached to self.scheduler. Rates it pushes take
        # effect on the very next admission decision.
        self.controller = controller
        self.control_every = max(int(control_every), 1)
        if params is not None and params.device != self.device:
            raise ValueError(f"params live on {params.device}, engine on "
                             f"{self.device}")
        if params is not None and params.shd is not self.shd:
            raise ValueError("params were made for another ShardingCtx "
                             "than the engine's")
        self.params = params if params is not None else init_params(
            cfg, device=self.device, generator=generator, shd=self.shd)
        # the batch rows this rank holds (all of them off a mesh)
        self._rows = range(self.B) if self.shd is None else range(
            self.B)[self.shd.block(self.shd.split("batch", self.B),
                                   self.B)]
        self.slots = self._make_slots()
        self.caches = None
        self._cache_nbytes = 0
        self._init_caches()
        self.steps = 0
        self.decode_steps = 0
        self.admissions = 0
        self.completed: List[Request] = []
        self.step_times: List[float] = []

    # -- StackModule buffer hooks (the suspend/resume memory story) --------
    def _make_slots(self):
        return [Slot() for _ in range(self.B)]

    def _init_caches(self) -> None:
        """(Re-)materialize the zeroed KV-cache — at construction, and
        lazily on the first admission after a ``resume``. Admission
        overwrites a slot's whole cache, so a re-init is bit-identical to
        never having suspended."""
        self.caches = init_cache(self.cfg, self.B, self.max_seq,
                                 dtype=self.rcfg.kv_cache_dtype,
                                 device=self.device, shd=self.shd)
        self._cache_nbytes = cache_nbytes(self.caches)

    def _cache_bytes(self) -> int:
        return 0 if self.caches is None else self._cache_nbytes

    def _release_buffers(self) -> None:
        self.caches = None
        self.step_times = []

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        """Queue one request for admission (delegates to the scheduler).
        Raises ValueError, before queueing, for a prompt no prefill can
        serve or no slot can hold (``models.model.check_slot_prompt``)."""
        check_slot_prompt(self.cfg, len(req.prompt), self.max_seq)
        self.scheduler.submit(req)

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if not s.active:
                return i
        return None

    def _admit(self, now=None):
        while True:
            i = self._free_slot()
            if i is None:
                return
            req = self.scheduler.next_request(now)
            if req is None:
                return
            if self.caches is None:
                # lazy resume: the KV-cache dropped at park re-materializes
                # only when a request actually lands here
                self._init_caches()
            prompt = torch.tensor([req.prompt], dtype=torch.int32,
                                  device=self.device)
            last_logits, caches1 = forward_prefill(
                self.params, prompt, self.rcfg, max_seq=self.max_seq)
            self.admissions += 1
            # install the single-sequence cache into slot i: the WHOLE slot
            # row, zero padding included — inactive slots decode at pos 0
            # (ring slot 0 too) and would otherwise leave a stale row 0
            # behind. On a mesh, the rank that holds row i installs it.
            if i in self._rows:
                row = i - self._rows.start
                for big, one in zip(self.caches, caches1):
                    for k in big:
                        big[k][:, row].copy_(one[k][:, 0])
            first = int(greedy(self.params, last_logits)[0])
            req.generated.append(first)
            req.admit_time = time.monotonic() if now is None else now
            self.observe_admitted(req)
            # prompt tokens + the first generated token: prefill produced
            # both, so the ledger bills them here — decode steps only
            # account the tokens they themselves produce
            self.scheduler.account(req.tenant_id, len(req.prompt) + 1)
            if req.max_new_tokens <= 1:
                # prefill already produced the only requested token; a slot
                # would run one decode step anyway and over-generate
                req.finish_time = req.admit_time
                self.completed.append(req)
                self.observe_finished(req)
                continue
            self.slots[i] = Slot(active=True, req=req,
                                 pos=len(req.prompt),
                                 remaining=req.max_new_tokens - 1)

    def step(self, now=None) -> int:
        """Admit + one decode step for all active slots. Returns #active."""
        if self.suspended:
            raise RuntimeError(
                "engine is suspended (parked); resume() before stepping")
        t0 = time.monotonic()
        if self.shd is not None:
            now = self.shd.agreed_now(now)
        self.steps += 1
        # tick before admission (and before the no-work early return): a
        # fully-throttled engine must still get rate updates or it livelocks
        if self.controller is not None and \
                self.steps % self.control_every == 0:
            self.controller.tick(time.monotonic() if now is None else now)
        self._admit(now)
        active = [i for i, s in enumerate(self.slots) if s.active]
        if not active:
            return 0
        tokens = np.zeros((self.B, 1), np.int32)
        pos = np.zeros((self.B,), np.int32)
        for i, s in enumerate(self.slots):
            if s.active:
                tokens[i, 0] = s.req.generated[-1]
                pos[i] = s.pos
        logits, self.caches = forward_decode(
            self.params, self.caches,
            torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(pos).to(self.device), self.rcfg,
            max_seq=self.max_seq)
        nxt = gather_rows(self.shd, greedy(self.params, logits),
                          self.B).cpu().numpy()
        for i in active:
            s = self.slots[i]
            s.req.generated.append(int(nxt[i]))
            s.pos += 1
            s.remaining -= 1
            self.scheduler.account(s.req.tenant_id, 1)
            if s.remaining <= 0 or s.pos >= self.max_seq - 1:
                s.req.finish_time = time.monotonic() if now is None else now
                self.completed.append(s.req)
                self.observe_finished(s.req)
                self.slots[i] = Slot()
        self.decode_steps += 1
        self.step_times.append(time.monotonic() - t0)
        return len(active)

    def run_until_drained(self, max_steps: int = 10000) -> Dict:
        n = 0
        while (self.scheduler.pending() or
               any(s.active for s in self.slots)) and n < max_steps:
            self.step()
            n += 1
        return {"decode_steps": self.decode_steps,
                "completed": len(self.completed),
                "shares": self.scheduler.shares()}

    # -- utilization metrics ------------------------------------------------
    def slot_utilization(self) -> float:
        """Fraction of slot-steps that produced a token (1.0 = no idle
        slots across the run)."""
        if not self.decode_steps:
            return 0.0
        served = sum(len(r.generated) for r in self.completed)
        return served / max(self.decode_steps * self.B, 1)
