"""FabricSnapshot: the whole fabric as one versioned, serializable value.

The counterpart of ``repro/fabric/checkpoint.py``: the same wire format,
so the same fabric state gives the same bytes in both packages.

NetKernel's premise — the stack is operator-managed infrastructure —
only holds in production if the operator can kill and restore a stack
module without tenants losing or double-billing a unit. This module is
the state half of that claim: a ``FabricSnapshot`` captures everything
``EngineCluster.restore`` / ``recover_engine`` need to re-materialize a
crashed engine —

  * every plane's per-tenant ``TenantState`` per module (bucket
    snapshot, cumulative counters, plane payload — the same wire shape a
    migration moves, captured non-destructively via ``snapshot_tenant``),
  * each module's full billed-ground-truth map (including tenants that
    migrated away but left their never-migrates history behind) and the
    serve plane's engine-side latency histograms,
  * the ``ConservationLedger`` carried view per plane,
  * the cluster's placement/draining maps, park set and swap log,
  * the controller's soft state (capacity, tick count, allocations).

``to_bytes``/``from_bytes`` is a DETERMINISTIC round trip: canonical
JSON (sorted keys, fixed separators, UTF-8), a leading ``version`` field
with strict-reject on anything unknown, and explicit codecs for the two
plane payloads — this is the wire format the fleet layer will reuse for
cross-cluster moves, so ``from_bytes(to_bytes(s)) == s`` exactly and
``to_bytes`` is byte-stable.

Stdlib only; ``Request`` is imported lazily inside the serve codec to
keep the fabric package import-cycle-free (serve.scheduler imports
``TenantState`` from here at module load).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List

from repro_torch.fabric.module import TenantState

FABRIC_SNAPSHOT_VERSION = 1


@dataclass
class ModuleSnapshot:
    """One ``StackModule``'s checkpointed state.

    ``tenants`` holds a ``TenantState`` per tenant *placed* on the
    module at checkpoint time. ``ground_truth`` is the module's FULL
    billed-ground-truth map — deliberately wider than ``tenants``:
    departed tenants' completed records / billed bytes stay on the
    module forever, and dropping them in a crash+recover would break
    conservation against the carried ledger. ``latency`` is the serve
    plane's engine-side histogram families (``{family: {tenant:
    Histogram payload}}``; empty for planes without latency state).
    """

    tenants: Dict[int, TenantState] = field(default_factory=dict)
    ground_truth: Dict[int, float] = field(default_factory=dict)
    latency: Dict[str, Dict[int, dict]] = field(default_factory=dict)


@dataclass
class PlaneSnapshot:
    """One plane: a ``ModuleSnapshot`` per engine slot plus the plane's
    ``ConservationLedger`` carried view (``{field: {tenant: value}}``)."""

    name: str
    carried: Dict[str, Dict[int, float]] = field(default_factory=dict)
    modules: List[ModuleSnapshot] = field(default_factory=list)


@dataclass
class FabricSnapshot:
    """The whole fabric at one instant — see the module docstring.

    Field units: ``step`` is cluster steps; ``placement``/``draining``
    map tenant → engine index; ``parked`` is a sorted engine-index list;
    ``controller`` carries {capacity [units/s], ticks, allocations
    {tenant: units/s}}; ``swap_log`` entries are ``SwapRecord`` fields
    as plain dicts.
    """

    version: int = FABRIC_SNAPSHOT_VERSION
    step: int = 0
    placement: Dict[int, int] = field(default_factory=dict)
    draining: Dict[int, int] = field(default_factory=dict)
    parked: List[int] = field(default_factory=list)
    planes: List[PlaneSnapshot] = field(default_factory=list)
    controller: Dict[str, Any] = field(default_factory=dict)
    swap_log: List[dict] = field(default_factory=list)

    # -- serialization ------------------------------------------------------
    def to_bytes(self) -> bytes:
        """Canonical JSON: sorted keys, no whitespace, UTF-8. Two calls
        on equal snapshots produce identical bytes."""
        return json.dumps(_encode_snapshot(self), sort_keys=True,
                          separators=(",", ":")).encode("utf-8")

    @classmethod
    def from_bytes(cls, data: bytes) -> "FabricSnapshot":
        """Strict inverse of ``to_bytes``. Rejects unknown versions by
        value — an old reader must never mis-install a newer layout."""
        doc = json.loads(data.decode("utf-8"))
        version = doc.get("version")
        if version != FABRIC_SNAPSHOT_VERSION:
            raise ValueError(
                f"unknown FabricSnapshot version {version!r} "
                f"(this reader understands {FABRIC_SNAPSHOT_VERSION})")
        return _decode_snapshot(doc)


# ---------------------------------------------------------------------------
# codecs (explicit per payload shape — no generic object hooks, so the
# wire format is exactly what this file spells out)
# ---------------------------------------------------------------------------


def _encode_request(r) -> dict:
    return {"tenant_id": r.tenant_id, "prompt": list(r.prompt),
            "max_new_tokens": r.max_new_tokens, "req_id": r.req_id,
            "arrival": r.arrival, "generated": list(r.generated),
            "admit_time": r.admit_time, "finish_time": r.finish_time}


def _decode_request(d: dict):
    # lazy: serve.scheduler imports TenantState from the fabric package
    from repro_torch.serve.scheduler import Request
    return Request(tenant_id=int(d["tenant_id"]),
                   prompt=list(d["prompt"]),
                   max_new_tokens=int(d["max_new_tokens"]),
                   req_id=int(d["req_id"]), arrival=float(d["arrival"]),
                   generated=list(d["generated"]),
                   admit_time=float(d["admit_time"]),
                   finish_time=float(d["finish_time"]))


def _encode_tenant_state(s: TenantState) -> dict:
    out = {"plane": s.plane, "bucket": s.bucket,
           "carried": dict(s.carried)}
    payload = dict(s.payload)
    if "queue" in payload:                       # serve plane
        payload["queue"] = [_encode_request(r) for r in payload["queue"]]
    if "ledger" in payload:                      # bytes plane
        payload["ledger"] = sorted(
            [verb, list(axes), ops, byts]
            for (verb, axes), (ops, byts) in payload["ledger"].items())
        payload["deferred"] = sorted(
            [list(axes), ops, byts]
            for axes, (ops, byts) in payload["deferred"].items())
        payload["admitted"] = list(payload.get("admitted", (0, 0)))
    out["payload"] = payload
    return out


def _decode_tenant_state(d: dict) -> TenantState:
    payload = dict(d.get("payload") or {})
    if "queue" in payload:
        payload["queue"] = [_decode_request(r) for r in payload["queue"]]
    if "ledger" in payload:
        payload["ledger"] = {
            (verb, tuple(axes)): (int(ops), int(byts))
            for verb, axes, ops, byts in payload["ledger"]}
        payload["deferred"] = {
            tuple(axes): (int(ops), int(byts))
            for axes, ops, byts in payload["deferred"]}
        payload["admitted"] = tuple(payload.get("admitted", (0, 0)))
    return TenantState(plane=d["plane"], bucket=d.get("bucket"),
                       carried=dict(d.get("carried") or {}),
                       payload=payload)


def _encode_module(m: ModuleSnapshot) -> dict:
    return {
        "tenants": {str(t): _encode_tenant_state(s)
                    for t, s in m.tenants.items()},
        "ground_truth": {str(t): v for t, v in m.ground_truth.items()},
        "latency": {fam: {str(t): p for t, p in per.items()}
                    for fam, per in m.latency.items()},
    }


def _decode_module(d: dict) -> ModuleSnapshot:
    return ModuleSnapshot(
        tenants={int(t): _decode_tenant_state(s)
                 for t, s in (d.get("tenants") or {}).items()},
        ground_truth={int(t): float(v)
                      for t, v in (d.get("ground_truth") or {}).items()},
        latency={fam: {int(t): dict(p) for t, p in per.items()}
                 for fam, per in (d.get("latency") or {}).items()})


def _encode_snapshot(s: FabricSnapshot) -> dict:
    return {
        "version": s.version,
        "step": s.step,
        "placement": {str(t): k for t, k in s.placement.items()},
        "draining": {str(t): k for t, k in s.draining.items()},
        "parked": list(s.parked),
        "planes": [{"name": p.name,
                    "carried": {f: {str(t): v for t, v in d.items()}
                                for f, d in p.carried.items()},
                    "modules": [_encode_module(m) for m in p.modules]}
                   for p in s.planes],
        "controller": _encode_controller(s.controller),
        "swap_log": [dict(r, tenants=list(r.get("tenants", ())))
                     for r in s.swap_log],
    }


def _decode_snapshot(doc: dict) -> FabricSnapshot:
    return FabricSnapshot(
        version=int(doc["version"]),
        step=int(doc.get("step", 0)),
        placement={int(t): int(k)
                   for t, k in (doc.get("placement") or {}).items()},
        draining={int(t): int(k)
                  for t, k in (doc.get("draining") or {}).items()},
        parked=[int(k) for k in doc.get("parked", ())],
        planes=[PlaneSnapshot(
            name=p["name"],
            carried={f: {int(t): v for t, v in d.items()}
                     for f, d in (p.get("carried") or {}).items()},
            modules=[_decode_module(m) for m in p.get("modules", ())])
            for p in doc.get("planes", ())],
        controller=_decode_controller(doc.get("controller") or {}),
        swap_log=[dict(r, tenants=list(r.get("tenants", ())))
                  for r in doc.get("swap_log", ())])


def _encode_controller(c: Dict[str, Any]) -> dict:
    out = dict(c)
    if "allocations" in out:
        out["allocations"] = {str(t): v
                              for t, v in out["allocations"].items()}
    return out


def _decode_controller(c: dict) -> Dict[str, Any]:
    out = dict(c)
    if "allocations" in out:
        out["allocations"] = {int(t): float(v)
                              for t, v in out["allocations"].items()}
    return out
