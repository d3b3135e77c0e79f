"""Mixture-of-Experts: top-k routing with sort-based capacity dispatch.

The counterpart of ``repro/models/moe.py``. Dispatch is the sort/gather
formulation, no (T, E, C) one-hot tensor:

  1. top-k per token, flattened to T*k assignments;
  2. a stable sort by expert, each assignment's position in its expert
     from the experts' cumulative counts;
  3. assignments past the capacity C = ``_capacity(T)`` are dropped;
  4. a gather to (E, C, d), one batched product per expert weight;
  5. a weighted sum of each token's k picks, back in f32.

DeepSeek-V2's shared experts (an always-on MLP of ``num_shared *
shared_ff``) and Arctic's parallel dense branch (an MLP of ``d_ff``) are
added after the routed sum. The aux losses are switch's load balance and
the router's z-loss; ``moe_max_frac`` and ``moe_drop_frac`` report the
busiest expert's share and the share of assignments dropped.

The reference splits the tokens into G groups, one per device of its data
axis, each routed and truncated alone; on one device G is 1. On a mesh
the port keeps the reference's groups (``dispatch_groups``) and splits
the experts over the model axis (expert parallelism: ``apply_moe``). The rounding points are the reference's: the
router and its logits are f32, the expert products run in the parameter
dtype, the gate's activation is computed in f32 and rounded to the
activation dtype before the product with ``h``, and the combine sums the
k picks in f32 before rounding back. Ties go as in ``jax.lax.top_k`` (the
lower expert first, from a stable descending sort), and an expert's
capacity goes to its assignments in flat order (a stable sort by expert):
the lower flat index keeps its slot. A dropped assignment, and an empty
slot of an expert, gather a clamped row that a mask zeroes, so each adds
exactly zero. All of it is plain PyTorch on any device: the reference has
no Pallas kernel here.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _split, apply_mlp, f32, mlp_schema
from repro_torch.models.schema import ParamDesc

AUX_KEYS = ("moe_lb_loss", "moe_z_loss", "moe_max_frac", "moe_drop_frac")


def moe_schema(cfg: ModelConfig) -> Dict:
    m, d, pd = cfg.moe, cfg.d_model, cfg.param_dtype
    e, ff = m.num_experts, m.expert_ff
    s: Dict = {
        "router": ParamDesc((d, e), "float32", dims=("embed", "experts")),
        "w_in": ParamDesc((e, d, ff), pd, fan_in=d,
                          dims=("experts", "embed", None)),
        "w_out": ParamDesc((e, ff, d), pd, fan_in=ff,
                           dims=("experts", None, "embed")),
    }
    if cfg.activation == "silu_glu":
        s["w_gate"] = ParamDesc((e, d, ff), pd, fan_in=d,
                                dims=("experts", "embed", None))
    if m.num_shared_experts:
        s["shared"] = mlp_schema(
            d, m.num_shared_experts * (m.shared_ff or m.expert_ff),
            cfg.activation, pd)
    if m.parallel_dense:
        s["dense"] = mlp_schema(d, cfg.d_ff, cfg.activation, pd)
    return s


def _capacity(tokens: int, m) -> int:
    c = int(tokens * m.top_k * m.capacity_factor / m.num_experts) + 1
    return max(8, min(c, tokens)) if tokens >= 8 else max(1, min(c, tokens))


def route_topk(router_w, x_flat, m, shd=None, axis=None, sums=None
               ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """x_flat (T, d) -> (gate weights (T, k) f32, expert ids (T, k) int64,
    aux: ``moe_lb_loss``, ``moe_z_loss``, ``moe_max_frac``). With the
    router's expert columns split over ``axis`` (``shd`` a
    ``ShardingCtx``) the rank's f32 logits are gathered over it first, so
    every rank routes over all experts.

    ``sums`` (training on a mesh): the aux's statistics over these tokens
    instead, summed for ``global_aux`` to reduce over the batch: each
    expert's assignments (``counts``, no gradient) and router probability
    (``probs``), and the squared log-sum-exps (``lse2``). ``sums`` names
    the axes whose ranks compute them alike while a transpose upstream
    (the logits' gather, Megatron-SP's row gather) sums their cotangents:
    their gradient is divided over those ranks (``ShardingCtx.shared``)."""
    logits = f32(x_flat) @ f32(router_w)
    if axis:
        logits = shd.all_gather(logits, axis, -1)
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = top[:, :m.top_k], idx[:, :m.top_k]
    gate = gate / gate.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    t, e = probs.shape
    counts = torch.bincount(eidx.reshape(-1), minlength=e).float()
    if sums is not None:
        lse = torch.logsumexp(shd.shared(logits, sums), dim=-1)
        return gate, eidx, {"counts": counts,
                            "probs": shd.shared(probs, sums).sum(dim=0),
                            "lse2": torch.sum(torch.square(lse))}
    frac = counts / (t * m.top_k)
    imp = probs.mean(dim=0)
    aux = {"moe_lb_loss": e * torch.sum(frac * imp),
           "moe_z_loss": torch.mean(torch.square(
               torch.logsumexp(logits, dim=-1))),
           "moe_max_frac": frac.max()}
    return gate, eidx, aux


def global_aux(shd, sums: Dict, drops, tokens: int, m) -> Dict:
    """The reference's aux over the global batch (``AUX_KEYS``) from a
    rank's ``route_topk`` sums over its ``tokens`` and the drop shares of
    its dispatch groups: one ``psum`` over the loss's axes (the batch
    axes; its backward the identity, so each rank's gradient is its
    tokens' share), divided by the tokens and the groups those ranks hold
    (a row held by several of them counts once for each, as the loss
    counts it). ``moe_lb_loss`` is E x sum(frac x imp) of the global
    means, the busiest share the global ``frac``'s, the drop share the
    mean over the reference's groups."""
    e = sums["counts"].shape[0]
    axes = shd.loss_axes
    n = math.prod(shd.axis_sizes[a] for a in axes)
    v = torch.cat([sums["counts"], sums["probs"], sums["lse2"][None],
                   torch.stack(drops).sum()[None]])
    if axes:
        v = shd.psum(v, axes)
    t = tokens * n
    frac = v[:e].detach() / (t * m.top_k)
    return {"moe_lb_loss": e * torch.sum(frac * v[e:2 * e] / t),
            "moe_z_loss": v[2 * e] / t,
            "moe_max_frac": frac.max(),
            "moe_drop_frac": v[2 * e + 1].detach() / (len(drops) * n)}


def _dispatch_tables(eidx, gate, n_experts: int, cap: int, tokens: int,
                     k: int):
    """(table (E*C,), slot_of (T*k,), w_flat (T*k,), drop): the token in
    each expert slot (``tokens`` where the slot is empty), the slot of
    each assignment (E*C where it was dropped), the assignments' gate
    weights, and the share of assignments dropped."""
    dev = eidx.device
    n = tokens * k
    e_flat = eidx.reshape(-1)
    tok_flat = torch.arange(n, device=dev) // k
    order = torch.sort(e_flat, stable=True).indices
    e_sorted = e_flat[order]
    counts = torch.bincount(e_flat, minlength=n_experts)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(n, device=dev) - starts[e_sorted]
    keep = pos_in_e < cap
    slot_sorted = torch.where(keep, e_sorted * cap + pos_in_e,
                              n_experts * cap)
    table = torch.full((n_experts * cap + 1,), tokens, dtype=torch.long,
                       device=dev)
    table[slot_sorted] = torch.where(keep, tok_flat[order], tokens)
    slot_of = torch.empty_like(slot_sorted)
    slot_of[order] = slot_sorted          # the inverse permutation
    drop = torch.sum(1.0 - keep.float()) / n
    return table[:-1], slot_of, gate.reshape(-1), drop


def _expert_act(h, g, activation: str, dtype):
    if activation == "silu_glu":
        return F.silu(f32(g)).to(dtype) * h
    if activation == "relu2":
        return torch.square(F.relu(f32(h))).to(dtype)
    return F.gelu(f32(h), approximate="tanh").to(dtype)


class Groups(NamedTuple):
    """A rank's share of the reference's dispatch groups
    (``dispatch_groups``): ``local`` whole groups among the rank's tokens,
    each routed and truncated alone; or, where one group spans several
    ranks' rows, the batch axes its rows are gathered over (``gather``),
    the group's rows in the gathered batch (``rows``) and the rank's rows
    among the group's (``mine``)."""
    local: int = 1
    gather: object = None
    rows: slice = slice(None)
    mine: slice = slice(None)


def dispatch_groups(shd, batch: int, seq: int, rows: int) -> Groups:
    """The rank's share of the reference's dispatch groups, for its
    ``rows`` of a global ``batch`` of ``seq`` tokens. The reference splits
    the global tokens into ``G = data`` groups (halved until G divides
    them), each routed and truncated alone: one group a data rank where the
    rows split over ``data``, all G of them on every rank where they do not
    (the engine's one-request prefill, whose groups cut the sequence), and
    a group over several ranks' rows where they split over ``pod`` x
    ``data`` (a multi-pod mesh): its rows are gathered."""
    if shd is None or shd.mesh is None:
        return Groups()
    g = max(shd.axis_sizes.get("data", 1), 1)
    while (batch * seq) % g:
        g //= 2
    if g * rows % batch == 0:
        return Groups(g * rows // batch)
    # rows split finer than the groups: the rank's block i of ``rows`` lies
    # in group i // span, which holds ``span`` consecutive blocks
    per = batch * seq // g
    if batch % g or per % (rows * seq):
        raise NotImplementedError(
            f"a dispatch group of {per} tokens does not hold whole rank "
            f"blocks of {rows} rows")
    span = per // (rows * seq)
    axes = shd.split("batch", batch)
    i = shd.block(axes, batch).start // rows
    first = i // span * span * rows
    return Groups(1, axes, slice(first, first + span * rows),
                  slice(i % span * rows, (i % span + 1) * rows))


def apply_moe(p, x: torch.Tensor, cfg: ModelConfig, shd=None,
              groups: Groups = Groups()) -> Tuple[torch.Tensor, Dict]:
    """x (B, S, d) -> (y (B, S, d) in x's dtype, aux with ``AUX_KEYS``).

    ``groups``: the reference's dispatch groups among x's tokens
    (``dispatch_groups``), each routed and truncated alone at capacity
    ``_capacity(tokens // groups.local)``; the drop share is their mean.
    A group that spans ranks is routed on its gathered rows, and the rank
    keeps its own.

    ``shd``: a ``ShardingCtx`` on a mesh, with ``p`` the rank's shards.
    Where the experts split over the model axis the rank holds E/tp of
    them (and their router columns): it routes over all experts
    (``route_topk`` gathers the logits), gathers only its experts' slots,
    runs the three batched products on them, sums each token's picks that
    it holds in f32, and the f32 partials are summed over the axis before
    the one cast; where the axis does not divide the experts every rank
    holds them all and nothing is summed. The shared and dense branches
    are ``apply_mlp``'s sharded MLP, on the rank's rows.

    In training (``shd.train``) x enters the experts' split under
    autograd (its gradient, partial on each rank, summed over the axis;
    a branch split over the same axis shares the one enter), and the aux
    is the reference's over the global batch (``global_aux``). Under
    Megatron-SP (``shd.sp``) x holds the rank's rows of the sequence: the
    whole rows are gathered once for routing (a group is the reference's
    whole rows) and every branch, and each branch's output
    reduce-scattered back to the rank's rows (or cut to them where
    nothing is summed)."""
    axis = _split(p, "w_in", 0) if shd is not None else None
    if shd is not None and shd.sp:
        x = shd.gather_rows(x)
    xr = shd.rows_in(x, axis) if axis else x
    if groups.gather:
        xg = shd.all_gather(xr, groups.gather, 0)[groups.rows]
        y, aux = _routed(p, xg, cfg, shd, 1, axis)
        y = y[groups.mine]
    else:
        y, aux = _routed(p, xr, cfg, shd, groups.local, axis)
    if shd is not None:
        y = shd.rows_out(y, axis, x)
    y = y.to(x.dtype)
    for key in ("shared", "dense"):
        if key in p:
            q = p[key]
            same = shd is not None and _split(q, "w_out", 0) == axis
            y = y + apply_mlp(q, xr if same else x, cfg.activation, shd)
    return y, aux


def _routed(p, x: torch.Tensor, cfg: ModelConfig, shd, groups: int,
            axis) -> Tuple[torch.Tensor, Dict]:
    """The routed experts' sum over x's tokens in ``groups`` dispatch
    groups, in f32 (partial over ``axis``, the experts' split), and the
    aux (``global_aux``'s in training on a mesh)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    k, e = m.top_k, m.num_experts
    tg = t // groups
    cap = _capacity(tg, m)
    el = p["w_in"].shape[0]               # the experts this rank holds
    lo = shd.index(axis) * el * cap if axis else 0
    xf = x.reshape(t, d)
    train = shd is not None and shd.train
    shared = (axis or shd.sp or ()) if train else None
    gate, eidx, aux = route_topk(p["router"], xf, m, shd, axis, shared)
    parts, drops = [], []
    for gi in range(groups):
        rows = slice(gi * tg, (gi + 1) * tg)
        table, slot_of, w_flat, drop = _dispatch_tables(
            eidx[rows], gate[rows], e, cap, tg, k)
        drops.append(drop)
        table = table[lo:lo + el * cap]
        xg = xf[rows]
        xe = xg[table.clamp(max=tg - 1)] * (table < tg)[:, None].to(x.dtype)
        xe = xe.reshape(el, cap, d)
        h = torch.bmm(xe, p["w_in"])
        g = torch.bmm(xe, p["w_gate"]) if cfg.activation == "silu_glu" \
            else None
        h = _expert_act(h, g, cfg.activation, x.dtype)
        yflat = torch.bmm(h, p["w_out"]).reshape(el * cap, d)
        at = slot_of - lo                 # past el * cap: another rank's
        held = (at >= 0) & (at < el * cap)   # or dropped
        picked = yflat[at.clamp(0, el * cap - 1)] \
            * held[:, None].to(yflat.dtype)
        parts.append(torch.sum(f32(picked).reshape(tg, k, d)
                               * w_flat.reshape(tg, k, 1), dim=1))
    y = parts[0] if groups == 1 else torch.cat(parts)
    if train:
        aux = global_aux(shd, aux, drops, t, m)
    else:
        aux["moe_drop_frac"] = drops[0] if groups == 1 \
            else torch.stack(drops).mean()
    return y.reshape(b, s, d), aux
