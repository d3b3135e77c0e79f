"""Plain PyTorch oracles for the ported kernels (the correctness contract).

Each ``*_ref`` mirrors its counterpart in ``repro/kernels/ref.py`` with the
same signature and layouts, so a test can hold the port's kernels and the
reference's against one oracle. The int8 codec has no separate oracle: its
plain versions (``kernels/quant_comm.py``) compute, to the bit, what the
reference's oracle and Pallas kernel compute, and ``ops`` takes them for
``impl="ref"``.

``water_fill_plain``, the water-fill kernel's own function in plain
PyTorch (the fixed-iteration bisection), lives beside the kernel in
``kernels/waterfill.py`` and is re-exported here with the exact oracle.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.waterfill import water_fill_plain  # noqa: F401


def flash_attention_ref(q, k, v, *, causal=True, window=0, scale=None):
    """q: (B,H,S,d); k,v: (B,H,T,d). Full softmax attention."""
    b, h, s, d = q.shape
    t = k.shape[2]
    scale = scale or 1.0 / math.sqrt(d)
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * scale
    q_pos = torch.arange(s, device=q.device)[:, None]
    k_pos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window:
        mask &= (q_pos - k_pos) < window
    logits = torch.where(mask, logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p, v.float()).to(q.dtype)


def decode_attention_ref(q, k, v, pos, *, scale=None):
    """q: (B,H,d); k,v: (B,T,H,d); pos: (B,). Returns (o, m, l) — partial
    softmax stats so shards can LSE-combine (context-parallel decode)."""
    b, h, d = q.shape
    t = k.shape[1]
    scale = scale or 1.0 / math.sqrt(d)
    logits = torch.einsum("bhd,bthd->bht", q.float(), k.float()) * scale
    mask = torch.arange(t, device=q.device)[None, :] <= pos.long()[:, None]
    logits = torch.where(mask[:, None, :], logits, -1e30)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bht,bthd->bhd", p, v.float())
    return (o / l.clamp_min(1e-30)[..., None]).to(q.dtype), m, l


def ssd_chunk_ref(xdt, dA, B, C):
    """One SSD chunk (intra-chunk quadratic part + chunk state).

    xdt: (Q,H,P) = x*dt; dA: (Q,H); B, C: (Q,N).
    Returns (y_diag (Q,H,P), state (H,P,N), chunk_decay (H,)).
    """
    q = xdt.shape[0]
    cs = torch.cumsum(dA.float(), dim=0)                      # (Q,H)
    diff = cs[:, None, :] - cs[None, :, :]                    # (Q,Q,H)
    ii = torch.arange(q, device=xdt.device)
    L = torch.where((ii[:, None] >= ii[None, :])[..., None],
                    torch.exp(diff), 0.0)                     # (Q,Q,H)
    G = torch.einsum("ln,sn->ls", C.float(), B.float())       # (Q,Q)
    M = G[..., None] * L
    y = torch.einsum("lsh,shp->lhp", M, xdt.float())
    decay_state = torch.exp(cs[-1][None, :] - cs)             # (Q,H)
    state = torch.einsum("sn,sh,shp->hpn", B.float(), decay_state,
                         xdt.float())
    return y.to(xdt.dtype), state, torch.exp(cs[-1])


def water_fill_ref(demands, weights, capacity):
    """Weighted max-min water-fill, exact sort-based progressive fill.

    demands, weights: (n,); capacity: scalar. Returns alloc (n,) with
    sum(alloc) <= capacity + eps. Tenants sorted by demand/weight ratio:
    the affordable prefix is satisfied exactly (alloc == demand), the
    rest split the leftover capacity by weight at one common water
    level. ``inf`` demand = greedy (never satisfied, always at level).
    Slots with demand <= 0 or weight <= 0 get 0 — that is how the fused
    tick parks inactive tenant slots.
    """
    d = demands
    w = weights.to(d.dtype)
    cap = torch.as_tensor(capacity, dtype=d.dtype, device=d.device)
    active = (d > 0) & (w > 0)
    w = torch.where(active, w, 0.0)
    r = torch.where(active, d / torch.where(active, w, 1.0), math.inf)
    order = torch.argsort(r, stable=True)
    rs = r[order]
    ws = w[order]
    ds = torch.where(active, d, 0.0)[order]
    fin = torch.isfinite(rs) & (ws > 0)
    sat_demand = torch.cumsum(torch.where(fin, ds, 0.0), 0)
    cum_w = torch.cumsum(ws, 0)
    tot_w = cum_w[-1] if ws.shape[0] else torch.zeros((), dtype=d.dtype,
                                                      device=d.device)
    # water needed to satisfy tenants through sorted position i: their
    # demands outright, everyone after held at level r_i
    fill_at = sat_demand + torch.where(fin, rs, 0.0) * (tot_w - cum_w)
    sat = fin & (fill_at <= cap * (1 + 1e-12) + 1e-12)
    k = int(sat.sum())
    used_d = sat_demand[k - 1] if k > 0 else torch.zeros_like(tot_w)
    used_w = cum_w[k - 1] if k > 0 else torch.zeros_like(tot_w)
    w_rem = tot_w - used_w
    lvl = torch.where(w_rem > 0, (cap - used_d) / w_rem, math.inf)
    lvl_safe = torch.where(torch.isfinite(lvl), lvl, 0.0).clamp_min(0.0)
    alloc_sorted = torch.where(sat, ds, ws * lvl_safe)
    return torch.zeros_like(alloc_sorted).scatter(0, order, alloc_sorted)
