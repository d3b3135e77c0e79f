"""Plain PyTorch oracles for the ported kernels (the correctness contract).

Each ``*_ref`` mirrors its counterpart in ``repro/kernels/ref.py`` with the
same signature and layouts, so a test can hold the port's kernels and the
reference's against one oracle. The oracles of the kernels still to be
ported (SSD scan, int8 codec, water-fill) come with those kernels.
"""
from __future__ import annotations

import math

import torch


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
