"""GQA attention: projections, rope, the prefill and decode cores, the cache.

The counterpart of the GQA half of ``repro/models/attention.py``. On the
serving path the two cores are the hand-written CUDA kernels:

* prefill runs ``kernels.flash_attention`` where the reference runs
  ``blockwise_attention``;
* decode runs ``kernels.decode_attention`` where the reference runs
  ``decode_attention`` through the ``tp == 1`` branch of
  ``decode_attention_cp``;
* training runs the flash kernel forward through ``FlashAttentionFn``,
  whose backward differentiates ``blockwise_attention``, the attention
  the reference trains through.

Both kernels take the grouped k/v layout directly, so the path never
expands k/v over query heads. ``RunConfig.attention_impl == "naive"``
runs the kernels' plain PyTorch versions instead, on any device — that is
how a run holds the kernel path against the plain one at full width.
``blockwise_attention``, ``naive_attention`` and ``decode_attention`` are
the plain ports of the reference's cores, held against it by the parity
tests.

A windowed layer whose cache holds no more slots than the window keeps a
ring buffer, as in the reference: decode writes position ``pos`` into slot
``pos % n_slots``. Slot ``j`` then holds position ``pos - ((pos - j) mod
n_slots)``, which is live (not ahead of ``pos``, not negative, inside the
window) exactly when ``j <= min(pos, n_slots - 1)``. Softmax does not
depend on the order of its terms, so the kernel reads the ring as a linear
cache at ``pos_eff = min(pos, n_slots - 1)`` with no window; the plain
path masks by the reference's absolute positions instead.

whisper's decoder layers add a cross-attention over the encoder output
(``kv_x``): k and v come from the encoder, with no rope, through flash at
prefill and in training; at decode the decode kernel reads the cached
encoder k/v (``ck``/``cv``) at ``pos = T - 1`` and writes nothing.

On a mesh whose model axis does not divide the query heads, the schemas
pad them up to its multiple (``padded_heads``), as the reference does: the
padded heads' weights are drawn like the real ones, the head mask zeroes
their output before the out-projection (which zeroes their gradients too),
and ``q_to_kv_map`` sends them to the last kv head. On one device ``hp ==
h`` and the mask is not applied.

**The sharded path** (a ``ShardingCtx`` on a mesh) splits the work
explicitly on each rank's shards. Each rank projects its ``heads``
slice of ``wq`` with the whole ``wk``/``wv`` (kv heads have no mesh
candidate, so they are replicated), runs flash at prefill on its local
query heads (``_local_kv`` gives the kernel the kv heads they read, as a
contiguous grouped slice where the local heads cover whole groups or one
group, else gathered per head at group 1), applies the mask, and sums the
row-parallel ``wo`` products over ``model`` (``nk_psum``). Decode gathers
q over ``model`` and runs ``decode_attention_cp``: with the cache's
sequence dim sharded over ``model`` (``kv_seq``), each rank launches the
decode kernel on its contiguous chunk at its local positions and the
shards combine their ``(o, m, l)`` by log-sum-exp (``lse_combine``); only
the rank whose chunk holds ``pos`` writes the new row. A windowed layer's
ring is split the same way, a contiguous chunk of its slots a rank, and
read at the ring's last live slot with no window. Whisper's cross
attention reads the replicated encoder k/v through the rank's heads'
``_local_kv``. MLA's sharded path is ``mla_attention``'s (its latent
decode gathers the absorbed queries, ``_mla_decode_chunk``).

DeepSeek-V2's multi-head latent attention (``mla_attention``) caches one
latent row per position, ``lat = concat(c_kv, k_pe)``: the rms-normed
down-projection (``kv_lora_rank``) and the key's rope channel
(``qk_rope_head_dim``), shared by all heads. Its prefill attends with dk =
nope + rope (192 at full width) and dv = ``v_head_dim`` (128) where the
reference runs ``blockwise_attention``; the flash kernel takes one head
dim for q, k and v, so ``_mla_prefill`` zero-pads v (and, below a head dim
the kernel is built for, q and k) and cuts the output back to dv. Its
decode is the absorbed form against the latent cache in plain PyTorch, as
the reference runs plain ``jnp``: there is no k/v to hand the decode
kernel.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distribution.sharding import padded_heads
from repro_torch.kernels.decode_attention import (
    decode_attention as decode_kernel, decode_attention_plain)
from repro_torch.kernels.flash_attention import (
    HEAD_DIMS, flash_attention, flash_attention_plain)
from repro_torch.models.layers import (apply_norm, apply_rope, matmul,
                                       norm_schema, rope_tables)
from repro_torch.models.schema import ParamDesc

NEG_INF = -2.0e30


def attn_schema(cfg: ModelConfig, mesh=None) -> Dict:
    """GQA weights, the query heads padded to the mesh's model axis."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    hp = padded_heads(h, mesh) if mesh is not None else h
    pd = cfg.param_dtype
    s = {
        "wq": ParamDesc((d, hp, hd), pd, dims=("embed", "heads", "head_dim")),
        "wk": ParamDesc((d, kv, hd), pd,
                        dims=("embed", "kv_heads", "head_dim")),
        "wv": ParamDesc((d, kv, hd), pd,
                        dims=("embed", "kv_heads", "head_dim")),
        "wo": ParamDesc((hp, hd, d), pd, fan_in=h * hd,
                        dims=("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        s["q_norm"] = norm_schema(hd, "rmsnorm", cfg.param_dtype)
        s["k_norm"] = norm_schema(hd, "rmsnorm", cfg.param_dtype)
    return s


def mla_schema(cfg: ModelConfig, mesh=None) -> Dict:
    mla, d, h, pd = cfg.mla, cfg.d_model, cfg.num_heads, cfg.param_dtype
    hp = padded_heads(h, mesh) if mesh is not None else h
    nope, rope, r = mla.qk_nope_head_dim, mla.qk_rope_head_dim, \
        mla.kv_lora_rank
    heads = (None, "heads", "head_dim")
    return {
        "wq": ParamDesc((d, hp, nope + rope), pd,
                        dims=("embed", "heads", "head_dim")),
        "w_dkv": ParamDesc((d, r + rope), pd, dims=("embed", None)),
        "w_uk": ParamDesc((r, hp, nope), pd, dims=heads),
        "w_uv": ParamDesc((r, hp, mla.v_head_dim), pd, dims=heads),
        "wo": ParamDesc((hp, mla.v_head_dim, d), pd,
                        fan_in=h * mla.v_head_dim,
                        dims=("heads", "head_dim", "embed")),
        "kv_norm": norm_schema(r, "rmsnorm", pd),
    }


def head_mask(num_real: int, num_padded: int, dtype, device=None):
    return (torch.arange(num_padded, device=device) < num_real).to(dtype)


def q_to_kv_map(num_q_real: int, num_q_padded: int, num_kv: int,
                device=None) -> torch.Tensor:
    """Which kv head each (possibly padded) q head reads."""
    grp = max(num_q_real // max(num_kv, 1), 1)
    m = torch.clamp(torch.arange(num_q_padded, device=device) // grp,
                    max=num_kv - 1)
    return m.long()


# ---------------------------------------------------------------------------
# Plain prefill cores (the reference's blockwise and naive attention)
# ---------------------------------------------------------------------------


def _block_ranges(n_q_blocks: int, n_kv_blocks: int, q_block: int,
                  kv_block: int, causal: bool, window: int):
    """(lo, hi) kv-block range per q block."""
    out = []
    for iq in range(n_q_blocks):
        q_lo, q_hi = iq * q_block, (iq + 1) * q_block - 1
        hi = min((q_hi // kv_block), n_kv_blocks - 1) if causal \
            else n_kv_blocks - 1
        lo = 0
        if window:
            lo = max(0, (q_lo - window + 1) // kv_block)
        out.append((lo, hi))
    return out


def blockwise_attention(q, k, v, *, kv_map, causal=True, window=0,
                        q_block=512, kv_block=512, q_offset=0,
                        softmax_scale=None):
    """q: (B,S,HP,hd); k,v: (B,T,KV,hd). Returns (B,S,HP,hd).

    Online softmax over kv blocks with f32 (m, l, acc), skipping the blocks
    ``_block_ranges`` rules out; p is rounded to q's dtype before the PV
    product, as in the reference."""
    b, s_real, hq, hd = q.shape
    t_real = k.shape[1]
    scale = softmax_scale or 1.0 / math.sqrt(hd)
    q_block = min(q_block, s_real)
    kv_block = min(kv_block, t_real)
    s = -(-s_real // q_block) * q_block
    t = -(-t_real // kv_block) * kv_block
    q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, s - s_real))
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, t - t_real))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, t - t_real))
    ranges = _block_ranges(s // q_block, t // kv_block, q_block, kv_block,
                           causal, window)
    outs = []
    for iq, (lo, hi) in enumerate(ranges):
        qi = q[:, iq * q_block:(iq + 1) * q_block]
        q_pos = q_offset + iq * q_block + torch.arange(q_block,
                                                       device=q.device)
        m = torch.full((b, hq, q_block), NEG_INF, device=q.device)
        l = torch.zeros((b, hq, q_block), device=q.device)
        acc = torch.zeros((b, hq, q_block, v.shape[-1]), device=q.device)
        for jblk in range(lo, hi + 1):
            kj = k[:, jblk * kv_block:(jblk + 1) * kv_block][:, :, kv_map]
            vj = v[:, jblk * kv_block:(jblk + 1) * kv_block][:, :, kv_map]
            kv_pos = jblk * kv_block + torch.arange(kv_block,
                                                    device=q.device)
            sres = torch.einsum("bqhd,bthd->bhqt", qi.float(),
                                kj.float()) * scale
            mask = (kv_pos[None, :] < t_real).expand(q_block, kv_block)
            if causal:
                mask = mask & (q_pos[:, None] >= kv_pos[None, :])
            if window:
                mask = mask & ((q_pos[:, None] - kv_pos[None, :]) < window)
            sres = torch.where(mask[None, None], sres, NEG_INF)
            m_new = torch.maximum(m, sres.amax(dim=-1))
            p = torch.exp(sres - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqt,bthd->bhqd", p.to(q.dtype).float(), vj.float())
            m = m_new
        out = acc / l.clamp_min(1e-30)[..., None]
        outs.append(out.transpose(1, 2).to(q.dtype))
    return torch.cat(outs, dim=1)[:, :s_real]


def naive_attention(q, k, v, *, kv_map, causal=True, window=0, q_offset=0,
                    softmax_scale=None):
    """Reference O(S^2)-memory attention (the 'naive' impl)."""
    b, s, hq, hd = q.shape
    t = k.shape[1]
    scale = softmax_scale or 1.0 / math.sqrt(hd)
    k = k[:, :, kv_map]
    v = v[:, :, kv_map]
    sres = torch.einsum("bqhd,bthd->bhqt", q.float(), k.float()) * scale
    q_pos = q_offset + torch.arange(s, device=q.device)
    kv_pos = torch.arange(t, device=q.device)
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= kv_pos[None, :]
    if window:
        mask &= (q_pos[:, None] - kv_pos[None, :]) < window
    sres = torch.where(mask[None, None], sres, NEG_INF)
    p = torch.softmax(sres, dim=-1)
    o = torch.einsum("bhqt,bthd->bqhd", p.to(q.dtype).float(), v.float())
    return o.to(q.dtype)


# ---------------------------------------------------------------------------
# The flash kernel under autograd (training)
# ---------------------------------------------------------------------------


class FlashAttentionFn(torch.autograd.Function):
    """Prefill attention that training can differentiate.

    The forward is ``kernels.flash_attention``: the CUDA kernel on the card
    (its output comes from ``data_ptr``s, so autograd cannot see through
    it), its plain version on the CPU. The backward recomputes the
    attention the reference trains through, ``blockwise_attention`` with
    the run's q and kv blocks, under autograd and returns its
    vector-Jacobian product: the JAX package has no backward kernel to
    port. k and v are expanded over each group's query heads by a
    broadcast, whose backward is a plain sum over the group (an index with
    repeats would accumulate with atomics on the card, and in no fixed
    order on the CPU). ``scale``: the softmax scale, 1/sqrt(head dim) when
    None."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, q_block: int,
                kv_block: int, scale=None):
        ctx.save_for_backward(q, k, v)
        ctx.opts = (causal, window, q_block, kv_block, scale)
        return flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        causal, window, q_block, kv_block, scale = ctx.opts
        b, t, kv, d = k.shape
        hq = q.shape[2]

        def expand(x):
            return x[:, :, :, None].expand(b, t, kv, hq // kv, d).reshape(
                b, t, hq, d)

        with torch.enable_grad():
            q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
            o = blockwise_attention(
                q, expand(k), expand(v), kv_map=torch.arange(
                    hq, device=q.device), causal=causal, window=window,
                q_block=q_block, kv_block=kv_block, softmax_scale=scale)
            dq, dk, dv = torch.autograd.grad(o, (q, k, v), do)
        return dq, dk, dv, None, None, None, None, None


# ---------------------------------------------------------------------------
# Plain decode core (the reference's decode_attention)
# ---------------------------------------------------------------------------


def decode_attention(q, k_cache, v_cache, pos, *, kv_map, window=0,
                     softmax_scale=None, kv_pos=None, n_real_heads=None):
    """One-token attention against a cache.

    q: (B,1,HP,hd); caches: (B,S,KV,hd); pos: (B,) index of the new token
    (the cache already holds it at ``pos``). ``kv_pos`` (B,S) gives the
    absolute position held in each cache slot (ring-buffer windows);
    default is the linear layout arange(S). Negative kv_pos marks empty
    slots. Grouped GQA uses the grouped product; padded head counts select
    each head's kv head through ``kv_map``."""
    b, _, hq, hd = q.shape
    s = k_cache.shape[1]
    kv = k_cache.shape[2]
    scale = softmax_scale or 1.0 / math.sqrt(hd)
    if kv_pos is None:
        kv_pos = torch.arange(s, device=q.device)[None, :].expand(b, s)
    p_col = pos.long()[:, None]
    mask = (kv_pos <= p_col) & (kv_pos >= 0)
    if window:
        mask &= (p_col - kv_pos) < window
    grouped = (hq % kv == 0) and (n_real_heads is None or n_real_heads == hq)
    if grouped:
        g = hq // kv
        qg = q.reshape(b, 1, kv, g, hd)
        sres = torch.einsum("bqkgd,btkd->bkgqt", qg.float(),
                            k_cache.float()) * scale
        sres = torch.where(mask[:, None, None, None, :], sres, NEG_INF)
        p = torch.softmax(sres, dim=-1)
        o = torch.einsum("bkgqt,btkd->bqkgd", p.to(q.dtype).float(),
                         v_cache.float())
        return o.reshape(b, 1, hq, hd).to(q.dtype)
    kc = k_cache[:, :, kv_map]
    vc = v_cache[:, :, kv_map]
    sres = torch.einsum("bqhd,bthd->bhqt", q.float(), kc.float()) * scale
    sres = torch.where(mask[:, None, None, :], sres, NEG_INF)
    p = torch.softmax(sres, dim=-1)
    o = torch.einsum("bhqt,bthd->bqhd", p.to(q.dtype).float(), vc.float())
    return o.to(q.dtype)


# ---------------------------------------------------------------------------
# Ring-buffer window caches
# ---------------------------------------------------------------------------


class RingSlots(NamedTuple):
    """A ring decode's slots for one step, shared by a segment's layers:
    ``slot`` (B,) int64, where the new row goes; ``pos_eff`` (B,) int32,
    the last live slot, which the kernel reads as a linear cache's
    position; ``kv_pos`` (B, n_slots), the absolute position each slot
    holds, for the plain path (None unless asked for); ``n``, the ring's
    slots (on a mesh, all of them: each rank holds a contiguous chunk of
    them where the model axis divides them)."""
    slot: torch.Tensor
    pos_eff: torch.Tensor
    kv_pos: Optional[torch.Tensor]
    n: int = 0


def is_ring(window: int, n_slots: int) -> bool:
    """A windowed cache of no more slots than the window is a ring (the
    reference's test; with ``max_seq <= window`` it is the linear layout)."""
    return bool(window) and n_slots <= window


def ring_slots(pos: torch.Tensor, n_slots: int, *,
               kv_pos: bool = False) -> RingSlots:
    """The ring slots of decode positions ``pos`` (B,) int32."""
    p = pos.long()
    held = None
    if kv_pos:
        j = torch.arange(n_slots, device=pos.device)[None, :]
        held = p[:, None] - torch.remainder(p[:, None] - j, n_slots)
    return RingSlots(torch.remainder(p, n_slots),
                     pos.clamp(max=n_slots - 1), held, n_slots)


# ---------------------------------------------------------------------------
# Full GQA attention block (projections + core + out-proj)
# ---------------------------------------------------------------------------


def _heads(x, w):
    """x (B,S,d) @ w (d,H,hd) -> (B,S,H,hd)."""
    d, h, hd = w.shape
    return matmul(x, w.reshape(d, h * hd)).reshape(*x.shape[:-1], h, hd)


def _out(o, w):
    """o (B,S,H,hd) @ w (H,hd,d) -> (B,S,d)."""
    h, hd, d = w.shape
    return matmul(o.reshape(*o.shape[:-2], h * hd), w.reshape(h * hd, d))


def _cross_decode(q, cache: Dict, naive: bool, local=None):
    """Cross-attention decode (whisper's decoder): every row reads the
    whole encoder cache ``ck``/``cv`` (B, T, KV, hd) at ``pos = T - 1``
    and writes nothing, as the reference does. The cache meets q in q's
    dtype (the reference's ``cache.astype(x.dtype)``); the kernel widens
    a bf16 cache for an f32 q itself. ``local`` (h, hp, first, n): on a
    mesh q holds the rank's query heads ``first .. first + n - 1`` of
    ``hp``, which read their kv heads of the replicated cache
    (``_local_kv``); the caller masks and sums the output."""
    ck, cv = cache["ck"], cache["cv"]
    if q.dtype == torch.bfloat16 and ck.dtype != q.dtype:
        ck, cv = ck.to(q.dtype), cv.to(q.dtype)
    if local is not None:
        ck, cv = _local_kv(ck, cv, *local)
    at = torch.full((q.shape[0],), ck.shape[1] - 1, dtype=torch.int32,
                    device=q.device)
    decode = decode_attention_plain if naive else decode_kernel
    o, _, _ = decode(q[:, 0].contiguous(), ck, cv, at)
    return o[:, None]


# ---------------------------------------------------------------------------
# The sharded path: context-parallel decode and tensor-parallel heads
# ---------------------------------------------------------------------------


def lse_combine(o, m, l, reduce_max, reduce_sum):
    """Partial softmaxes combined by log-sum-exp, in f32.

    ``o`` (..., H, D) is each shard's normalized output, ``m`` and ``l``
    (..., H) its running max and exp-sum (the decode kernel's outputs).
    ``reduce_max``/``reduce_sum`` take a tensor to its max and sum over
    the shards: a ``pmax`` and ``psum`` over ``model`` on the sharded path,
    reductions over a leading stack dim in ``stacked_lse_combine``. A shard
    with no live position (``m = NEG_INF``, ``l = 0``) weighs nothing."""
    m_all = reduce_max(m)
    w = torch.exp(m - m_all) * l
    num = reduce_sum(o.float() * w[..., None])
    return num / reduce_sum(w).clamp_min(1e-30)[..., None]


def stacked_lse_combine(o, m, l):
    """``lse_combine`` over shards stacked on dim 0: o (n, ..., H, D), m
    and l (n, ..., H) -> (..., H, D) f32."""
    return lse_combine(o, m, l, lambda t: t.amax(0, keepdim=True),
                       lambda t: t.sum(0))


def decode_attention_cp(q, k_c, v_c, pos, *, window, n_real_heads, shd,
                        chunked: bool, scale=None, naive: bool = False):
    """Context-parallel flash-decode over the model axis (the reference's
    ``decode_attention_cp``).

    q (B, 1, HP, hd), the whole (padded) heads on every rank; ``pos`` (B,)
    int32 global positions, each already written into the cache. With
    ``chunked`` each rank's ``k_c``/``v_c`` (B, S/tp, KV, hd) is its
    contiguous chunk of the sequence: the decode kernel runs on it at
    ``pos - rank * S/tp`` (negative past the chunk's start, where the
    kernel gives the empty row) with the window unchanged, and the ranks
    combine by ``lse_combine`` through one ``pmax`` and two ``psum``s
    over ``model``. Without it (``tp == 1`` or ``S % tp != 0``) the kernel
    reads the whole cache once, the reference's one-device fallback. The
    kernel takes the real heads only (``HQ % KV == 0``; the padded heads'
    map is not uniform), and the padded heads' output is zero. Returns
    (B, 1, HP, hd) in q's dtype, the same on every rank of ``model``."""
    b, _, hp, hd = q.shape
    decode = decode_attention_plain if naive else decode_kernel
    qr = q[:, 0, :n_real_heads].contiguous()
    if not chunked:
        o, _, _ = decode(qr, k_c, v_c, pos, window=window, scale=scale)
    else:
        local = pos - shd.index("model") * k_c.shape[1]
        o, m, l = decode(qr, k_c, v_c, local.to(torch.int32),
                         window=window, scale=scale)
        o = lse_combine(o, m, l, lambda t: shd.pmax(t, "model"),
                        lambda t: shd.psum(t, "model")).to(q.dtype)
    if hp > n_real_heads:
        o = torch.cat([o, o.new_zeros((b, hp - n_real_heads, hd))], dim=1)
    return o[:, None]


def _local_kv(k, v, h: int, hp: int, first: int, n: int):
    """The kv heads that query heads ``first .. first + n - 1`` read, in a
    layout the kernels take (``HQ % KV == 0``, head ``i`` reading kv head
    ``i // (HQ // KV)``): a contiguous slice of kv heads where the local
    heads are real and cover whole groups (group g) or lie in one group
    (group n); otherwise each head's kv head gathered (group 1), which
    also serves the padded heads, whose output the mask zeroes."""
    kv = k.shape[2]
    g = max(h // kv, 1)
    last = first + n - 1
    if last < h and first % g == 0 and n % g == 0:
        sl = slice(first // g, (last + 1) // g)
    elif last < h and first // g == last // g:
        sl = slice(first // g, first // g + 1)
    else:
        kvm = q_to_kv_map(h, hp, kv, k.device)[first:first + n]
        return k.index_select(2, kvm), v.index_select(2, kvm)
    return k[:, :, sl].contiguous(), v[:, :, sl].contiguous()


def _head_axis(p):
    """The mesh axis a layer's query heads are split over (from ``wq``'s
    layout), or None."""
    spec = p.spec("wq") if hasattr(p, "spec") else ()
    return spec[1] if len(spec) > 1 else None


def _sum_heads(shd, out, axis):
    """The row-parallel out-projection's partial sums over the heads'
    axis (none to sum where the heads are whole)."""
    return shd.psum(out, axis) if axis else out


def gqa_attention(p, x, cfg: ModelConfig, rcfg, *, positions, causal=True,
                  window=0, cache: Optional[Dict] = None, decode_pos=None,
                  ring: Optional[RingSlots] = None, return_cache=False,
                  kv_x=None, cross_decode=False, shd=None,
                  max_seq: Optional[int] = None):
    """Unified GQA attention.

    Prefill and training: ``positions`` (S,); returns out (B,S,d) [and
    {"k", "v"} in their compute dtype when ``return_cache``]. Under grad
    (training) the flash kernel runs through ``FlashAttentionFn``; the
    plain path (``attention_impl == "naive"``) is differentiated by
    autograd. Decode: pass ``cache`` ({"k", "v"},
    each (B, n_slots, KV, hd)) and ``decode_pos`` (B,) int32; x is
    (B,1,d). Returns (out, cache) with the new token's k/v written into
    the cache rows in place. A ring cache (``is_ring``) takes its slots
    from ``ring`` where the caller computed them once for many layers,
    else computes them here.

    Cross-attention (whisper's decoder): ``kv_x`` (B, T, d), the encoder
    output, gives k and v at prefill and in training, with no rope and,
    as in the reference, the ``causal`` mask: decoder position t sees
    frames 0..t (ROADMAP R8). Where k/v are f32 (an f32 encoder) and q
    is bf16, q widens (exactly) to f32 for the kernel, which takes one
    dtype, and the output rounds back to q's dtype, as the reference's
    mixed product does (ROADMAP P18). ``cross_decode`` reads the cached
    encoder k/v (``cache`` {"ck", "cv"}) instead: see ``_cross_decode``.

    ``shd``: a ``ShardingCtx`` on a mesh runs the sharded path of the
    module's docstring (a linear cache, a ring or the cross caches; x
    (B_local, S, d) is the same on every rank of ``model``, and so is the
    result after the ``psum`` of the row-parallel out-projection; decode
    needs ``max_seq``, the cache's global length). Under autograd
    (training) the rank's query heads go through ``FlashAttentionFn``; x,
    ``wk``, ``wv`` and the q/k norms' scales enter the heads' split through
    ``shd.enter``, so the kv heads' gradient, of which each rank sees only
    its own query heads' use, is summed over ``model``; the head mask
    zeroes the padded heads' gradients in both directions. Under
    Megatron-SP (``shd.sp``) x holds the rank's rows of the sequence: they
    are gathered for the heads' split and the out-projection's partial
    sums reduce-scattered back to them (``rows_in``/``rows_out``), and the
    weights are not entered (``enter_weight``: the step sums their
    gradients over the axis)."""
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    naive = rcfg.attention_impl == "naive"
    sharded = shd is not None and shd.mesh is not None
    wk, wv, q_norm, k_norm = p["wk"], p["wv"], p.get("q_norm"), \
        p.get("k_norm")
    if sharded:
        # the axis the query heads split over (none under the "fsdp"
        # rules, whose model axis carries batch rows); under autograd x and
        # the weights every rank holds whole but reads for its own heads
        # (wk, wv, the q/k norms) enter the split, so their gradients are
        # summed over it
        axis = _head_axis(p)
        tp = shd.axis_sizes[axis] if axis else 1
        rank = shd.index(axis) if axis else 0
        n = p["wq"].shape[1]                   # this rank's query heads
        hp, first = n * tp, rank * n
        mask = head_mask(h, hp, x.dtype, x.device)[first:first + n, None]
        if axis and torch.is_grad_enabled():
            x = shd.rows_in(x, axis)
            if kv_x is not None:
                # the encoder's output: every rank's heads read all of it;
                # where Megatron-SP split the frames its rows were
                # gathered once and marked entered (``model._encoded``),
                # and this is the identity
                kv_x = shd.enter(kv_x, axis)
            wk, wv = shd.enter_weight(wk, axis), shd.enter_weight(wv, axis)
            if cfg.qk_norm:
                q_norm, k_norm = (
                    {"scale": shd.enter_weight(t["scale"], axis)}
                    for t in (q_norm, k_norm))
    q = _heads(x, p["wq"])
    if cfg.qk_norm:
        q = apply_norm(q_norm, q, "rmsnorm")
    if cross_decode:
        if sharded:
            o = _cross_decode(q, cache, naive, (h, hp, first, n))
            return _sum_heads(shd, _out(o * mask, p["wo"]), axis)
        return _out(_cross_decode(q, cache, naive), p["wo"])
    src = x if kv_x is None else kv_x
    knew = _heads(src, wk)
    vnew = _heads(src, wv)
    if cfg.qk_norm:
        knew = apply_norm(k_norm, knew, "rmsnorm")
    prefill = cache is None or decode_pos is None
    if cfg.rope_theta > 0 and kv_x is None:
        cos, sin = rope_tables(positions if prefill else decode_pos[:, None],
                               hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        knew = apply_rope(knew, cos, sin)

    if prefill:
        q_dtype, kv_out = q.dtype, {"k": knew, "v": vnew}
        if q.dtype != knew.dtype:
            q = q.to(torch.promote_types(q.dtype, knew.dtype))
            knew, vnew = knew.to(q.dtype), vnew.to(q.dtype)
        if sharded:
            # the local query heads and the kv heads they read
            knew, vnew = _local_kv(knew, vnew, h, hp, first, n)
        if naive:
            o = flash_attention_plain(q, knew, vnew, causal=causal,
                                      window=window)
        elif torch.is_grad_enabled():
            # training: the kernel forward, the reference's backward
            o = FlashAttentionFn.apply(q, knew, vnew, causal, window,
                                       rcfg.attn_q_block,
                                       rcfg.attn_kv_block)
        else:
            o = flash_attention(q, knew, vnew, causal=causal, window=window)
        o = o.to(q_dtype)
        out = shd.rows_out(_out(o * mask, p["wo"]), axis, x) if sharded \
            else _out(o, p["wo"])
        return (out, kv_out) if return_cache else out

    # ---- decode ----
    b = x.shape[0]
    k_c, v_c = cache["k"], cache["v"]
    n_slots = k_c.shape[1]
    rows = torch.arange(b, device=x.device)
    if sharded:
        if max_seq is None:
            raise ValueError("decode on a mesh needs max_seq, the cache's "
                             "global length")
        # a ring (the caller's slots over all of its ``n`` slots) is read
        # as a linear cache at its last live slot with no window; each
        # rank holds a contiguous chunk of the ring or of the sequence
        # where the model axis divides it, and the new row goes into the
        # chunk that holds it
        if ring is not None:
            n_all, slot, at, win = ring.n, ring.slot, ring.pos_eff, 0
        else:
            n_all, slot, at, win = max_seq, decode_pos.long(), \
                decode_pos.to(torch.int32), window
        chunked = n_slots < n_all
        local = slot - (rank * n_slots if chunked else 0)
        inside = ((local >= 0) & (local < n_slots))[:, None, None]
        slot = local.clamp(0, n_slots - 1)
        k_c[rows, slot] = torch.where(inside, knew[:, 0].to(k_c.dtype),
                                      k_c[rows, slot])
        v_c[rows, slot] = torch.where(inside, vnew[:, 0].to(v_c.dtype),
                                      v_c[rows, slot])
        qa = shd.all_gather(q, axis, 2) if axis else q
        o = decode_attention_cp(qa, k_c, v_c, at, window=win,
                                n_real_heads=h, shd=shd, chunked=chunked,
                                naive=naive)
        o = o[:, :, first:first + n] * mask
        return _sum_heads(shd, _out(o, p["wo"]), axis), \
            {"k": k_c, "v": v_c}
    if ring is None and is_ring(window, n_slots):
        ring = ring_slots(decode_pos, n_slots, kv_pos=naive)
    # In-place row write. The reference rebuilds the whole cache with a
    # one-hot where (a scatter would make its partitioner all-gather a
    # sequence-sharded cache); on one device the row write saves a full
    # cache copy per layer per step.
    slot = decode_pos.long() if ring is None else ring.slot
    k_c[rows, slot] = knew[:, 0].to(k_c.dtype)
    v_c[rows, slot] = vnew[:, 0].to(v_c.dtype)
    # the kernel reads the (bf16) cache and upcasts it inside, as the
    # reference decodes against the cache cast to x's dtype
    if ring is not None and naive:
        o = decode_attention(q, k_c, v_c, decode_pos,
                             kv_map=q_to_kv_map(h, h, kv, x.device),
                             window=window, kv_pos=ring.kv_pos)
        return _out(o, p["wo"]), {"k": k_c, "v": v_c}
    decode = decode_attention_plain if naive else decode_kernel
    at, win = (decode_pos.to(torch.int32), window) if ring is None \
        else (ring.pos_eff, 0)
    o, _, _ = decode(q[:, 0].contiguous(), k_c, v_c, at, window=win)
    o = o[:, None]
    return _out(o, p["wo"]), {"k": k_c, "v": v_c}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): latent cache, absorbed-weight decode
# ---------------------------------------------------------------------------


def _mla_prefill(q, k, v, scale: float, rcfg):
    """MLA's prefill attention, q and k (B, S, H, dk), v (B, S, H, dv),
    through the flash kernel with each head its own kv head (group 1),
    causal, at ``scale``: the three are zero-padded to the smallest head
    dim the kernel is built for that holds dk and dv (192 = dk at full
    width, so only v pads there; 32 for the smoke config's 24 and 16), and
    the output is cut back to dv. A zero column of q and k adds nothing to
    a score and a zero column of v gives a zero output column, so this is
    the attention the reference's ``blockwise_attention`` computes. The
    same three-way choice as ``gqa_attention``: the plain version under
    ``attention_impl == "naive"``, ``FlashAttentionFn`` under grad (the pad
    is differentiable), the kernel otherwise."""
    dk, dv = q.shape[-1], v.shape[-1]
    hd = next((d for d in HEAD_DIMS if d >= max(dk, dv)), max(dk, dv))
    pad = torch.nn.functional.pad
    q, k, v = pad(q, (0, hd - dk)), pad(k, (0, hd - dk)), pad(v, (0, hd - dv))
    if rcfg.attention_impl == "naive":
        o = flash_attention_plain(q, k, v, causal=True, scale=scale)
    elif torch.is_grad_enabled():
        o = FlashAttentionFn.apply(q, k, v, True, 0, rcfg.attn_q_block,
                                   rcfg.attn_kv_block, scale)
    else:
        o = flash_attention(q, k, v, causal=True, scale=scale)
    return o[..., :dv]


def _mla_decode_chunk(q_lat, q_rope, lat, decode_pos, r: int, scale: float,
                      dtype, off: int = 0):
    """The absorbed decode of q's heads over the latent cache ``lat``
    holding positions ``off ..`` (all of it off a mesh, a rank's chunk on
    one): the latent and rope scores in f32, masked to ``t <= pos``, the
    softmax normalized over the chunk, p rounded to ``dtype`` before the
    latent PV product, which is kept in f32. Returns (o_lat (B, H, r) f32,
    m, l), the chunk's running max and exp-sum for ``lse_combine``; a
    chunk with no live position has l 0 and weighs nothing."""
    latx = lat.to(dtype)
    c_c, pe_c = latx[..., :r], latx[..., r:]
    s_lat = torch.einsum("bhr,btr->bht", q_lat.float(), c_c.float())
    s_pe = torch.einsum("bhk,btk->bht", q_rope.float(), pe_c.float())
    sres = (s_lat + s_pe) * scale
    t = off + torch.arange(lat.shape[1], device=lat.device)
    valid = (t[None, :] <= decode_pos.long()[:, None])[:, None, :]
    sres = torch.where(valid, sres, NEG_INF)
    m = sres.amax(dim=-1)
    pexp = torch.where(valid, torch.exp(sres - m[..., None]), 0.0)
    l = pexp.sum(dim=-1)
    pr = pexp / l.clamp_min(1e-30)[..., None]
    o_lat = torch.einsum("bht,btr->bhr", pr.to(dtype).float(), c_c.float())
    return o_lat, m, l


def mla_attention(p, x: torch.Tensor, cfg: ModelConfig, rcfg, *, positions,
                  cache: Optional[Dict] = None, decode_pos=None,
                  return_cache=False, shd=None,
                  max_seq: Optional[int] = None):
    """Multi-head latent attention.

    Prefill and training: ``positions`` (S,); k and v are made explicit
    from the latent (k = concat(c_kv w_uk, k_pe) with k_pe roped on the
    rope dims and broadcast over heads, v = c_kv w_uv) and attend through
    the flash kernel (``_mla_prefill``: causal, each head its own kv head,
    scale 1/sqrt(nope + rope)). Returns out (B, S, d) [and {"lat": (B, S,
    r + rope)} in x's dtype when ``return_cache``].

    Decode: ``cache`` {"lat": (B, n, r + rope)}, ``decode_pos`` (B,)
    int32, x (B, 1, d). The new latent row is written in place at
    ``decode_pos``; the scores are q_nope absorbed through w_uk against
    the latent plus q_rope against the rope channel, f32, masked to
    ``t <= pos``; p is rounded to x's dtype before the latent PV product,
    which w_uv takes back to heads. Returns (out, cache).

    ``shd``: a ``ShardingCtx`` on a mesh, with ``wq``, ``w_uk``, ``w_uv``
    and ``wo`` the rank's (padded) heads and ``w_dkv`` whole. The prefill
    (and training) runs flash on the rank's heads and sums ``wo``'s
    products over the heads' axis. Under autograd x, ``w_dkv`` and
    ``kv_norm``, which every rank holds whole but reads for its own heads
    only, enter the split, so their gradients are summed over it (under
    Megatron-SP x's rows are gathered instead and the two weights summed
    by the step, as ``gqa_attention`` does). Decode needs ``max_seq``,
    the latent's global length: where the model axis splits the latent's
    sequence each rank holds a
    contiguous chunk, the rank owning ``decode_pos`` writes the new row,
    the absorbed queries of all heads are gathered (B x H x (r + rope),
    never the cache) and scored against the rank's chunk, and the chunks
    combine by log-sum-exp (``_mla_decode_chunk``, ``lse_combine``); each rank then takes its
    heads' latent output through ``w_uv`` and ``wo``. With the latent
    whole on every rank, the rank decodes its heads against all of it."""
    mla = cfg.mla
    nope, rope_d, r = mla.qk_nope_head_dim, mla.qk_rope_head_dim, \
        mla.kv_lora_rank
    scale = 1.0 / math.sqrt(nope + rope_d)
    sharded = shd is not None and shd.mesh is not None
    w_dkv, kv_norm = p["w_dkv"], p["kv_norm"]
    if sharded:
        # the axis the query heads split over (none under the "fsdp"
        # rules); under autograd x and the weights every rank holds whole
        # but reads for its own heads only (w_dkv, kv_norm) enter the
        # split, so their gradients are summed over it
        axis = _head_axis(p)
        tp = shd.axis_sizes[axis] if axis else 1
        n = p["wq"].shape[1]                   # this rank's query heads
        first = (shd.index(axis) if axis else 0) * n
        mask = head_mask(cfg.num_heads, n * tp, x.dtype,
                         x.device)[first:first + n, None]
        if axis and torch.is_grad_enabled():
            x = shd.rows_in(x, axis)
            w_dkv = shd.enter_weight(w_dkv, axis)
            kv_norm = {"scale": shd.enter_weight(kv_norm["scale"], axis)}
    q = _heads(x, p["wq"])
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    dkv = matmul(x, w_dkv)
    c_kv = apply_norm(kv_norm, dkv[..., :r], "rmsnorm")
    k_pe_new = dkv[..., r:]

    if cache is None or decode_pos is None:
        # ---- train / prefill: explicit k, v ----
        cos, sin = rope_tables(positions, rope_d, cfg.rope_theta)
        q_rope = apply_rope(q_rope, cos, sin)
        k_pe = apply_rope(k_pe_new[:, :, None, :], cos, sin)   # (B,S,1,rope)
        k_nope = _heads(c_kv, p["w_uk"])
        v = _heads(c_kv, p["w_uv"])
        k = torch.cat([k_nope, k_pe.expand(*k_nope.shape[:3], rope_d)], -1)
        qq = torch.cat([q_nope, q_rope], -1)
        o = _mla_prefill(qq, k, v, scale, rcfg)
        out = shd.rows_out(_out(o * mask, p["wo"]), axis, x) if sharded \
            else _out(o, p["wo"])
        if return_cache:
            return out, {"lat": torch.cat([c_kv, k_pe[:, :, 0]], -1)}
        return out

    # ---- decode: absorbed form against the latent cache ----
    b = x.shape[0]
    cos, sin = rope_tables(decode_pos[:, None], rope_d, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_pe = apply_rope(k_pe_new[:, :, None, :], cos, sin)[:, 0, 0]
    lat = cache["lat"]
    rows = torch.arange(b, device=x.device)
    new_row = torch.cat([c_kv[:, 0], k_pe], -1).to(lat.dtype)
    q_lat = torch.einsum("bhk,rhk->bhr", q_nope[:, 0], p["w_uk"])
    if sharded:
        if max_seq is None:
            raise ValueError("decode on a mesh needs max_seq, the latent "
                             "cache's global length")
        n_slots = lat.shape[1]
        off = shd.index("model") * n_slots if n_slots < max_seq else 0
        local = decode_pos.long() - off
        inside = ((local >= 0) & (local < n_slots))[:, None]
        slot = local.clamp(0, n_slots - 1)
        lat[rows, slot] = torch.where(inside, new_row, lat[rows, slot])
    else:
        # in-place row write, as gqa_attention writes k/v (the reference
        # rebuilds the cache with a one-hot where)
        lat[rows, decode_pos.long()] = new_row
    if sharded and n_slots < max_seq:
        # every head against the rank's chunk, combined over ``model``
        qq = shd.all_gather(torch.cat([q_lat, q_rope[:, 0]], -1), "model", 1)
        o_lat = lse_combine(*_mla_decode_chunk(
            qq[..., :r], qq[..., r:], lat, decode_pos, r, scale, x.dtype,
            off), lambda t: shd.pmax(t, "model"),
            lambda t: shd.psum(t, "model"))[:, first:first + n]
    else:
        o_lat = _mla_decode_chunk(q_lat, q_rope[:, 0], lat, decode_pos, r,
                                  scale, x.dtype)[0]
    # the latent product rounded once, after the chunks' combine
    o = torch.einsum("bhr,rhk->bhk", o_lat.to(x.dtype), p["w_uv"])[:, None]
    if sharded:
        return shd.psum(_out(o * mask, p["wo"]), "model"), {"lat": lat}
    return _out(o, p["wo"]), {"lat": lat}
