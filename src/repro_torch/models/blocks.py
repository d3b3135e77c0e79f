"""Block composition: the ``dense``, ``moe``, ``dense_prefix``, ``ssm``,
``hybrid``, ``enc`` and ``dec`` kinds.

The counterpart of ``repro/models/blocks.py``: ``dense`` is a pre-norm
attention half plus a pre-norm MLP half (llama, internlm2, granite,
nemotron, chameleon); ``moe`` swaps the MLP for a mixture of experts with
its shared experts or parallel dense branch (arctic, deepseek's body);
``dense_prefix`` is ``dense`` with ``dense_prefix_ff`` (deepseek's layer
0); ``ssm`` is a pre-norm Mamba-2 block and no FFN half (mamba2);
``hybrid`` feeds one pre-norm output to attention and to a Mamba-2 block
in parallel, averages the two after a norm each, then runs the MLP half
(hymba); ``enc`` is ``dense`` with bidirectional attention (whisper's
encoder), always run as in training (no cache); ``dec`` adds a pre-norm
cross-attention half over the encoder output between the two (whisper's
decoder), whose cache leaves ``ck``/``cv`` hold the encoder's k/v. A
config with MLA (deepseek) runs ``mla_attention`` in the attention half
and caches its latent ``lat`` in place of k/v.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import RingSlots, _head_axis, \
    attn_schema, gqa_attention, mla_attention, mla_schema
from repro_torch.models.layers import apply_mlp, apply_norm, mlp_schema, \
    norm_schema
from repro_torch.models.moe import Groups, apply_moe, moe_schema
from repro_torch.models.schema import ParamDesc
from repro_torch.models.ssm import ssm_block, ssm_cache_schema, ssm_schema

KINDS = ("dense", "moe", "dense_prefix", "ssm", "hybrid", "enc", "dec")
MODES = ("train", "prefill", "decode")


def check_kind(kind: str) -> str:
    if kind not in KINDS:
        raise ValueError(f"block kind must be one of {KINDS}, got "
                         f"{kind!r}")
    return kind


def block_schema(cfg: ModelConfig, kind: str, mesh=None) -> Dict:
    """One layer's weights; ``mesh`` pads the query heads to its model
    axis (``attention.attn_schema``)."""
    check_kind(kind)
    d, nk, pd = cfg.d_model, cfg.norm, cfg.param_dtype
    if kind == "ssm":
        return {"ln1": norm_schema(d, nk, pd), "ssm": ssm_schema(cfg)}
    s = {"ln1": norm_schema(d, nk, pd),
         "attn": mla_schema(cfg, mesh) if cfg.mla is not None
         else attn_schema(cfg, mesh)}
    if kind == "dec":
        s.update(ln_cross=norm_schema(d, nk, pd),
                 cross=attn_schema(cfg, mesh))
    if kind == "hybrid":
        s.update(ssm=ssm_schema(cfg), attn_out_norm=norm_schema(d, nk, pd),
                 ssm_out_norm=norm_schema(d, nk, pd))
    s["ln2"] = norm_schema(d, nk, pd)
    if kind == "moe":
        s["moe"] = moe_schema(cfg)
    else:
        ff = (cfg.dense_prefix_ff or cfg.d_ff) if kind == "dense_prefix" \
            else cfg.d_ff
        s["mlp"] = mlp_schema(d, ff, cfg.activation, pd)
    return s


def block_cache_schema(cfg: ModelConfig, kind: str, batch: int, seq: int,
                       window: int, dtype: str) -> Dict:
    """Cache descriptors for one layer of this kind. ``seq`` = max
    positions; window layers keep a ring buffer of ``window`` slots; a
    ``dec`` layer also keeps the encoder's k/v over ``encoder_seq``
    frames."""
    check_kind(kind)
    if kind == "ssm":
        return ssm_cache_schema(cfg, batch, dtype)
    if kind == "enc":
        return {}
    if cfg.mla is not None:
        width = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
        return {"lat": ParamDesc((batch, seq, width), dtype, "zeros",
                                 dims=("batch", "kv_seq", None))}
    n = min(seq, window) if window else seq
    shape = (batch, n, cfg.num_kv_heads, cfg.head_dim)
    dims = ("batch", "kv_seq", "kv_heads", "head_dim")
    s = {"k": ParamDesc(shape, dtype, "zeros", dims=dims),
         "v": ParamDesc(shape, dtype, "zeros", dims=dims)}
    if kind == "dec":
        cross = (batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
        dims = ("batch", None, "kv_heads", "head_dim")
        s.update(ck=ParamDesc(cross, dtype, "zeros", dims=dims),
                 cv=ParamDesc(cross, dtype, "zeros", dims=dims))
    if kind == "hybrid":
        s.update(ssm_cache_schema(cfg, batch, dtype))
    return s


def _sharded(shd, max_seq) -> Dict:
    """The sharded path's keywords, passed only on a mesh."""
    if shd is None or shd.mesh is None:
        return {}
    return {"shd": shd, "max_seq": max_seq}


def _attn(p, h, cfg: ModelConfig, rcfg, **kw):
    """The attention half's core: ``mla_attention`` when the config has
    MLA, which takes no window, ring, cross input or causal flag (the
    reference's ``_attn`` drops them), else ``gqa_attention``."""
    if cfg.mla is None:
        return gqa_attention(p, h, cfg, rcfg, **kw)
    for key in ("window", "ring", "causal"):
        kw.pop(key, None)
    return mla_attention(p, h, cfg, rcfg, **kw)


def apply_block(p, x: torch.Tensor, cfg: ModelConfig, rcfg, kind: str, *,
                positions=None, window: int = 0,
                cache: Optional[Dict] = None, decode_pos=None,
                ring: Optional[RingSlots] = None, enc_out=None,
                mode: str = "prefill", shd=None,
                max_seq: Optional[int] = None,
                groups: Groups = Groups()
                ) -> Tuple[torch.Tensor, Dict, Dict]:
    """One layer. ``mode`` is "train" (no cache: returns None for it),
    "prefill" (returns the layer's new cache: k/v or an MLA latent, the
    SSM state and conv tails, or both; a ``dec`` layer's ``ck``/``cv``
    too) or "decode" (writes the new token's k/v or latent and the new SSM
    state and conv tails into ``cache`` in place and returns it).
    ``ring``: a windowed decode's ring slots, computed once for the
    layer's segment (``attention.ring_slots``). ``enc_out``: the encoder
    output a ``dec`` layer attends to at prefill and in training. Returns
    (x', cache, aux): aux holds a ``moe`` layer's losses and routing
    statistics (``moe.AUX_KEYS``) and is empty for the other kinds; the
    cache never holds them. ``groups``: a ``moe`` layer's share of the
    reference's dispatch groups (``moe.dispatch_groups``).

    ``shd``: a ``ShardingCtx`` on a mesh (decode needs ``max_seq``):
    every kind runs on this rank's shards, attention and MLA
    (``attention.gqa_attention``, ``mla_attention``), the cross
    attention, the SSM path (``ssm.ssm_block``), the MLP
    (``layers.apply_mlp``) and the experts (``moe.apply_moe``); an
    ``enc`` layer (run in "train" mode) too. Under autograd (training on
    a mesh, every kind) ``p`` is the layer as ``ShardingCtx.gathered``
    reads it, its FSDP shards gathered, and under Megatron-SP (``shd.sp``;
    every kind) x holds the rank's rows of the sequence, the norms run on
    them, each half (the SSM path too) gathers them and reduce-scatters
    its output back to them; a ``hybrid`` layer's one pre-norm output
    ``h``, which both its attention and its SSM path read, enters their
    split once in the block, its rows gathered once under SP (the paths'
    own enters or gathers of it are then the identity), so its gradient
    sums both paths' once, and its two outputs' norms run on the rank's
    rows."""
    check_kind(kind)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    train = mode == "train"
    on_mesh = _sharded(shd, max_seq)
    h = apply_norm(p["ln1"], x, cfg.norm)
    if kind == "ssm":
        y, new_cache = ssm_block(p["ssm"], h, cfg, rcfg, cache=cache,
                                 decode=mode == "decode", shd=shd)
        return x + y, None if train else new_cache, {}
    decode = mode == "decode"
    if kind == "hybrid" and on_mesh:
        # both paths read h: it enters their split once (under autograd;
        # under Megatron-SP its rows are gathered once), and the paths' own
        # enters or gathers of it are then the identity, so its gradient,
        # both paths' partial ones added first, is summed (or
        # reduce-scattered) once
        h = shd.rows_in(h, _head_axis(p["attn"]))
    if train:
        a = _attn(p["attn"], h, cfg, rcfg, positions=positions,
                  window=window, causal=kind != "enc", **on_mesh)
        new_cache = None
    elif decode:
        a, new_cache = _attn(p["attn"], h, cfg, rcfg, positions=positions,
                             window=window, cache=cache,
                             decode_pos=decode_pos, ring=ring, **on_mesh)
    else:
        a, new_cache = _attn(p["attn"], h, cfg, rcfg, positions=positions,
                             window=window, causal=kind != "enc",
                             return_cache=True, **on_mesh)
    if kind == "hybrid":
        s, ssm_cache = ssm_block(p["ssm"], h, cfg, rcfg, cache=cache,
                                 decode=decode, shd=shd)
        a = 0.5 * (apply_norm(p["attn_out_norm"], a, cfg.norm)
                   + apply_norm(p["ssm_out_norm"], s, cfg.norm))
        if not train:
            new_cache = {**new_cache, **ssm_cache}
    x = x + a
    if kind == "dec":
        h = apply_norm(p["ln_cross"], x, cfg.norm)
        if decode:
            c = gqa_attention(p["cross"], h, cfg, rcfg, positions=positions,
                              cache=cache, cross_decode=True, **on_mesh)
        elif train:
            c = gqa_attention(p["cross"], h, cfg, rcfg, positions=positions,
                              kv_x=enc_out, **on_mesh)
        else:
            c, cc = gqa_attention(p["cross"], h, cfg, rcfg,
                                  positions=positions, kv_x=enc_out,
                                  return_cache=True, **on_mesh)
            new_cache.update(ck=cc["k"], cv=cc["v"])
        x = x + c
    h = apply_norm(p["ln2"], x, cfg.norm)
    if kind == "moe":
        y, aux = apply_moe(p["moe"], h, cfg, shd, groups)
        return x + y, new_cache, aux
    return x + apply_mlp(p["mlp"], h, cfg.activation, shd), new_cache, {}
