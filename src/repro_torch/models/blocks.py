"""Block composition; this slice ports the ``dense`` kind.

The counterpart of ``repro/models/blocks.py``: ``dense`` is a pre-norm
attention half plus a pre-norm MLP half (llama, internlm2, granite,
nemotron, chameleon). The other kinds (moe, dense_prefix, ssm, hybrid,
enc, dec) come with their families.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import attn_schema, gqa_attention
from repro_torch.models.layers import apply_mlp, apply_norm, mlp_schema, \
    norm_schema
from repro_torch.models.schema import ParamDesc

KINDS = ("dense",)


def check_kind(kind: str) -> str:
    if kind not in KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet; it comes with the "
            f"other model families (ROADMAP: other model families)")
    return kind


def block_schema(cfg: ModelConfig, kind: str) -> Dict:
    check_kind(kind)
    d, nk, pd = cfg.d_model, cfg.norm, cfg.param_dtype
    if cfg.mla is not None:
        raise NotImplementedError(
            "MLA attention is not ported yet (ROADMAP: other model "
            "families, mla_attention)")
    return {"ln1": norm_schema(d, nk, pd), "attn": attn_schema(cfg),
            "ln2": norm_schema(d, nk, pd),
            "mlp": mlp_schema(d, cfg.d_ff, cfg.activation, pd)}


def block_cache_schema(cfg: ModelConfig, kind: str, batch: int, seq: int,
                       window: int, dtype: str) -> Dict:
    """Cache descriptors for one layer of this kind. ``seq`` = max
    positions; window layers keep a ring buffer of ``window`` slots."""
    check_kind(kind)
    n = min(seq, window) if window else seq
    shape = (batch, n, cfg.num_kv_heads, cfg.head_dim)
    return {"k": ParamDesc(shape, dtype, "zeros"),
            "v": ParamDesc(shape, dtype, "zeros")}


def apply_block(p, x: torch.Tensor, cfg: ModelConfig, rcfg, kind: str, *,
                positions=None, window: int = 0,
                cache: Optional[Dict] = None, decode_pos=None,
                mode: str = "prefill") -> Tuple[torch.Tensor, Dict]:
    """One layer. ``mode`` is "prefill" (returns the layer's new k/v) or
    "decode" (writes the new token into ``cache`` in place and returns
    it). Returns (x', cache)."""
    check_kind(kind)
    h = apply_norm(p["ln1"], x, cfg.norm)
    if mode == "decode":
        a, new_cache = gqa_attention(p["attn"], h, cfg, rcfg,
                                     positions=positions, window=window,
                                     cache=cache, decode_pos=decode_pos)
    elif mode == "prefill":
        a, new_cache = gqa_attention(p["attn"], h, cfg, rcfg,
                                     positions=positions, window=window,
                                     return_cache=True)
    else:
        raise ValueError(f"mode must be 'prefill' or 'decode', got {mode!r}")
    x = x + a
    h = apply_norm(p["ln2"], x, cfg.norm)
    return x + apply_mlp(p["mlp"], h, cfg.activation), new_cache
