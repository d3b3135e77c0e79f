"""Shared neural layers: norms, MLPs, rotary embeddings, vocab heads.

The counterpart of ``repro/models/layers.py``, with its bf16 rounding
points kept: norms and rope compute in f32 and cast back to the input
dtype, the gated MLP rounds ``silu(f32(g))`` to the activation dtype before
the product with ``h``. Products are ``torch.matmul`` (f32 accumulation;
bf16 results rounded once). ``matmul`` promotes as JAX does where a bf16
and an f32 operand meet (whisper's f32 training encoder against its bf16
weights): both widen, exactly, to f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.schema import ParamDesc


def f32(x: torch.Tensor) -> torch.Tensor:
    return x.float()


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two (jnp's promotion: bf16
    and f32 give f32); a plain product when the dtypes agree."""
    if x.dtype != w.dtype:
        t = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(t), w.to(t)
    return x @ w


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_schema(d: int, kind: str, dtype: str):
    if kind == "layernorm":
        return {"scale": ParamDesc((d,), dtype, "ones", dims=("none",)),
                "bias": ParamDesc((d,), dtype, "zeros", dims=("none",))}
    return {"scale": ParamDesc((d,), dtype, "ones", dims=("none",))}


def apply_norm(p, x: torch.Tensor, kind: str, eps: float = 1e-5):
    xf = f32(x)
    if kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * f32(p["scale"]) + f32(p["bias"])
    else:  # rmsnorm
        ms = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * f32(p["scale"])
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (gated / squared-relu / gelu)
# ---------------------------------------------------------------------------


def mlp_schema(d: int, ff: int, activation: str, dtype: str):
    s = {"w_in": ParamDesc((d, ff), dtype, dims=("embed", "ffn")),
         "w_out": ParamDesc((ff, d), dtype, dims=("ffn", "embed"))}
    if activation == "silu_glu":
        s["w_gate"] = ParamDesc((d, ff), dtype, dims=("embed", "ffn"))
    return s


def _split(p, key: str, dim: int):
    """The mesh axis a ``ParamTree`` leaf is sharded over at ``dim``."""
    spec = p.spec(key) if hasattr(p, "spec") else ()
    return spec[dim] if len(spec) > dim else None


def apply_mlp(p, x: torch.Tensor, activation: str, shd=None):
    """The MLP; with a ``ShardingCtx`` whose rules shard ``ffn``, the rank
    holds ``w_in``/``w_gate`` by column and ``w_out`` by row, and the
    partial products are summed over ``model``. Under autograd ``x``
    enters the column-parallel products through ``shd.enter`` (its
    gradient summed over ``model``) and the sum's backward is the
    identity. Under Megatron-SP (``shd.sp``) ``x`` holds the rank's rows:
    they are gathered before the split products and the partial sums
    reduce-scattered back to them (``rows_in``/``rows_out``); an MLP the
    axis does not split runs on the rows ``x`` holds."""
    axis = _split(p, "w_out", 0) if shd is not None else None
    x_in = x = shd.rows_in(x, axis) if shd is not None else x
    h = matmul(x, p["w_in"])
    if activation == "silu_glu":
        g = matmul(x, p["w_gate"])
        h = F.silu(f32(g)).to(x.dtype) * h
    elif activation == "relu2":
        h = torch.square(F.relu(f32(h))).to(x.dtype)
    else:  # gelu (tanh approximation, jax.nn.gelu's default)
        h = F.gelu(f32(h), approximate="tanh").to(x.dtype)
    out = matmul(h, p["w_out"])
    return shd.rows_out(out, axis, x_in) if shd is not None else out


# ---------------------------------------------------------------------------
# Rotary position embedding (rotate-half convention)
# ---------------------------------------------------------------------------


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: (...,) int -> (cos, sin) of shape positions.shape +
    (head_dim // 2,)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=positions.device), exps)
    angles = positions[..., None].float() * freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: (..., heads, head_dim); cos/sin: broadcastable (..., head_dim//2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos.unsqueeze(-2)   # broadcast over heads
    s = sin.unsqueeze(-2)
    y1 = f32(x1) * c - f32(x2) * s
    y2 = f32(x2) * c + f32(x1) * s
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def sinusoid_positions(positions: torch.Tensor, d_model: int):
    """Sinusoidal absolute position embedding (the reference's
    whisper-style stub): f32 ``positions.shape + (d_model,)``, sin then
    cos."""
    half = d_model // 2
    log = torch.log(torch.tensor(10000.0, device=positions.device))
    freq = torch.exp(-log * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


def embed_schema(vocab: int, d: int, dtype: str, tie: bool):
    s = {"tokens": ParamDesc((vocab, d), dtype, init_scale=1.0,
                             dims=("vocab", "embed"))}
    if not tie:
        s["head"] = ParamDesc((vocab, d), dtype, fan_in=d,
                              dims=("vocab", "embed"))
    return s


def embed_tokens(p, tokens: torch.Tensor, dtype: torch.dtype, shd=None):
    """Token embeddings. With the table vocab-sharded over ``model`` the
    rank looks up the tokens in its range, zeroes the others and sums over
    ``model``: one nonzero term per token, so the sum is exact. Under
    autograd the sum's backward is the identity, so each rank's rows of the
    table get the gradient of its own tokens. Under Megatron-SP
    (``shd.sp``) the sum is a reduce-scatter along the sequence, so each
    rank keeps its rows of the residual stream."""
    axis = _split(p, "tokens", 0) if shd is not None else None
    if not axis:
        e = F.embedding(tokens.long(), p["tokens"]).to(dtype)
        return shd.own_rows(e) if shd is not None and shd.sp else e
    n = p["tokens"].shape[0]
    idx = tokens.long() - shd.index(axis) * n
    inside = (idx >= 0) & (idx < n)
    e = F.embedding(idx.clamp(0, n - 1), p["tokens"]) \
        * inside[..., None].to(p["tokens"].dtype)
    if shd.sp:
        return shd.scatter_rows(e).to(dtype)
    return shd.psum(e, axis).to(dtype)


def lm_logits(p, x: torch.Tensor, softcap: float = 0.0, shd=None):
    """Logits over the head's rows: this rank's vocab columns where the
    head is vocab-sharded (``models.model.greedy`` combines shards'
    argmax, ``train.train_loop.loss_fn`` their cross entropy); there ``x``
    enters through ``shd.enter``, so under autograd its gradient is summed
    over the vocab's axis. A tied table's gradient sums this use and the
    lookup's (``embed_tokens``). Under Megatron-SP the rank's rows are
    gathered first (``rows_in``), so the logits cover the rank's batch
    rows whole."""
    key = "head" if "head" in p else "tokens"
    w = p[key]
    axis = _split(p, key, 0) if shd is not None else None
    if axis:
        x = shd.rows_in(x, axis)
    logits = x @ w.T
    if softcap:
        logits = torch.tanh(f32(logits) / softcap) * softcap
    return logits
