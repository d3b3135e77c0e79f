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
        return {"scale": ParamDesc((d,), dtype, "ones"),
                "bias": ParamDesc((d,), dtype, "zeros")}
    return {"scale": ParamDesc((d,), dtype, "ones")}


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
    s = {"w_in": ParamDesc((d, ff), dtype),
         "w_out": ParamDesc((ff, d), dtype)}
    if activation == "silu_glu":
        s["w_gate"] = ParamDesc((d, ff), dtype)
    return s


def apply_mlp(p, x: torch.Tensor, activation: str):
    h = matmul(x, p["w_in"])
    if activation == "silu_glu":
        g = matmul(x, p["w_gate"])
        h = F.silu(f32(g)).to(x.dtype) * h
    elif activation == "relu2":
        h = torch.square(F.relu(f32(h))).to(x.dtype)
    else:  # gelu (tanh approximation, jax.nn.gelu's default)
        h = F.gelu(f32(h), approximate="tanh").to(x.dtype)
    return matmul(h, p["w_out"])


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
    s = {"tokens": ParamDesc((vocab, d), dtype, init_scale=1.0)}
    if not tie:
        s["head"] = ParamDesc((vocab, d), dtype, fan_in=d)
    return s


def embed_tokens(p, tokens: torch.Tensor, dtype: torch.dtype):
    return F.embedding(tokens.long(), p["tokens"]).to(dtype)


def lm_logits(p, x: torch.Tensor, softcap: float = 0.0):
    w = p.get("head", p["tokens"])
    logits = x @ w.T
    if softcap:
        logits = torch.tanh(f32(logits) / softcap) * softcap
    return logits
