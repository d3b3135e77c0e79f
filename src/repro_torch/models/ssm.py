"""Mamba-2 SSD (state-space duality) block: chunked prefill + O(1) decode.

The counterpart of ``repro/models/ssm.py``, with the same names and
layouts: x ``(B, L, H, P)`` heads; B/C ``(B, L, N)`` single group; dt
``(B, L, H)``; state ``(B, H, P, N)`` f32. The chunked scan's intra-chunk
part (the masked decay matrix, ``y_diag``, the chunk states and decays,
and ``state_decay = exp(cumsum(dA))``, the weight of the inter-chunk
output) is the hand-written kernel ``kernels/ssd_scan.py::ssd_chunk_scan``
(its plain version under ``RunConfig.attention_impl == "naive"``); the
inter-chunk recurrence and ``y_off`` stay plain torch, as they stay
``jnp`` in the reference. Training runs the kernel forward through
``SsdScanFn``, whose backward differentiates the scan's plain version.
``_segsum`` lives beside the scan's plain version, which uses it
(``kernels/ssd_scan.py::segsum``). Decode writes the new state and conv
tails into the cache in place (the reference returns new arrays); in
training ``ssm_block`` returns no cache.

On a mesh (``ssm_block(..., shd=)``) the inner width is split over
``model`` (``ffn``) and so are the heads (``ssm_heads``) where the model
axis divides them; where it divides the width but not the heads, the rank
gathers the post-conv x stream and scans every head. The gated RMSNorm
sums each rank's weighted mean square over the model axis
(``gated_norm``), and ``w_out``'s partial products are summed once.
Training on a mesh runs the same path under autograd: the inputs every
rank holds whole (x, ``w_B``/``w_C``, their convs, the norm's scale, and
the heads' parameters where the heads stay whole) enter the split, and
the norm's sum of squares is a ``psum_partial``, whose backward sums the
ranks' partial cotangents.

Rounding points follow the reference: conv, gate and D-skip products round
to the activation dtype where it rounds; ``y_diag`` is f32. One exception
at bf16: the scan keeps the masked decay matrix and the decayed inputs in
f32, as the Pallas kernel does, where the reference's ``ssd_chunked``
rounds them to bf16 before its products (ROADMAP §3, P5).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import segsum as _segsum  # noqa: F401
from repro_torch.kernels.ssd_scan import ssd_chunk_scan, \
    ssd_chunk_scan_plain
from repro_torch.models.layers import _split, apply_norm, f32, norm_schema
from repro_torch.models.schema import ParamDesc

def ssm_schema(cfg: ModelConfig) -> Dict:
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.num_heads(d)
    n = s.state_dim
    w = s.conv_width
    pd = cfg.param_dtype
    return {
        "w_x": ParamDesc((d, di), pd, dims=("embed", "ffn")),
        "w_z": ParamDesc((d, di), pd, dims=("embed", "ffn")),
        "w_B": ParamDesc((d, n), pd, dims=("embed", None)),
        "w_C": ParamDesc((d, n), pd, dims=("embed", None)),
        "w_dt": ParamDesc((d, nh), pd, dims=("embed", "ssm_heads")),
        "w_out": ParamDesc((di, d), pd, dims=("ffn", "embed")),
        # depthwise: each output channel sums W taps
        "conv_x": ParamDesc((w, di), pd, "small_normal", 0.5, fan_in=w,
                            dims=("conv", "ffn")),
        "conv_B": ParamDesc((w, n), pd, "small_normal", 0.5, fan_in=w,
                            dims=("conv", None)),
        "conv_C": ParamDesc((w, n), pd, "small_normal", 0.5, fan_in=w,
                            dims=("conv", None)),
        "A_log": ParamDesc((nh,), "float32", "zeros", dims=("ssm_heads",)),
        "D": ParamDesc((nh,), "float32", "ones", dims=("ssm_heads",)),
        "dt_bias": ParamDesc((nh,), "float32", "zeros",
                             dims=("ssm_heads",)),
        "norm": norm_schema(di, "rmsnorm", pd),
    }


# ---------------------------------------------------------------------------
# Causal depthwise conv (width W), prefill + streaming forms
# ---------------------------------------------------------------------------


def causal_conv(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """u: (B, L, C); w: (W, C) depthwise. Causal: y[t] = sum_j w[j]*u[t-W+1+j].
    Summed in f32 and rounded once to u's dtype (XLA fuses the reference's
    chain the same way)."""
    W = w.shape[0]
    uf, wf = f32(u), f32(w)
    y = uf * wf[-1]
    for j in range(W - 1):
        shift = W - 1 - j
        y = y + F.pad(uf, (0, 0, shift, 0))[:, :-shift] * wf[j]
    return y.to(u.dtype)


def conv_step(u_t: torch.Tensor, state: torch.Tensor, w: torch.Tensor):
    """u_t: (B, C); state: (B, W-1, C) past inputs. Returns (y_t, state')."""
    full = torch.cat([state, u_t[:, None]], dim=1)            # (B, W, C)
    y = torch.einsum("bwc,wc->bc", f32(full), f32(w)).to(u_t.dtype)
    return y, full[:, 1:]


# ---------------------------------------------------------------------------
# SSD core (chunked)
# ---------------------------------------------------------------------------


class SsdScanFn(torch.autograd.Function):
    """The intra-chunk scan that training can differentiate, modelled on
    ``attention.FlashAttentionFn``.

    The forward is ``kernels.ssd_chunk_scan`` with all four outputs (y,
    states, chunk decays, state decays; f32): the CUDA kernel on the card
    (its outputs come from ``data_ptr``s, so autograd cannot see through
    it), its plain version on the CPU. The backward recomputes
    ``ssd_chunk_scan_plain`` under autograd and returns its
    vector-Jacobian product with respect to xdt, dA, B and C, taking the
    gradients of all four outputs: the JAX package has no backward kernel
    to port (it trains through its inline ``ssd_chunked``)."""

    @staticmethod
    def forward(ctx, xdt, dA, B, C):
        ctx.save_for_backward(xdt, dA, B, C)
        return ssd_chunk_scan(xdt, dA, B, C, out_dtype=torch.float32,
                              state_decay=True)

    @staticmethod
    def backward(ctx, *douts):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            outs = ssd_chunk_scan_plain(*ins, out_dtype=torch.float32,
                                        state_decay=True)
            return torch.autograd.grad(outs, ins, douts)


def ssd_chunked(xdt, dA, B, C, chunk: int,
                initial_state: Optional[torch.Tensor] = None, *,
                naive: bool = False):
    """SSD scan. xdt: (b,l,h,p) = x*dt; dA: (b,l,h) = dt*A (negative);
    B, C: (b,l,n). Returns (y (b,l,h,p) f32, final_state (b,h,p,n) f32).
    ``naive`` runs the intra-chunk part's plain version instead of the
    kernel; under grad the kernel runs through ``SsdScanFn``."""
    b, l_real, h, p = xdt.shape
    n = B.shape[-1]
    # pad to a chunk multiple: trailing zeros in xdt and dA=0 (decay exp(0)=1)
    # leave the recurrence and final state untouched; outputs are sliced.
    l = -(-l_real // chunk) * chunk
    if l != l_real:
        pad = l - l_real
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        dA = F.pad(dA, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    nc = l // chunk
    xc = xdt.reshape(b, nc, chunk, h, p)
    dAc = dA.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, n)
    Cc = C.reshape(b, nc, chunk, n)

    # --- intra-chunk (quadratic, attention-like), chunk states and the
    # in-chunk decays: kernel ---
    if naive:
        out = ssd_chunk_scan_plain(xc, dAc, Bc, Cc, out_dtype=torch.float32,
                                   state_decay=True)
    elif torch.is_grad_enabled():
        out = SsdScanFn.apply(xc, dAc, Bc, Cc)
    else:
        out = ssd_chunk_scan(xc, dAc, Bc, Cc, out_dtype=torch.float32,
                             state_decay=True)
    y_diag, states, chunk_decay, state_decay = out

    # --- inter-chunk recurrence (linear scan over chunks) ---
    s = torch.zeros((b, h, p, n), dtype=torch.float32, device=xdt.device) \
        if initial_state is None else f32(initial_state)
    entering = []
    for c in range(nc):
        entering.append(s)                                    # entering state
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    entering = torch.stack(entering, dim=1)                   # (b,c,h,p,n)

    # --- inter-chunk output, weighted by state_decay (b,c,Q,h) ---
    # on the CPU the product goes through the host's BLAS, whose f32
    # blocking varies with its thread count and load: summed in f64 there
    # and rounded once, it depends on the inputs alone (as the plain scan)
    acc = torch.float64 if xdt.device.type == "cpu" else torch.float32
    y_off = torch.einsum("bcln,bchpn->bclhp", Cc.to(acc),
                         entering.to(xdt.dtype).to(acc)).float()
    y_off = y_off * state_decay[..., None]
    y = (y_diag + y_off).reshape(b, l, h, p)[:, :l_real]
    return y, s


def ssd_decode_step(x_t, dt_t, A, B_t, C_t, state):
    """One-token SSD update. x_t: (b,h,p); dt_t: (b,h); A: (h,) negative;
    B_t, C_t: (b,n); state: (b,h,p,n). Returns (y (b,h,p), state')."""
    dA = torch.exp(f32(dt_t) * A)                             # (b,h)
    xdt = f32(x_t) * f32(dt_t)[..., None]
    upd = torch.einsum("bhp,bn->bhpn", xdt, f32(B_t))
    state = f32(state) * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", state, f32(C_t))
    return y.to(x_t.dtype), state


# ---------------------------------------------------------------------------
# Full block (projections + conv + SSD + gate + out)
# ---------------------------------------------------------------------------


def _inner_split(p, shd):
    """(inner axis, gather) of a rank's SSM weights on a mesh: the mesh
    axis ``w_x``'s inner width (``ffn``) is split over, or None, and
    whether the heads (``ssm_heads``, resolved on their own) stay whole
    where the inner width splits (hymba's 50 heads against 3,200 channels
    at model 4, 8 and 16): the rank then gathers the post-conv x stream
    over the inner axis and scans every head."""
    if shd is None:
        return None, False
    axis = _split(p, "w_x", 1)
    return axis, bool(axis) and not _split(p, "w_dt", 1)


def gated_norm(p, gated: torch.Tensor, di: int, shd=None, axis=None,
               eps: float = 1e-5) -> torch.Tensor:
    """The gated RMSNorm over the whole inner width ``di``. With the
    width split over ``axis`` each rank holds its channels of ``gated``
    and the whole scale: its f32 mean square, weighted by its share of
    ``di``, is summed over ``axis``, so every rank normalizes by the
    reference's mean over all channels. Under autograd the sum's backward
    is a gradient ``psum`` too (``ShardingCtx.psum_partial``), and the
    input and scale gradients are the one-device norm's."""
    if not axis:
        return apply_norm(p, gated, "rmsnorm", eps)
    xf = f32(gated)
    n = xf.shape[-1]
    lo = shd.index(axis) * n
    # the rank's mean square weighted by its share of the width: at one
    # rank the weight is exactly 1 and the mean is ``apply_norm``'s. Each
    # rank scales only its channels by the sum, so under autograd its
    # cotangent is partial and is summed back (``psum_partial``), and the
    # whole scale, of which it reads its slice, enters the split (under
    # Megatron-SP the step sums its gradient instead: ``enter_weight``)
    ms = shd.psum_partial((xf * xf).mean(dim=-1, keepdim=True) * (n / di),
                          axis)
    scale = shd.enter_weight(p["scale"], axis)
    y = xf * torch.rsqrt(ms + eps) * f32(scale[lo:lo + n])
    return y.to(gated.dtype)


def ssm_block(p, x: torch.Tensor, cfg: ModelConfig, rcfg, *,
              cache: Optional[Dict] = None, decode: bool = False, shd=None):
    """x: (B,L,D) (prefill, training) or (B,1,D) (decode). Prefill
    returns (y, the layer's cache {"state" f32, "conv_x", "conv_B",
    "conv_C"} in x's dtype), which training drops; decode reads ``cache``
    and writes the new state and conv tails into it in place, returning
    (y, cache).

    ``shd``: a ``ShardingCtx`` on a mesh, with ``p`` the rank's shards:
    ``w_x``/``w_z``/``conv_x`` by inner channel, ``w_dt``/``A_log``/``D``/
    ``dt_bias`` by head, ``w_out`` by row; ``w_B``/``w_C``/``conv_B``/
    ``conv_C`` and the norm's scale whole. The rank scans its heads (all
    of them where the heads stay whole: ``_inner_split``), normalizes by
    ``gated_norm`` and sums ``w_out``'s partial products over the inner
    axis once; its cache holds its heads' state and its channels' x tail.
    Under autograd (training on a mesh) the inputs it holds whole enter
    the split (``ShardingCtx.enter``), the x-stream gather's backward is a
    reduce-scatter and the norm's sum a ``psum_partial``, so every
    gradient is the one-device one's block."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    hp = s.head_dim
    axis, gather = _inner_split(p, shd)
    nh = p["w_dt"].shape[1]               # the heads this rank scans
    n_in = p["w_x"].shape[1]              # and its inner channels
    lo = shd.index(axis) * n_in if axis else 0
    # under autograd every input the rank holds whole but reads for its
    # own channels or heads enters the split, so its gradient is summed
    # over the inner axis: x, the B/C projections and convs, and, where
    # the heads stay whole, the heads' parameters (the norm's scale
    # enters in ``gated_norm``); the identity without autograd. Under
    # Megatron-SP x holds the rank's rows of the sequence, which the conv
    # and the scan need all of: they are gathered (whether or not the
    # width splits), and the weights are not entered (``enter_weight``:
    # the step sums their gradients over the axis)
    w = {k: p[k] for k in ("w_z", "w_x", "w_B", "w_C", "w_dt", "dt_bias",
                           "A_log", "D", "conv_x", "conv_B", "conv_C")}
    if axis:
        entering = ("w_B", "w_C", "conv_B", "conv_C") + (
            ("w_dt", "dt_bias", "A_log", "D") if gather else ())
        w.update({k: shd.enter_weight(w[k], axis) for k in entering})
    if shd is not None and shd.sp:
        x = shd.gather_rows(x)
    elif axis:
        x = shd.enter(x, axis)
    A = -torch.exp(f32(w["A_log"]))

    z = x @ w["w_z"]
    streams = {"x": x @ w["w_x"], "B": x @ w["w_B"], "C": x @ w["w_C"]}
    dt = F.softplus(f32(x @ w["w_dt"]) + f32(w["dt_bias"]))

    def silu(t):
        return F.silu(f32(t)).to(x.dtype)

    def heads_in(xs):
        """The x stream the rank's heads read: its channels, or every
        channel gathered where the heads stay whole."""
        return shd.all_gather(xs, axis, -1) if gather else xs

    def own(yflat):
        """The rank's channels of a whole-width output."""
        return yflat[..., lo:lo + n_in] if gather else yflat

    def out_proj(gated):
        out = gated_norm(p["norm"], gated, di, shd, axis) @ p["w_out"]
        # partial sums over the inner axis psummed, or under Megatron-SP
        # reduce-scattered back to the rank's rows (``rows_out``)
        return shd.rows_out(out, axis, x) if shd is not None else out

    if not decode:
        b, l = x.shape[:2]
        conv = {k: silu(causal_conv(u, w["conv_" + k]))
                for k, u in streams.items()}
        xh = heads_in(conv["x"]).reshape(b, l, nh, hp)
        xdt = (f32(xh) * dt[..., None]).to(x.dtype)
        y, state = ssd_chunked(xdt, dt * A, conv["B"], conv["C"], s.chunk,
                               naive=rcfg.attention_impl == "naive")
        yD = y + f32(xh) * f32(w["D"])[None, None, :, None]
        yflat = own(yD.reshape(b, l, nh * hp).to(x.dtype))
        out = out_proj(yflat * silu(z))
        # the pre-conv streams' last W-1 inputs, for streaming decode
        tail = s.conv_width - 1
        new_cache = {"state": state}
        new_cache.update({"conv_" + k: u[:, -tail:]
                          for k, u in streams.items()})
        return out, new_cache

    # ---- decode ----
    conv = {}
    for k, u in streams.items():
        c = cache["conv_" + k]
        y_t, tail = conv_step(u[:, 0], c.to(x.dtype), w["conv_" + k])
        c.copy_(tail)
        conv[k] = silu(y_t)
    xh = heads_in(conv["x"]).reshape(-1, nh, hp)
    y, state = ssd_decode_step(xh, dt[:, 0], A, conv["B"], conv["C"],
                               cache["state"])
    cache["state"].copy_(state)
    y = y + xh * f32(w["D"])[None, :, None].to(x.dtype)
    gated = own(y.reshape(-1, 1, nh * hp)) * silu(z)
    return out_proj(gated), cache


def ssm_cache_schema(cfg: ModelConfig, batch: int, dtype: str) -> Dict:
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.num_heads(cfg.d_model)
    w = s.conv_width
    return {
        "state": ParamDesc((batch, nh, s.head_dim, s.state_dim), "float32",
                           "zeros", dims=("batch", "ssm_heads", None, None)),
        "conv_x": ParamDesc((batch, w - 1, di), dtype, "zeros",
                            dims=("batch", None, "ffn")),
        "conv_B": ParamDesc((batch, w - 1, s.state_dim), dtype, "zeros",
                            dims=("batch", None, None)),
        "conv_C": ParamDesc((batch, w - 1, s.state_dim), dtype, "zeros",
                            dims=("batch", None, None)),
    }
