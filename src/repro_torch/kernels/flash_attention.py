"""Flash attention forward (prefill): the CUDA kernel and its plain version.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention``; its header says what
bounds it on the H100 and how the design answers that. Layouts are the
model's: q ``(B, S, HQ, D)``, k and v ``(B, T, KV, D)`` with
``HQ % KV == 0`` and q head ``h`` reading kv head ``h // (HQ // KV)``.

``flash_attention`` takes the plain PyTorch version only for tensors on the
CPU (the CPU tests). On CUDA tensors it launches the kernel or raises; it
never falls back. ``flash_attention.launches`` counts kernel launches, and
``flash_attention.launches_by_route`` counts them by the kernel that took
them (``route``): ``"wgmma"`` (bf16 at head dims 64, 128 and 192),
``"tf32x3"`` (f32 at 64 and 128: three TF32 products on wgmma) and
``"simt"`` (the rest, on the CUDA cores).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

NEG_INF = -2.0e30
HEAD_DIMS = (16, 32, 64, 128, 192)
DTYPES = {torch.float32: build.DT_F32, torch.bfloat16: build.DT_BF16}
ROUTES = ("wgmma", "tf32x3", "simt")


def route(dtype, d: int) -> str:
    """The kernel that takes ``dtype`` at head dim ``d``: the table of
    ``csrc/flash_attention.cu::dispatch_d``."""
    if dtype == torch.bfloat16 and d in (64, 128, 192):
        return "wgmma"
    if dtype == torch.float32 and d in (64, 128):
        return "tf32x3"
    return "simt"


def _mask(s: int, t: int, *, causal: bool, window: int, q_offset: int,
          device) -> torch.Tensor:
    q_pos = q_offset + torch.arange(s, device=device)[:, None]
    k_pos = torch.arange(t, device=device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos >= k_pos
    if window:
        mask &= (q_pos - k_pos) < window
    return mask


def flash_attention_plain(q, k, v, *, causal=True, window=0, scale=None,
                          q_offset=0):
    """The kernel's function in plain PyTorch: full masked softmax in f32
    (finite ``NEG_INF`` mask), p rounded to v's dtype before the PV
    product as the kernel does, output in q's dtype."""
    b, s, hq, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = hq // kv
    scale = scale or 1.0 / math.sqrt(d)
    qg = q.float().reshape(b, s, kv, g, d)
    sc = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    mask = _mask(s, t, causal=causal, window=window, q_offset=q_offset,
                 device=q.device)
    sc = sc.masked_fill(~mask, NEG_INF)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bkgst,btkd->bkgsd", p.to(v.dtype).float(), v.float())
    o = pv / l.clamp_min(1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, hq, d).to(q.dtype)


def _check(q, k, v, window: int, q_offset: int) -> None:
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise TypeError(f"q, k, v must share one dtype of "
                        f"{sorted(map(str, DTYPES))}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,S,HQ,D), k and v (B,T,KV,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _s, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v "
                         f"{tuple(k.shape)} (batch, head dim, HQ % KV)")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported; kernel takes "
                         f"{HEAD_DIMS}")
    for x in (q, k, v):
        if not x.is_contiguous():
            raise ValueError("q, k and v must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError("q, k and v must be 16-byte aligned")
    if window < 0 or q_offset < 0:
        raise ValueError("window and q_offset must be >= 0")


def flash_attention(q, k, v, *, causal=True, window=0, scale=None,
                    q_offset=0):
    """q (B,S,HQ,D), k/v (B,T,KV,D) -> (B,S,HQ,D) in q's dtype.

    ``q_offset``: absolute position of q[:, 0] (0 for a prefill). On CPU
    tensors this is ``flash_attention_plain``; on CUDA tensors it launches
    the kernel on the current stream."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    _check(q, k, v, window, q_offset)
    b, s, hq, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    if s == 0 or t == 0 or b == 0:
        return o.zero_()
    lib = build.library()
    rc = lib.nk_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        b, s, t, hq, kv, d, DTYPES[q.dtype], int(bool(causal)), int(window),
        int(q_offset), float(scale or 1.0 / math.sqrt(d)), q.device.index
        if q.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "flash_attention")
    flash_attention.launches += 1
    flash_attention.launches_by_route[route(q.dtype, d)] += 1
    return o


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
