"""Decode attention: the CUDA kernel and its plain version.

The kernel (``csrc/decode_attention.cu``) replaces the Pallas TPU kernel
``repro/kernels/decode_attention.py::decode_attention``; its header says
what bounds it on the H100 and how the design answers that. It reads the
grouped cache directly: q ``(B, HQ, D)``, caches ``(B, T, KV, D)`` with
``HQ % KV == 0``, ``pos (B,)`` the position of each sequence's new token
(already written into the cache). Position ``t`` of sequence ``b`` takes
part iff ``t <= pos[b]``, ``t < kv_len`` and, with a window,
``pos[b] - t < window``. Returns ``(o, m, l)``: o in q's dtype, and the f32
running max and exp-sum per (sequence, head) that let shards of a cache be
combined by log-sum-exp (the context-parallel decode contract).

``decode_attention`` takes the plain version only for tensors on the CPU;
on CUDA tensors it launches the kernel or raises. The kernel is one launch
per call: a block per (run of positions, kv head, sequence), where runs
past ``pos[b]`` exit at once, and the last block of each (sequence, kv
head) to finish combines the runs' partials (``split_plan``). That block
finds itself through a per-device counter that the kernel sets back to
zero, so calls on one device must not run concurrently on two streams.
``decode_attention.launches`` counts the calls that launched the kernel,
and ``decode_attention.launches_by_route`` counts them by the kernel that
took them (``route``): ``"mma"`` or ``"simt"``.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import build

NEG_INF = -2.0e30
# (head dim, group HQ // KV) pairs the kernel is built for: groups 1-8 at
# every head dim up to 128, and head dim 192 at nemotron-4-340b's group 12
SHAPES = frozenset([(d, g) for d in (16, 32, 64, 128) for g in range(1, 9)]
                   + [(192, 12)])
# (q dtype, cache dtype) pairs the kernel is built for
DTYPE_PAIRS = {
    (torch.bfloat16, torch.bfloat16): (build.DT_BF16, build.DT_BF16),
    (torch.float32, torch.bfloat16): (build.DT_F32, build.DT_BF16),
    (torch.float32, torch.float32): (build.DT_F32, build.DT_F32),
}
# positions per sequence chunk are a multiple of the kernel's 64-position
# chunk
SPLIT_ALIGN = 64
ROUTES = ("mma", "simt")


def route(q_dtype, cache_dtype, d: int) -> str:
    """The kernel that takes a ``q_dtype`` query over a ``cache_dtype``
    cache at head dim ``d``, as ``csrc/decode_attention.cu::launch`` picks
    it: ``"mma"`` (bf16 over bf16 at head dims 64 and up, on mma.sync) or
    ``"simt"`` (f32 queries, and bf16 at 16 and 32, on the CUDA cores)."""
    if q_dtype == cache_dtype == torch.bfloat16 and d >= 64:
        return "mma"
    return "simt"


def split_plan(b: int, kv: int, kv_len: int, sms: int):
    """(nsplit, chunk): how many runs of ``chunk`` positions the kernel
    splits each sequence into. Enough (run, kv head, sequence) blocks to
    give every SM two, but no run shorter than ``SPLIT_ALIGN``. The runs
    cover the padded cache; which of them hold live positions is decided
    on the card from ``pos``, which the host never reads."""
    want = -(-2 * sms // (b * kv))
    nsplit = max(1, min(want, -(-kv_len // SPLIT_ALIGN)))
    chunk = -(-kv_len // nsplit)
    chunk = -(-chunk // SPLIT_ALIGN) * SPLIT_ALIGN
    return -(-kv_len // chunk), chunk


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_counters = {}


def _counter(index: int, stream, n: int) -> torch.Tensor:
    """The kernel's per-(sequence, kv head) tickets for launches on
    ``stream`` of card ``index``: zero when made, and left zero by every
    launch. One counter per (card, stream): launches on one stream run in
    order, so a launch never shares its tickets with one in flight, and a
    counter that grows is replaced, made and zeroed on that same stream
    (the allocator hands its old memory only to later work there)."""
    key = (index, stream.cuda_stream)
    have = _counters.get(key)
    if have is None or have.numel() < n:
        with torch.cuda.stream(stream):
            have = torch.zeros(max(n, 256), dtype=torch.int32,
                               device=torch.device("cuda", index))
        _counters[key] = have
    return have


def live_mask(pos, t: int, *, window: int = 0, kv_len=None) -> torch.Tensor:
    """(B, T) bool: the cache positions each sequence attends to."""
    kv_len = t if kv_len is None else kv_len
    t_pos = torch.arange(t, device=pos.device)[None, :]
    p = pos.long()[:, None]
    mask = (t_pos <= p) & (t_pos < kv_len)
    if window:
        mask &= (p - t_pos) < window
    return mask


def decode_attention_plain(q, k_cache, v_cache, pos, *, window=0,
                           kv_len=None, scale=None):
    """The kernel's function in plain PyTorch (f32 math). A sequence with
    no live position gets m = NEG_INF, l = 0, o = 0, as the kernel does."""
    b, hq, d = q.shape
    t, kv = k_cache.shape[1], k_cache.shape[2]
    g = hq // kv
    scale = scale or 1.0 / math.sqrt(d)
    qg = q.float().reshape(b, kv, g, d)
    s = torch.einsum("bkgd,btkd->bkgt", qg, k_cache.float()) * scale
    mask = live_mask(pos, t, window=window, kv_len=kv_len)[:, None, None, :]
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", p, v_cache.float())
    o = o / l.clamp_min(1e-30)[..., None]
    return (o.reshape(b, hq, d).to(q.dtype), m.reshape(b, hq),
            l.reshape(b, hq))


def _check(q, k, v, pos, kv_len: int, window: int) -> None:
    if not (q.device == k.device == v.device == pos.device):
        raise ValueError("q, caches and pos must be on one device")
    if (q.dtype, k.dtype) not in DTYPE_PAIRS or v.dtype != k.dtype:
        raise TypeError(f"(q, cache) dtypes {q.dtype}, {k.dtype}/{v.dtype} "
                        f"not supported; kernel takes "
                        f"{[(str(a), str(c)) for a, c in DTYPE_PAIRS]}")
    if pos.dtype != torch.int32:
        raise TypeError(f"pos must be int32, got {pos.dtype}")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,HQ,D), caches (B,T,KV,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[2] \
            or tuple(pos.shape) != (b,):
        raise ValueError(f"q {tuple(q.shape)}, caches {tuple(k.shape)} and "
                         f"pos {tuple(pos.shape)} do not match")
    if (d, hq // k.shape[2]) not in SHAPES:
        raise ValueError(f"head dim {d} / group {hq // k.shape[2]} not "
                         f"supported; the kernel is built for (D, HQ/KV) "
                         f"in {sorted(SHAPES)}")
    for x in (q, k, v, pos):
        if not x.is_contiguous():
            raise ValueError("q, caches and pos must be contiguous")
    for x in (k, v):
        if x.data_ptr() % 16:
            raise ValueError("caches must be 16-byte aligned")
    if not 0 < kv_len <= k.shape[1] or window < 0:
        raise ValueError(f"kv_len {kv_len} outside (0, {k.shape[1]}] or "
                         f"negative window")


def decode_attention(q, k_cache, v_cache, pos, *, window=0, kv_len=None,
                     scale=None):
    """q (B,HQ,D), caches (B,T,KV,D), pos (B,) int32 -> (o, m, l).

    On CPU tensors this is ``decode_attention_plain``; on CUDA tensors it
    launches the kernel on the current stream."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, pos,
                                      window=window, kv_len=kv_len,
                                      scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu, not "
                         f"{q.device}")
    t = k_cache.shape[1]
    kv_len = t if kv_len is None else int(kv_len)
    _check(q, k_cache, v_cache, pos, kv_len, window)
    b, hq, d = q.shape
    kv = k_cache.shape[2]
    index = q.device.index if q.device.index is not None \
        else torch.cuda.current_device()
    nsplit, chunk = split_plan(b, kv, kv_len, _sm_count(index))
    g = hq // kv
    o = torch.empty_like(q)
    m, l = torch.empty((2, b, hq), dtype=torch.float32,
                       device=q.device).unbind(0)
    # per-run partials (acc, m, l) that the last block of a group combines
    part = torch.empty((b * kv * nsplit * (g * d + 2 * g) if nsplit > 1
                        else 0,), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device)
    counter = _counter(index, stream, b * kv)
    qdt, kdt = DTYPE_PAIRS[(q.dtype, k_cache.dtype)]
    lib = build.library()
    rc = lib.nk_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        o.data_ptr(), m.data_ptr(), l.data_ptr(), part.data_ptr(),
        counter.data_ptr(), b, t, hq, kv, d, qdt, kdt, int(window), kv_len,
        nsplit, chunk, float(scale or 1.0 / math.sqrt(d)), index,
        stream.cuda_stream)
    build.check(rc, "decode_attention")
    decode_attention.launches += 1
    decode_attention.launches_by_route[route(q.dtype, k_cache.dtype, d)] += 1
    return o, m, l


decode_attention.launches = 0
decode_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
