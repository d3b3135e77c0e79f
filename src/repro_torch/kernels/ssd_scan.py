"""Mamba-2 SSD intra-chunk scan: the CUDA kernel and its plain version.

The kernel (``csrc/ssd_scan.cu``) replaces the Pallas TPU kernel
``repro/kernels/ssd_scan.py::ssd_chunk_scan``; its header says what bounds
it on the H100 and how the design answers that. Per (batch, chunk) and
head, with ``cs = cumsum(dA)`` over the chunk's Q positions:

* ``y[l] = sum_{s <= l} (C[l] . B[s]) exp(cs[l] - cs[s]) xdt[s]``;
* ``state = sum_s exp(cs[Q-1] - cs[s]) xdt[s]^T B[s]`` (P x N);
* ``decay = exp(cs[Q-1])``;
* ``state_decay[l] = exp(cs[l])``, the reference model's weight of the
  inter-chunk output (``repro/models/ssm.py::ssd_chunked``'s
  ``state_decay``), asked for with ``state_decay=True``.

The reference's signature: ``xdt (nb, nc, Q, H, P)``, ``dA (nb, nc, Q, H)``,
``B, C (nb, nc, Q, N)`` -> ``(y (nb, nc, Q, H, P), states (nb, nc, H, P, N)
f32, decay (nb, nc, H) f32)``, any H (the Pallas kernel's ``head_block`` is
not part of the contract), and with ``state_decay=True`` a fourth output,
``state_decay (nb, nc, Q, H) f32``. ``y`` comes out in ``out_dtype``, by
default xdt's. The decay exponent is always a difference ``cs[l] -
cs[s]``, masked before the exponential: a factored ``exp(cs[l]) *
exp(-cs[s])`` underflows and overflows at full width, where ``cs`` reaches
about -180 in a chunk.

Both versions take f32 or bf16 inputs and give f32 results, as the Pallas
kernel does: the kernel feeds the f32 masked decay matrix
``M = (C B^T) o L`` and the decayed inputs ``exp(cs[Q-1] - cs) xdt`` to
bf16 tensor-core products as hi + lo bf16 pairs (~1e-5 relative); the
plain version accumulates in f64 and rounds once to f32, so that its
result depends on the inputs alone and not on how a BLAS blocks f32
products under a given thread count and load. The reference model's
``ssd_chunked`` rounds both to bf16 before its products at bf16
(ROADMAP §3, P5).

``ssd_chunk_scan`` takes the plain PyTorch version only for tensors on the
CPU. On CUDA tensors it launches the kernel or raises; it never falls
back. ``ssd_chunk_scan.launches`` counts kernel launches, and
``ssd_chunk_scan.launches_by_route`` counts them by the kernel that took
them (``route``): ``"wg"`` (bf16 at P 64, N 128: mamba2's width, on
wgmma), ``"heads"`` (bf16 at (P, N) in ``HEADS_SHAPES``: a block a chunk
and a run of heads, on mma.sync) and ``"simt"`` (f32, and bf16 at any
other width, on the CUDA cores).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: build.DT_F32, torch.bfloat16: build.DT_BF16}
MAX_CHUNK = 256      # the kernels keep a chunk's cumsum in shared memory
ROUTES = ("wg", "heads", "simt")
# (P, N) of the "heads" kernel: hymba-1.5b, the reference's kernel test,
# the smoke configs
HEADS_SHAPES = ((64, 16), (32, 64), (16, 16))


def route(dtype, p: int, n: int) -> str:
    """The kernel that takes ``dtype`` inputs at head dim ``p`` and state
    size ``n``: the table of ``csrc/ssd_scan.cu::nk_ssd_chunk_scan``."""
    if dtype == torch.bfloat16 and (p, n) == (64, 128):
        return "wg"
    if dtype == torch.bfloat16 and (p, n) in HEADS_SHAPES:
        return "heads"
    return "simt"


def segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., T). Returns (..., T, T): ``sum_{k=j+1..i} x[k]`` on i >= j,
    -inf above the diagonal (so that ``exp`` of it is the masked decay
    matrix, with no inf ever formed)."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    ii = torch.arange(t, device=x.device)
    return diff.masked_fill(ii[:, None] < ii[None, :], float("-inf"))


def ssd_chunk_scan_plain(xdt, dA, B, C, *, out_dtype=None,
                         state_decay=False):
    """The kernel's function in plain PyTorch: the inputs widened (exactly)
    to f64, every product and sum in f64, each output rounded once to
    f32 (``y`` then to ``out_dtype``)."""
    x = xdt.double()
    a = dA.double().transpose(-1, -2)                    # (nb,nc,H,Q)
    cs = torch.cumsum(a, dim=-1)
    L = torch.exp(segsum(a))                             # (nb,nc,H,Q,Q)
    G = torch.einsum("bcln,bcsn->bcls", C.double(), B.double())
    y = torch.einsum("bchls,bcshp->bclhp", G[:, :, None] * L, x)
    w = torch.exp(cs[..., -1:] - cs)                     # (nb,nc,H,Q)
    st = torch.einsum("bcsn,bcshp->bchpn", B.double(),
                      x * w.transpose(-1, -2)[..., None])
    out = (y.float().to(out_dtype or xdt.dtype), st.float(),
           torch.exp(cs[..., -1]).float())
    if state_decay:
        out += (torch.exp(cs).transpose(-1, -2).float(),)
    return out


def _check(xdt, dA, B, C, out_dtype) -> None:
    if not (xdt.device == dA.device == B.device == C.device):
        raise ValueError("xdt, dA, B and C must be on one device")
    if xdt.dtype not in DTYPES or not (xdt.dtype == B.dtype == C.dtype):
        raise TypeError(f"xdt, B and C must share one dtype of "
                        f"{sorted(map(str, DTYPES))}, got {xdt.dtype}, "
                        f"{B.dtype}, {C.dtype}")
    if out_dtype not in DTYPES:
        raise TypeError(f"out_dtype must be one of "
                        f"{sorted(map(str, DTYPES))}, got {out_dtype}")
    if xdt.dim() != 5 or dA.dim() != 4 or B.dim() != 4 or \
            B.shape != C.shape:
        raise ValueError(f"want xdt (nb,nc,Q,H,P), dA (nb,nc,Q,H), B and C "
                         f"(nb,nc,Q,N); got {tuple(xdt.shape)}, "
                         f"{tuple(dA.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    nb, nc, q, h, _p = xdt.shape
    if tuple(dA.shape) != (nb, nc, q, h) or tuple(B.shape[:3]) != \
            (nb, nc, q):
        raise ValueError(f"xdt {tuple(xdt.shape)} does not match dA "
                         f"{tuple(dA.shape)} / B {tuple(B.shape)}")
    if not 0 < q <= MAX_CHUNK:
        raise ValueError(f"chunk length {q} not supported; the kernel "
                         f"takes 1..{MAX_CHUNK}")
    for t in (xdt, B, C):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("xdt, B and C must be contiguous and 16-byte "
                             "aligned")


def ssd_chunk_scan(xdt, dA, B, C, *, out_dtype=None, state_decay=False):
    """xdt (nb,nc,Q,H,P), dA (nb,nc,Q,H), B/C (nb,nc,Q,N) -> (y
    (nb,nc,Q,H,P) in ``out_dtype`` (default xdt's), states (nb,nc,H,P,N)
    f32, decay (nb,nc,H) f32), and ``state_decay`` (nb,nc,Q,H) f32 when
    asked for (the kernel always writes it).

    On CPU tensors this is ``ssd_chunk_scan_plain``; on CUDA tensors it
    launches the kernel on the current stream (one launch, no
    synchronisation)."""
    if xdt.device.type == "cpu":
        return ssd_chunk_scan_plain(xdt, dA, B, C, out_dtype=out_dtype,
                                    state_decay=state_decay)
    if xdt.device.type != "cuda":
        raise ValueError(f"ssd_chunk_scan runs on cuda or cpu, not "
                         f"{xdt.device}")
    out_dtype = out_dtype or xdt.dtype
    _check(xdt, dA, B, C, out_dtype)
    nb, nc, q, h, p = xdt.shape
    n = B.shape[-1]
    dA = dA.float().contiguous()
    y = torch.empty(xdt.shape, dtype=out_dtype, device=xdt.device)
    st = torch.empty((nb, nc, h, p, n), dtype=torch.float32,
                     device=xdt.device)
    dec = torch.empty((nb, nc, h), dtype=torch.float32, device=xdt.device)
    sd = torch.empty((nb, nc, q, h), dtype=torch.float32, device=xdt.device)
    out = (y, st, dec, sd) if state_decay else (y, st, dec)
    if nb * nc == 0 or h == 0:
        return out
    dev = xdt.device.index if xdt.device.index is not None \
        else torch.cuda.current_device()
    rc = build.library().nk_ssd_chunk_scan(
        xdt.data_ptr(), dA.data_ptr(), B.data_ptr(), C.data_ptr(),
        y.data_ptr(), st.data_ptr(), dec.data_ptr(), sd.data_ptr(), nb * nc,
        q, h, p, n, DTYPES[xdt.dtype], DTYPES[out_dtype], dev,
        torch.cuda.current_stream(xdt.device).cuda_stream)
    build.check(rc, "ssd_chunk_scan")
    ssd_chunk_scan.launches += 1
    ssd_chunk_scan.launches_by_route[route(xdt.dtype, p, n)] += 1
    return out


ssd_chunk_scan.launches = 0
ssd_chunk_scan.launches_by_route = dict.fromkeys(ROUTES, 0)
