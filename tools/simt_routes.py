#!/usr/bin/env python3
"""Time the port's three CUDA-core kernels at the shapes the f32 parity
checks launch them.

    python3 tools/simt_routes.py [--src DIR] [--label NAME] [--out FILE]

``flash_fwd_simt`` (f32 flash at head dim 192), ``decode_simt`` (f32
queries over an f32 cache) and ``ssd_simt`` (the f32 SSD scan) run on the
main path only in ``chip_smoke.py``'s f32 parity checks (its ``routes``
row counts their launches). Shapes, from those checks
(``chip_smoke.parity_logits``: one prompt of 300 tokens, hymba's of
``HYBRID_PARITY_PROMPT``, then 4 decode steps, B 1, f32 caches of 1024
positions): flash at nemotron-4-340b's 96/8 heads and deepseek-v2-236b's
MLA prefill (128/128, v zero-padded from 128), S 300, causal; decode at
chameleon-34b's 64/8 heads (d 128), nemotron's 96/8 (d 192) and
hymba-1.5b's global layer (25/5, d 64, 2,048 positions), at the first
step's position; the SSD scan at mamba2-370m's width over 2 chunks (300
rows) and hymba's over 11 (1,300 rows). Each beside its plain version,
its bound at the CUDA cores' f32 rate (``chip_smoke.bound``) and, for
attention, ``scaled_dot_product_attention`` with the backend it
dispatches to (``chip_smoke.library_row``); each call is checked to take
the ``"simt"`` route. Device ms: ``chip_smoke.Timer`` (CUDA events, L2
flushed), median of 20. Prints one JSON object per shape with the card's
name and power limit. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (the timing helpers; stdlib imports only)

PROMPT = 300
HYBRID_PROMPT = cs.HYBRID_PARITY_PROMPT
# (label, hq, kv, d, v columns) of each flash shape at S PROMPT
FLASH = [("nemotron-4-340b", 96, 8, 192, 192),
         ("deepseek-v2-236b MLA", 128, 128, 192, 128)]
# (label, hq, kv, d, T, position) of each decode shape
DECODE = [("chameleon-34b", 64, 8, 128, 1024, PROMPT),
          ("nemotron-4-340b", 96, 8, 192, 1024, PROMPT),
          ("hymba-1.5b global", 25, 5, 64, 2048, HYBRID_PROMPT)]
# (label, chunks, (Q, H, P, N), rows) of each SSD shape
SSD = [("mamba2-370m", 2, (256, 32, 64, 128), PROMPT),
       ("hymba-1.5b", 11, cs.HYBRID_SSD, HYBRID_PROMPT)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("simt_routes: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    torch.backends.cuda.matmul.allow_tf32 = False
    build.library()
    smi = cs.nvidia_smi()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    timer = cs.Timer(torch, dev)
    rows = []

    def simt(fn, wrapper, call):
        before = wrapper.launches_by_route["simt"]
        call()
        torch.cuda.synchronize()
        if wrapper.launches_by_route["simt"] != before + 1:
            raise AssertionError(f"{fn}: not on the simt route: "
                                 f"{wrapper.launches_by_route}")
        return timer.ms(call)

    def out(row):
        row.update(label=args.label, src=args.src, gpu=smi)
        rows.append(row)
        print(json.dumps(row), flush=True)

    f32 = torch.float32
    for name, hq, kv, d, dv in FLASH:
        q, k, v = (torch.randn((1, PROMPT, h, d), generator=gen,
                               device=dev) for h in (hq, kv, kv))
        v[..., dv:] = 0
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        nbytes, flops = cs.flash_work(1, PROMPT, PROMPT, hq, kv, d, 4, True,
                                      0, dv)
        b_ms, b_by = cs.bound(nbytes, flops, "float32")
        out({"kernel": "flash_fwd_simt", "shape": name, "S": PROMPT,
             "hq": hq, "kv": kv, "d": d, "v_cols": dv, "dtype": "float32",
             "ms": simt("flash", fa.flash_attention,
                        lambda: fa.flash_attention(q, k, v)),
             "plain_ms": timer.ms(
                 lambda: fa.flash_attention_plain(q, k, v)),
             **cs.library_row(torch, timer, qt, kt, vt, is_causal=True,
                              enable_gqa=True),
             "bound_ms": b_ms, "bound_by": b_by})
    for name, hq, kv, d, t, p in DECODE:
        pos = torch.tensor([p], dtype=torch.int32, device=dev)
        q = torch.randn((1, hq, d), generator=gen, device=dev)
        kc, vc = (torch.randn((1, t, kv, d), generator=gen, device=dev)
                  for _ in range(2))
        kt, vt = (x.transpose(1, 2).contiguous() for x in (kc, vc))
        nbytes, flops = cs.decode_work([p], t, hq, kv, d, 4, 4)
        b_ms, b_by = cs.bound(nbytes, flops, "float32")
        out({"kernel": "decode_simt", "shape": name, "B": 1, "T": t,
             "hq": hq, "kv": kv, "d": d, "pos": p, "dtype": "float32",
             "ms": simt("decode", da.decode_attention,
                        lambda: da.decode_attention(q, kc, vc, pos)),
             "plain_ms": timer.ms(
                 lambda: da.decode_attention_plain(q, kc, vc, pos)),
             **cs.library_row(torch, timer, q[:, :, None, :], kt, vt,
                              attn_mask=da.live_mask(pos, t)[:, None, None,
                                                             :],
                              enable_gqa=True),
             "bound_ms": b_ms, "bound_by": b_by})
    for name, nc, shape, real in SSD:
        xdt, dA, B, C = cs.ssd_inputs(torch, gen, dev, nc, "float32",
                                      pad_rows=nc * shape[0] - real,
                                      shape=shape)
        nbytes, flops = cs.ssd_work(nc, 4, shape)
        b_ms, b_by = cs.bound(nbytes, flops, "float32")
        kw = {"out_dtype": f32, "state_decay": True}
        out({"kernel": "ssd_simt", "shape": name, "nc": nc,
             **dict(zip("QHPN", shape)), "rows": real, "dtype": "float32",
             "ms": simt("ssd", ss.ssd_chunk_scan,
                        lambda: ss.ssd_chunk_scan(xdt, dA, B, C, **kw)),
             "plain_ms": timer.ms(
                 lambda: ss.ssd_chunk_scan_plain(xdt, dA, B, C, **kw)),
             "library_ms": None, "bound_ms": b_ms, "bound_by": b_by})
    if args.out:
        Path(args.out).write_text("".join(json.dumps(r) + "\n"
                                          for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
