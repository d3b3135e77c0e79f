#!/usr/bin/env python3
"""Time the port's SSD scan kernel of one source tree on the card.

    python3 tools/ssd_ab.py [--src DIR] [--label NAME] [--flush MODE]
                            [--shapes SET]

``--src`` is the ``src`` directory of a checkout (default: this one's), so
that two trees can be compared on one card in one call, in turns (parent,
change, change, parent): each run is its own process, since both trees
name their package ``repro_torch``. The tree's kernels are built into its
own ``build/kernels``.

Shapes (``--shapes``) are ``chip_smoke.py``'s, bf16 in, f32 y, one
sequence, the inputs of ``chip_smoke.ssd_inputs``: ``mamba2`` (the
default), mamba2-370m's width (Q 256, H 32, P 64, N 128) at 1, 2 and 16
chunks (a 256-, 512- and 4,096-token prompt); ``hymba``, hymba-1.5b's
(Q 128, P 64, N 16) at 12 chunks with H 50 (a 1,536-token prompt, the
serve phase), 32 chunks with H 50 (a 4,096-token training sequence), and
12 and 32 chunks with H 25 (a TP rank at tp 2, serving and training);
``all``, both. The call is the reference-shaped three-output one, which
every tree takes. Device ms per call: ``chip_smoke.Timer`` (CUDA events
around one launch, the L2 flushed, the host's enqueue hidden), median of
20; ``--flush write`` (the default, as ``chip_smoke.py``) or ``read`` (a
clean L2). Each row carries its bound (``chip_smoke.ssd_work``,
``chip_smoke.bound``). Prints one JSON object per shape with the card's
name and power limit. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the timing helpers; stdlib imports only)

MAMBA2 = (chip_smoke.SSD_Q, chip_smoke.SSD_H, chip_smoke.SSD_P,
          chip_smoke.SSD_N)
HYMBA = chip_smoke.HYBRID_SSD
# (label, chunks, (Q, H, P, N)) of each shape, per shape set
SHAPES = {
    "mamba2": [(f"mamba2 nc {nc}", nc, MAMBA2) for nc in (1, 2, 16)],
    "hymba": [("hymba serve nc 12 H 50", 12, HYMBA),
              ("hymba train nc 32 H 50", 32, HYMBA),
              ("hymba TP rank nc 12 H 25", 12, (HYMBA[0], HYMBA[1] // 2)
               + HYMBA[2:]),
              ("hymba TP train rank nc 32 H 25", 32, (HYMBA[0],
                                                      HYMBA[1] // 2)
               + HYMBA[2:])],
}
SHAPES["all"] = SHAPES["mamba2"] + SHAPES["hymba"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--flush", choices=("write", "read"), default="write")
    ap.add_argument("--shapes", choices=sorted(SHAPES), default="mamba2")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ssd_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan
    build.library()
    smi = chip_smoke.nvidia_smi()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    timer = chip_smoke.Timer(torch, dev, flush=args.flush)
    for name, nc, shape in SHAPES[args.shapes]:
        xdt, dA, B, C = chip_smoke.ssd_inputs(torch, gen, dev, nc,
                                              "bfloat16", shape=shape)
        call = lambda: ssd_chunk_scan(   # noqa: E731
            xdt, dA, B, C, out_dtype=torch.float32)
        nbytes, flops = chip_smoke.ssd_work(nc, 2, shape)
        b_ms, b_by = chip_smoke.bound(nbytes, flops, "bfloat16")
        print(json.dumps({
            "label": args.label, "src": args.src, "flush": args.flush,
            "kernel": "ssd_chunk_scan", "shape": name, "nc": nc,
            **dict(zip("QHPN", shape)), "tokens": nc * shape[0],
            "ms": timer.ms(call), "bound_ms": b_ms, "bound_by": b_by,
            "gpu": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
