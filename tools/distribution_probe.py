#!/usr/bin/env python3
"""``chip_smoke.py``'s distribution phase alone, with its timings.

    python3 tools/distribution_probe.py [--out FILE]

Builds the kernels, serves full-width llama3.2-3b through the unsharded
engine (the serve phase, to get the tokens the sharded path must
reproduce; then profiled, the step the sharded one is set beside), then
runs ``phase_distribution`` (the cp decode's per-rank
kernel work at T 32,768, flash at each TP rank's shapes, the sharded serve
on an NCCL world of one, the per-rank bytes), with the sharded engine
profiled and the collectives' host µs a call, and the phase's timing rows
(``cp_timings``, ``tp_flash_timings``): a quick way to re-measure the model
axis without the rest of the script (about a minute). One JSON object a
line goes to stdout and to ``--out``; the card's name and power limit come
first. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("distribution_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    lines = []
    emit = chip_smoke.emit

    def kept(obj):
        lines.append(obj)
        emit(obj)

    chip_smoke.emit = kept
    t0 = time.perf_counter()
    smi = chip_smoke.nvidia_smi()
    kept({"probe": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0)})
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    build.library()
    cfg = get_config("llama3.2-3b")
    eng, _, _ = chip_smoke.phase_serve(
        torch, device, cfg, cfg.num_layers,
        {"flash_attention": flash_attention},
        {"decode_attention": decode_attention}, prefill_lens=())
    tokens = {r.req_id: list(r.generated) for r in eng.completed}
    chip_smoke.phase_profile(torch, device, eng)     # the unsharded step
    del eng
    torch.cuda.empty_cache()
    chip_smoke.phase_distribution(torch, device, cfg, tokens, profile=True)
    timer = chip_smoke.Timer(torch, device)
    chip_smoke.cp_timings(torch, device, smi, timer)
    chip_smoke.tp_flash_timings(torch, device, smi, timer)
    kept({"probe": "seconds", "seconds": time.perf_counter() - t0})
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
