#!/usr/bin/env python3
"""``chip_smoke.py``'s moe train phase alone, and its sharded train phase.

    python3 tools/train_moe_probe.py [--out FILE] [--llama]

Builds the kernels and runs ``phase_sharded_train_moe``: deepseek-v2-236b
at full width and 1 + 1 of its 60 layers trained on one device, then on
the model axis at an NCCL world of one under ``"2d"`` with Megatron-SP
(bf16 moments, factored nu, bf16 accumulation), each TP train rank's
flash at MLA's (tp 1 too, the phase's own shape) and arctic's heads
(about two minutes after the build).
``--llama`` runs ``phase_sharded_train`` (full-width llama3.2-3b at 4
layers on the model axis, its Megatron-SP step included) after it. One
JSON object a line goes to stdout and to ``--out``; the card's name and
power limit come first. Needs a CUDA device.
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
    ap.add_argument("--llama", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("train_moe_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    emit = chip_smoke.emit
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("")

    def kept(obj):
        """Each line to stdout and, as it comes, to ``--out``."""
        emit(obj)
        if args.out:
            with args.out.open("a") as f:
                f.write(json.dumps(obj, default=str) + "\n")

    chip_smoke.emit = kept
    t0 = time.perf_counter()
    smi = chip_smoke.nvidia_smi()
    kept({"probe": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0)})
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    build.library()
    kept({"probe": "build", "seconds": time.perf_counter() - t0})
    t1 = time.perf_counter()
    launches, _checks = chip_smoke.phase_sharded_train_moe(torch, device,
                                                           smi)
    kept({"probe": "sharded_train_moe", "flash_launches": launches,
          "seconds": time.perf_counter() - t1})
    if args.llama:
        t1 = time.perf_counter()
        launches, _checks = chip_smoke.phase_sharded_train(
            torch, device, get_config("llama3.2-3b"), smi)
        kept({"probe": "sharded_train", "flash_launches": launches,
              "seconds": time.perf_counter() - t1})
    kept({"probe": "seconds", "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
