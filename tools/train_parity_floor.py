#!/usr/bin/env python3
"""Is hymba-1.5b's full-depth bf16 gradient gap between the kernel path
and the plain path the model's own noise, or a kernel's fault?

    python3 tools/train_parity_floor.py [--out FILE]

``chip_smoke.py``'s train-families phase compares, on one micro-batch of
full-width, full-depth hymba-1.5b (1 x 4,096 tokens, bf16), the grads of
the kernel-fed leaves (``chip_smoke.kernel_fed``) of the kernel path with
the plain path's, beside one noise floor: the plain path against itself
with every flash and scan output scaled by 1 + 2^-8. This tool repeats
that comparison, through ``chip_smoke.train_parity``, for three seeds
(weights and data: ``chip_smoke.SEED`` and the next two), with three
floor samples each (every output scaled by 1 + 2^-8, by 1 - 2^-8, and
each element by 1 + 2^-8 or 1 - 2^-8, the sign a fixed function of its
flat index), and with one kernel at a time: the flash kernel with the
SSD scan's plain version (``SsdScanFn`` swapped out), and the SSD kernel
with flash's plain version (``FlashAttentionFn`` swapped out). Per seed:
the loss and grad-norm gaps, the worst and median kernel-fed gap of each
run and floor, and the worst leaves with their gap in each. One JSON
object per seed goes to stdout and to ``--out``, with the card's name
and power limit. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

ARCH = "hymba-1.5b"
SEEDS = (chip_smoke.SEED, chip_smoke.SEED + 1, chip_smoke.SEED + 2)


def signed_nudge(torch, n: float):
    """Each element scaled by 1 + n or 1 - n in f32, the sign a fixed
    function of its flat index (the same in remat's recomputation), then
    rounded to the element's dtype."""
    def nudge(t):
        i = torch.arange(t.numel(), device=t.device, dtype=torch.float32)
        sign = torch.sin(i * 12.9898 + 78.233).sign().view(t.shape)
        return (t.float() * (1 + n * sign)).to(t.dtype)
    return nudge


def one_kernel(torch, keep: str):
    """Swaps the other kernel's autograd wrapper for its plain version
    under autograd; returns the undo."""
    from repro_torch.models import attention, ssm
    if keep == "flash":
        swapped = ssm.SsdScanFn
        ssm.SsdScanFn.apply = lambda *ins: ssm.ssd_chunk_scan_plain(
            *ins, out_dtype=torch.float32, state_decay=True)
    else:
        swapped = attention.FlashAttentionFn
        attention.FlashAttentionFn.apply = \
            lambda q, k, v, causal, window, *_blocks: \
            attention.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)

    def undo():
        del swapped.apply           # back to torch.autograd.Function's
    return undo


def summary(gaps: dict) -> dict:
    return {"worst_gap": max(gaps.values()),
            "median_gap": statistics.median(gaps.values())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("train_parity_floor: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data import for_model
    from repro_torch.kernels import build
    from repro_torch.models.params import init_params
    build.library()
    smi = chip_smoke.nvidia_smi()
    device = torch.device("cuda", 0)
    cfg = get_config(ARCH)
    seq, batch = next((s, b) for a, s, b in chip_smoke.FAMILY_TRAINERS
                      if a == ARCH)
    n = chip_smoke.FLOOR_NUDGE
    floors = {"up": chip_smoke.uniform_nudge(n),
              "down": chip_smoke.uniform_nudge(-n),
              "signed": signed_nudge(torch, n)}
    rows = []
    for seed in SEEDS:
        feed = for_model(cfg, ShapeConfig("train", seq, batch, "train"),
                         seed=seed, device=device)
        micro = {k: v[:batch // chip_smoke.TRAIN_ACCUM]
                 for k, v in feed.batch_at(0).items()}
        model = init_params(cfg, device=device, seed=seed)
        par = chip_smoke.train_parity(torch, device, cfg, model, micro,
                                      chip_smoke.kernel_fed,
                                      nudges=tuple(floors.values()))
        runs = {"both_kernels": par.pop("grad_gaps")}
        runs.update(("floor_" + k, f)
                    for k, f in zip(floors, par.pop("floor_gaps")))
        for keep in ("flash", "ssd"):
            undo = one_kernel(torch, keep)
            try:
                runs[f"{keep}_kernel_only"] = chip_smoke.train_parity(
                    torch, device, cfg, model, micro,
                    chip_smoke.kernel_fed)["grad_gaps"]
            finally:
                undo()
        both = runs["both_kernels"]
        row = {"model": cfg.name, "layers": cfg.num_layers, "seed": seed,
               "tokens": seq, **par, "kernel_fed_grads": len(both),
               **{k: summary(g) for k, g in runs.items()},
               "worst_leaves": {leaf: {k: g[leaf] for k, g in runs.items()}
                                for leaf in sorted(both, key=both.get)[-3:]},
               "gpu": smi}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del model, feed, micro
        gc.collect()
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).write_text("".join(json.dumps(r) + "\n"
                                          for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
