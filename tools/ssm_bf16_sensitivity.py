#!/usr/bin/env python3
"""How far a random-weight mamba2-370m moves under tiny perturbations, on
the card: why bf16 end-to-end logit parity is not a test of the SSD kernel.

    python3 tools/ssm_bf16_sensitivity.py

Full width (d_model 1024, 32 SSD heads of P 64, N 128, chunk 256), random
weights from a seeded generator, one 300-token prompt's prefill logits,
each gap as max |a - b| / max |b|:

* ``bf16_kernel_vs_plain_L{n}``: the SSD kernel path against the plain
  path (``attention_impl="naive"``), at depth 1 to 48;
* ``f32_kernel_vs_plain_L{n}``: the same with the weights widened to f32;
* ``bf16_plain_vs_nudged_plain_L{n}``: the plain path against itself with
  every scan's y scaled by (1 + 1e-6);
* ``bf16_plain_vs_f32_plain_L{n}``: the plain path at bf16 against the
  same weights widened to f32 (the model's own bf16 noise).

Prints one JSON object per depth, and the card's name and power limit.
Needs a CUDA device; run from the root of a checkout.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DEPTHS = (1, 2, 4, 8, 16, 48)
FLOOR_DEPTHS = (8, 48)
NUDGE = 1e-6


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.models import Model, forward_prefill, init_params
    from repro_torch.models import ssm as ssm_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    base = get_config("mamba2-370m")
    prompt = torch.randint(
        0, base.vocab_size, (1, 300), device=dev, dtype=torch.int64,
        generator=torch.Generator(device=dev).manual_seed(1)).int()
    kernel, plain = RunConfig(), RunConfig(attention_impl="naive")

    def logits(model, rc):
        return forward_prefill(model, prompt, rc, max_seq=1024)[0].float()

    def gap(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    scan_plain = ssm_mod.ssd_chunk_scan_plain

    def nudged(*args, **kw):
        y, st, dec = scan_plain(*args, **kw)
        return y * (1 + NUDGE), st, dec

    out = {}
    for depth in DEPTHS:
        cfg = dataclasses.replace(base, num_layers=depth)
        m = init_params(cfg, device=dev, generator=torch.Generator(
            device=dev).manual_seed(0))
        ref = logits(m, plain)
        row = {"layers": depth,
               "bf16_kernel_vs_plain": gap(logits(m, kernel), ref)}
        if depth in FLOOR_DEPTHS:
            m32 = Model(dataclasses.replace(cfg, dtype="float32",
                                            param_dtype="float32"),
                        device=dev)
            m32.load_state_dict(m.state_dict())     # widened, exactly
            ref32 = logits(m32, plain)
            row["f32_kernel_vs_plain"] = gap(logits(m32, kernel), ref32)
            row["bf16_plain_vs_f32_plain"] = gap(ref, ref32)
            ssm_mod.ssd_chunk_scan_plain = nudged
            try:
                row["bf16_plain_vs_nudged_plain"] = gap(logits(m, plain),
                                                        ref)
            finally:
                ssm_mod.ssd_chunk_scan_plain = scan_plain
            row["max_abs_logit"] = ref.abs().max().item()
            del m32
        out[depth] = row
        print(json.dumps(row), flush=True)
        del m
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
