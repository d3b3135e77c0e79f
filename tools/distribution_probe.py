#!/usr/bin/env python3
"""``chip_smoke.py``'s distribution phase alone, with its timings.

    python3 tools/distribution_probe.py [--out FILE] [--families [NAMES]]

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
first. ``--families`` runs, instead, each other family's world-of-one
sharded serve beside its unsharded one, both profiled (mamba2-370m and
hymba-1.5b at full depth, arctic-480b at 2 and deepseek-v2-236b at 1 + 7
layers, each model's weights freed before the next; whisper-small's
sharded prefill and decode beside its unsharded ones) and the per-rank
timing rows (``family_rank_timings``): a few minutes. Needs a CUDA device.
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
    ap.add_argument("--families", nargs="?", const="all", default=None,
                    help="all, or a comma list of mamba2-370m, hymba-1.5b, "
                         "arctic-480b, deepseek-v2-236b, whisper-small")
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
    emit = chip_smoke.emit
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("")

    def kept(obj):
        """Each line to stdout and, as it comes, to ``--out``."""
        emit(obj)
        if args.out:
            with args.out.open("a") as f:
                f.write(json.dumps(obj) + "\n")

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
    if args.families:
        families(torch, device, smi, args.families)
        kept({"probe": "seconds", "seconds": time.perf_counter() - t0})
        return 0
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
    return 0


def families(torch, device, smi, names="all"):
    """Each other family (``names``: "all" or a comma list) served
    unsharded and then sharded at a world of one, both profiled
    (``phase_profile`` on a controller-free engine over the same weights:
    the step's device time and busy share), the sharded run held to the
    unsharded tokens; then the per-rank timing rows."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan
    cs = chip_smoke
    hy = dict(max_seq=cs.HYBRID_MAX_SEQ, prompt_range=cs.HYBRID_PROMPT_RANGE,
              fixed_lengths=cs.HYBRID_FIXED_LENGTHS)
    flash = {"flash_attention": flash_attention}
    dec = {"decode_attention": decode_attention}
    ssd = {"kernel": "ssd_"}
    runs = [(get_config("mamba2-370m"), {"ssd_chunk_scan": ssd_chunk_scan},
             {}, {}, ssd),
            (get_config("hymba-1.5b"),
             {**flash, "ssd_chunk_scan": ssd_chunk_scan}, dec, hy,
             {**ssd, "prompt_len": cs.HYBRID_PROMPT_RANGE[0],
              "prefill_len": cs.HYBRID_PREFILL_LENS[-1]})]
    for arch, layers, _f32 in cs.MOE_MODELS:
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        runs.append((cfg, flash, {} if cfg.mla is not None else dec, {},
                     {}))
    from repro_torch.configs import RunConfig
    from repro_torch.serve import ServeEngine
    wanted = None if names == "all" else set(names.split(","))
    for cfg, pre, dec_k, kw, prof in runs:
        if wanted is not None and cfg.name not in wanted:
            continue
        eng, _, _ = cs.phase_serve(torch, device, cfg, cfg.num_layers, pre,
                                   dec_k, prefill_lens=(), **kw)
        tokens = {r.req_id: list(r.generated) for r in eng.completed}
        cs.phase_profile(torch, device, ServeEngine(
            cfg, RunConfig(), eng.params, batch_slots=eng.B,
            max_seq=eng.max_seq), **prof)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        cs.sharded_serve(torch, device, cfg, tokens, pre, dec_k,
                         profile=True, profile_kw=prof, **kw)
    if wanted is None or "whisper-small" in wanted:
        encdec = {}
        cs.phase_encdec(torch, device, out=encdec)
        cs.sharded_encdec(torch, device, get_config("whisper-small"),
                          encdec["prompts"], encdec["frames"],
                          encdec["tokens"])
    cs.family_rank_timings(torch, device, smi, cs.Timer(torch, device))


if __name__ == "__main__":
    sys.exit(main())
