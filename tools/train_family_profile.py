#!/usr/bin/env python3
"""Where a training micro-batch of the ssm, hybrid and encdec trainers
spends its time: is it host-bound, and by which plain backward?

    python3 tools/train_family_profile.py [--out FILE] [--src DIR]
                                          [--archs A,B] [--label NAME]

For mamba2-370m, hymba-1.5b and whisper-small at full width and depth,
one micro-batch of ``chip_smoke.py``'s train-families phase (mamba2 and
hymba: 1 x 4,096 tokens; whisper: 4 x 448 tokens and 4 x 1,500 f32
frames, from ``for_model``), its forward and backward as
``train_loop._grads`` runs them (``loss_fn``, ``torch.autograd.grad``;
``RunConfig()``'s defaults: remat full, the kernels through
``FlashAttentionFn`` and ``SsdScanFn``). After one warm-up run,
``chip_smoke._profile`` gives the host clock's wall, the CUDA kernels'
device time under torch.profiler and its share of the wall (the busy
share), the launches, the top kernels, and the device time and share of
the backward nodes of the two kernel wrappers (``FlashAttentionFnBackward``
and ``SsdScanFnBackward``: the plain versions' VJPs). One JSON object per
model goes to stdout and to ``--out``, with the card's name and power
limit. ``--src`` is the ``src`` directory of a checkout (default: this
one's) and ``--archs`` a comma-separated subset of the trainers, so that
two trees can be profiled on one card in one call, in turns, as
``tools/attention_ab.py`` times them. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

NODES = tuple(f"autograd::engine::evaluate_function: {n}Backward"
              for n in ("FlashAttentionFn", "SsdScanFn"))


def profile_micro_batch(torch, cfg, micro) -> dict:
    from repro_torch.configs import RunConfig
    from repro_torch.models.params import init_params
    from repro_torch.train.train_loop import _trainable, loss_fn
    model = init_params(cfg, device=torch.device("cuda", 0),
                        seed=chip_smoke.SEED)
    params = [p for _, p in _trainable(model)]
    rcfg = RunConfig()

    def run():
        loss, _ = loss_fn(model, micro, cfg, rcfg)
        torch.autograd.grad(loss, params)

    run()
    row = {"model": cfg.name, "tokens": tuple(micro["tokens"].shape),
           **chip_smoke._profile(torch, run, ranges=NODES)}
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--archs", default="")
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    archs = set(filter(None, args.archs.split(",")))
    import torch
    if not torch.cuda.is_available():
        print("train_family_profile: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data import for_model
    from repro_torch.kernels import build
    build.library()
    smi = chip_smoke.nvidia_smi()
    rows = []
    for arch, seq, batch in chip_smoke.FAMILY_TRAINERS:
        if archs and arch not in archs:
            continue
        cfg = get_config(arch)
        feed = for_model(cfg, ShapeConfig("train", seq, batch, "train"),
                         seed=chip_smoke.SEED,
                         device=torch.device("cuda", 0))
        micro = {k: v[:batch // chip_smoke.TRAIN_ACCUM]
                 for k, v in feed.batch_at(0).items()}
        row = {**profile_micro_batch(torch, cfg, micro), "gpu": smi,
               "label": args.label, "src": args.src}
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        Path(args.out).write_text("".join(json.dumps(r) + "\n"
                                          for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
