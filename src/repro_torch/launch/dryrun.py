"""Dry run: one rank's shard of every (arch x shape x mesh) cell, on meta.

The counterpart of ``repro/launch/dryrun.py``. The reference lowers and
compiles each cell's step against 512 host placeholder devices and reads
XLA's ``memory_analysis()``. The port has no compiler to ask. It builds,
for one rank of the production mesh (16x16, or 2x16x16 with
``multi_pod``), what that rank's step holds, on ``device="meta"``: shapes
and dtypes, no storage, no world, no weights drawn. The layouts are the
port's own, the ones its sharded step makes (``ShardingCtx`` on an
``{axis: size}`` dict):

  * **train**: ``make_train_state(..., abstract=True, shd=train_ctx(...))``
    (the params and the optimizer moments in the cell's dtype, factored or
    not) and the rank's rows of the batch (``batch_shardings``). The step
    updates the state in place: its output is its argument.
  * **prefill**: the params in the serving layout, the rank's rows of the
    tokens (and frames), and what the prefill returns: the last logits
    (the rank's rows and vocab columns) and the cache (``init_cache(...,
    shd=)``: rows over the batch axes, the sequence over ``model``).
  * **decode**: the params, the cache (updated in place), the tokens and
    positions; the logits out.

Each cell reports argument and output bytes per rank, as
``memory_analysis``'s ``argument_size_in_bytes`` and
``output_size_in_bytes`` do, the bytes the outputs share with the
arguments (``in_place_bytes``), and ``resident_bytes``, their union.
Temporaries (activations) are not modelled: nothing runs on meta.
``state_fits_80gb`` says only that the resident state fits the card's
``HBM_BYTES``. FLOPs are ``roofline.model_flops``; the reference's
``cost_analysis`` and its layer-differencing probes have no counterpart
(``run_probes`` raises by name), so a cell's executed FLOPs, HBM and
collective bytes stay ``None`` in its ``RooflineCell``.

The serving layout differs from the reference's where the rules put a
weight on ``data``: the reference lowers prefill and "2d" decode cells
with the rules whole (FSDP over ``data``), the port's serving path keeps
weights model-sharded and replicated over the batch axes
(``ShardingCtx.weight_rules``). Each cell also gives its parameter bytes
in the reference's layout (``params_bytes_reference_layout``).

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k
  python -m repro_torch.launch.dryrun --all                 # every cell
  python -m repro_torch.launch.dryrun --all --multi-pod
  python -m repro_torch.launch.dryrun --report              # the table

Records go to ``results/dryrun_torch/`` at the checkout's root (``--out``
another directory).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import torch

from repro_torch.configs import (
    ARCHS, SHAPES, RunConfig, get_config, get_shape, shape_applicable)
from repro_torch.device import dtype_of
from repro_torch.distribution.sharding import (
    ShardingCtx, local_shape, make_rules, spec_for)
from repro_torch.launch import roofline as rl
from repro_torch.models.model import (
    Model, init_cache, input_specs, model_schema)
from repro_torch.models.schema import ParamDesc
from repro_torch.train.train_loop import (
    batch_shardings, make_train_state, train_ctx)

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def run_config_for(arch: str, shape_name: str, probe: bool = False
                   ) -> RunConfig:
    """Operator-side per-cell parallelism/numerics table, the reference's.

    Small/medium dense archs train pure-FSDP (batch over the whole mesh);
    MoE + the 340B dense train 2D (FSDP x TP) with sequence-parallel
    activations; >100B models use bf16 moments, factored second moment and
    gradient accumulation. Serving shapes use the 2D rules, decode TP
    where the weights fit replicated over ``data`` (<60B)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    nparams = cfg.num_params()
    seq = shape.seq_len
    blk = 512 if seq <= 4096 else 2048
    kw: Dict = dict(
        attn_q_block=blk, attn_kv_block=blk, remat="full",
        force_unroll_segments=probe,
    )
    if shape.kind == "train":
        if cfg.moe is not None or nparams > 60e9:
            kw["rules_variant"] = "2d"
            kw["seq_parallel_activations"] = True
        else:
            kw["rules_variant"] = "fsdp"
        if nparams > 100e9:
            kw.update(moment_dtype="bfloat16", factored_nu=True,
                      grad_accum_dtype="bfloat16",
                      grad_accum=16 if nparams > 300e9 else
                      (8 if nparams > 200e9 else 4))
    elif shape.kind == "decode":
        kw["rules_variant"] = "tp" if nparams < 60e9 else "2d"
    return RunConfig(**kw)


# ---------------------------------------------------------------------------
# One rank's cell on meta
# ---------------------------------------------------------------------------


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _rows(t: torch.Tensor, dims, sizes: Dict[str, int], rules
          ) -> torch.Tensor:
    """The rank's block of a global meta tensor laid out by ``dims``."""
    spec = spec_for(tuple(t.shape), dims, sizes, rules)
    return _meta(local_shape(tuple(t.shape), spec, sizes), t.dtype)


def tensors(tree) -> List[torch.Tensor]:
    """Every tensor of a tree of dicts, lists, tuples and modules."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        tree = tree.values()
    return [t for v in tree for t in tensors(v)]


def nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tensors(tree))


def _descs(tree) -> List[ParamDesc]:
    if isinstance(tree, ParamDesc):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    return [d for v in tree for d in _descs(v)]


def params_bytes(cfg, sizes: Dict[str, int], rules) -> int:
    """A rank's parameter bytes of ``cfg`` with every leaf laid out by
    ``rules`` on ``sizes``, by spec math alone (no module built)."""
    return sum(
        math.prod(local_shape(desc.shape, spec_for(
            desc.shape, desc.dims, sizes, rules), sizes))
        * dtype_of(desc.dtype).itemsize
        for desc in _descs(model_schema(cfg, sizes)))


def build_cell(cfg, shape, sizes: Dict[str, int], rcfg: RunConfig) -> Dict:
    """One rank's shard of the cell on meta: ``{"arguments": {...},
    "outputs": {...}, "in_place": (output names that are arguments,
    updated in place)}``."""
    rules = make_rules(rcfg.rules_variant)
    specs = input_specs(cfg, shape)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        shd = train_ctx(sizes, rcfg)
        state = make_train_state(cfg, rcfg, abstract=True, device="meta",
                                 shd=shd)
        bsh = batch_shardings(cfg, sizes, rcfg=rcfg, global_batch=b)
        batch = {k: _meta(local_shape(tuple(specs[k].shape), v.spec, sizes),
                          specs[k].dtype) for k, v in bsh.items()}
        return {"arguments": {"state": state, "batch": batch},
                "outputs": {"state": state}, "in_place": ("state",)}
    shd = ShardingCtx(sizes, rules=rules)
    params = Model(cfg, device="meta", shd=shd)
    logits = _rows(_meta((b, cfg.vocab_size), dtype_of(cfg.dtype)),
                   ("batch", "vocab"), sizes, rules)
    if shape.kind == "prefill":
        args = {"params": params,
                "tokens": _rows(specs["tokens"], ("batch", None), sizes,
                                rules)}
        if cfg.encoder_layers:
            args["frames"] = _rows(specs["frames"], ("batch", None, None),
                                   sizes, rules)
        caches = init_cache(cfg, b, s, dtype=cfg.dtype, device="meta",
                            shd=shd)
        return {"arguments": args,
                "outputs": {"logits": logits, "caches": caches},
                "in_place": ()}
    caches = init_cache(cfg, b, s, device="meta", shd=shd)
    args = {"params": params, "caches": caches,
            "tokens": _rows(specs["tokens"], ("batch", None), sizes, rules),
            "pos": _rows(specs["pos"], ("batch",), sizes, rules)}
    return {"arguments": args,
            "outputs": {"logits": logits, "caches": caches},
            "in_place": ("caches",)}


def memory(cell: Dict, cfg, sizes: Dict[str, int], rcfg: RunConfig
           ) -> Dict:
    """A built cell's bytes per rank."""
    args, outs = cell["arguments"], cell["outputs"]
    arg_b, out_b = nbytes(args), nbytes(outs)
    in_place = sum(nbytes(outs[k]) for k in cell["in_place"])
    resident = arg_b + out_b - in_place
    state = args.get("state")
    params = state["params"] if state is not None else args["params"]
    rec = {"argument_bytes": arg_b, "output_bytes": out_b,
           "in_place_bytes": in_place, "resident_bytes": resident,
           "params_bytes": nbytes(params),
           "params_bytes_reference_layout": params_bytes(
               cfg, sizes, make_rules(rcfg.rules_variant)),
           "temp_bytes": "not modelled (activations; nothing runs on meta)",
           "state_fits_80gb": bool(resident < rl.HBM_BYTES)}
    if state is not None:
        rec["opt_bytes"] = nbytes(state["opt"])
        rec["batch_bytes"] = nbytes(args["batch"])
    else:
        rec["cache_bytes"] = nbytes(outs["caches"])
    return rec


def run_probes(cfg, shape, mesh):
    """The reference's layer-differencing FLOP probes."""
    raise NotImplementedError(
        "run_probes: the layer-differencing probes read XLA's "
        "cost_analysis of compiled HLO, which the port does not have; a "
        "cell's FLOPs are roofline.model_flops")


def cost_analysis(cfg, shape, mesh):
    """The reference's ``compiled.cost_analysis()``."""
    raise NotImplementedError(
        "cost_analysis: the port compiles no HLO, so nothing counts the "
        "FLOPs and bytes a step executes; a cell's FLOPs are "
        "roofline.model_flops")


# ---------------------------------------------------------------------------
# Cell driver
# ---------------------------------------------------------------------------


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: Optional[str] = None, write: bool = True) -> Dict:
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    sizes = MESHES[mesh_name]
    chips = 512 if multi_pod else 256
    ok, why = shape_applicable(cfg, shape)
    rec: Dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "chips": chips,
                 "model_flops_global": rl.model_flops(cfg, shape)}
    if not ok:
        rec.update(skipped=True, skip_reason=why)
        if write:
            _write(rec, out_dir)
        return rec
    rcfg = run_config_for(arch, shape_name)
    t0 = time.perf_counter()
    cell = build_cell(cfg, shape, sizes, rcfg)
    seconds = time.perf_counter() - t0
    mem = memory(cell, cfg, sizes, rcfg)
    roof = rl.RooflineCell(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        flops_per_chip=None, hbm_bytes_per_chip=None,
        coll_bytes_per_chip=None, coll_by_kind={},
        model_flops_global=rec["model_flops_global"],
        memory_per_chip_gb=mem["resident_bytes"] / 1e9,
        compile_seconds=seconds, ideal_bytes_global=rl.ideal_bytes(cfg, shape),
        notes="meta build of one rank; no temporaries; executed FLOPs, HBM "
              "and collective bytes not measured")
    rec.update(skipped=False, build_seconds=seconds,
               rules_variant=rcfg.rules_variant,
               seq_parallel=rcfg.seq_parallel_activations,
               moment_dtype=rcfg.moment_dtype, factored_nu=rcfg.factored_nu,
               grad_accum=rcfg.grad_accum, memory=mem,
               roofline=roof.to_json())
    if write:
        _write(rec, out_dir)
    return rec


def run_all(multi_pod: bool, archs: Iterable[str] = tuple(ARCHS),
            out_dir: Optional[str] = None, write: bool = True
            ) -> List[Dict]:
    return [run_cell(a, s, multi_pod, out_dir, write)
            for a in archs for s in SHAPES]


def _write(rec: Dict, out_dir: Optional[str]) -> None:
    out = Path(out_dir) if out_dir else RESULTS
    out.mkdir(parents=True, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    with open(out / name, "w") as f:
        json.dump(rec, f, indent=1, default=str)


def _gb(n) -> str:
    return f"{n / 1e9:.2f}"


def table(recs: Iterable[Dict]) -> str:
    """The markdown table of dry-run records."""
    lines = ["| arch | shape | mesh | rules | args GB | out GB | resident GB "
             "| fits 80 GB | params GB | params GB (ref layout) | t_ideal | "
             "temp |",
             "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r.get("skipped"):
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                         f"SKIP: {r['skip_reason'][:40]} | - | - | - | - | "
                         f"- | - | - | - |")
            continue
        m = r["memory"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r['rules_variant']}{' +SP' if r['seq_parallel'] else ''} | "
            f"{_gb(m['argument_bytes'])} | {_gb(m['output_bytes'])} | "
            f"{_gb(m['resident_bytes'])} | "
            f"{'Y' if m['state_fits_80gb'] else 'N'} | "
            f"{_gb(m['params_bytes'])} | "
            f"{_gb(m['params_bytes_reference_layout'])} | "
            f"{rl.fmt_seconds(r['roofline']['t_ideal'])} | not modelled |")
    return "\n".join(lines)


def report(out_dir: Optional[str] = None) -> str:
    out = Path(out_dir) if out_dir else RESULTS
    recs = []
    for name in sorted(os.listdir(out)):
        if name.endswith(".json"):
            with open(out / name) as f:
                recs.append(json.load(f))
    return table(recs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCHS))
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.report:
        print(report(args.out))
        return
    if args.all:
        recs = run_all(args.multi_pod, out_dir=args.out)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all, or --report")
        recs = [run_cell(args.arch, args.shape, args.multi_pod, args.out)]
    print(table(recs))


if __name__ == "__main__":
    main()
