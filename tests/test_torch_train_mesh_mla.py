"""The moe family's sharded train step with MLA against the reference's
GSPMD step, on the CPU: deepseek-v2-236b.

deepseek-v2-236b's smoke config (a dense prefix layer and 2 moe layers of
4 experts of 64 top-2 with 2 shared experts; MLA with 4 heads, q/k head
dim 24 = 16 + 8 rope, v 16, a latent of 32) in one spawned gloo world of
8 ranks as (pod 2, data 2, model 2), with (data 1, model 8) made over the
same ranks; helpers in ``tests/_torch_mesh_train.py``, arctic-480b's
steps and the router's gradient in ``tests/test_torch_train_mesh_moe.py``.
MLA's prefill runs under grad on the rank's (padded) heads through
``FlashAttentionFn`` (``_mla_prefill``); ``x``, ``w_dkv`` and
``kv_norm``, which every rank holds whole but reads for its own heads,
enter the heads' split (under Megatron-SP they are summed over the model
axis after the backward instead, with the norms). Checked, each with its
tolerance:

* one step under ``"2d"``, ``"fsdp"`` and ``"tp"`` at f32, and under
  ``"2d"`` with Megatron-SP activations: loss, grad norm and the four
  ``moe_*`` metrics within 1e-5 relative, routing identical to the
  reference's, every param, ``mu`` and ``nu`` shard within 1e-4 of the
  leaf's max |.| at the rank's coordinate (and ``adam_slack``);
* (data 1, model 8) with Megatron-SP: the 4 heads pad to 8, the 4
  experts are replicated (4 % 8), each rank holds 2 of 16 positions
  between blocks, so the experts' and the router's gradients are each
  rank's rows' part, summed over model after the backward, and the aux
  losses' is divided over the model ranks; at f32 as above;
* at bf16 under ``"2d"``: flipped routing choices reported and held to
  no more than measured (``BF16_FLIPS``), the step as in
  ``test_torch_train_mesh_moe.py`` (ROADMAP P21, P27).
"""
from __future__ import annotations

import pytest

from _torch_mesh_train import SHAPE, rank_step, \
    step_matches  # noqa: F401  (rank_step: run by the ranks)
from _torch_threads import one_thread  # noqa: F401
from _torch_world import world_fixture

ARCH = "deepseek-v2-236b"
LEAVES = ("attn.w_dkv", "attn.kv_norm", "attn.w_uk", "attn.w_uv",
          "attn.wq", "attn.wo", "moe.router", "moe.w_in",
          "moe.shared.w_in", "mlp.w_in", "ln2")
BATCH = (8, 16)
PADDED = (1, 8)
# measured as test_torch_train_mesh_moe.py's BF16_FLIPS (of 2,048)
BF16_FLIPS = 4

world = world_fixture(__name__, SHAPE)


@pytest.mark.parametrize("variant,sp,shape", [
    ("2d", False, SHAPE), ("fsdp", False, SHAPE), ("tp", False, SHAPE),
    ("2d", True, SHAPE), ("2d", True, PADDED)],
    ids=["2d", "fsdp", "tp", "2d-sp", "model8-sp"])
def test_sharded_step_matches_reference(world, variant, sp, shape):
    """One f32 step under ``variant``: MLA's heads over model ("2d",
    "tp"), FSDP rows over data (and model under "fsdp"), the experts over
    model or replicated, the dispatch groups spanning two ranks' rows on
    (2, 2, 2)."""
    step_matches(world, ARCH, "float32", variant, shape=shape,
                 batch=BATCH, must=LEAVES, sp=sp)


def test_sharded_step_bf16(world):
    """One bf16 step under ``"2d"`` (ROADMAP P21, P27)."""
    _, flips = step_matches(world, ARCH, "bfloat16", "2d", batch=BATCH,
                            must=LEAVES)
    print(f"{ARCH} bf16 sharded step: {flips} routing choices flipped")
    assert flips <= BF16_FLIPS, flips


class _NoTimer:
    """``chip_smoke.Timer`` on the CPU: each function runs once, untimed."""

    def __init__(self, *a, **k):
        pass

    def ms(self, fn, reps=None, warmup=None):
        fn()
        return 0.0


def test_sharded_train_moe_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s moe train phase on the CPU at a gloo world of
    one, on deepseek's smoke config cut to its dense prefix layer and one
    moe layer over 32 tokens, 2 micro-batches of one row and one step a
    path (the card's timer, profiler and SDPA backend stubbed, the plain
    flash wrapped to count its launches): the one-device
    Runner's and the sharded (Megatron-SP) Runner's flash launches, every
    leaf moved on both, the sharded micro-batch against the unsharded one,
    the ledger's collectives a step equal to ``train_collectives(...,
    sp=True)``, and each TP train rank's flash at MLA's and arctic's heads
    (shrunk; MLA's all heads at tp 1 too, the path's own shape) against
    the plain VJP."""
    import dataclasses
    import importlib.util
    import pathlib

    import torch
    import torch.distributed as dist
    from torch.nn.attention import SDPBackend

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(cs, "Timer", _NoTimer)
    monkeypatch.setattr(cs, "_profile", lambda *a, **k: {})
    monkeypatch.setattr(cs, "sdpa_backend", lambda *a, **k: SDPBackend.MATH)
    monkeypatch.setattr(cs, "SHARDED_MOE_SEQ", 32)
    monkeypatch.setattr(cs, "TRAIN_BATCH", 2)
    monkeypatch.setattr(cs, "TRAIN_ACCUM", 2)
    monkeypatch.setattr(cs, "SHARDED_TRAIN_STEPS", 1)
    monkeypatch.setattr(cs, "TRAIN_RANK_S", 64)
    monkeypatch.setattr(cs, "TRAIN_RANK_MLA", (16, 32, 16))
    real = attention.flash_attention

    def counted(*args, **kw):
        fa.flash_attention.launches += 1
        return real(*args, **kw)

    monkeypatch.setattr(attention, "flash_attention", counted)
    monkeypatch.setattr(fa, "flash_attention", counted)
    fa.flash_attention.launches = 0
    rows = []
    monkeypatch.setattr(cs, "emit", rows.append)
    cfg = dataclasses.replace(get_smoke_config(ARCH), num_layers=2)
    launches, checks = cs.phase_sharded_train_moe(
        torch, torch.device("cpu"), "cpu", cfg=cfg)
    assert not dist.is_initialized()
    per_path = 2 * cs.TRAIN_ACCUM * 2 * cs.SHARDED_TRAIN_STEPS
    assert launches == 2 * per_path
    (row,) = [r for r in rows if r.get("phase") == "sharded_train_moe"]
    assert row["flash_launches_unsharded"] == \
        row["flash_launches_sharded"] == per_path
    assert row["sp_rows_axis"] == "model"
    assert row["compared_grads"] == 4
    assert row["compared_worst_gap"] <= cs.TRAIN_TOL
    assert not row["params_not_moved_unsharded"]
    assert not row["params_not_moved_sharded"]
    assert row["ledger_ops_a_step"] == row["ledger_ops_want"] == \
        cs.train_collectives(cfg, cs.TRAIN_ACCUM, sp=True, factored=True)
    assert sorted(checks) == sorted(
        [("deepseek mla", 1)] + [(case, tp) for case in ("arctic",
                                                         "deepseek mla")
                                 for tp in cs.CP_TP])
    assert all(c["launches"] == 1 for c in checks.values())
    mla = [checks[("deepseek mla", tp)]["row"] for tp in (1,) + cs.CP_TP]
    assert [r["hq"] for r in mla] == [16, 8, 4, 2, 1]
    assert all(r["dv"] == 16 and r["d"] == 32 for r in mla)
