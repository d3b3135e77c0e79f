"""The encdec family's sharded train step against the reference's GSPMD
step, on the CPU.

whisper-small's smoke config (2 encoder and 2 decoder layers, 4 heads,
24 f32 frames) in one spawned gloo world of 8 ranks as (pod 2, data 2,
model 2); helpers in ``tests/_torch_mesh_train.py``. Every encoder layer
runs through ``_train_layer`` with its FSDP gathers, in f32 against the
f32 frames; the encoder's output is replicated over model and enters
each decoder layer's cross attention as its k/v input, so the cross
``wk``/``wv`` gradients are summed over model. Checked, each with its
tolerance:

* one step under ``"2d"`` at f32: loss and grad norm within 1e-5
  relative, every rank's param, ``mu`` and ``nu`` shard (the encoder's
  and ``cross`` included) within 1e-4 of the leaf's max |.| against the
  reference's block at the rank's coordinate (a parameter also within
  what that lets through Adam's first step,
  ``_torch_mesh_train.adam_slack``); at bf16 within 2e-2 plus twice the
  leaf's one-device gap to the reference, the reference compiled with
  ``SOURCE_ROUNDING``;
* Megatron-SP under ``"2d"`` at f32 and bf16 with both sequences split
  over model, and at f32 on (data 2, model 4) with 22 frames, which stay
  whole, against 16 tokens, which split, each against the reference's
  SP step within the tolerances above (at bf16 one element of the last
  ``ln_cross`` bias, whose gradient is within the ``mu`` check's
  tolerance of zero, may take its first Adam step the other way,
  ROADMAP P30);
* the frames: ``DataPipeline(shardings=)`` gives each rank its rows of
  ``frames`` (and tokens, labels), equal to the reference pipeline's
  addressable block bit for bit, and ``forward_train`` on the mesh
  consumes those rows as they are: each rank's logits are its rows' and
  vocab columns' block of the one-device forward on the global batch,
  within 1e-4 at f32 (cut a second time, the frames would no longer
  match the tokens' rows).
"""
from __future__ import annotations

import numpy as np
import pytest

from _torch_mesh_train import SHAPE, cfg_of, jmesh, mesh_axes, \
    rank_step, step_matches  # noqa: F401  (rank_step: run by the ranks)
from _torch_threads import one_thread  # noqa: F401
from _torch_world import world_fixture

ARCH = "whisper-small"
BATCH = (8, 16)                  # global batch, decoder tokens
MIXED = (2, 4)                   # (data, model) of the mixed SP split
MIXED_FRAMES = 22                # frames the model axis (4) does not divide
# bf16 with Megatron-SP: the one element of the last ln_cross bias whose
# gradient, 0.5% of the leaf's max, changes sign below the bf16 noise of
# eight ranks' partial sums, so its first Adam step turns (ROADMAP P30)
SP_TURNED = {"blocks.1.ln_cross.bias": 1}
LEAVES = ("encoder.blocks.0.attn.wq", "encoder.blocks.1.mlp.w_in",
          "encoder.final_norm", "encoder.segments.0.ln1", "cross.wq",
          "cross.wk", "cross.wv", "cross.wo", "ln_cross")

world = world_fixture(__name__, SHAPE)


def rank_frames(axes, step):
    """This rank's rows of step ``step`` from a pipeline with shardings,
    and ``forward_train``'s logits on them at f32 from weights drawn
    from a seed (every layout draws the same values), beside the
    one-device forward's block of the global batch's logits."""
    import torch

    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.data import for_model
    from repro_torch.models.model import forward_train
    from repro_torch.models.params import init_params
    from repro_torch.train import batch_shardings
    from repro_torch.train.train_loop import train_ctx
    cfg = cfg_of(ARCH, "float32")
    rcfg = RunConfig(attn_q_block=8, attn_kv_block=8)
    shd = train_ctx(axes, rcfg)
    shape = ShapeConfig("t", BATCH[1], BATCH[0], "train")
    bsh = batch_shardings(cfg, axes, rcfg=rcfg, global_batch=BATCH[0])
    rows = for_model(cfg, shape, axes, bsh, seed=3,
                     device="cpu").batch_at(step)
    whole = for_model(cfg, shape, seed=3, device="cpu").batch_at(step)
    with torch.no_grad():
        logits, _ = forward_train(init_params(cfg, device="cpu", seed=4,
                                              shd=shd), rows, cfg, rcfg)
        full, _ = forward_train(init_params(cfg, device="cpu", seed=4),
                                whole, cfg, rcfg)
    n = logits.shape[-1]
    cols = slice(shd.index("model") * n, (shd.index("model") + 1) * n)
    want = full[bsh["tokens"].block(tuple(whole["tokens"].shape))][..., cols]
    return {k: v.clone() for k, v in rows.items()}, logits, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_step_matches_reference(world, dtype):
    """One step on (pod 2, data 2, model 2) under ``"2d"``: the encoder's
    and the decoder's heads and MLP columns over model, FSDP rows over
    data, the batch (frames too) over pod x data."""
    step_matches(world, ARCH, dtype, "2d", batch=BATCH, must=LEAVES)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sp_step_matches_reference(world, dtype):
    """One step on (pod 2, data 2, model 2) under ``"2d"`` with
    Megatron-SP, both sequences split over model: the encoder's 12 of 24
    frames a rank after the positions are added, the decoder's 8 of 16
    tokens with their own positions; the encoder's output gathered once
    for the cross attention (not entered again), its leaves summed by
    the encoder's split."""
    step_matches(world, ARCH, dtype, "2d", batch=BATCH, must=LEAVES,
                 sp=True, turned=SP_TURNED if dtype == "bfloat16" else None)


def test_sp_mixed_split_matches_reference(world):
    """(data 2, model 4) with Megatron-SP and 22 frames, which 4 does not
    divide, against 16 tokens, which it does: the encoder stays whole on
    every rank and its output enters the cross attention, while the
    decoder's rows split 4 ways (as whisper's 1,500 frames and 448
    tokens at a model axis of 8 or 16); the encoder's leaves follow its
    own split, the decoder's SP's. Every shard matches the reference's
    SP step at f32."""
    from repro_torch.distribution.sharding import ShardingCtx
    shd = ShardingCtx(dict(zip(("data", "model"), MIXED)),
                      seq_parallel=True, train=True)
    assert shd.sp_of(MIXED_FRAMES) is None
    assert shd.sp_of(BATCH[1]) == "model"
    step_matches(world, ARCH, "float32", "2d",
                 (("encoder_seq", MIXED_FRAMES),), MIXED, batch=BATCH,
                 must=LEAVES, sp=True)


def test_pipeline_frames_are_the_rows_forward_train_consumes(world):
    """Step 0 and 5 at a global batch of 8 over pod x data: each rank's
    frames, tokens and labels equal the reference pipeline's shard on
    the device at its coordinate, bit for bit; ``forward_train`` on the
    mesh reads the frames as the rank's rows (2 of 8), and its logits
    are the one-device forward's block of the global batch's."""
    import torch

    from repro.configs import RunConfig as JRunConfig
    from repro.configs import ShapeConfig as JShape
    from repro.configs import get_smoke_config as j_smoke
    from repro.data import for_model as j_for_model
    from repro.train.train_loop import batch_shardings as j_batch_sh
    from test_torch_train_mesh import _addressable
    jcfg = j_smoke(ARCH)
    mesh = jmesh(SHAPE)
    jfeed = j_for_model(jcfg, JShape("t", BATCH[1], BATCH[0], "train"),
                        mesh, j_batch_sh(jcfg, mesh, rcfg=JRunConfig(),
                                         global_batch=BATCH[0]), seed=3)
    for step in (0, 5):
        want = jfeed.batch_at(step)
        assert "frames" in want
        ranks = world.run(rank_frames, step)
        for rank, (got, logits, full) in enumerate(ranks):
            assert sorted(got) == sorted(want)
            for k, arr in want.items():
                np.testing.assert_array_equal(
                    got[k].numpy(), _addressable(arr, SHAPE, rank).astype(
                        got[k].numpy().dtype), err_msg=(step, rank, k))
            assert got["frames"].shape[0] == BATCH[0] // 4
            assert logits.shape[:2] == (BATCH[0] // 4, BATCH[1])
            torch.testing.assert_close(logits, full, rtol=1e-4, atol=1e-4)
