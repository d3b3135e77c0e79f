"""The encdec family (whisper-small) on the model axis against the reference.

The smoke whisper on spawned gloo worlds of (data 2, model 2), (data 1,
model 2) and (data 1, model 8) (``tests/_torch_world.py``), one rank a
device of the reference's ``make_host_mesh``; helpers in
``tests/_torch_tp_families.py``. The encoder's heads and MLP split over
``model`` (a psum a layer each), its frames over ``data`` with the
batch; the decoder's cross attention reads the replicated encoder k/v
(``ck``/``cv``) through each rank's query heads' kv heads; on (1, 8) the
4 heads pad to 8. whisper is served through ``forward_prefill(...,
frames=)`` and ``forward_decode`` (ROADMAP R9). Checks, each with its
tolerance:

* prefill + 8 greedy decode steps at f32 (f32 frames and caches): logits
  within 1e-4, identical tokens;
* bf16 (bf16 frames and caches), teacher-forced with the tokens of the
  reference compiled to round where its source casts: within 2e-2 of max
  |logit|;
* every rank's parameter shards (the encoder's too) equal, bit for bit,
  the reference's addressable shards on the serving layout, and its cache
  blocks (self k/v, cross ``ck``/``cv``) the reference's shards within
  1e-4;
* at a world of one (in-process gloo): the sharded prefill and decode give
  the unsharded tokens, with ``chip_smoke.model_psums`` psums a forward
  (the encoder's layers at the prefill).
"""
import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
from _torch_tp_families import (
    B, NAMES, SOURCE_ROUNDING, STEPS, cfg_of, check_cache_shards,
    check_param_shards, pair, rank_forward, ref_forward, rel,
)
from _torch_world import World

ARCH = "whisper-small"
SHAPES = ((2, 2), (1, 2), (1, 8))
PROMPT, MAX_SEQ = 12, 32


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def world(request):
    w = World(__name__, request.param, NAMES)
    w.mesh_shape = request.param
    yield w
    procs = list(w.procs)
    w.close()
    assert not any(p.is_alive() for p in procs)


def _inputs():
    cfg = cfg_of(ARCH, "float32")
    prompt = np.random.default_rng(7).integers(1, 256, (B, PROMPT)).astype(
        np.int32)
    frames = np.random.default_rng(8).standard_normal(
        (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return prompt, frames


_RUNS = {}


def _f32_run(world):
    shape = world.mesh_shape
    if shape not in _RUNS:
        jcfg, tree, ttree = pair(shape, ARCH, "float32")
        prompt, frames = _inputs()
        ref = ref_forward(shape, jcfg, tree, prompt, MAX_SEQ, frames=frames,
                          cache_dtype="float32")
        ranks = world.run(rank_forward, ARCH, "float32", (), ttree, prompt,
                          MAX_SEQ, None, frames, "float32")
        _RUNS[shape] = jcfg, tree, ref, ranks
    return _RUNS[shape]


def test_forward_matches_reference_f32(world):
    _jcfg, _tree, (j_logits, j_toks, _c, _r), ranks = _f32_run(world)
    for logits, toks, *_ in ranks:
        np.testing.assert_array_equal(toks, j_toks)
        for i, (a, b) in enumerate(zip(logits, j_logits)):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4,
                                       err_msg=f"step {i}")


def test_forward_matches_reference_bf16(world):
    shape = world.mesh_shape
    jcfg, tree, ttree = pair(shape, ARCH, "bfloat16")
    prompt, frames = _inputs()
    j_logits, j_toks, _c, _r = ref_forward(
        shape, jcfg, tree, prompt, MAX_SEQ, frames=frames,
        cache_dtype="bfloat16", compiler_options=SOURCE_ROUNDING)
    for logits, *_ in world.run(rank_forward, ARCH, "bfloat16", (), ttree,
                                prompt, MAX_SEQ, j_toks, frames,
                                "bfloat16"):
        gaps = [rel(a, b) for a, b in zip(logits, j_logits)]
        assert max(gaps) <= 2e-2, gaps


def test_shards_match_reference(world):
    shape = world.mesh_shape
    jcfg, tree, (_l, _t, j_caches, _r), ranks = _f32_run(world)
    split = check_param_shards(shape, ARCH, "float32", (), tree,
                               [r[3] for r in ranks])
    assert split > 0
    # the encoder's heads split over model (4 heads, padded to 8 on (1, 8))
    assert ranks[0][3]["encoder.blocks.0.attn.wq"].shape[1] * shape[1] \
        == max(4, shape[1])
    n = check_cache_shards(shape, jcfg, j_caches, [r[2] for r in ranks], B,
                           MAX_SEQ, atol=1e-4)
    assert n == len(ranks) * sum(len(seg) for seg in j_caches)


def test_sharded_forward_on_a_world_of_one_equals_the_unsharded_one():
    """``chip_smoke.py``'s world-of-one sharded whisper, on the CPU: the
    smoke model's prefill (with frames) and 8 greedy decode steps through
    ``ShardingCtx(make_host_mesh(1, 1))`` give the unsharded tokens on the
    same seeded weights, and the CoreEngine's ledger holds
    ``chip_smoke.model_psums`` psums over ``model`` for the prefill (the
    encoder's layers too) and for each step."""
    import torch.distributed as dist

    import chip_smoke
    from repro_torch.configs import RunConfig
    from repro_torch.core import make_engine, use_engine
    from repro_torch.distribution.sharding import ShardingCtx
    from repro_torch.launch import make_host_mesh
    from repro_torch.models.model import forward_decode, forward_prefill, \
        gather_rows, greedy
    from repro_torch.models.params import init_params
    cfg = cfg_of(ARCH, "bfloat16")
    prompt, frames = _inputs()

    def run(shd):
        model = init_params(cfg, device="cpu", seed=4, shd=shd)
        logits, caches = forward_prefill(
            model, torch.from_numpy(prompt), RunConfig(), max_seq=MAX_SEQ,
            frames=torch.from_numpy(frames).to(torch.bfloat16))
        toks = []
        for i in range(STEPS):
            tok = gather_rows(shd, greedy(model, logits), B).to(torch.int32)
            toks.append(tok)
            logits, caches = forward_decode(
                model, caches, tok[:, None],
                torch.full((B,), PROMPT + i, dtype=torch.int32),
                RunConfig(), max_seq=MAX_SEQ)
        return torch.stack(toks)

    want = run(None)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        shd = ShardingCtx(make_host_mesh(1, 1, device="cpu"))
        core = make_engine(shd.axes, "xla")
        with use_engine(core):
            got = run(shd)
        psums = sum(ops for _t, verb, axes, ops, _b in core.ledger_table()
                    if verb == "psum" and axes == ("model",))
    finally:
        dist.destroy_process_group()
    assert torch.equal(got, want)
    assert psums == chip_smoke.model_psums(cfg, prefill=True) \
        + STEPS * chip_smoke.model_psums(cfg, prefill=False)
