"""The model: layer schedule, parameter/cache schemas, train, prefill, decode.

The counterpart of ``repro/models/model.py``. A model is a list of
segments, each ``count`` layers of one block kind; where the reference
stacks a segment's parameters over its layers and scans them, the port
keeps one ``nn.Module`` per layer and loops. Caches keep the reference's
layout: a tuple with one dict per segment, each leaf stacked over the
segment's layers in its own dtype: attention k/v ``(L, B, n_slots, KV,
hd)`` in the cache dtype, an SSM layer's ``state`` ``(L, B, H, P, N)`` in
f32 and its ``conv_*`` tails ``(L, B, W-1, C)`` in the cache dtype, a
``dec`` layer's encoder k/v ``ck``/``cv`` ``(L, B, encoder_seq, KV, hd)``.
``n_slots`` is ``max_seq``, or ``min(max_seq, window)`` for a windowed
segment, whose cache is then a ring (``attention.is_ring``); an MLA model
caches a latent ``lat`` ``(L, B, max_seq, kv_lora_rank + rope)`` in the
cache dtype in place of k/v. The port has every family of the reference:
``dense``, ``vlm``, ``moe``, ``ssm``, ``hybrid`` and ``encdec``. A ``moe``
model (arctic, deepseek) is one segment of ``moe`` layers behind
deepseek's ``dense_prefix`` layer; its layers' aux (the load-balance and
z losses, the busiest expert's share, the drop share) is averaged over a
segment's layers and summed over segments, as the reference does, and
``forward_train`` returns it. A ``vlm`` model (chameleon) is scheduled as
plain ``dense``, as in the reference: its frontend is a stub, token ids in, and
its q/k norms live in the attention block. A ``hybrid`` model (hymba) runs
its global-attention layers as one-layer segments and each run of
windowed layers between them as one segment. An ``encdec`` model
(whisper) is one segment of ``dec`` layers behind an ``encoder`` of
``enc`` layers over stub frame embeddings (its conv stem is the
reference's stub too); both add sinusoid positions to their inputs, and
``input_specs`` gives a cell's inputs as meta tensors. ``forward_train``
takes every family; parameters are made frozen, and a trainer turns
``requires_grad`` on for its own model (``train.train_loop``).

**On a mesh.** A ``Model`` made with a ``ShardingCtx`` (every family)
holds each rank's shard of its weights (``schema.ParamTree``; an encoder's
too), with the query heads padded to the model axis (``model_schema(cfg,
mesh)``). ``forward_prefill`` and ``forward_decode`` then run the
reference's function on the same mesh with the work split explicitly: the
batch rows over ``data`` (each data rank takes its rows of the global
``tokens``/``pos``, and an encoder's ``frames``), attention heads, the
MLP's and the SSM path's ``ffn``, the SSM heads, the experts and the
vocabulary over ``model``, and the k/v or latent cache's sequence (a
ring's slots) over ``model`` (``kv_seq``; ``init_cache(..., shd=)`` and
the prefill give each rank its chunk). A MoE layer routes and truncates
the reference's dispatch groups (``moe.dispatch_groups``). Their logits are the rank's vocab
shard of its rows; ``greedy`` takes them to global token ids and
``gather_logits`` to the full logits. ``forward_train`` trains every
family on a mesh, a model made with a training ``ShardingCtx``
(``train=True``): each rank holds its block of the run's rules (FSDP and
TP), and each layer gathers its FSDP shards as it runs (an encoder's
layers gather theirs in ``encode``, its frames the rank's rows of the
batch; a moe layer's aux is over the global batch). Megatron-SP
activations (``seq_parallel_activations``) train every family: the
residual stream holds the rank's rows of the sequence between blocks
(an encoder's of its frames, where the model axis divides them).
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.device import dtype_of, resolve_device
from repro_torch.distribution.sharding import local_shape
from repro_torch.models.attention import is_ring, ring_slots
from repro_torch.models.blocks import apply_block, block_cache_schema, \
    block_schema
from repro_torch.models.layers import apply_norm, embed_schema, \
    embed_tokens, lm_logits, norm_schema, sinusoid_positions
from repro_torch.models.moe import Groups, dispatch_groups
from repro_torch.models.schema import ParamTree

FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec")
REMAT = ("full", "dots", "none")
# the ops remat="dots" keeps: the products with no batch dimension
DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
# cache leaves laid out along the sequence (padded to max_seq, or turned
# into a ring, at prefill); the others (SSM state, conv tails) are
# per-sequence and pass through
SEQ_LEAVES = ("k", "v", "lat")


@dataclass(frozen=True)
class Segment:
    kind: str
    count: int
    window: int = 0       # 0 = full attention


def check_family(cfg: ModelConfig) -> ModelConfig:
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: family must be one of {FAMILIES}, "
                         f"got {cfg.family!r}")
    return cfg


def build_schedule(cfg: ModelConfig) -> Tuple[Segment, ...]:
    check_family(cfg)
    if cfg.family == "ssm":
        return (Segment("ssm", cfg.num_layers),)
    if cfg.family == "encdec":
        return (Segment("dec", cfg.num_layers),)
    if cfg.family == "hybrid":
        segs: List[Segment] = []
        i = 0
        while i < cfg.num_layers:
            if i in cfg.global_attn_layers:
                segs.append(Segment("hybrid", 1))
                i += 1
                continue
            j = i
            while j < cfg.num_layers and j not in cfg.global_attn_layers:
                j += 1
            segs.append(Segment("hybrid", j - i, window=cfg.attn_window))
            i = j
        return tuple(segs)
    if cfg.moe is not None:
        segs = [Segment("dense_prefix", cfg.dense_layer_prefix)] \
            if cfg.dense_layer_prefix else []
        return tuple(segs + [Segment(
            "moe", cfg.num_layers - cfg.dense_layer_prefix)])
    return (Segment("dense", cfg.num_layers),)


def model_schema(cfg: ModelConfig, mesh=None) -> Dict:
    """Per-layer (unstacked) parameter schema: ``layers`` holds one block
    schema per layer, in schedule order; an encoder model's ``encoder``
    holds its ``layers`` (``encoder_layers`` ``enc`` blocks, the
    reference's ``encoder.segments[0]``) and its ``final_norm``. ``mesh``
    pads the query heads to its model axis, as the reference does; with
    none the shapes are the one-device ones."""
    s = {
        "embed": embed_schema(cfg.vocab_size, cfg.d_model, cfg.param_dtype,
                              cfg.tie_embeddings),
        "final_norm": norm_schema(cfg.d_model, cfg.norm, cfg.param_dtype),
        "layers": [block_schema(cfg, seg.kind, mesh)
                   for seg in build_schedule(cfg)
                   for _ in range(seg.count)],
    }
    if cfg.encoder_layers:
        s["encoder"] = {
            "layers": [block_schema(cfg, "enc", mesh)] * cfg.encoder_layers,
            "final_norm": norm_schema(cfg.d_model, cfg.norm,
                                      cfg.param_dtype)}
    return s


class Encoder(nn.Module):
    """An encoder's parameters: one ``ParamTree`` per ``enc`` layer in
    ``blocks`` and its ``final_norm``, each leaf this rank's shard on a
    mesh (``shd``)."""

    def __init__(self, schema: Dict, device: torch.device, shd=None):
        super().__init__()
        self.blocks = nn.ModuleList(
            [ParamTree(s, device, shd) for s in schema["layers"]])
        self.final_norm = ParamTree(schema["final_norm"], device, shd)


class Model(nn.Module):
    """A model's parameters: ``embed``, an encoder model's ``encoder``,
    ``final_norm`` and one ``ParamTree`` per layer in ``blocks``. Created
    uninitialized on ``device`` (``cuda`` unless ``"cpu"`` is passed);
    ``models.params`` fills it. With a ``ShardingCtx`` on a mesh
    (``shd``) each leaf holds this rank's shard of the padded schema."""

    def __init__(self, cfg: ModelConfig, *, device=None, shd=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = check_family(cfg)
        self.shd = shd if shd is not None and shd.mesh is not None \
            else None
        schema = model_schema(cfg, None if self.shd is None
                              else self.shd.mesh)
        self.embed = ParamTree(schema["embed"], dev, self.shd)
        if cfg.encoder_layers:
            self.encoder = Encoder(schema["encoder"], dev, self.shd)
        self.final_norm = ParamTree(schema["final_norm"], dev, self.shd)
        self.blocks = nn.ModuleList(
            [ParamTree(s, dev, self.shd) for s in schema["layers"]])

    @property
    def device(self) -> torch.device:
        return self.embed["tokens"].device


def cache_schema(cfg: ModelConfig, batch: int, max_seq: int,
                 dtype: str = "bfloat16") -> Tuple:
    """One dict of ``ParamDesc`` per segment; each leaf stacked over the
    segment's layers (logical dim "layers") and in its own dtype (``dtype``
    for k/v and conv tails, f32 for an SSM state)."""
    return tuple(
        {k: dataclasses.replace(d, shape=(seg.count,) + d.shape,
                                dims=("layers",) + d.dims)
         for k, d in block_cache_schema(cfg, seg.kind, batch, max_seq,
                                        seg.window, dtype).items()}
        for seg in build_schedule(cfg))


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               dtype: str = "bfloat16", device=None, shd=None) -> Tuple:
    """A zeroed decode cache for ``batch`` slots of ``max_seq`` tokens; with
    a ``ShardingCtx`` on a mesh, this rank's block of it (its rows over
    ``data``, its sequence chunk over ``model``)."""
    dev = resolve_device(device)
    on_mesh = shd is not None and shd.mesh is not None

    def shape(d):
        if not on_mesh:
            return d.shape
        return local_shape(d.shape, shd.spec(d.shape, d.dims), shd.mesh)

    return tuple(
        {k: torch.zeros(shape(d), dtype=dtype_of(d.dtype), device=dev)
         for k, d in seg.items()}
        for seg in cache_schema(cfg, batch, max_seq, dtype))


def cache_nbytes(caches: Tuple) -> int:
    return sum(t.numel() * t.element_size()
               for seg in caches for t in seg.values())


# ---------------------------------------------------------------------------
# Forwards
# ---------------------------------------------------------------------------


def check_prompt(cfg: ModelConfig, s: int, max_seq: int) -> None:
    """Raise ValueError for a prompt of ``s`` tokens that a prefill cannot
    serve: longer than the cache, or, with SSM layers, shorter than
    ``conv_width - 1``, the conv tails decode streams from (the reference
    fails on such a prompt at its slot install: ROADMAP R5)."""
    if s > max_seq:
        raise ValueError(f"prompt of {s} tokens exceeds max_seq {max_seq}")
    if cfg.ssm is not None and s < cfg.ssm.conv_width - 1:
        raise ValueError(
            f"{cfg.name}: prompt of {s} tokens is shorter than conv_width - "
            f"1 = {cfg.ssm.conv_width - 1}, the conv tails an SSM layer "
            f"decodes from")


def keeps_ring(seg: Segment, max_seq: int) -> bool:
    """A windowed segment's prefill turns its k/v into a ring of
    ``min(window, S)`` slots when the window is below ``max_seq`` (the
    reference's test); otherwise it zero-pads them to ``max_seq``."""
    return bool(seg.window) and seg.window < max_seq


def check_slot_prompt(cfg: ModelConfig, s: int, max_seq: int) -> None:
    """``check_prompt``, and the limit of an engine's slot install: where
    a windowed segment keeps a ring (``window < max_seq``), a slot holds
    ``window`` rows, and a prefill of ``s < window`` tokens gives a ring of
    ``s`` rows (valid at model level, as in the reference, whose engine
    fails to install it: ROADMAP R7)."""
    check_prompt(cfg, s, max_seq)
    if any(keeps_ring(seg, max_seq) for seg in build_schedule(cfg)) \
            and s < cfg.attn_window:
        raise ValueError(
            f"{cfg.name}: prompt of {s} tokens is shorter than attn_window "
            f"= {cfg.attn_window}, the ring a slot of max_seq {max_seq} "
            f"holds")


def to_ring(kv: torch.Tensor, window: int) -> torch.Tensor:
    """A prefill's k or v ``(B, S, ...)`` in the ring layout ``(B, w, ...)``,
    ``w = min(window, S)``: the last ``w`` positions, rolled so that
    position ``t`` sits in slot ``t % w`` (the reference's
    ``_to_ring_stacked``)."""
    s = kv.shape[1]
    w = min(window, s)
    tail = kv[:, s - w:]
    return torch.roll(tail, s % w, dims=1) if s % w else tail


def _finalize_prefill_cache(layer_caches: List[Dict], seg: Segment, s: int,
                            max_seq: int, shd=None) -> Dict:
    """Stack one segment's per-layer prefill caches over its layers: k/v to
    (L, B, max_seq, KV, hd) and an MLA latent to (L, B, max_seq, r +
    rope), zero-padded past the prompt's ``s`` positions (the decode
    layout), or k/v to a ring where the segment ``keeps_ring``
    (``to_ring``); per-sequence leaves (SSM state, conv tails) as they
    are. On a mesh (``shd``) a rank keeps the chunk of ``max_seq``
    positions its ``kv_seq`` block covers."""
    ring = keeps_ring(seg, max_seq)
    lo, n = 0, max_seq
    if shd is not None:
        block = shd.block(shd.split("kv_seq", max_seq), max_seq)
        lo, n = block.start, block.stop - block.start
    out = {}
    for key in layer_caches[0]:
        if key not in SEQ_LEAVES:
            out[key] = torch.stack([c[key] for c in layer_caches])
        elif ring:
            rings = [to_ring(c[key], seg.window) for c in layer_caches]
            if shd is not None:
                w = rings[0].shape[1]
                rings = [r[:, shd.block(shd.split("kv_seq", w), w)]
                         for r in rings]
            out[key] = torch.stack(rings)
        else:
            first = layer_caches[0][key]
            full = first.new_zeros((len(layer_caches), first.shape[0],
                                    n) + tuple(first.shape[2:]))
            held = max(min(s - lo, n), 0)
            for i, c in enumerate(layer_caches):
                full[i, :, :held] = c[key][:, lo:lo + held]
            out[key] = full
    return out


def _ring_len(shd, seg: Segment, n_slots: int,
              max_seq: Optional[int]) -> int:
    """The slots of a segment's ring, or 0 for a linear cache, from a
    rank's ``n_slots`` cache rows. On a mesh a ring holds the window
    (``keeps_ring``; a prompt shorter than the window is refused there),
    split over ``model`` where the model axis divides it."""
    if shd is None:
        return n_slots if is_ring(seg.window, n_slots) else 0
    if max_seq is None or not keeps_ring(seg, max_seq):
        return 0
    w = seg.window
    want = shd.block(shd.split("kv_seq", w), w)
    if n_slots != want.stop - want.start:
        raise ValueError(f"a ring of {n_slots} rows a rank; on this mesh a "
                         f"ring of the window {w} holds "
                         f"{want.stop - want.start}")
    return w


def _train_layer(block, x, cfg, rcfg, seg: Segment, positions, enc_out,
                 shd=None, groups: Groups = Groups()):
    """One layer in training (or an encoder layer): (x', aux). With a
    training ``ShardingCtx`` the layer reads its weights gathered over
    their FSDP axes (``shd.gathered``): inside a rematerialized layer the
    gathered copies live while the layer runs, and its recompute gathers
    them again. ``groups``: a moe layer's dispatch groups."""
    if shd is not None and shd.train:
        block = shd.gathered(block)
    x, _, aux = apply_block(block, x, cfg, rcfg, seg.kind,
                            positions=positions, window=seg.window,
                            enc_out=enc_out, mode="train", shd=shd,
                            groups=groups)
    return x, aux


def _dots_saveable(ctx, op, *args, **kwargs):
    """The reference's ``dots_with_no_batch_dims_saveable`` as a selective
    checkpoint policy: a matrix product with no batch dimension (``mm``,
    ``addmm``: what ``F.linear`` and a flattened ``x @ W`` become, the
    weight products) is kept, everything else recomputed, ``bmm`` (a
    product with a batch dimension: attention's, and the MoE experts' whose
    einsum in the reference carries the expert dimension) included. A
    kernel launched through ctypes (``FlashAttentionFn``, ``SsdScanFn``) is
    not an op the policy sees and runs again, as under "full"."""
    if op in DOTS_SAVED:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, rcfg: RunConfig):
    """``rcfg.remat`` on one layer: "full" keeps only the layer's input and
    recomputes the layer in the backward (non-reentrant
    ``torch.utils.checkpoint``, the reference's ``nothing_saveable``);
    "dots" also keeps the outputs of the products with no batch dimension
    (``_dots_saveable``, selective checkpointing: the reference's
    ``dots_with_no_batch_dims_saveable``)."""
    if rcfg.remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {rcfg.remat!r}")
    if rcfg.remat == "none":
        return fn
    if rcfg.remat == "dots":
        context = functools.partial(create_selective_checkpoint_contexts,
                                    _dots_saveable)
        return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                        context_fn=context)
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def encode(model: Model, frames: torch.Tensor, rcfg: RunConfig, shd=None):
    """The encoder over stub frame embeddings ``frames`` (B, encoder_seq,
    d): sinusoid positions added in the frames' dtype, the ``enc`` layers
    (each under ``rcfg.remat`` when autograd records), the encoder's final
    norm. As in the reference the encoder computes in the frames' dtype:
    f32 frames (the data pipeline's) run it in f32 against bf16 weights,
    bf16 ones (``input_specs``'s, serving) in bf16. On a mesh ``frames``
    are the rank's rows and each layer runs on the rank's heads and MLP
    shards. ``shd``: the context the layers run in (default
    ``model.shd``); a training forward's ``for_seq`` copy over the frames
    keeps, under Megatron-SP, the rank's rows of the frames once the
    positions are added (the reference constrains after the sum), and
    the output is those rows."""
    cfg = model.cfg
    shd = model.shd if shd is None else shd
    pos = torch.arange(frames.shape[1], device=frames.device)
    x = frames + sinusoid_positions(pos, cfg.d_model)[None].to(frames.dtype)
    if shd is not None and shd.sp:
        x = shd.own_rows(x)
    layer_fn = _remat(_train_layer, rcfg) if torch.is_grad_enabled() \
        else _train_layer
    seg = Segment("enc", cfg.encoder_layers)
    for block in model.encoder.blocks:
        x = layer_fn(block, x, cfg, rcfg, seg, pos, None, shd)[0]
    return apply_norm(model.encoder.final_norm, x, cfg.norm)


def _embed_in(model: Model, tokens: torch.Tensor, positions: torch.Tensor,
              embed=None, shd=None):
    """The decoder's input: token embeddings in the model's dtype, plus an
    encoder model's sinusoid positions (``positions`` (S,) at prefill and
    in training, (B, 1) per row at decode), rounded to that dtype.
    ``embed``: the table as the forward reads it (default
    ``model.embed``); ``shd``: the forward's context (default
    ``model.shd``; a training forward's Megatron-SP copy, whose rows, and
    so whose positions, are the rank's block of the sequence)."""
    cfg = model.cfg
    shd = model.shd if shd is None else shd
    x = embed_tokens(model.embed if embed is None else embed, tokens,
                     dtype_of(cfg.dtype), shd)
    if cfg.family == "encdec":
        pe = sinusoid_positions(positions, cfg.d_model).to(x.dtype)
        x = x + (shd.own_rows(pe[None]) if shd is not None and shd.sp
                 else pe)
    return x


def _encoded(model: Model, frames, rcfg: RunConfig, train: bool = False):
    """The encoder's output for ``frames``, the rank's rows of the batch
    on a mesh (in training the batch's, which ``batch_shardings`` lays out
    as ``tokens``). ``train``: a training forward on a mesh, whose encoder
    runs in the context's ``for_seq`` copy over the frames: under
    Megatron-SP, where the model axis divides the frames, each rank's
    layers end on its rows of them, which are then gathered once, outside
    the layers' remat, since every rank's cross-attention heads read
    every frame; the gather marks them entered, so the cross attention
    does not enter them again, and its transpose, a reduce-scatter, sums
    the decoder ranks' partial cotangents. Where the frames stay whole
    the cross attention enters them (``attention.gqa_attention``)."""
    cfg = model.cfg
    if not cfg.encoder_layers:
        return None
    if frames is None:
        raise ValueError(f"{cfg.name}: an encoder model needs frames "
                         f"(B, {cfg.encoder_seq}, {cfg.d_model})")
    if not train:
        return encode(model, frames, rcfg)
    shd = model.shd.for_seq(frames.shape[1])
    return shd.gather_rows(encode(model, frames, rcfg, shd))


def check_mesh_training(cfg: ModelConfig, rcfg: RunConfig, sp=None,
                        vocab=None) -> None:
    """Raise for a training run on a mesh that the port does not have:
    Megatron-SP activations (``sp``, the axis a forward's rows split
    over, ``ShardingCtx.for_seq``) with a vocabulary that axis does not
    split (``vocab``: its axis, ``vocab_axis``; ROADMAP P28). No setting
    of ``rcfg`` is refused: every family trains on a mesh, with
    Megatron-SP too."""
    if sp and vocab != sp:
        raise NotImplementedError(
            f"{cfg.name}: Megatron-SP with a vocabulary the {sp} axis "
            f"does not split is not ported")


def forward_train(model: Model, batch: Dict, cfg: ModelConfig,
                  rcfg: RunConfig, global_batch: Optional[int] = None):
    """batch: tokens (B, S) int [+ frames (B, encoder_seq, d) for an
    encoder model]. Returns (logits (B, S, V) in the model's dtype, aux),
    with autograd recording: embed, the encoder, every layer (each under
    ``rcfg.remat``), the final norm, the LM head. ``aux``: a ``moe``
    model's losses and routing statistics, each the mean over a segment's
    layers summed over segments (0-d f32); empty for other families.

    On a mesh (a ``Model`` made with a training ``ShardingCtx``)
    ``batch`` holds this rank's rows (``frames`` too), its block of the
    global batch over the batch axes (``train.batch_shardings``,
    ``data.DataPipeline(shardings=)``; the same rows on every rank of the
    TP axis), the layers run on the rank's heads, MLP columns and experts
    with their FSDP shards gathered, and the logits are the rank's vocab
    columns of its rows. A moe layer routes the reference's dispatch
    groups of the ``global_batch`` rows the ranks' blocks make up
    (``moe.dispatch_groups``; required for a moe model on a mesh) and its
    aux is over the global batch, as the reference's. With
    ``rcfg.seq_parallel_activations`` (every family) the residual stream
    between blocks holds the rank's rows of the sequence over the model
    axis (Megatron-SP, ``ShardingCtx.for_seq``): the embedding's sum and
    each block's row-parallel sums are reduce-scatters, each block
    gathers the rows it splits its work over (an SSM path every row: its
    conv and scan read them all), the norms run on the rank's rows, and
    the LM head gathers them back. An encoder splits its frames on its
    own (``_encoded``): where the model axis divides them its layers run
    under Megatron-SP too, and its output's rows are gathered once for
    the cross attention."""
    check_family(cfg)
    shd = model.shd
    tokens = batch["tokens"]
    groups = Groups()
    if shd is not None:
        b, s = tokens.shape
        shd = shd.for_seq(s)
        check_mesh_training(cfg, rcfg, shd.sp, vocab_axis(model))
        if cfg.moe is not None:
            if global_batch is None:
                raise ValueError(
                    f"{cfg.name}: a moe model's sharded training step "
                    f"needs the global batch its ranks' rows make up "
                    f"(global_batch=)")
            groups = dispatch_groups(shd, global_batch, s, b)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = _embed_in(model, tokens, positions,
                  None if shd is None else shd.gathered(model.embed), shd)
    enc_out = _encoded(model, batch.get("frames"), rcfg, shd is not None)
    layer_fn = _remat(_train_layer, rcfg)
    layer = 0
    aux_all: Dict = {}
    for seg in build_schedule(cfg):
        seg_aux: Dict = {}
        for _ in range(seg.count):
            x, aux = layer_fn(model.blocks[layer], x, cfg, rcfg, seg,
                              positions, enc_out, shd, groups)
            for k, v in aux.items():
                seg_aux[k] = seg_aux.get(k, 0.0) + v
            layer += 1
        for k, v in seg_aux.items():
            aux_all[k] = aux_all.get(k, 0.0) + v / seg.count
    x = apply_norm(model.final_norm, x, cfg.norm)
    if shd is None:
        return lm_logits(model.embed, x, cfg.logit_softcap), aux_all
    return lm_logits(shd.gathered(model.embed), x, cfg.logit_softcap,
                     shd), aux_all


@torch.no_grad()
def forward_prefill(model: Model, tokens: torch.Tensor, rcfg: RunConfig, *,
                    max_seq: int, frames: Optional[torch.Tensor] = None):
    """Full-sequence prefill. tokens: (B, S) int; ``frames`` (B,
    encoder_seq, d) for an encoder model. Returns (last_logits (B, V),
    caches): k/v (or an MLA latent) and conv tails in the model's dtype,
    k/v and latents zero-padded to ``max_seq`` positions, SSM states in
    f32, the encoder's k/v ``ck``/``cv`` in the encoder's dtype. On a mesh:
    this rank's rows of ``tokens``, its vocab shard of their logits and its
    block of their caches."""
    cfg = model.cfg
    shd = model.shd
    b, s = tokens.shape
    # on a mesh a ring holds the whole window (``_ring_len``)
    (check_prompt if shd is None else check_slot_prompt)(cfg, s, max_seq)
    tokens = _rows(shd, tokens)
    groups = dispatch_groups(shd, b, s, tokens.shape[0])
    positions = torch.arange(s, device=tokens.device)
    x = _embed_in(model, tokens, positions)
    enc_out = _encoded(model, None if frames is None
                       else _rows(shd, frames), rcfg)
    caches_out = []
    layer = 0
    for seg in build_schedule(cfg):
        per_layer = []
        for _ in range(seg.count):
            x, c, _ = apply_block(model.blocks[layer], x, cfg, rcfg,
                                  seg.kind, positions=positions,
                                  window=seg.window, enc_out=enc_out,
                                  mode="prefill", shd=shd, groups=groups)
            per_layer.append(c)
            layer += 1
        caches_out.append(_finalize_prefill_cache(per_layer, seg, s,
                                                  max_seq, shd))
    x = apply_norm(model.final_norm, x, cfg.norm)
    logits = lm_logits(model.embed, x[:, -1:], cfg.logit_softcap)
    return logits[:, 0], tuple(caches_out)


@torch.no_grad()
def forward_decode(model: Model, caches: Tuple, tokens: torch.Tensor,
                   pos: torch.Tensor, rcfg: RunConfig, *,
                   max_seq: Optional[int] = None):
    """One decode step. tokens: (B, 1); pos: (B,) int32 positions of the
    new tokens. Writes the new k/v, SSM states and conv tails into
    ``caches`` in place; returns (logits (B, V), caches). A ring segment's
    slots are computed once for all its layers. An encoder model's
    ``ck``/``cv`` pass through untouched. On a mesh ``tokens`` and ``pos``
    are global, ``caches`` this rank's block (``max_seq``, the caches'
    global length, says how the sequence is split), and the logits the
    rank's vocab shard of its rows."""
    cfg = model.cfg
    shd = model.shd
    b = tokens.shape[0]
    tokens, pos = _rows(shd, tokens), _rows(shd, pos)
    groups = dispatch_groups(shd, b, 1, tokens.shape[0])
    x = _embed_in(model, tokens, pos[:, None])
    layer = 0
    for seg, c_seg in zip(build_schedule(cfg), caches):
        ring = None
        n_ring = _ring_len(shd, seg, c_seg["k"].shape[2], max_seq) \
            if "k" in c_seg else 0
        if n_ring:
            ring = ring_slots(pos, n_ring,
                              kv_pos=rcfg.attention_impl == "naive")
        for i in range(seg.count):
            c_l = {k: v[i] for k, v in c_seg.items()}
            x, _, _ = apply_block(model.blocks[layer], x, cfg, rcfg,
                                  seg.kind, positions=pos, window=seg.window,
                                  cache=c_l, decode_pos=pos, ring=ring,
                                  mode="decode", shd=shd, max_seq=max_seq,
                                  groups=groups)
            layer += 1
    x = apply_norm(model.final_norm, x, cfg.norm)
    logits = lm_logits(model.embed, x, cfg.logit_softcap)
    return logits[:, 0], caches


# ---------------------------------------------------------------------------
# Rows and vocab shards on a mesh
# ---------------------------------------------------------------------------


def _rows(shd, x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global batch (all of them off a mesh, or
    where the batch does not divide over the batch axes)."""
    if shd is None:
        return x
    return x[shd.block(shd.split("batch", x.shape[0]), x.shape[0])]


def vocab_axis(model: Model):
    """The mesh axis the LM head's rows (the vocabulary) split over, or
    None."""
    head = "head" if "head" in model.embed else "tokens"
    spec = model.embed.spec(head)
    return spec[0] if spec else None


def greedy(model: Model, logits: torch.Tensor) -> torch.Tensor:
    """Greedy token ids (B_local,) int64 of the logits ``forward_prefill``
    or ``forward_decode`` returned. Off a mesh, ``argmax``. With the
    vocabulary sharded over ``model`` each rank's (max, first index) pair
    is gathered and the largest value wins, ties to the lowest global
    index, as ``jnp.argmax`` breaks them."""
    axis = None if model.shd is None else vocab_axis(model)
    if not axis:
        return torch.argmax(logits, dim=-1)
    shd = model.shd
    n = logits.shape[-1]
    ix = torch.argmax(logits, dim=-1, keepdim=True)
    mx = torch.gather(logits, -1, ix).float()
    mxs = shd.all_gather(mx, axis, -1)
    ixs = shd.all_gather(ix + shd.index(axis) * n, axis, -1)
    best = mxs.amax(dim=-1, keepdim=True)
    big = torch.iinfo(torch.int64).max
    return torch.where(mxs == best, ixs, big).amin(dim=-1)


def gather_logits(model: Model, logits: torch.Tensor,
                  batch: int) -> torch.Tensor:
    """The full (batch, V) logits from every rank's block of them (one
    device: as they are)."""
    shd = model.shd
    if shd is None:
        return logits
    axis = vocab_axis(model)
    if axis:
        logits = shd.all_gather(logits, axis, -1)
    return gather_rows(shd, logits, batch)


def gather_rows(shd, x: torch.Tensor, batch: int) -> torch.Tensor:
    """A global batch of ``batch`` rows from each rank's rows (``_rows``'s
    inverse): an all-gather over the batch axes where the batch is split
    over them."""
    if shd is None:
        return x
    axis = shd.split("batch", batch)
    return shd.all_gather(x, axis, 0) if axis else x


# ---------------------------------------------------------------------------
# Abstract inputs per (cfg, shape)
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                cache_dtype: str = "bfloat16") -> Dict:
    """Meta-device stand-ins for every model input of this cell, with the
    shapes and dtypes of the reference's ``ShapeDtypeStruct``s: tokens
    and labels (train), tokens [+ frames in the model's dtype for an
    encoder model] (train, prefill), or tokens (B, 1), pos and the caches
    (decode)."""
    b, s = shape.global_batch, shape.seq_len

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    out: Dict = {}
    if shape.kind in ("train", "prefill"):
        out["tokens"] = meta((b, s), torch.int32)
        if shape.kind == "train":
            out["labels"] = meta((b, s), torch.int32)
        if cfg.encoder_layers:
            out["frames"] = meta((b, cfg.encoder_seq, cfg.d_model),
                                 dtype_of(cfg.dtype))
    else:
        out["tokens"] = meta((b, 1), torch.int32)
        out["pos"] = meta((b,), torch.int32)
        out["caches"] = tuple(
            {k: meta(d.shape, dtype_of(d.dtype)) for k, d in seg.items()}
            for seg in cache_schema(cfg, b, s, cache_dtype))
    return out
