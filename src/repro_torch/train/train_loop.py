"""Training step factory: loss, gradient accumulation, NSM-routed pod sync.

The counterpart of ``repro/train/train_loop.py``. Two stacks for the same
model code (the paper's use case 3, applied to training):

  * **plain**: on one card ``plain_step`` computes the gradients and runs
    AdamW; no collective. On a mesh (a state made with a training
    ``ShardingCtx``: ``make_train_step(cfg, rcfg, shd)``) the same step
    runs on every rank's shards, the reference's GSPMD step with its work
    split explicitly: each layer gathers its FSDP shards, TP splits heads,
    MLP columns and the vocabulary over ``model``, the loss is the
    reference's select-reduce cross entropy over vocab shards, and each
    gradient is summed over the mesh axes whose ranks hold other rows of
    the batch and the same block of it (``pod`` x ``data`` for a leaf
    replicated there; an FSDP leaf's ``data`` part is its gather's
    reduce-scatter), every collective through the ``nk_*`` verbs.
  * **netkernel pod sync** (``RunConfig.explicit_pod_sync`` on a mesh
    with a ``pod`` axis): the gradients' ``pod`` sum goes through the
    CoreEngine (``nk_grad_sync``), so the operator's routing table picks
    the cross-pod transport (hierarchical / int8-compressed / ring)
    without touching model or loss code. With a state not sharded (one
    rank per pod of a ``torch.distributed`` world,
    ``core/nsm.py::MeshAxes``) each rank computes its pod's rows, as the
    reference's ``vmap`` lanes do; the arithmetic is the same.

A step updates the state in place (the reference donates it) and returns
it with its metrics, as 0-d tensors on the state's device, the same on
every rank. The state is ``{"params": Model, "opt": {"mu", "nu",
"count"}, "step"}`` (``models/params.py::opt_slots`` lays out the
moments); ``state_shardings`` and ``batch_shardings`` give its layout and
the batch's on a mesh, trees of ``NamedSharding``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.collectives import nk_grad_sync, use_engine
from repro_torch.core.compression import absmax_scale, \
    int8_roundtrip_residual
from repro_torch.core.engine import CoreEngine, make_engine
from repro_torch.device import dtype_of, resolve_device
from repro_torch.distribution.sharding import (
    NamedSharding, ShardingCtx, fsdp_entry, make_rules, mesh_axis_sizes,
    spec_for, split_axes)
from repro_torch.models.model import (
    Model, check_family, forward_train, vocab_axis)
from repro_torch.models.params import (
    init_params, nu_specs, opt_slots, param_layouts, schema_layouts,
    slot_spec)
from repro_torch.train.optimizer import adamw_update, init_opt_state


def _sharded_ce(model: Model, logits: torch.Tensor, labels: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lse, picked) of each of the rank's tokens from its vocab columns:
    the reference's select-reduce, never a gather over the vocabulary. The
    max is a ``pmax`` over the vocab's axis (no gradient, as logsumexp's
    shift has none), the shifted exps and the picked logit (the label's
    column where this rank holds it, else 0) are ``psum``s over it."""
    shd = model.shd
    axis = vocab_axis(model)
    if not axis:
        lse = torch.logsumexp(logits, dim=-1)
        return lse, torch.gather(logits, -1, labels[..., None])[..., 0]
    n = logits.shape[-1]
    m = shd.pmax(logits.amax(dim=-1, keepdim=True), axis)
    lse = m[..., 0] + torch.log(shd.psum(
        torch.exp(logits - m).sum(dim=-1), axis))
    cols = torch.arange(n, device=logits.device) + shd.index(axis) * n
    picked = shd.psum(torch.where(cols == labels[..., None], logits,
                                  0.0).sum(dim=-1), axis)
    return lse, picked


def loss_fn(model: Model, batch: Dict, cfg: ModelConfig, rcfg: RunConfig,
            global_batch: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """Mean next-token cross entropy in f32, plus the z-loss. On one card
    a gather picks the labels' logits. On a mesh the logits are the rank's
    vocab columns of its rows (``_sharded_ce``), and the means are over
    the global batch: the sums of the rank's tokens are ``psum``med over
    every non-TP axis and divided by the tokens those ranks hold (a row
    held by several of them counts once for each, so a batch axis that
    does not split the batch changes nothing). The ``psum``'s backward is
    the identity, so each rank's gradient is its rows' share of the
    global batch's, which the step then sums over the ranks
    (``_sync_grads``). A moe model's aux losses are the reference's over
    the global batch (``forward_train``; ``global_batch`` as there)."""
    logits, aux = forward_train(model, batch, cfg, rcfg, global_batch)
    logits = logits.float()
    labels = batch["labels"].long()
    shd = model.shd
    if shd is None:
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, labels[..., None])[..., 0]
        loss = torch.mean(lse - picked)
        lse2 = torch.mean(torch.square(lse)) if rcfg.z_loss else None
    else:
        lse, picked = _sharded_ce(model, logits, labels)
        axes = shd.loss_axes
        count = lse.numel() * math.prod(shd.axis_sizes[a] for a in axes)
        sums = torch.stack([torch.sum(lse - picked),
                            torch.sum(torch.square(lse))])
        if axes:
            sums = shd.psum(sums, axes)
        loss, lse2 = sums[0] / count, sums[1] / count
    metrics = {"ce_loss": loss}
    if rcfg.z_loss:
        zl = rcfg.z_loss * lse2
        loss = loss + zl
        metrics["z_loss"] = zl
    if "moe_lb_loss" in aux:
        moe_l = 1e-2 * aux["moe_lb_loss"] + 1e-3 * aux["moe_z_loss"]
        loss = loss + moe_l
        metrics.update(aux)
    metrics["loss"] = loss
    return loss, {k: v.detach() for k, v in metrics.items()}


def _trainable(model: Model) -> List[Tuple[str, torch.Tensor]]:
    """The model's parameters by name, with ``requires_grad`` on (the
    port makes them frozen; a trainer turns it on for its own model)."""
    named = list(model.named_parameters())
    for _, p in named:
        p.requires_grad_(True)
    return named


def _grads(model: Model, batch: Dict, cfg: ModelConfig, rcfg: RunConfig,
           sync: Optional[Callable] = None,
           global_batch: Optional[int] = None
           ) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """(gradients by parameter name, metrics). With ``grad_accum > 1``:
    each micro-batch's gradient (in the parameter dtype) is added into
    ``grad_accum_dtype`` accumulators, each the shape of the rank's shard
    of its parameter, and the mean is cast to bf16; the metrics are the
    last micro-batch's (the reference's scan carry keeps only those).
    ``sync``: applied to the gradients by name (the accumulated sums)
    before the mean, the cross-rank sum on a mesh (``_sync_grads``).
    ``global_batch``: the global batch the rows are a block of (a
    micro-batch's is its ``grad_accum``-th part), which a moe model's
    sharded step needs (``forward_train``)."""
    named = _trainable(model)
    names = [n for n, _ in named]
    params = [p for _, p in named]
    sync = sync or (lambda g: g)
    if rcfg.grad_accum <= 1:
        loss, metrics = loss_fn(model, batch, cfg, rcfg, global_batch)
        grads = dict(zip(names, torch.autograd.grad(loss, params)))
        with torch.no_grad():
            return sync(grads), metrics
    a = rcfg.grad_accum
    micro_global = None if global_batch is None else global_batch // a
    mb = {k: v.reshape((a, v.shape[0] // a) + v.shape[1:])
          for k, v in batch.items()}
    adt = dtype_of(rcfg.grad_accum_dtype)
    acc = [torch.zeros(p.shape, dtype=adt, device=p.device) for p in params]
    metrics = _zero_metrics(cfg, rcfg, params[0].device)
    for i in range(a):
        loss, metrics = loss_fn(model, {k: v[i] for k, v in mb.items()},
                                cfg, rcfg, micro_global)
        g = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for acc_i, g_i in zip(acc, g):
                acc_i.add_(g_i.to(adt))
        del g
    grads = {}
    with torch.no_grad():
        summed = sync(dict(zip(names, acc)))
        del acc
        for name in names:
            grads[name] = (summed.pop(name) / a).to(torch.bfloat16)
    return grads, metrics


@torch.no_grad()
def ef_residual_metrics(grads: Dict[str, torch.Tensor],
                        model: Optional[Model] = None) -> Dict:
    """Measured int8 error-feedback residual of a gradient tree.

    ``ef_residual_max`` is the largest absolute one-step quantization
    error any gradient element would incur on the int8 wire: the residual
    EF-SGD carries, and the quantity an error-feedback-aware numerics
    bound is derived from (``RunConfig.track_ef_residual`` exposes it as a
    per-step training metric). On a mesh (``model``'s) each leaf's scale
    comes from its global absmax and the max is taken over the ranks."""
    shd = None if model is None else model.shd
    if shd is None:
        leaves = [int8_roundtrip_residual(g).abs().amax()
                  for g in grads.values()]
        return {"ef_residual_max": torch.stack(leaves).amax()}
    every = tuple(shd.axis_sizes)
    peaks = shd.pmax(torch.stack([g.float().abs().amax()
                                  for g in grads.values()]), every)
    leaves = [int8_roundtrip_residual(g, absmax_scale(a)).abs().amax()
              for g, a in zip(grads.values(), peaks)]
    return {"ef_residual_max": shd.pmax(torch.stack(leaves).amax(), every)}


def _zero_metrics(cfg: ModelConfig, rcfg: RunConfig, device=None) -> Dict:
    def zero():
        return torch.zeros((), dtype=torch.float32, device=device)
    m = {"ce_loss": zero(), "loss": zero()}
    if rcfg.z_loss:
        m["z_loss"] = zero()
    if cfg.moe is not None:
        m.update({k: zero() for k in ("moe_lb_loss", "moe_z_loss",
                                      "moe_max_frac", "moe_drop_frac")})
    return m


def _pod_mean(metrics: Dict, group, pods: int) -> Dict:
    """Each metric averaged over the pod group: one small all-reduce
    outside the engine (GSPMD's mean in the reference, which costs no
    NQE)."""
    keys = sorted(metrics)
    stacked = torch.stack([metrics[k].float() for k in keys])
    dist.all_reduce(stacked, group=group)
    return dict(zip(keys, stacked / pods))


def sum_axes(shd: ShardingCtx, spec: Tuple, dims: Tuple, sp=None
             ) -> Tuple[str, ...]:
    """The axes a leaf's gradient is summed over after the backward: every
    axis but the TP axes (whose ranks share one loss, and whose
    rank-dependent uses the ``enter``s already summed) and the axes of its
    FSDP dim (summed by its gather's reduce-scatter), in mesh order. Under
    Megatron-SP (``sp``, the axis the rows split over between blocks) a
    leaf that axis does not split is summed over it too: the norms run on
    the rank's rows, and the weights every rank holds whole (kv heads,
    q/k norms, MLA's down-projection, experts the axis does not divide)
    are not entered, each rank's gradient being its rows' or heads'
    part."""
    entry = fsdp_entry(spec, dims)
    fsdp = split_axes((entry[1],)) if entry else set()
    tp = set(shd.tp_axes)
    if sp and not split_axes((sp,)) & split_axes(spec):
        tp -= split_axes((sp,))
    return tuple(a for a in shd.axis_sizes if a not in tp and a not in fsdp)


def _sync_grads(model: Model, grads: Dict[str, torch.Tensor],
                pod_engine: Optional[CoreEngine] = None,
                seq: Optional[int] = None) -> Dict:
    """Each rank's gradient shards summed over the ranks that hold the
    same block and other rows (``sum_axes``), as gradient ``psum``s
    through the ``nk_*`` verbs. With ``pod_engine`` the ``pod`` part is
    ``nk_grad_sync`` over ``("pod",)`` on that engine (the NetKernel pod
    sync) after the rest. ``seq``: the batch's sequence length, which
    says whether Megatron-SP split the rows (``ShardingCtx.for_seq``); an
    encoder's leaves follow the split of its own ``encoder_seq`` frames,
    which may differ (1,500 frames stay whole at a model axis of 8, where
    448 tokens split)."""
    shd = model.shd
    sp = enc_sp = None
    if seq is not None:
        sp = shd.sp_of(seq)
        if model.cfg.encoder_layers:
            enc_sp = shd.sp_of(model.cfg.encoder_seq)
    layouts = param_layouts(model)
    out, pod = {}, {}
    for name, g in grads.items():
        axes = sum_axes(shd, *layouts[name],
                        enc_sp if name.startswith("encoder.") else sp)
        if pod_engine is not None and "pod" in axes:
            axes = tuple(a for a in axes if a != "pod")
            pod[name] = None
        out[name] = shd._psum(g, axes, gradient=True) if axes else g
    if pod:
        with use_engine(pod_engine):
            out.update(nk_grad_sync({n: out[n] for n in pod}, ("pod",)))
    return out


def train_ctx(mesh, rcfg: RunConfig) -> ShardingCtx:
    """The training ``ShardingCtx`` of ``mesh`` (a ``DeviceMesh``, a
    ``MeshAxes`` or a context already made)."""
    if isinstance(mesh, ShardingCtx):
        return mesh
    return ShardingCtx(mesh, rules=make_rules(rcfg.rules_variant),
                       seq_parallel=rcfg.seq_parallel_activations,
                       train=True)


def make_train_step(cfg: ModelConfig, rcfg: RunConfig, mesh=None,
                    engine: Optional[CoreEngine] = None,
                    global_batch: Optional[int] = None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics). ``mesh``: None
    on one card, a training ``ShardingCtx``, or the ``MeshAxes`` of a
    ``torch.distributed`` world. The step follows the state: one whose
    model holds shards runs the sharded step (the batch is the rank's rows,
    ``batch_shardings``); an unsharded one on a mesh with a ``pod`` axis
    and ``explicit_pod_sync``, one rank per pod (``batch`` global, each
    rank taking its pod's rows); else the one-card step. ``engine`` routes
    the pod sync (default: the native stack, ``make_engine(mesh,
    "xla")``). ``global_batch``: the global batch a sharded step's rows
    are a block of, which a moe model's sharded step needs (its dispatch
    groups follow it, ``forward_train``)."""
    check_family(cfg)
    axes = mesh.axes if isinstance(mesh, ShardingCtx) else mesh
    pod_sync = rcfg.explicit_pod_sync and axes is not None \
        and "pod" in axes
    if pod_sync and engine is None:
        engine = make_engine(axes, "xla")

    def plain_step(state, batch):
        model = state["params"]
        sync = None
        if model.shd is not None:
            seq = batch["tokens"].shape[1]

            def sync(g):
                return _sync_grads(model, g, engine if pod_sync else None,
                                   seq)
        grads, metrics = _grads(model, batch, cfg, rcfg, sync, global_batch)
        if rcfg.track_ef_residual:
            metrics.update(ef_residual_metrics(grads, model))
        _, _, om = adamw_update(model, grads, state["opt"], rcfg)
        metrics.update(om)
        state["step"] += 1
        return state, metrics

    if not pod_sync:
        return plain_step

    # --- NetKernel-owned cross-pod gradient sync, one rank per pod ---
    mesh = axes
    pods = mesh["pod"]
    me = mesh.index("pod")
    group = mesh.group(("pod",))

    def pod_step(state, batch):
        if state["params"].shd is not None:
            return plain_step(state, batch)
        rows = {k: v.reshape((pods, v.shape[0] // pods) + v.shape[1:])[me]
                for k, v in batch.items()}
        grads, metrics = _grads(state["params"], rows, cfg, rcfg)
        with torch.no_grad():
            with use_engine(engine):
                grads = nk_grad_sync(grads, ("pod",))
            grads = {k: g / pods for k, g in grads.items()}
        metrics = _pod_mean(metrics, group, pods)
        if rcfg.track_ef_residual:
            # the residual of the *synced* gradients: what the int8 wire
            # would have cost this step had the compressed stack carried it
            metrics.update(ef_residual_metrics(grads))
        _, _, om = adamw_update(state["params"], grads, state["opt"], rcfg)
        metrics.update(om)
        state["step"] += 1
        return state, metrics

    return pod_step


def make_train_state(cfg: ModelConfig, rcfg: RunConfig, *,
                     model: Optional[Model] = None, seed: int = 0,
                     device=None, abstract: bool = False,
                     shd: Optional[ShardingCtx] = None) -> Dict:
    """A fresh train state on ``device`` (``cuda`` unless ``"cpu"``): the
    given ``model``, or the port's ``init_params`` from ``seed``, or, with
    ``abstract``, an uninitialized model (the template a checkpoint
    restore fills in place); zero moments, count and step. ``shd``: a
    training ``ShardingCtx`` on a mesh, whose rank's shards the model and
    the moments hold (``init_params`` draws the same values on every
    layout)."""
    check_family(cfg)
    if model is None:
        dev = resolve_device(device)
        model = Model(cfg, device=dev, shd=shd) if abstract \
            else init_params(cfg, device=dev, seed=seed, shd=shd)
    _trainable(model)
    return {"params": model, "opt": init_opt_state(model, rcfg),
            "step": torch.zeros((), dtype=torch.int32, device=model.device)}


def _named(mesh, rcfg: Optional[RunConfig]):
    """(the mesh a ``NamedSharding`` holds, the rules) for ``mesh``: a
    ``ShardingCtx``, a ``DeviceMesh``, a ``MeshAxes`` or a dict."""
    if isinstance(mesh, ShardingCtx):
        return (mesh.axes if mesh.axes is not None else mesh.mesh), \
            mesh.rules
    rules = make_rules(rcfg.rules_variant) if rcfg is not None else None
    if isinstance(mesh, dict):
        return mesh, rules
    from repro_torch.core.nsm import MeshAxes
    return (mesh if isinstance(mesh, MeshAxes) else MeshAxes(mesh)), rules


def state_shardings(cfg: ModelConfig, rcfg: RunConfig, mesh) -> Dict:
    """The train state's layout on ``mesh`` under ``rcfg.rules_variant``,
    as ``make_train_state(..., shd=)`` lays it out: ``{"params": {name:
    NamedSharding}, "opt": {"mu": {slot: ...}, "nu": {slot: {"full"} or
    {"vr", "vc"}}, "count": ...}, "step": ...}``. A per-layer slot's spec is
    its parameter's, which is the reference's stacked leaf's without the
    leading layer entry; a stacked slot's is the stacked leaf's."""
    check_family(cfg)
    named, rules = _named(mesh, rcfg)
    layouts = schema_layouts(cfg, ShardingCtx(mesh_axis_sizes(named),
                                              rules=rules, train=True))
    sizes = {n: len(dims) for n, (_, dims) in layouts.items()}

    def ns(spec):
        return NamedSharding(named, spec)

    mu, nu = {}, {}
    for slot in opt_slots(cfg):
        spec = slot_spec(slot, layouts)
        ndim = sizes[slot.params[0]] + slot.stacked
        mu[slot.name] = ns(spec)
        nu[slot.name] = {k: ns(v) for k, v in
                         nu_specs(spec, ndim, rcfg.factored_nu).items()}
    return {"params": {n: ns(spec) for n, (spec, _) in layouts.items()},
            "opt": {"mu": mu, "nu": nu, "count": ns(())}, "step": ns(())}


def batch_shardings(cfg: ModelConfig, mesh, with_labels: bool = True,
                    rcfg: Optional[RunConfig] = None,
                    global_batch: Optional[int] = None) -> Dict:
    """The batch's layout: its rows over the rules' batch axes (the first
    candidate that divides ``global_batch``; with none given, the first
    the mesh has), one ``NamedSharding`` per input."""
    named, rules = _named(mesh, rcfg)
    gb = global_batch or (1 << 30)   # sentinel: divisible by any mesh axis
    tok = NamedSharding(named, spec_for((gb, 1), ("batch", None), named,
                                        rules))
    out = {"tokens": tok}
    if with_labels:
        out["labels"] = tok
    if cfg.encoder_layers:
        out["frames"] = tok
    return out
